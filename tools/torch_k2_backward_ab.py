#!/usr/bin/env python3
"""Time two or more builds of the port's K2 backward on one CUDA card, in
turns.

    python3 tools/torch_k2_backward_ab.py --old PATH/fused_render.cu \
        [--variants PATH/fused_render.cu ...]

``--old`` is the ``csrc/fused_render.cu`` of an earlier commit of
``lightcurver_tpu_torch`` whose ``k2_backward`` took no slab count and a
du scratch of (2, N, ceil(Lh / 32), C, L), as the tile kernel of 80883cd
did; unpack it from git first, e.g. ``git archive 80883cd
lightcurver_tpu_torch/csrc/fused_render.cu | tar -x -C build/parent``.
The new backward is the checkout's; ``--variants`` are other sources with
the checkout's interface (the slab count from
``ops/fused_render_cuda.py::backward_slabs``).

All run on the K2 operands of the ROI fit (100 epochs, s 2, 4 sources, a
random background, a random cotangent), with the k axis padded as the
wrapper pads it, at (n 64, with h), (64, without), (32, with) and (31,
with), through ctypes on preallocated outputs (neither pays the wrapper's
Python). Each is held to the plain twin first, per output: the old kernel
to 1e-4 max|plain|, the others to 1e-5. Then they are timed in the order
old, new, variants, variants reversed, new, old, each two ways, ``--reps``
launches after a warm-up: ``ms``, a loop of launches between two CUDA
events, and ``graph_ms``, the same launches captured in one CUDA graph.
Prints the card line, one line per case and one JSON line.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_ms, graph_ms  # noqa: E402
from lightcurver_tpu_torch.ops import (cuda_build, enforce_fp32,  # noqa: E402
                                       fused_render, fused_render_cuda)
from tools.torch_k2_forward_ab import operands  # noqa: E402

CASES = ((64, True), (64, False), (32, True), (31, True))


def load(source, old):
    """ctypes library of a fused_render source; ``old``: the tile kernel's
    interface (no slab count)."""
    lib = ctypes.CDLL(str(cuda_build.build(source)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.k2_backward.argtypes = [ptr] * 18 + [i32] * (6 if old else 7) + [ptr]
    lib.k2_backward.restype = i32
    if old:
        lib.k2_tile_width.restype = i32
    return lib


def launcher(lib, old, ops, g, include_h):
    """(run, outputs): ``run()`` launches the backward of ``lib`` on the
    current stream into preallocated outputs."""
    N, C, L = ops[0].shape
    Lh, n = ops[2].shape[-1], ops[8].shape[0]
    dev = dict(device=ops[0].device, dtype=torch.float32)
    if old:
        slabs = -(-Lh // lib.k2_tile_width())
        extra = ()
    else:
        slabs = fused_render_cuda.backward_slabs(
            C, Lh, n, fused_render_cuda.smem_optin(ops[0].device))
        extra = (slabs,)
    du_part = torch.empty(2, N, slabs, C, L, **dev) \
        if old or slabs > 1 else None
    du = torch.empty(2, N, C, L, **dev)
    dv = torch.empty(N, C, Lh, **dev)
    dh_part = torch.empty(2, N, L, Lh, **dev)
    dh = torch.empty(2, L, Lh, **dev)
    buffers = (g, *ops, du_part, du, dv, dh_part, dh)
    ptrs = [None if x is None else x.data_ptr() for x in buffers]

    def run():
        rc = lib.k2_backward(*ptrs, N, C, L, Lh, n, int(include_h), *extra,
                             torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"k2_backward failed ({rc})")

    run.buffers = buffers   # the kernel writes them: keep them alive
    return run, (du[0], du[1], dv, dh[0], dh[1])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old", required=True, type=Path)
    parser.add_argument("--variants", type=Path, nargs="*", default=[])
    parser.add_argument("--reps", type=int, default=100)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", flush=True)
        return 1
    enforce_fp32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    sources = {"old": (args.old, True),
               "new": (fused_render_cuda.SOURCE, False),
               **{path.stem: (path, False) for path in args.variants}}
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc each
        list(pool.map(cuda_build.build, [p for p, _ in sources.values()]))
    libs = {label: (load(path, old), old)
            for label, (path, old) in sources.items()}
    labels = list(libs)
    order = labels + labels[::-1]
    results = []
    for n_pix, include_h in CASES:
        ops = operands(n_pix)
        bwd_ops = (*ops[:8], *ops[10:])
        g = torch.randn(100, n_pix, n_pix,
                        generator=torch.Generator().manual_seed(n_pix)).cuda()
        L0 = ops[0].shape[-1]
        padded = fused_render_cuda.pad_k((*ops[:8], None, None, *ops[10:]))
        padded = (*padded[:8], *padded[10:])
        wants = fused_render.render_backward_plain(g, *bwd_ops,
                                                   include_h=include_h)
        runs, errs = {}, {}
        for label, (lib, old) in libs.items():
            run, outs = launcher(lib, old, padded, g, include_h)
            run()
            torch.cuda.synchronize()
            rel = []
            for i, (got, want) in enumerate(zip(outs, wants)):
                if want is None:
                    continue
                got = got[..., :L0] if i < 2 else got[:L0] if i > 2 else got
                rel.append((got - want).abs().max().item()
                           / want.abs().max().item())
            bar = 1e-4 if old else 1e-5
            if max(rel) > bar:
                print(f"FAIL: {label} n={n_pix} h={include_h}: max|diff| / "
                      f"max|plain| per output {rel} > {bar}", flush=True)
                return 1
            runs[label], errs[label] = run, rel
        times = {label: [] for label in labels}
        for label in order:
            times[label].append({"ms": cuda_ms(runs[label], args.reps),
                                 "graph_ms": graph_ms(runs[label],
                                                      args.reps)})
        results.append({"n": n_pix, "include_h": include_h,
                        "times": times, "rel_err": errs})
        shown = "; ".join(
            f"{label} " + " / ".join(f"{t['ms']:.4f}" for t in times[label])
            + " ms (graph " + " / ".join(f"{t['graph_ms']:.4f}"
                                         for t in times[label]) + ")"
            for label in labels)
        worst = ", ".join(f"{label} {max(errs[label]):.2e}"
                          for label in labels)
        print(f"n={n_pix} include_h={include_h} (order "
              f"{', '.join(order)}): {shown}; max|diff| / max|plain| "
              f"{worst}", flush=True)
    print(json.dumps({"card": card, "k2_backward_ab": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
