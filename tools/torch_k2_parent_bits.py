#!/usr/bin/env python3
"""Hold the checkout's K2 against an earlier build, bit for bit and in time.

    python3 tools/torch_k2_parent_bits.py --old PATH/fused_render.cu

``--old`` is the ``csrc/fused_render.cu`` of an earlier commit whose
``k2_forward`` and ``k2_backward`` take one shared background plane (no
group count: the interface of 9dd4fd8), unpacked from git first, e.g.
``git archive 9dd4fd8 lightcurver_tpu_torch/csrc/fused_render.cu | tar -x
-C build/parent``. On the K2 operands of the ROI fit (100 epochs, s 2, 4
sources, a random background) at n 64 (ROI-100), 32 and 31, with and
without the background, the checkout's kernels (``ops/fused_render_cuda``,
one shared plane) must give the old kernels' bits, forward and backward;
then both are timed in the order old, new, new, old (CUDA events,
``--reps`` calls each after a warm-up). Prints the card line, one line per
case and one JSON line.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lightcurver_tpu_torch.core.deconv.model import setup_model  # noqa: E402
from lightcurver_tpu_torch.ops import (cuda_build, enforce_fp32,  # noqa: E402
                                       fused_render_cuda as k2)
from lightcurver_tpu_torch.utilities.synthetic import \
    make_roi_scene  # noqa: E402


def load_old(source):
    lib = ctypes.CDLL(str(cuda_build.build(source)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.k2_forward.argtypes = [ptr] * 15 + [i32] * 6 + [ptr]
    lib.k2_backward.argtypes = [ptr] * 18 + [i32] * 7 + [ptr]
    lib.k2_forward.restype = lib.k2_backward.restype = i32
    return lib


def _ptr(x):
    return None if x is None else x.data_ptr()


def old_forward(lib, ops, include_h):
    ops = k2.pad_k(ops)
    N, C, L = ops[0].shape
    Lh, n = ops[2].shape[-1], ops[10].shape[0]
    out = torch.empty(N, n, n, device=ops[0].device)
    rc = lib.k2_forward(*(_ptr(x) for x in (*ops, out)), N, C, L, Lh, n,
                        int(include_h),
                        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old k2_forward failed ({rc})")
    return [out]


def old_backward(lib, g, ops, include_h):
    L0 = ops[0].shape[-1]
    ops = k2.pad_k(ops)
    ops = (*ops[:8], *ops[10:])
    N, C, L = ops[0].shape
    Lh, n = ops[2].shape[-1], ops[9].shape[0]
    plan = k2.backward_plan(N, C, L, Lh, n, include_h,
                            k2.smem_optin(g.device))
    dev = dict(device=g.device, dtype=torch.float32)
    du = torch.empty(2, N, C, L, **dev)
    dv = torch.empty(N, C, Lh, **dev)
    dh = torch.empty(2, L, Lh, **dev) if include_h else None
    du_part = torch.empty(2, N, plan.n_slabs, C, L, **dev) \
        if plan.n_slabs > 1 else None
    dh_part = torch.empty(2, N, L, Lh, **dev) if include_h else None
    rc = lib.k2_backward(
        *(_ptr(x) for x in (g, *ops, du_part, du, dv, dh_part, dh)),
        N, C, L, Lh, n, int(include_h), plan.n_slabs,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old k2_backward failed ({rc})")
    du = du[..., :L0]
    return [du[0], du[1], dv] + ([dh[0, :L0], dh[1, :L0]] if include_h
                                 else [])


def events_ms(fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old", required=True, type=Path)
    parser.add_argument("--reps", type=int, default=20)
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
    lib = load_old(args.old)
    rows, ok = [], True
    for n_pix in (64, 32, 31):
        sc = make_roi_scene(n_epochs=100, n_pix=n_pix, s=2, n_sources=4,
                            seed=11)
        model, kw, *_ = setup_model(sc["data"], sc["sigma_2"], sc["psf"],
                                    sc["xs"], sc["ys"], 2, device="cuda")
        gen = torch.Generator().manual_seed(n_pix)
        h = (0.01 * torch.randn(model.m**2, generator=gen)).cuda()
        a = kw["kwargs_analytic"]["a"].reshape(100, 4)
        px, py = model.source_positions(kw)
        ops = model.fused_render_operands(a, px, py, h,
                                          model.matmul_consts())
        g = torch.randn(100, n_pix, n_pix, generator=gen).cuda()
        for include_h in (True, False):
            fwd = ops if include_h else (*ops[:8], None, None, *ops[10:])
            bwd = (*ops[:8], *ops[10:])
            pairs = {
                "forward": (lambda: old_forward(lib, fwd, include_h),
                            lambda: [k2.forward(*fwd, include_h=include_h)]),
                "backward": (lambda: old_backward(lib, g, fwd, include_h),
                             lambda: [x for x in k2.backward(
                                 g, *bwd, include_h=include_h)
                                 if x is not None]),
            }
            for direction, (old, new) in pairs.items():
                same = all(torch.equal(x, y) for x, y in zip(old(), new()))
                ok = ok and same
                times = [events_ms(fn, args.reps)
                         for fn in (old, new, new, old)]
                row = {"n": n_pix, "include_h": include_h,
                       "direction": direction, "same_bits": same,
                       "old_ms": [times[0], times[3]],
                       "new_ms": [times[1], times[2]]}
                rows.append(row)
                print(f"{direction} n={n_pix} include_h={include_h}: "
                      f"{'same bits' if same else 'BITS DIFFER'}; old "
                      f"{times[0]:.4f} / {times[3]:.4f} ms, new "
                      f"{times[1]:.4f} / {times[2]:.4f} ms (card {card})",
                      flush=True)
    print(json.dumps({"card": card, "rows": rows}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
