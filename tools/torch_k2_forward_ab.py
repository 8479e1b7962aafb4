#!/usr/bin/env python3
"""Time two builds of the port's K2 forward on one CUDA card, in turns.

    python3 tools/torch_k2_forward_ab.py --old PATH/fused_render.cu

``--old`` is the ``csrc/fused_render.cu`` of an earlier commit of
``lightcurver_tpu_torch`` whose ``k2_forward`` took a partial-sum scratch
(N, ceil(Lh / 32), n, n) before the output, as the tile design did; unpack
it from git first, e.g.
``git archive 2df0c23 lightcurver_tpu_torch/csrc/fused_render.cu | tar -x
-C build/parent``. The new forward is the checkout's
(``ops/fused_render_cuda.py``). Both run on the K2 operands of the ROI fit
(100 epochs, s 2, 4 sources, a random background) at n 64 (ROI-100) and
n 32 (the production stamp), with and without the background channel, in
the order old, new, new, old (CUDA events, ``--reps`` launches each after
a warm-up), and are held to the plain twin first: the old kernel to
1e-4 max|plain|, the new to 1e-5. Prints the card line, one line per
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
                                       fused_render, fused_render_cuda)
from lightcurver_tpu_torch.utilities.synthetic import \
    make_roi_scene  # noqa: E402


def load_old(source):
    lib = ctypes.CDLL(str(cuda_build.build(source)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.k2_forward.argtypes = [ptr] * 16 + [i32] * 6 + [ptr]
    lib.k2_forward.restype = i32
    lib.k2_tile_width.restype = i32
    return lib


def old_forward(lib, ops, include_h):
    u_re, v, ayp = ops[0], ops[2], ops[10]
    N, C, L = u_re.shape
    Lh, n = v.shape[-1], ayp.shape[0]
    out = torch.empty(N, n, n, device=u_re.device)
    partial = torch.empty(N, -(-Lh // lib.k2_tile_width()), n, n,
                          device=u_re.device)
    ptrs = [None if x is None else x.data_ptr()
            for x in (*ops, partial, out)]
    rc = lib.k2_forward(*ptrs, N, C, L, Lh, n, int(include_h),
                        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old k2_forward failed ({rc})")
    return out


def operands(n_pix):
    scene = make_roi_scene(n_epochs=100, n_pix=n_pix, s=2, n_sources=4,
                           seed=11)
    model, kw, *_ = setup_model(scene["data"], scene["sigma_2"],
                                scene["psf"], scene["xs"], scene["ys"],
                                scene["s"], device="cuda")
    gen = torch.Generator().manual_seed(n_pix)
    h = (0.01 * torch.randn(model.m**2, generator=gen)).cuda()
    a = kw["kwargs_analytic"]["a"].reshape(100, model.n_sources)
    px, py = model.source_positions(kw)
    return model.fused_render_operands(a, px, py, h, model.matmul_consts())


def cuda_ms(fn, reps):
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
    parser.add_argument("--reps", type=int, default=200)
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
    old = load_old(args.old)
    results = []
    for n_pix in (64, 32):
        ops = operands(n_pix)
        for include_h in (True, False):
            case = ops if include_h else (*ops[:8], None, None, *ops[10:])
            plain = fused_render.render_plain(*case, include_h=include_h)
            scale = plain.abs().max().item()
            runs = {
                "old": lambda: old_forward(old, case, include_h),
                "new": lambda: fused_render_cuda.forward(
                    *case, include_h=include_h),
            }
            errs = {}
            for name, fn in runs.items():
                out = fn()
                torch.cuda.synchronize()
                errs[name] = (out - plain).abs().max().item() / scale
            if errs["old"] > 1e-4 or errs["new"] > 1e-5:
                print(f"FAIL: n={n_pix} h={include_h}: relative max|diff| "
                      f"{errs}", flush=True)
                return 1
            times = {"old": [], "new": []}
            for name in ("old", "new", "new", "old"):
                times[name].append(cuda_ms(runs[name], args.reps))
            row = {"n": n_pix, "include_h": include_h,
                   "old_ms": times["old"], "new_ms": times["new"],
                   "old_rel_err": errs["old"], "new_rel_err": errs["new"]}
            results.append(row)
            print(f"n={n_pix} include_h={include_h}: old "
                  f"{times['old'][0]:.4f} / {times['old'][1]:.4f} ms, new "
                  f"{times['new'][0]:.4f} / {times['new'][1]:.4f} ms "
                  f"(order old, new, new, old); max|diff| / max|plain| "
                  f"old {errs['old']:.2e}, new {errs['new']:.2e}",
                  flush=True)
    print(json.dumps({"card": card, "k2_forward_ab": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
