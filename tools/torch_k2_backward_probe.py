#!/usr/bin/env python3
"""Where the K2 backward's time goes, on one CUDA card.

    python3 tools/torch_k2_backward_probe.py

Compiles variants of the checkout's ``lightcurver_tpu_torch/csrc/
fused_render.cu`` with parts of the backward switched off (by editing a
copy of the source under ``build/k2_bwd_probe/``) and times each with CUDA
events on the K2 operands of the ROI fit (100 epochs, s 2, 4 sources, a
random background, a random cotangent) at n 64 (ROI-100, one slab) with
and without the background channel:

- ``full``: the backward as it is;
- ``no_phase_a``: dA, dB are not computed (their buffers are stale);
- ``no_product``: phase B's tensor-core product of each chunk is skipped;
- ``no_dspec``: the elementwise pass (dspec and, with h, the rows of
  dh_part, reading t_hat, r_hat, pc, ps) is skipped;
- ``no_reductions``: du and dv are not summed;
- ``skeleton``: all four off: what is left is the launch, the loads of G,
  Cxp, Sxp and v, the staging of each chunk's Ayp, Byp and u, the block
  barriers, dv's final write and, with h, the sum of dh_part over epochs.

The variants' outputs are garbage, except for ``full``, which is held to
the plain twin (1e-5 of max|plain| per output). Prints the card line, one
line per variant and one JSON line.
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

from chip_smoke import cuda_ms  # noqa: E402
from lightcurver_tpu_torch.ops import (cuda_build, enforce_fp32,  # noqa: E402
                                       fused_render, fused_render_cuda)
from tools.torch_k2_backward_ab import launcher, load  # noqa: E402
from tools.torch_k2_forward_ab import operands  # noqa: E402

OFF = {
    "phase_a": ("for (int ks = 0; ks < ny; ks += 8) {\n      uint32_t gh[4]",
                "for (int ks = 0; ks < 0; ks += 8) {\n      uint32_t gh[4]"),
    "product": ("for (int ks = 0; ks < ny; ks += 8) {\n        const int ar",
                "for (int ks = 0; ks < 0; ks += 8) {\n        const int ar"),
    "dspec": ("for (int kk = warp; kk < kc; kk += kBwdWarps) {",
              "for (int kk = warp; kk < 0; kk += kBwdWarps) {"),
    "du": ("for (int p = tid; p < KC * cgs * 8; p += kBwdThreads) {",
           "for (int p = tid; p < 0; p += kBwdThreads) {"),
    "dv": ("      for (int kk = 0; kk < kc; ++kk) {\n        const float xr",
           "      for (int kk = 0; kk < 0; ++kk) {\n        const float xr"),
}
VARIANTS = {
    "full": (),
    "no_phase_a": ("phase_a",),
    "no_product": ("product",),
    "no_dspec": ("dspec",),
    "no_reductions": ("du", "dv"),
    "skeleton": ("phase_a", "product", "dspec", "du", "dv"),
}


def variant_source(source, off):
    for name in off:
        old, new = OFF[name]
        if source.count(old) != 1:
            raise RuntimeError(f"the source has changed: no single {old!r}")
        source = source.replace(old, new)
    return source


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
    out = ROOT / "build" / "k2_bwd_probe"
    out.mkdir(parents=True, exist_ok=True)
    source = fused_render_cuda.SOURCE.read_text()
    paths = []
    for name, off in VARIANTS.items():
        path = out / f"{name}.cu"
        path.write_text(variant_source(source, off))
        paths.append(path)
    with ThreadPoolExecutor(len(paths)) as pool:   # one nvcc each
        list(pool.map(cuda_build.build, paths))
    libs = {name: load(path, False) for name, path in zip(VARIANTS, paths)}
    ops = operands(64)
    g = torch.randn(100, 64, 64,
                    generator=torch.Generator().manual_seed(64)).cuda()
    bwd_ops = (*ops[:8], *ops[10:])
    results = []
    for name, lib in libs.items():
        row = {"variant": name}
        for include_h in (True, False):
            run, outs = launcher(lib, False, bwd_ops, g, include_h)
            run()
            torch.cuda.synchronize()
            if name == "full":
                wants = fused_render.render_backward_plain(
                    g, *bwd_ops, include_h=include_h)
                for got, want in zip(outs, wants):
                    if want is None:
                        continue
                    err = ((got - want).abs().max()
                           / want.abs().max()).item()
                    if err > 1e-5:
                        print(f"FAIL: full h={include_h}: {err:.2e}",
                              flush=True)
                        return 1
            row["h_us" if include_h else "no_h_us"] = \
                cuda_ms(run, args.reps) * 1e3
        results.append(row)
        print(f"{name:14s} with h {row['h_us']:8.1f} us, without "
              f"{row['no_h_us']:8.1f} us", flush=True)
    print(json.dumps({"card": card, "k2_backward_probe": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
