#!/usr/bin/env python3
"""Where the K2 forward's time goes, on one CUDA card.

    python3 tools/torch_k2_forward_probe.py [--split 12/8 8/8]

Compiles variants of the checkout's ``lightcurver_tpu_torch/csrc/
fused_render.cu`` with parts of the forward switched off (by editing a
copy of the source under ``build/k2_probe/``) and times each with CUDA
events on the K2 operands of the ROI fit (100 epochs, s 2, 4 sources, a
random background, with the background channel) at n 64 (ROI-100, 64 rows
per block) and n 32 (the production stamp, 32 rows per block):

- ``full``: the kernel as it is;
- ``no_stage2``: stage 1 alone (the output is not written);
- ``stage1_build_only``: the building warps work, the tensor cores idle;
- ``stage1_mma_only``: the tensor cores work on stale X, nobody builds;
- ``skeleton``: neither: what is left is the launch, v, the cp.async
  traffic of the raw chunks and the barriers.

``--split`` times other divisions of the warps between the tensor cores
and the building (``MMA/BUILD``, default 12/8 as shipped; MMA a multiple
of 4). The variants' outputs are garbage, except for ``full``, which is
held to the plain twin (1e-5 max|plain|).
Prints the card line, one line per variant and one JSON line.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lightcurver_tpu_torch.ops import (cuda_build, enforce_fp32,  # noqa: E402
                                       fused_render, fused_render_cuda)
from tools.torch_k2_forward_ab import cuda_ms, operands  # noqa: E402

OFF = {
    "build": ("for (int kk = bw; kk < kc; kk += kBuildWarps) {",
              "for (int kk = bw; kk < 0; kk += kBuildWarps) {"),
    "mma": ("for (int ks = 0; ks < kc; ks += 8) {",
            "for (int ks = 0; ks < 0; ks += 8) {"),
    "stage2": ("for (int x0 = 0; x0 < n; x0 += kPassCols) {",
               "for (int x0 = 0; x0 < 0; x0 += kPassCols) {"),
}
VARIANTS = {
    "full": (),
    "no_stage2": ("stage2",),
    "stage1_build_only": ("mma", "stage2"),
    "stage1_mma_only": ("build", "stage2"),
    "skeleton": ("build", "mma", "stage2"),
}


def variant_source(source, off, split):
    mma, build = split
    edits = [OFF[name] for name in off]
    for old, new in edits:
        if old not in source:
            raise RuntimeError(f"the source has changed: no {old!r}")
        source = source.replace(old, new)
    return re.sub(r"kMmaWarps = \d+;\nconstexpr int kBuildWarps = \d+;",
                  f"kMmaWarps = {mma};\nconstexpr int kBuildWarps = {build};",
                  source)


def build(source, tag):
    out = ROOT / "build" / "k2_probe"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{tag}.cu"
    cu.write_text(source)
    so = out / f"lib{tag}.so"
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True,
                          check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {tag}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.k2_forward.argtypes = [ptr] * 15 + [i32] * 6 + [ptr]
    lib.k2_forward.restype = i32
    return lib


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--split", nargs="+", default=["12/8"])
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
    cases = {n_pix: operands(n_pix) for n_pix in (64, 32)}
    plain = {n_pix: fused_render.render_plain(*ops)
             for n_pix, ops in cases.items()}
    source = fused_render_cuda.SOURCE.read_text()
    results = []
    for split in args.split:
        mma, build_warps = (int(x) for x in split.split("/"))
        for name, off in VARIANTS.items():
            tag = f"{name}_{mma}_{build_warps}"
            lib = build(variant_source(source, off, (mma, build_warps)), tag)
            row = {"split": split, "variant": name}
            for n_pix, ops in cases.items():
                out = torch.zeros_like(plain[n_pix])
                N, C, L = ops[0].shape
                args_c = [x.data_ptr() for x in ops] + [out.data_ptr()]

                def run():
                    rc = lib.k2_forward(*args_c, N, C, L, L // 2 + 1, n_pix,
                                        1, torch.cuda.current_stream()
                                        .cuda_stream)
                    if rc:
                        raise RuntimeError(f"{tag} failed ({rc})")

                run()
                torch.cuda.synchronize()
                if name == "full":
                    ref = plain[n_pix]
                    err = ((out - ref).abs().max() / ref.abs().max()).item()
                    if err > 1e-5:
                        print(f"FAIL: {tag} n={n_pix}: {err:.2e}", flush=True)
                        return 1
                row[f"n{n_pix}_us"] = cuda_ms(run, args.reps) * 1e3
            results.append(row)
            print(f"{split:5s} {name:18s} n64 {row['n64_us']:8.1f} us, "
                  f"n32 {row['n32_us']:8.1f} us", flush=True)
    print(json.dumps({"card": card, "k2_forward_probe": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
