#!/usr/bin/env python3
"""How far rounding moves the batched PSF fit, and its gradient's floor.

    python3 tools/torch_psf_rounding.py sensitivity [--budgets 200,100 400,1]
    python3 tools/torch_psf_rounding.py gradient [--device cuda]

``sensitivity`` (on the CPU): ``build_psf_batched`` on 3 frames of 4
stars, 24 px, s = 2 (the stamps of ``chip_smoke.py`` phase 6), against
the same fit of the data times ``1 + 1e-7 N(0, 1)`` (three draws), on
each render: the largest relative change of a frame's reduced chi2, of
its full PSF over its peak, and of the pixel phase's first loss.

``gradient``: the pixel-phase loss of 16 frames of 8 stars, 64 px (the
full width) and its gradient at one parameter point (that of
``chip_smoke.py`` phase 6), in float32 on ``--device`` and in float64 on
the CPU: the largest difference of each gradient leaf over its largest
float64 value. The float64 run upcasts the data, the parameters and the
DFT matrices; the grids of the profiles stay float32.

One JSON line per case.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from lightcurver_tpu_torch.core.psf.batched import build_psf_batched  # noqa: E402
from lightcurver_tpu_torch.utilities.synthetic import (  # noqa: E402
    psf_bench_frames, psf_pixel_phase_point)


def sensitivity(budgets):
    data, sigma = psf_bench_frames(3, 4, 24)
    for n_analytic, n_pixels in budgets:
        for render in ("fft", "matmul"):
            kw = dict(n_iter_analytic=n_analytic, n_iter_adabelief=n_pixels,
                      device="cpu", irfft_backend=render,
                      dft_pad=16 if render == "matmul" else None)
            ref = build_psf_batched(data, sigma, 2, **kw)
            worst = np.zeros(3)
            for seed in range(3):
                noise = np.random.default_rng(seed).normal(size=data.shape)
                out = build_psf_batched(
                    data * (1 + 1e-7 * noise).astype(np.float32), sigma, 2,
                    **kw)
                peak = np.abs(ref["full_psf"]).max(axis=(1, 2))
                worst = np.maximum(worst, [
                    np.abs(out["chi2"] / ref["chi2"] - 1).max(),
                    (np.abs(out["full_psf"] - ref["full_psf"]).max(
                        axis=(1, 2)) / peak).max(),
                    np.abs(out["loss_history_pixels"][:, 0]
                           / ref["loss_history_pixels"][:, 0] - 1).max()])
            print(json.dumps({
                "part": "sensitivity", "render": render,
                "budget": [n_analytic, n_pixels], "draws": 3,
                "max_rel_chi2": worst[0], "max_full_over_peak": worst[1],
                "max_rel_first_pixel_loss": worst[2]}), flush=True)


def grads(render, device, dtype):
    loss, free, consts = psf_pixel_phase_point(16, 8, 64, render, device,
                                               dtype)
    leaves = {k: v.requires_grad_(True) for d in free.values()
              for k, v in d.items()}
    loss(free, consts).sum().backward()
    return {k: v.grad.detach().cpu().double() for k, v in leaves.items()}


def gradient(device):
    if device == "cuda":
        from lightcurver_tpu_torch.ops import enforce_fp32

        enforce_fp32()
    for render in ("fft", "matmul"):
        want = grads(render, "cpu", np.float64)
        got = grads(render, device, np.float32)
        print(json.dumps({
            "part": "gradient", "render": render, "device": device,
            "card": torch.cuda.get_device_name(0) if device == "cuda"
            else None,
            "float32_vs_float64_over_max": {
                k: ((got[k] - want[k]).abs().max()
                    / want[k].abs().max()).item() for k in want}}),
            flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("part", choices=["sensitivity", "gradient"])
    parser.add_argument("--budgets", nargs="+", default=["200,100", "400,1"])
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args()
    if args.part == "sensitivity":
        sensitivity([tuple(int(x) for x in b.split(","))
                     for b in args.budgets])
    else:
        gradient(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
