#!/usr/bin/env python3
"""Where the full-width batched PSF fit spends its time, on a CUDA card.

    python3 tools/torch_psf_profile.py [--renders fft matmul]

The fit is ``lightcurver_tpu_torch.core.psf.batched.build_psf_batched``
on the frames of the JAX package's PSF bench (16 frames of 8 stars,
64-px stamps, s = 2; ``bench.py::run_psf_bench``), ``irfft_backend``
"fft", or "matmul" at ``dft_pad`` 16. For each render:

- the wall time of whole fits (host clock, outputs fetched) at three
  budgets, run twice in the order A B C C B A: A = (100 L-BFGS, 300
  AdaBelief), B = (100, 1300), C = (20, 300); a pixel-phase iteration
  costs (B - A) / 1000, a Moffat iteration (A - C) / 80, and the rest of
  A is the fixed cost (set-up, noise weights, final render, fetch);
- a ``torch.profiler`` window over a (10, 100) fit: the device's busy
  time against the wall time, the kernel launches, K1's share, and the
  kernels that take the most device time.

Prints the card line (``nvidia-smi``), then one JSON object a render. It
needs a card: without one it fails.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BUDGETS = {"A": (100, 300), "B": (100, 1300), "C": (20, 300)}
ORDER = "ABCCBA"


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--renders", nargs="+", default=["fft", "matmul"],
                        choices=["fft", "matmul"])
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", flush=True)
        return 1
    sys.path.insert(0, str(REPO))
    from lightcurver_tpu_torch.core.psf.batched import build_psf_batched
    from lightcurver_tpu_torch.utilities.synthetic import psf_bench_frames

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    data, sigma = psf_bench_frames(16, 8, 64)

    for render in args.renders:
        pad = 16 if render == "matmul" else None

        def fit(n_analytic, n_pixels):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            build_psf_batched(data, sigma, 2, n_iter_analytic=n_analytic,
                              n_iter_adabelief=n_pixels, device="cuda",
                              irfft_backend=render, dft_pad=pad)
            return time.perf_counter() - t0

        fit(5, 5)                                  # warm-up: plans, kernels
        walls = {key: [] for key in BUDGETS}
        for key in ORDER:
            walls[key].append(fit(*BUDGETS[key]))
        wall = {key: float(np.mean(v)) for key, v in walls.items()}
        pixel_ms = (wall["B"] - wall["A"]) / 1000 * 1e3
        moffat_ms = (wall["A"] - wall["C"]) / 80 * 1e3
        fixed_s = wall["A"] - (100 * moffat_ms + 300 * pixel_ms) / 1e3

        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            window = fit(10, 100)
        # the kernels themselves (the ops that launch them carry the same
        # device time again)
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in events)
        launches = sum(e.count for e in events)
        k1_us = sum(e.self_device_time_total for e in events
                    if "starlet" in e.key)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
        print(json.dumps({
            "render": render, "card": card,
            "walls_s": walls, "pixel_iteration_ms": pixel_ms,
            "moffat_iteration_ms": moffat_ms, "fixed_s": fixed_s,
            "profile_window": {
                "budget": [10, 100], "wall_s": window,
                "device_s": device_us * 1e-6,
                "busy_share": device_us * 1e-6 / window,
                "kernel_launches": launches,
                "k1_device_share": k1_us / max(device_us, 1),
                "top_kernels_ms": [[e.key[:60],
                                    e.self_device_time_total * 1e-3,
                                    e.count] for e in top]},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
