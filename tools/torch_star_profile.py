#!/usr/bin/env python3
"""Where the full-width star fit spends its time, on a CUDA card.

    python3 tools/torch_star_profile.py [--cells shipped-fft ...]

The fit is ``lightcurver_tpu_torch.core.deconv.batched.fit_stars_batched``
on one bucket of the JAX package's star bench (32 stars x 100 epochs,
24-px stamps, s = 2; ``bench.py::run_star_photometry_bench``), in four
cells: the shipped flags (h fixed at zero) and a starlet background per
star (``starlet_global_background=True``), each on ``irfft_backend``
"fft" and "matmul". For each cell:

- the wall time of whole fits (host clock, outputs fetched) at two
  budgets, run in the order A B B A: A = 200 AdaBelief iterations, B =
  1200; an iteration costs (B - A) / 1000, and the rest of A is the fixed
  cost (set-up, noise weights, GLS polish and errors, fetch);
- a ``torch.profiler`` window over a 100-iteration fit: the device's
  busy time against the wall time, the kernel launches, the shares of K1
  (``starlet``) and K2 (``k2_``) in the device time, and the kernels that
  take the most device time.

Prints the card line (``nvidia-smi``), then one JSON object a cell. It
needs a card: without one it fails.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CELLS = ("shipped-fft", "shipped-matmul", "starlet-fft", "starlet-matmul")
BUDGETS = {"A": 200, "B": 1200}
ORDER = "ABBA"


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cells", nargs="+", default=list(CELLS),
                        choices=CELLS)
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", flush=True)
        return 1
    sys.path.insert(0, str(REPO))
    from lightcurver_tpu_torch.core.deconv.batched import fit_stars_batched
    from lightcurver_tpu_torch.utilities.synthetic import \
        star_photometry_scene

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    sc = star_photometry_scene(32, 100, 24, 2)

    for cell in args.cells:
        flags, render = cell.split("-")

        def fit(n_iter):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit_stars_batched(sc["data"], sc["sigma"], sc["psf"], 2,
                              n_iter=n_iter,
                              starlet_global_background=flags == "starlet",
                              irfft_backend=render)
            return time.perf_counter() - t0

        fit(5)                                     # warm-up: plans, kernels
        walls = {key: [] for key in BUDGETS}
        for key in ORDER:
            walls[key].append(fit(BUDGETS[key]))
        wall = {key: float(np.mean(v)) for key, v in walls.items()}
        iteration_ms = (wall["B"] - wall["A"]) / 1000 * 1e3
        fixed_s = wall["A"] - BUDGETS["A"] * iteration_ms / 1e3

        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            window = fit(100)
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in events)

        def share(tag):
            return sum(e.self_device_time_total for e in events
                       if tag in e.key) / max(device_us, 1)

        top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
        print(json.dumps({
            "cell": cell, "card": card, "walls_s": walls,
            "iteration_ms": iteration_ms, "fixed_s": fixed_s,
            "profile_window": {
                "n_iter": 100, "wall_s": window,
                "device_s": device_us * 1e-6,
                "busy_share": device_us * 1e-6 / window,
                "kernel_launches": sum(e.count for e in events),
                "k1_device_share": share("starlet"),
                "k2_device_share": share("k2_"),
                "top_kernels_ms": [[e.key[:60],
                                    e.self_device_time_total * 1e-3,
                                    e.count] for e in top]},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
