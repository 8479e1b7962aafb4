#!/usr/bin/env python3
"""Device busy share of the fits with their optimizer loops captured and
eager, on a CUDA card.

    python3 tools/torch_loop_profile.py [--cells roi-fft ...]

Each cell is one fit of the port at a cut budget: ROI-100
(``fit_roi``, 100 epochs, 64 px, s 2, 4 sources, 30 + 300 iterations),
PSF-16 (``build_psf_batched``, 16 frames of 8 stars, 64 px, 20 + 300;
matmul at ``dft_pad`` 16) and STAR-32 (``fit_stars_batched``, 32 stars x
100 epochs, 24 px, 300 iterations) at the shipped flags on cuFFT and with
the starlet background on matmul. Each fit runs with its loops as CUDA
graphs (``core/optimize.py::StepLoop``, the default) and with the same
steps called eagerly, each once to warm up and then timed (host clock,
synchronised) in the order graph, eager, eager, graph; then once more
eagerly inside a ``torch.profiler`` window, which gives the device time
of the fit's kernels. Both drivers run the same kernels, so that device
time over each driver's best wall is its busy share. The window holds an
eager fit only, so that no graph is captured under the profiler's
tracing.

Prints the card line (``nvidia-smi``), then one JSON object a cell. It
needs a card: without one it fails.
"""

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CELLS = ("roi-fft", "roi-matmul", "psf-fft", "psf-matmul",
         "star-shipped-fft", "star-starlet-matmul")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cells", nargs="+", default=list(CELLS),
                        choices=CELLS)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", flush=True)
        return 1
    sys.path.insert(0, str(REPO))
    from lightcurver_tpu_torch.core import optimize
    from lightcurver_tpu_torch.core.deconv.batched import fit_stars_batched
    from lightcurver_tpu_torch.core.psf.batched import (build_psf_batched,
                                                        clear_plans)
    from lightcurver_tpu_torch.ops import (cuda_build, enforce_fp32,
                                           fused_render_cuda, starlet_cuda)
    from lightcurver_tpu_torch.processes.roi_modelling import (ROI_CONFIG,
                                                               fit_roi)
    from lightcurver_tpu_torch.utilities.synthetic import (
        make_roi_scene, psf_bench_frames, star_photometry_scene)

    enforce_fp32()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(cuda_build.build, (starlet_cuda.SOURCE,
                                         fused_render_cuda.SOURCE)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    roi = make_roi_scene(n_epochs=100, n_pix=64, s=2, n_sources=4, seed=7)
    n = roi["data"].shape[-1]
    roi_args = (roi["data"], roi["sigma_2"] ** 0.5, roi["psf"],
                roi["xs"] + (n - 1) / 2.0, roi["ys"] + (n - 1) / 2.0, 2,
                roi["fwhm"], 1.0, [0.0] * 100,
                {**ROI_CONFIG, "roi_deconv_translations_iters": 30,
                 "roi_deconv_all_iters": 300})
    psf_data, psf_sigma = psf_bench_frames(16, 8, 64)
    stars = star_photometry_scene(32, 100, 24, 2)
    fits = {
        "roi-fft": lambda: fit_roi(*roi_args),
        "roi-matmul": lambda: fit_roi(*roi_args, irfft_backend="matmul"),
        "psf-fft": lambda: build_psf_batched(
            psf_data, psf_sigma, 2, n_iter_analytic=20,
            n_iter_adabelief=300),
        "psf-matmul": lambda: build_psf_batched(
            psf_data, psf_sigma, 2, n_iter_analytic=20,
            n_iter_adabelief=300, irfft_backend="matmul", dft_pad=16),
        "star-shipped-fft": lambda: fit_stars_batched(
            stars["data"], stars["sigma"], stars["psf"], 2, n_iter=300),
        "star-starlet-matmul": lambda: fit_stars_batched(
            stars["data"], stars["sigma"], stars["psf"], 2, n_iter=300,
            starlet_global_background=True, irfft_backend="matmul"),
    }
    base = optimize.StepLoop

    class Eager(base):
        def __init__(self, step, state, *, eager=False):
            super().__init__(step, state, eager=True)

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]

    def run(cell, driver):
        clear_plans()    # a PSF plan would replay the other driver's loops
        optimize.StepLoop = Eager if driver == "eager" else base
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fits[cell]()
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        finally:
            optimize.StepLoop = base

    for cell in args.cells:
        walls = {"graph": [], "eager": []}
        run(cell, "graph")                      # warm-up: plans, kernels
        run(cell, "eager")
        for driver in ("graph", "eager", "eager", "graph"):
            walls[driver].append(run(cell, driver))
        with torch.profiler.profile(activities=activities) as prof:
            run(cell, "eager")
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        device_s = sum(e.self_device_time_total for e in events) * 1e-6
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
        print(json.dumps({
            "cell": cell, "card": card, "walls_s": walls,
            "device_s": device_s,
            "busy_share": {d: device_s / min(w) for d, w in walls.items()},
            "kernel_launches": sum(e.count for e in events),
            "top_kernels_ms": [[e.key[:50], e.self_device_time_total * 1e-3,
                                e.count] for e in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
