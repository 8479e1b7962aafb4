#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone, with the rounding floors behind
its comparisons; or its 14b on one rank per card.

    python3 tools/torch_shard_probe.py
    python3 tools/torch_shard_probe.py --ranks 4     # on four cards
    python3 tools/torch_shard_probe.py --ranks 4 --fits roi,psf,stars,star1
    python3 tools/torch_shard_probe.py --ranks 4 --fits tasks,broadcast
    python3 tools/torch_shard_probe.py --breakdown   # one card

Builds both kernels and measures the rounding floor of ROI-100 (matmul):
the unsharded fit of the scene and of its data times (1 + 1e-7), max and
median |dmag|, at phase 5's noise (0.3) and at 0.03, at the shipped
recipe, at 14b's budget (100 + 1000 iterations) and at 50 + 300; then,
at 14b's noise and budget, the same over ``ULP_SEEDS`` changes of the
data that move each pixel one ulp up or down at random. Then runs 14a
(the fits under a mesh at world 1 over NCCL, captured, against the
unsharded fits to the bit) and 14b (two ranks on the card over gloo,
``mesh="auto"``, against the unsharded fits), with the gates of
``chip_smoke.py``, which print the PSF-16 fit's own floor. Each line
carries the card's ``nvidia-smi`` name and power limit. Needs a CUDA
card; about six minutes.

With ``--ranks N`` (N cards, one rank each over NCCL) it runs the fits
of ``--fits`` on N ranks against the unsharded fits on one card, with
14b's gates, and nothing else. Every loop of a fit under NCCL replays one
CUDA graph with its all-reduce inside; a name ending in "/eager" runs that
fit with every step called eagerly, and is compared with it to the bit.
The default, ``DEFAULT_FITS``, is "roi1000/eager", "roi1000", "psf",
"stars" and "tasks". "roi1000" is BASELINE.json's config 5, the
1000-epoch ROI of ``chip_smoke.py`` phase 18 at the shipped recipe,
epoch-sharded (matmul, which the ranks force), against the same fit on
one card (fluxes within 1 mmag, reduced chi2 within 1 %, the ranks
bit-equal), with each rank's wall and peak memory and the one-card fit's
rounding floor (its data x (1 + 1e-7)); the eager run goes first, so it
pays the process's first-fit costs (the mesh's import, the communicators)
and the captured run is timed warm. 14b's
fits are "roi", "psf", "stars", "star1" and "tasks" (the fit tasks'
device bodies under the pipeline's rank rule); "broadcast" times
``broadcast_work`` of a config-5 star bucket from rank 0 to every rank.

With ``--breakdown`` (one card) it fits ROI-1000 (matmul) at world 1 over
NCCL unsharded and on an epoch mesh, in turns (unsharded, mesh, mesh,
unsharded), each fit under one ``torch.profiler`` window, and splits each
wall by the program's spans (``utilities/tracing.py``): ``roi.fit``, its
stages (``roi.stage1``, ``roi.noise_weights`` as the host issues it,
``roi.stage2``, ``roi.polish``) and, inside each stage, its loop's
``optimizer.warmup``, ``optimizer.drain`` and ``optimizer.capture``; a
stage's replays are the rest of it. The profiler costs each traced fit
some host time.
"""

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
BUDGETS = {"the shipped recipe": {},
           "100 + 1000 iterations": dict(roi_deconv_translations_iters=100,
                                         roi_deconv_all_iters=1000),
           "50 + 300 iterations": dict(roi_deconv_translations_iters=50,
                                       roi_deconv_all_iters=300)}
ULP_SEEDS = (1, 2, 3, 4)
DEFAULT_FITS = "roi1000/eager,roi1000,psf,stars,tasks"


def one_ulp(np, data, seed):
    """``data`` (float32) with each pixel moved one ulp up or down at
    random."""
    up = np.random.default_rng(seed).random(data.shape) < 0.5
    toward = np.where(up, np.float32(np.inf), np.float32(-np.inf))
    return np.nextafter(data, toward.astype(data.dtype))


def breakdown(torch, c, card):
    """``--breakdown``: ROI-1000 at world 1, unsharded and on an epoch
    mesh, each fit under one profiler window and split by the program's
    spans."""
    from lightcurver_tpu_torch.parallel.distributed import \
        initialize_distributed
    from lightcurver_tpu_torch.parallel.mesh import epoch_mesh
    from lightcurver_tpu_torch.processes import roi_modelling as rm
    from lightcurver_tpu_torch.utilities import tracing
    from lightcurver_tpu_torch.utilities.synthetic import make_roi_scene

    import torch.distributed as dist

    scene = make_roi_scene(n_epochs=c.SURVEY_EPOCHS, n_pix=64, s=2,
                           n_sources=4)
    initialize_distributed(f"localhost:{c.free_port()}", 1, 0)
    try:
        mesh = epoch_mesh()
        for label, m in (("unsharded", None), ("epoch mesh", mesh),
                         ("epoch mesh", mesh), ("unsharded", None)):
            tracing.clear()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                c.fit_scene(rm.fit_roi, rm.ROI_CONFIG, scene, "cuda",
                            "matmul", mesh=m)
            print(f"breakdown, ROI-1000 matmul, world 1 (NCCL), {label}: "
                  f"{stage_walls(tracing.spans())} (card {card})",
                  flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def stage_walls(spans):
    """One fit's spans as text: the fit's wall, each stage's and, inside
    a stage, its loops' warm-up, drain and capture, in s."""
    def wall(span):
        return (span["end_ns"] - span["start_ns"]) * 1e-9

    fit = next(s for s in spans if s["name"] == "roi.fit")
    parts = []
    stages = sorted((s for s in spans if s["parent"] == fit["id"]),
                    key=lambda s: s["start_ns"])
    for stage in stages:
        loops = ", ".join(f"{s['name'].split('.')[1]} {wall(s):.3f}"
                          for s in sorted(spans, key=lambda s: s["start_ns"])
                          if s["parent"] == stage["id"]
                          and s["name"].startswith("optimizer."))
        parts.append(f"{stage['name']} {wall(stage):.3f}"
                     + (f" ({loops})" if loops else ""))
    rest = wall(fit) - sum(wall(s) for s in stages)
    return (f"{wall(fit):.3f} s wall; {'; '.join(parts)}; the rest "
            f"{rest:.3f} s")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=None,
                        help="run 14b alone on this many cards")
    parser.add_argument("--breakdown", action="store_true",
                        help="split ROI-1000's wall at world 1, unsharded "
                             "and on an epoch mesh, and nothing else")
    parser.add_argument("--fits", default=DEFAULT_FITS,
                        help="with --ranks: the fits to shard, comma "
                             f"separated (default: {DEFAULT_FITS})")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", flush=True)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as c
    from lightcurver_tpu_torch.core import optimize
    from lightcurver_tpu_torch.core.deconv.batched import fit_stars_batched
    from lightcurver_tpu_torch.core.psf.batched import build_psf_batched
    from lightcurver_tpu_torch.ops import (cuda_build, enforce_fp32,
                                           fused_render_cuda, starlet_cuda)
    from lightcurver_tpu_torch.processes.roi_modelling import (ROI_CONFIG,
                                                               fit_roi)
    from lightcurver_tpu_torch.utilities.synthetic import (
        make_roi_scene, psf_bench_frames, star_photometry_scene)

    enforce_fp32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, f"torch {torch.__version__}", flush=True)
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(cuda_build.build, (starlet_cuda.SOURCE,
                                         fused_render_cuda.SOURCE)))
    counters = c.launch_counters(starlet_cuda, fused_render_cuda.launches)
    # NCCL bootstraps over this host's loopback: one host
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if args.breakdown:
        return breakdown(torch, c, card)
    work = HERE / "build" / "chip_smoke" / "shard"
    if args.ranks is not None:
        names = tuple(args.fits.split(","))
        reports, wall = c.run_shard_ranks(work, args.ranks, names)
        c.check_shard_ranks(np, torch, counters, work, reports, wall, card,
                            names)
        print(f"phase 14b ({', '.join(names)}) passed on {args.ranks} "
              "ranks", flush=True)
        return 0

    fits = {}
    for noise in (0.3, 0.03):
        scene = make_roi_scene(n_epochs=100, n_pix=64, s=2, n_sources=4,
                               seed=7, noise_sigma=noise)
        bumped = dict(scene, data=scene["data"] * np.float32(1 + 1e-7))
        for label, budget in BUDGETS.items():
            config = {**ROI_CONFIG, **budget}
            a, b = (c.fit_scene(fit_roi, config, sc, "cuda", "matmul")
                    for sc in (scene, bumped))
            fits[noise, label] = a
            dmag = np.abs(2.5 * np.log10(a["fluxes"] / b["fluxes"]))
            print(f"rounding floor, ROI-100 matmul at noise {noise}, "
                  f"{label}, unsharded, data x (1 + 1e-7): max |dmag| "
                  f"{dmag.max() * 1e3:.4f} mmag, median "
                  f"{np.median(dmag) * 1e3:.4f} mmag (card {card})",
                  flush=True)

    scene = make_roi_scene(n_epochs=100, n_pix=64, s=2, n_sources=4, seed=7)
    ref = fits[0.3, "100 + 1000 iterations"]     # 14b's budget
    worst, medians = 0.0, []
    for seed in ULP_SEEDS:
        moved = dict(scene, data=one_ulp(np, scene["data"], seed))
        b = c.fit_scene(fit_roi, {**ROI_CONFIG, **c.SHARD_ROI_BUDGET}, moved,
                        "cuda", "matmul")
        dmag = np.abs(2.5 * np.log10(ref["fluxes"] / b["fluxes"]))
        worst = max(worst, float(dmag.max()))
        medians.append(float(np.median(dmag)))
        print(f"rounding floor, ROI-100 matmul at noise 0.3, 14b's budget, "
              f"unsharded, one ulp a pixel (seed {seed}): max |dmag| "
              f"{dmag.max() * 1e3:.4f} mmag, median "
              f"{np.median(dmag) * 1e3:.4f} mmag (card {card})", flush=True)
    print(f"rounding floor over {len(ULP_SEEDS)} one-ulp changes: max |dmag| "
          f"{worst * 1e3:.4f} mmag, median of the medians "
          f"{np.median(medians) * 1e3:.4f} mmag (card {card})", flush=True)
    c.phase_shard_one(np, torch, optimize,
                      (fit_roi, build_psf_batched, fit_stars_batched),
                      (scene, psf_bench_frames(16, 8, 64),
                       star_photometry_scene(32, 100, 24, 2)),
                      None, counters, card)
    c.phase_shard_two(np, torch, counters, work, card)
    print("phase 14 passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
