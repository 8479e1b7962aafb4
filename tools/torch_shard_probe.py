#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone, with the rounding floors behind
its comparisons; or its 14b on one rank per card.

    python3 tools/torch_shard_probe.py
    python3 tools/torch_shard_probe.py --ranks 4     # on four cards

Builds both kernels and measures the rounding floor of ROI-100 (matmul):
the unsharded fit of the scene and of its data times (1 + 1e-7), max and
median |dmag|, at phase 5's noise (0.3) and at 0.03, at the shipped
recipe, at 14b's budget (100 + 1000 iterations) and at 50 + 300; then,
at 14b's noise and budget, the same over ``ULP_SEEDS`` changes of the
data that move each pixel one ulp up or down at random. Then runs 14a (the sharded path at world 1 over NCCL, against phase 5b's
fit) and 14b (two ranks on the card over gloo, ``mesh="auto"``, against
the unsharded fits), with the gates of ``chip_smoke.py``, which print the
PSF-16 fit's own floor. Each line carries the card's ``nvidia-smi`` name
and power limit. Needs a CUDA card; about six minutes.

With ``--ranks N`` (N cards, one rank each over NCCL) it runs 14b's four
fits on N ranks against the unsharded fits on one card, with 14b's
gates, and nothing else.
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


def one_ulp(np, data, seed):
    """``data`` (float32) with each pixel moved one ulp up or down at
    random."""
    up = np.random.default_rng(seed).random(data.shape) < 0.5
    toward = np.where(up, np.float32(np.inf), np.float32(-np.inf))
    return np.nextafter(data, toward.astype(data.dtype))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=None,
                        help="run 14b alone on this many cards")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", flush=True)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as c
    from lightcurver_tpu_torch.ops import (cuda_build, enforce_fp32,
                                           fused_render_cuda, starlet_cuda)
    from lightcurver_tpu_torch.processes.roi_modelling import (ROI_CONFIG,
                                                               fit_roi)
    from lightcurver_tpu_torch.utilities.synthetic import make_roi_scene

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
    work = HERE / "build" / "chip_smoke" / "shard"
    if args.ranks is not None:
        reports, wall = c.run_shard_ranks(work, args.ranks)
        c.check_shard_ranks(np, torch, counters, work, reports, wall, card)
        print(f"phase 14b passed on {args.ranks} ranks", flush=True)
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
    c.phase_shard_one(np, torch, fit_roi, scene,
                      fits[0.3, "the shipped recipe"], counters, card)
    c.phase_shard_two(np, torch, counters, work, card)
    print("phase 14 passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
