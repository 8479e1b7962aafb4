#!/usr/bin/env python3
"""Drive the PyTorch port (lightcurver_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero and
prints no result:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of the CUDA starlet kernels from ``lightcurver_tpu_torch/csrc``
   (into ``build/lightcurver_tpu_torch/``), with its time;
3. each kernel against its plain PyTorch twin on the card at the main
   path's shapes (m in {64, 128}, batch in {1, 500}), held to
   max|diff| <= 1e-5 max|input|, and timed beside the twin;
4. a small scene (16 epochs, 32 px, s = 2, 4 sources, noise 0.03):
   ``fit_roi`` on the card through the kernels against ``fit_roi`` on the
   CPU through the plain twins, at the shipped recipe: fluxes within
   1 mmag, reduced chi2 within 1 %;
5. the ROI-100 scene (100 epochs, 64 px, s = 2, 4 sources) through
   ``fit_roi`` at the shipped recipe (300 L-BFGS + 2000 AdaBelief
   iterations, 500 noise samples): wall time, kernel launches (at least
   2000 forward and 2000 adjoint), finite fluxes and errors, and a mean
   reduced chi2 in [0.9, 1.1].

Then one JSON line on the kernels and, last, the device line. There is
no CPU path: without a card the script fails.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
TOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(ok, message):
    if not ok:
        raise SmokeFailure(message)


def say(phase, message):
    print(f"[{phase}] {message}", flush=True)


def cuda_ms(fn, reps):
    """Mean time of ``fn`` on the card, from CUDA events, after warm-up."""
    import torch

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


def phase_kernels(torch, starlet_cuda, plain):
    """Kernel vs plain twin on the card; returns the kernels' records."""
    gen = torch.Generator().manual_seed(0)
    records = {"starlet_forward": {"max_abs_err": 0.0},
               "starlet_adjoint": {"max_abs_err": 0.0}}
    for m in (64, 128):
        n_scales = plain.n_starlet_scales(m)
        for batch in (1, 500):
            x = torch.randn(batch, m, m, generator=gen).cuda()
            g = torch.randn(batch, n_scales + 1, m, m, generator=gen).cuda()
            pairs = (
                ("starlet_forward", x,
                 lambda: starlet_cuda.starlet_forward(x),
                 lambda: plain.starlet_transform(x)),
                ("starlet_adjoint", g,
                 lambda: starlet_cuda.starlet_adjoint(g),
                 lambda: plain.starlet_adjoint(g)),
            )
            for name, inp, kernel, twin in pairs:
                out = kernel()
                torch.cuda.synchronize()
                err = (out - twin()).abs().max().item()
                bound = TOL * inp.abs().max().item()
                check(err <= bound, f"{name} m={m} B={batch}: max|diff| "
                      f"{err:.3e} > {bound:.3e}")
                reps = 200 if batch == 1 else 20
                ms, plain_ms = cuda_ms(kernel, reps), cuda_ms(twin, reps)
                rec = records[name]
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                if (m, batch) == (128, 1):
                    # the shape of every stage-2 iteration of ROI-100
                    rec.update(ms=ms, plain_ms=plain_ms)
                say(3, f"{name} m={m} B={batch}: max|diff| {err:.3e} "
                    f"(bound {bound:.3e}); kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms")
    return records


def fit_scene(fit_roi, config, scene, device):
    n = scene["data"].shape[-1]
    n_epochs = scene["data"].shape[0]
    return fit_roi(scene["data"], scene["sigma_2"] ** 0.5, scene["psf"],
                   scene["xs"] + (n - 1) / 2.0, scene["ys"] + (n - 1) / 2.0,
                   scene["s"], scene["fwhm"], 1.0, [0.0] * n_epochs, config,
                   device=device)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: chip_smoke.py "
              "needs a CUDA card", flush=True)
        return 1

    # the port must come from this checkout, never from elsewhere
    sys.path.insert(0, str(HERE))
    import lightcurver_tpu_torch

    check(Path(lightcurver_tpu_torch.__file__).resolve().parent.parent
          == HERE, "lightcurver_tpu_torch does not come from this checkout")
    from lightcurver_tpu_torch.core import starlet as plain
    from lightcurver_tpu_torch.ops import enforce_fp32, starlet_cuda
    from lightcurver_tpu_torch.processes.roi_modelling import (ROI_CONFIG,
                                                               fit_roi)
    from lightcurver_tpu_torch.utilities.synthetic import make_roi_scene

    enforce_fp32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    say(1, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib = starlet_cuda.build()
    say(2, f"built {lib.relative_to(HERE)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            say(2, line.strip())

    records = phase_kernels(torch, starlet_cuda, plain)

    # noise 0.03, not the default 0.3: at 0.3 the float32 loss pins the
    # faintest epoch's flux only to ~1 mmag (0.02 sigma), so a relative
    # 1e-7 change of the data alone moves it by 1.0 mmag on the CPU and
    # the comparison would measure that, not the device; at 0.03 the
    # same change moves the fluxes by 0.13 mmag at most
    small = make_roi_scene(n_epochs=16, n_pix=32, s=2, n_sources=4, seed=3,
                           noise_sigma=0.03)
    t0 = time.perf_counter()
    on_card = fit_scene(fit_roi, ROI_CONFIG, small, "cuda")
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = fit_scene(fit_roi, ROI_CONFIG, small, "cpu")
    t_cpu = time.perf_counter() - t0
    dmag = np.abs(2.5 * np.log10(on_card["fluxes"] / on_cpu["fluxes"]))
    dchi2 = np.abs(on_card["reduced_chi2"] / on_cpu["reduced_chi2"] - 1)
    say(4, f"small scene card vs cpu: max |dmag| {dmag.max() * 1e3:.4f} "
        f"mmag, max |dchi2|/chi2 {dchi2.max():.2e}; wall card "
        f"{t_card:.2f} s, cpu {t_cpu:.2f} s")
    check(dmag.max() <= 1e-3, "small scene: fluxes differ by > 1 mmag")
    check(dchi2.max() <= 0.01, "small scene: reduced chi2 differs by > 1 %")

    scene = make_roi_scene(n_epochs=100, n_pix=64, s=2, n_sources=4, seed=7)
    torch.cuda.synchronize()
    starlet_cuda.launches.reset()
    t0 = time.perf_counter()
    out = fit_scene(fit_roi, ROI_CONFIG, scene, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_fwd, n_adj = starlet_cuda.launches.forward, starlet_cuda.launches.adjoint
    chi2 = float(np.mean(out["reduced_chi2"]))
    rel = out["fluxes"] / scene["a_true"] - 1
    pull = (out["fluxes"] - scene["a_true"]) / out["flux_errors"]
    say(5, f"ROI-100 fit_roi on the card: {wall:.3f} s wall (card {card}); "
        f"starlet launches forward {n_fwd}, adjoint {n_adj}; mean reduced "
        f"chi2 {chi2:.4f}")
    say(5, f"flux vs a_true: median |dmag| "
        f"{np.median(np.abs(2.5 * np.log10(1 + rel))) * 1e3:.3f} mmag, "
        f"max |rel| {np.abs(rel).max():.4f}, pull rms "
        f"{np.sqrt(np.mean(pull**2)):.3f}")
    check(n_fwd >= 2000 and n_adj >= 2000,
          "the fit did not run through the starlet kernels")
    check(np.all(np.isfinite(out["fluxes"]))
          and np.all(np.isfinite(out["flux_errors"])),
          "non-finite fluxes or errors")
    check(0.9 <= chi2 <= 1.1, f"mean reduced chi2 {chi2} outside [0.9, 1.1]")

    source = "lightcurver_tpu_torch/csrc/starlet.cu"
    replaces = {
        "starlet_forward": "lightcurver_tpu/ops/starlet_pallas.py:32",
        "starlet_adjoint": "lightcurver_tpu/ops/starlet_op.py:43",
    }
    launches = {"starlet_forward": n_fwd, "starlet_adjoint": n_adj}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
         "plain_ms": rec["plain_ms"]} for name, rec in records.items()]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
