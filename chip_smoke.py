#!/usr/bin/env python3
"""Drive the PyTorch port (lightcurver_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero and
prints no result:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of both CUDA sources of ``lightcurver_tpu_torch/csrc``
   (starlet K1 and fused render K2; one ``nvcc`` each, started together,
   into ``build/lightcurver_tpu_torch/``), with their times and the
   ``-Xptxas -v`` register and spill lines;
3. each K1 kernel against its plain PyTorch twin on the card at the main
   path's shapes (m in {64, 128}, batch in {1, 500}) and at m 256 (past
   one block's shared memory) and m 62 (an odd stamp at s = 2), batch 1,
   held to max|diff| <= 1e-5 max|input|, and timed beside the twin, with
   the cluster size C that the wrapper chose for each shape (the kernel's
   time from a CUDA graph of its calls, and in a loop of calls, which at
   batch 1 also times the host's cost of issuing them);
3b. K2 forward (with and without the background channel) and backward
   against their plain twins on the card, at ROI-100 (100 epochs, n 64),
   the production stamp (100 epochs, n 32) and an odd stamp (n 31, whose
   k axis the wrapper pads from 124 to 128), held to
   max|diff| <= 1e-5 max|plain| per output (3xTF32 products keep float32
   accuracy, plain TF32 would miss by ~3e-4), timed beside the twins,
   with their TFLOP/s and share of their bounds, and the backward's
   slabs, launches per call and scratch bytes;
4. a small scene (16 epochs, 32 px, s = 2, 4 sources, noise 0.03):
   ``fit_roi`` on the card through the kernels against ``fit_roi`` on the
   CPU through the plain twins, at the shipped recipe: fluxes within
   1 mmag, reduced chi2 within 1 %;
4b. the same on the matmul-DFT render (``irfft_backend="matmul"``), whose
   loss evaluations run through K2 on the card;
5. the ROI-100 scene (100 epochs, 64 px, s = 2, 4 sources) through
   ``fit_roi`` at the shipped recipe (300 L-BFGS + 2000 AdaBelief
   iterations, 500 noise samples): wall time, K1 launches (at least
   2000 forward and 2000 adjoint), finite fluxes and errors, and a mean
   reduced chi2 in [0.9, 1.1];
5b. ROI-100 again on ``irfft_backend="matmul"``: wall time, K2 launches
   per stage (stage 2, with the background: at least 2000 forward and
   2000 backward; stage 1: more than none of each), K1 launches, the
   same bars, and the flux differences to phase 5's fit, whose median
   must stay within 0.15 mmag (a 0.15 % reduced-precision systematic
   would be ~1.6 mmag).

Then one JSON line on the kernels, each with its bound (the larger of
its bytes over the card's memory rate and its operations over the peak
rate of the units that can run them, from the shapes of this run) and,
last, the device line. There is no CPU path: without a card the script
fails.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
TOL = 1e-5
K2_TOL = 1e-5       # 3xTF32 forward and backward: float32 accuracy
DMAG_MATMUL_MAX = 0.15e-3   # median |dmag| of the matmul vs the fft fit

# Published H100 SXM peaks (NVIDIA's data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12        # CUDA cores
TF32_FLOPS = 495e12       # tensor cores, dense


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


def graph_ms(fn, reps):
    """Mean device time of ``fn``: ``reps`` calls captured in one CUDA graph
    and replayed between two CUDA events, after a warm-up on a side stream.
    A loop of launches shorter than the host's cost of issuing them times
    the host; the replay does not."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes, ops):
    """(bound_ms, bound_by): the larger of ``n_bytes`` over the memory rate
    and the time of ``ops``, pairs (FLOPs, peak rate) of units that run
    side by side, so the slowest of them."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(flops / rate for flops, rate in ops)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k1_bound(m, batch, n_scales):
    """K1 forward or adjoint: one plane in, n_scales + 1 out (or back);
    per level two 5-tap passes and a difference, 21 FLOPs a pixel."""
    return bound(4 * batch * m * m * (n_scales + 2),
                 [(21 * n_scales * batch * m * m, FP32_FLOPS)])


def k2_work(ops, backward, include_h):
    """Bytes (each operand read once, each result written once) and
    FLOPs of K2 at the shapes of ``ops``: ``(bytes, products, rest)``,
    the products being those the tensor cores can take (the two DFT
    stages), the rest the spectrum and the elementwise terms."""
    u_re, v, ayp = ops[0], ops[2], ops[10]
    N, C, L = u_re.shape
    Lh, n = v.shape[-1], ayp.shape[0]
    plane = L * Lh
    consts = (3 + 2 * (not backward)) if include_h else 1
    floats = (2 * N * C * L + N * C * Lh + 2 * N * plane + consts * plane
              + 2 * n * L + 2 * Lh * n + N * n * n)
    if backward:   # du, dv and dh out
        floats += 2 * N * C * L + N * C * Lh + 2 * plane * include_h
    products = 2 * N * (4 * n * plane + 2 * n * n * Lh)
    rank1 = (2 if backward else 1) * 2 * N * 2 * C * plane
    rest = rank1 + N * plane * (8 + 14 * include_h)
    return 4 * floats, products, rest


def k2_bounds(ops, backward, include_h):
    """(bound_ms, bound_by) with the products on the tensor cores in
    3xTF32, and the fp32 bound with everything on the CUDA cores."""
    n_bytes, products, rest = k2_work(ops, backward, include_h)
    tensor = bound(n_bytes, [(3 * products, TF32_FLOPS), (rest, FP32_FLOPS)])
    fp32 = bound(n_bytes, [(products + rest, FP32_FLOPS)])
    return tensor, fp32, products + rest


def phase_kernels(torch, starlet_cuda, plain):
    """Kernel vs plain twin on the card; returns the kernels' records."""
    gen = torch.Generator().manual_seed(0)
    records = {"starlet_forward": {"max_abs_err": 0.0},
               "starlet_adjoint": {"max_abs_err": 0.0}}
    for m, batch in ((64, 1), (64, 500), (128, 1), (128, 500), (256, 1),
                     (62, 1)):
        n_scales = plain.n_starlet_scales(m)
        cluster = starlet_cuda.cluster_for(torch.device("cuda"), m, batch)
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
            loop_ms, plain_ms = cuda_ms(kernel, reps), cuda_ms(twin, reps)
            ms = graph_ms(kernel, reps)
            rec = records[name]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if (m, batch) == (128, 1):
                # the shape of every stage-2 iteration of ROI-100
                bound_ms, bound_by = k1_bound(m, batch, n_scales)
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
            say(3, f"{name} m={m} B={batch} C={cluster}: max|diff| "
                f"{err:.3e} (bound {bound:.3e}); kernel {ms:.4f} ms (CUDA "
                f"graph; {loop_ms:.4f} ms a call in a loop), plain "
                f"{plain_ms:.4f} ms")
    return records


def k2_operands(torch, setup_model, scene, seed):
    """K2's operands as the ROI fit gives them, with a random background,
    and a random output cotangent, on the card."""
    n_epochs, n = scene["data"].shape[0], scene["data"].shape[-1]
    model, kw, *_ = setup_model(scene["data"], scene["sigma_2"],
                                scene["psf"], scene["xs"], scene["ys"],
                                scene["s"], device="cuda")
    gen = torch.Generator().manual_seed(seed)
    h = (0.01 * torch.randn(model.m**2, generator=gen)).cuda()
    a = kw["kwargs_analytic"]["a"].reshape(n_epochs, model.n_sources)
    px, py = model.source_positions(kw)
    ops = model.fused_render_operands(a, px, py, h, model.matmul_consts())
    return ops, torch.randn(n_epochs, n, n, generator=gen).cuda()


def phase_k2(torch, k2_cuda, twin, setup_model, make_roi_scene, card):
    """K2 vs its plain twins on the card; returns the kernels' records."""
    records = {"fused_render_forward": {"max_abs_err": 0.0},
               "fused_render_backward": {"max_abs_err": 0.0}}
    optin = k2_cuda.smem_optin(torch.device("cuda"))
    for n_pix in (64, 32, 31):
        scene = make_roi_scene(n_epochs=100, n_pix=n_pix, s=2, n_sources=4,
                               seed=11)
        ops, g = k2_operands(torch, setup_model, scene, seed=n_pix)
        for include_h in (True, False):
            fwd_ops = ops if include_h else (*ops[:8], None, None,
                                             *ops[10:])
            bwd_ops = (*ops[:8], *ops[10:])
            pairs = (
                ("fused_render_forward",
                 lambda: [k2_cuda.forward(*fwd_ops, include_h=include_h)],
                 lambda: [twin.render_plain(*fwd_ops,
                                            include_h=include_h)]),
                ("fused_render_backward",
                 lambda: k2_cuda.backward(g, *bwd_ops, include_h=include_h),
                 lambda: twin.render_backward_plain(g, *bwd_ops,
                                                    include_h=include_h)),
            )
            for name, kernel, plain in pairs:
                outs = kernel()
                torch.cuda.synchronize()
                err, rel = 0.0, []
                for got, want in zip(outs, plain()):
                    if want is None:
                        continue
                    diff = (got - want).abs().max().item()
                    scale = want.abs().max().item()
                    check(diff <= K2_TOL * scale, f"{name} n={n_pix} "
                          f"h={include_h}: max|diff| {diff:.3e} > "
                          f"{K2_TOL * scale:.3e}")
                    err = max(err, diff)
                    rel.append(f"{diff / scale:.2e}")
                ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 20)
                rec = records[name]
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                backward = name.endswith("backward")
                (bound_ms, bound_by), (fp32_ms, _), flops = k2_bounds(
                    ops, backward, include_h)
                if (n_pix, include_h) == (64, True):
                    # the shape of every stage-2 iteration of ROI-100
                    rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by)
                say("3b", f"{name} N=100 n={n_pix} include_h={include_h}: "
                    f"max|diff| {err:.3e} (/ max|plain| per output: "
                    f"{', '.join(rel)}); kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms; {flops / ms * 1e-9:.2f} TFLOP/s, "
                    f"{fp32_ms / ms:.1%} of the fp32 bound {fp32_ms:.4f} "
                    f"ms, {bound_ms / ms:.1%} of the 3xTF32 bound "
                    f"{bound_ms:.4f} ms ({bound_by}; card {card})")
                if backward:
                    N, C, L = ops[0].shape
                    plan = k2_cuda.backward_plan(
                        N, C, -(-L // k2_cuda.K_STEP) * k2_cuda.K_STEP,
                        ops[2].shape[-1], n_pix, include_h, optin)
                    say("3b", f"fused_render_backward n={n_pix} "
                        f"include_h={include_h}: {plan.n_slabs} slab(s), "
                        f"{plan.launches} launch(es) a call, scratch "
                        f"{plan.scratch_bytes} bytes")
    return records


def fit_scene(fit_roi, config, scene, device, irfft_backend="fft"):
    n = scene["data"].shape[-1]
    n_epochs = scene["data"].shape[0]
    return fit_roi(scene["data"], scene["sigma_2"] ** 0.5, scene["psf"],
                   scene["xs"] + (n - 1) / 2.0, scene["ys"] + (n - 1) / 2.0,
                   scene["s"], scene["fwhm"], 1.0, [0.0] * n_epochs, config,
                   device=device, irfft_backend=irfft_backend)


def card_vs_cpu(np, fit_roi, config, scene, backend, phase):
    """The same fit on the card and on the CPU, held to 1 mmag and 1 %."""
    t0 = time.perf_counter()
    on_card = fit_scene(fit_roi, config, scene, "cuda", backend)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = fit_scene(fit_roi, config, scene, "cpu", backend)
    t_cpu = time.perf_counter() - t0
    dmag = np.abs(2.5 * np.log10(on_card["fluxes"] / on_cpu["fluxes"]))
    dchi2 = np.abs(on_card["reduced_chi2"] / on_cpu["reduced_chi2"] - 1)
    say(phase, f"small scene, {backend}, card vs cpu: max |dmag| "
        f"{dmag.max() * 1e3:.4f} mmag, max |dchi2|/chi2 {dchi2.max():.2e}; "
        f"wall card {t_card:.2f} s, cpu {t_cpu:.2f} s")
    check(dmag.max() <= 1e-3, f"small scene ({backend}): fluxes differ by "
          "> 1 mmag")
    check(dchi2.max() <= 0.01, f"small scene ({backend}): reduced chi2 "
          "differs by > 1 %")


def check_fit(np, out):
    check(np.all(np.isfinite(out["fluxes"]))
          and np.all(np.isfinite(out["flux_errors"])),
          "non-finite fluxes or errors")
    chi2 = float(np.mean(out["reduced_chi2"]))
    check(0.9 <= chi2 <= 1.1, f"mean reduced chi2 {chi2} outside [0.9, 1.1]")
    return chi2


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
    from lightcurver_tpu_torch.core.deconv.model import setup_model
    from lightcurver_tpu_torch.ops import (cuda_build, enforce_fp32,
                                           fused_render, fused_render_cuda,
                                           starlet_cuda)
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

    def timed_build(source):
        t0 = time.perf_counter()
        return cuda_build.build(source), time.perf_counter() - t0

    with ThreadPoolExecutor(2) as pool:
        builds = list(pool.map(timed_build, (starlet_cuda.SOURCE,
                                             fused_render_cuda.SOURCE)))
    for lib, seconds in builds:
        say(2, f"built {lib.relative_to(HERE)} in {seconds:.2f} s")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                say(2, line.strip())

    records = phase_kernels(torch, starlet_cuda, plain)
    records.update(phase_k2(torch, fused_render_cuda, fused_render,
                            setup_model, make_roi_scene, card))

    # noise 0.03, not the default 0.3: at 0.3 the float32 loss pins the
    # faintest epoch's flux only to ~1 mmag (0.02 sigma), so a relative
    # 1e-7 change of the data alone moves it by 1.0 mmag on the CPU and
    # the comparison would measure that, not the device; at 0.03 the
    # same change moves the fluxes by 0.13 mmag at most
    small = make_roi_scene(n_epochs=16, n_pix=32, s=2, n_sources=4, seed=3,
                           noise_sigma=0.03)
    card_vs_cpu(np, fit_roi, ROI_CONFIG, small, "fft", 4)
    card_vs_cpu(np, fit_roi, ROI_CONFIG, small, "matmul", "4b")

    scene = make_roi_scene(n_epochs=100, n_pix=64, s=2, n_sources=4, seed=7)
    torch.cuda.synchronize()
    starlet_cuda.launches.reset()
    t0 = time.perf_counter()
    out = fit_scene(fit_roi, ROI_CONFIG, scene, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_fwd, n_adj = starlet_cuda.launches.forward, starlet_cuda.launches.adjoint
    chi2 = check_fit(np, out)
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

    # 5b: the same scene on the matmul-DFT render, through K2
    k2 = fused_render_cuda.launches
    torch.cuda.synchronize()
    starlet_cuda.launches.reset()
    k2.reset()
    t0 = time.perf_counter()
    out_mm = fit_scene(fit_roi, ROI_CONFIG, scene, "cuda", "matmul")
    torch.cuda.synchronize()
    wall_mm = time.perf_counter() - t0
    # stage 2 (h free) renders with the background channel, stage 1
    # (h fixed) without; nothing else on the path launches K2
    stage2 = (k2.forward_h, k2.backward_h)
    stage1 = (k2.forward - k2.forward_h, k2.backward - k2.backward_h)
    n_fwd_mm = starlet_cuda.launches.forward
    n_adj_mm = starlet_cuda.launches.adjoint
    chi2_mm = check_fit(np, out_mm)
    dmag = np.abs(2.5 * np.log10(out_mm["fluxes"] / out["fluxes"]))
    say("5b", f"ROI-100 fit_roi matmul on the card: {wall_mm:.3f} s wall "
        f"(card {card}); K2 launches stage 1 forward {stage1[0]}, backward "
        f"{stage1[1]}; stage 2 forward {stage2[0]}, backward {stage2[1]}; "
        f"starlet forward {n_fwd_mm}, adjoint {n_adj_mm}; mean reduced chi2 "
        f"{chi2_mm:.4f}")
    say("5b", f"flux vs phase 5 (fft): median |dmag| "
        f"{np.median(dmag) * 1e3:.4f} mmag, max {dmag.max() * 1e3:.4f} mmag")
    check(min(stage2) >= 2000, "stage 2 did not run through K2 every "
          "iteration")
    check(np.median(dmag) <= DMAG_MATMUL_MAX, "matmul fit: median |dmag| "
          f"to the fft fit {np.median(dmag) * 1e3:.4f} mmag > "
          f"{DMAG_MATMUL_MAX * 1e3} mmag")
    check(min(stage1) > 0, "stage 1 did not run through K2")

    csrc = "lightcurver_tpu_torch/csrc/"
    kernels = {
        "starlet_forward": ("starlet.cu",
                            "lightcurver_tpu/ops/starlet_pallas.py:32",
                            n_fwd),
        "starlet_adjoint": ("starlet.cu",
                            "lightcurver_tpu/ops/starlet_op.py:43", n_adj),
        "fused_render_forward": (
            "fused_render.cu",
            "lightcurver_tpu/ops/experimental/fused_render.py:55",
            k2.forward),
        # the JAX kernel's VJP was planned there and never built
        "fused_render_backward": (
            "fused_render.cu",
            "lightcurver_tpu/ops/experimental/fused_render.py:20",
            k2.backward),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": csrc + source,
         "replaces": replaces, "launches": launches,
         "max_abs_err": records[name]["max_abs_err"],
         **{key: records[name][key]
            for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         # no single PyTorch call computes any of the four (a cascade of
         # mirror-padded stencils; a rank-1 spectrum and chained products)
         "library_ms": None}
        for name, (source, replaces, launches) in kernels.items()]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
