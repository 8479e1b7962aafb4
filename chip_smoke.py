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
3c. K1 forward and adjoint at the PSF fit's shape, a batch of 16 frames of
   m 128 (the wrapper's C: 8), against the twin and timed as in phase 3;
3d. the star photometry's shapes: K2 forward and backward with a per-star
   background (G = 32 groups of 100 epochs, n 24, L 96: 3200 render
   epochs) against the plain twins at phase 3b's bar and timed beside
   their bounds (which count G background planes); the same at phase
   15a's single star (one shared background plane (L, Lh), 100 epochs,
   n 24); K2 with one group against the shared plane, to the bit; K1 at
   (m 48, batch 32), the l1 term of 32 stars, (48, 6400), their noise
   weights, (48, 1), the single star's l1 term, and (48, 200), its noise
   weights, against the twin and timed as in phase 3;
4. a small scene (16 epochs, 32 px, s = 2, 4 sources, noise 0.03):
   ``fit_roi`` on the card through the kernels against ``fit_roi`` on the
   CPU through the plain twins, at 100 + 1000 iterations
   (``SMALL_ROI_BUDGET``): fluxes within 1 mmag, reduced chi2 within 1 %;
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
   would be ~1.6 mmag);
6. the frame-batched PSF fit's pixel-phase loss and its gradient at full
   width (16 frames of 8 stars, 64 px, s = 2) at one parameter point, on
   the card (one K1 launch each way) against the CPU (1e-5 of the loss,
   1e-4 of max|grad|), then a small ``build_psf_batched`` (3 frames of 4
   stars, 24 px) on the card against the same fit on the CPU: reduced chi2
   within 1 %, full PSF within 1e-2 of its peak, and the pixel phase's
   first loss within 1e-4, after a converged Moffat phase (400 L-BFGS
   iterations; ``SMALL_PSF_BUDGET`` says why); 6b the same on
   ``irfft_backend="matmul"`` at ``dft_pad`` 16;
7. the full-width ``build_psf_batched`` (16 frames of 8 stars, 64 px,
   s = 2, 100 L-BFGS + 3000 AdaBelief iterations; the stamps of the JAX
   package's ``bench.py::run_psf_bench``) on cuFFT: wall time and PSF
   fits/s, K1 launches (at least 3000 each way), finite PSFs and a mean
   reduced chi2 in [0.5, 1.0]; 7b the same on the matmul render at
   ``dft_pad`` 16, the production default;
8. a small star fit (3 stars with 6, 5 and 4 real epochs padded to 6,
   16 px, s = 2, 60 AdaBelief iterations, a starlet background per star)
   through ``fit_stars_batched`` on the card against the CPU, fluxes within
   1 mmag and chi2 within 1 %, with the card run's K1 and K2 launches
   (exactly 61 forward and 60 adjoint K1; 60 each way of K2 on matmul,
   none on fft); 8b the same on ``irfft_backend="matmul"``;
9. the full-width star fit (one bucket of 32 stars x 100 epochs, 24 px,
   s = 2, 2000 AdaBelief iterations; the stamps of the JAX package's
   ``bench.py::run_star_photometry_bench``) at the shipped flags on cuFFT:
   wall time (host clock, outputs fetched) and star fits/s, finite fluxes
   and errors, a mean reduced chi2 in [0.9, 1.1] (true PSF, exact noise),
   the median |dmag| against the true fluxes, and no launch of K1 or K2
   (the shipped flags render without them); 9b the same on matmul;
9c, 9d the same with ``starlet_global_background=True`` on each render,
   with exact launch counts: K1 2001 forward (2000 iterations and one
   noise batch of 32 x 200) and 2000 adjoint; K2 2000 each way on matmul
   (the finalize renders without it), none on fft;
10. ROI-100 on matmul again, through ``fit_roi`` with stage 2 checkpointed
   every 500 iterations under the digest the pipeline task builds
   (``roi_checkpoint_digest``), killed for real at the third checkpoint
   write (a wrapper around ``core.optimize.save_checkpoint`` raises
   ``SmokeKill``, the one exception caught), the file checked to hold
   1000 iterations, then called again: it resumes there and replays the
   lost segment. Held to phase 5b's uninterrupted fit (fluxes within
   1 mmag, reduced chi2 within 1 %; whether the fluxes are bit-equal is
   printed), with the launches of the iterations that ran (stage 2: K2
   with the background and K1 1500 + 1000 each way, K1 forward also
   twice phase 5b's noise-weight launches), the checkpoint writes' times,
   and the file gone after success;
10b. the same for the star fit of phase 9d (``fit_stars_batched`` with
   ``checkpoint_path``, the starlet background on matmul), against 9d's
   result;
10c. a small scene (phase 4's, at 50 + 300 iterations) fitted twice
   uninterrupted and once killed at its second checkpoint write (of
   every 100) and resumed, on each render: are the card's fits
   bit-reproducible at all, and is the resumed fit the uninterrupted one
   to the bit?
11. the device paths of the PSF and star pipeline tasks, driven through
   the tasks' own functions on in-memory jobs (the card's machine has no
   h5py, pandas or PyYAML for their database and HDF5 shells):
   ``psf_modelling.run_pipelined_buckets`` over two buckets of 16 frames
   x 8 stars, 64 px (cuFFT), prepared by ``mask_surrounding_stars``,
   dispatched by ``_dispatch_fit_jobs`` and collected by
   ``_collect_fit_results``: the first phase 7's frames at its 100 + 3000
   iterations, the second with 6 stars in every other frame at 100 +
   1000; and ``star_photometry._dispatch_star_jobs`` (``fetch="device"``)
   pipelined over two buckets of 32 stars x 100 epochs, 24 px (starlet
   background, matmul): the first phase 9d's stars at its 2000
   iterations, the second with ragged epoch counts at 500. A bucket whose
   padded arrays and budget are phase 7's (or 9d's) must give that
   phase's bits, any other a direct ``build_psf_batched``
   (``fit_stars_batched``) call's on the same arrays; PSFs and fluxes
   finite, mean chi2 in phase 7's (9d's) range; launches exact (K1 one
   each way per pixel-phase iteration of the PSF fits; K1 n + 1 / n and
   K2 n / n per star bucket of n iterations); each bucket's wall and the
   pipelined wall against the buckets' sum; then the second star bucket
   checkpointed every 100 iterations through the task: the same bits,
   and no file left.
12. the front of the pipeline's host bodies (numpy and scipy; the card's
   machine has no pandas or h5py for their task shells) on one seeded
   2048 x 2048 frame of ~300 stars of FWHM 3 px with ~200 cosmic-ray
   hits: ``subtract_background`` at the example config's 3 boxes,
   ``_segment`` and ``_moments`` at its threshold 2 and area 20,
   ``find_transform`` against a rotated, shifted copy of the sources, and
   ``extract_stamp`` and ``mask_cutout`` of 32 px stamps for 200 stars;
   >= 95 % of the stars found within 0.5 px, the transform within
   0.05 px, >= 90 % of the hit pixels masked; each body's wall beside the
   card line (the background and the cosmics run the host C++ of
   ``native/`` when it loads; its first use, which builds it, is timed
   apart before them).
13. the port's pipeline shell: the synthetic scene of
   tests/test_e2e_pipeline.py (3 frames of 160 px, 8 stars, 2 blended ROI
   sources, its Gaia fixture and config; ``write_e2e_scene``, from
   ``default_rng(42)``) through ``WorkflowManager(device="cuda")`` to
   ``query_gaia_for_stars``, each task's wall: 3 frames imported,
   plate-solved, kept, the ROI in every footprint, 8 stars each assigned
   to every frame; the same through ``python -m
   lightcurver_tpu_torch.scripts.run <config> --stop query_gaia_for_stars``
   in a subprocess on a fresh copy, which must give the same DB rows.
   Where h5py is installed the run goes on from ``stamp_extraction`` to
   the light curves, printing each task's wall and the K1 and K2 launches
   it made, and holds the e2e test's eight invariants (seeing, PSF chi2,
   star fluxes, normalization and zeropoints, the ROI products, an
   incremental rerun, the adapt-WCS fault, the field-distortion redo);
   without h5py one line names the task it stopped before and why.
14. the sharded fits of ``parallel/`` (torch.distributed):
14a. one rank, in this process: ``initialize_distributed`` at world 1
   (NCCL), then ``fit_roi(..., irfft_backend="matmul",
   mesh=epoch_mesh())`` on phase 5b's ROI-100 scene at the shipped
   recipe, through the sharded loss (the all-reduce of the loss and the
   gradient, W broadcast from rank 0): fluxes within 1 mmag of phase 5b
   and reduced chi2 within 1 %, whether they are bit-equal (expected),
   the wall and the K1 and K2 launches;
14b. two ranks on the one card: ``python3 chip_smoke.py --shard-rank R
   DIR`` twice, with torchrun's variables, talking over gloo on CUDA
   tensors (NCCL refuses two ranks on one device), each running four
   fits with ``mesh="auto"``: phase 5's ROI-100 at full width and
   100 + 1000 iterations (``SHARD_ROI_BUDGET`` says why; 50 epochs a
   rank, matmul), PSF-16 at 100 + 300 iterations (8 frames a rank, matmul
   at ``dft_pad`` 16), the STAR-32 bucket with the starlet background at
   300 iterations on the 1-D batch mesh (16 stars a rank), and its first
   star alone on the (1, 2) mesh (50 epochs a rank). Each is held against
   the same fit unsharded here: ROI-100 and the stars with fluxes within
   1 mmag and reduced chi2 within 1 %, the PSFs against the unsharded fit
   of each rank's 8 frames (within 1e-2 of a frame's peak, chi2 within
   1 %), with the 16-frame fit and its rounding floor printed beside
   (``check_shard_ranks`` says why); the two ranks' results must be equal
   to the bit, their launches exact, and each rank's K1 and K2 launches
   come back on a JSON line; a rank that fails or outlives its timeout
   fails the phase.

15. the notebook API (the JAX package's top-level names) and the host
   C++ of ``native/``:
15a. ``do_one_star_forward_modelling`` on the first star of phase 9's
   bucket (100 epochs, 24 px, s 2, 1000 iterations) with the background
   fixed, on cuFFT and on matmul, each against ``fit_stars_batched`` of
   that star alone at the same budget (fluxes, chi2 per frame and errors
   within ``SINGLE_VS_BATCHED`` relative; K1 forward once an iteration,
   the l1 term of the fixed background as in JAX, and nothing else);
   then with its default starlet background on matmul: finite outputs, a
   mean reduced chi2 in [0.9, 1.1], exactly K1 1001 forward / 1000
   adjoint and K2 1000 each way, and the walls; and that fit against the
   same call on the CPU through the plain twins (fluxes, chi2 per frame
   and errors within ``SINGLE_CARD_VS_CPU`` relative), with its floor
   beside it: the card fit's gap to the card fit of the data moved one
   ulp;
15b. ``Optimizer.minimize`` on that star's problem (cuFFT, background
   fixed): ``return_param_history`` over 200 iterations (the snapshots'
   iterations JAX's ring rule; the history bit-equal to the plain
   loop's), ``stop_at_loss_increase`` at lr 0.5 without a schedule and
   ``min_iterations`` 5 (``stopped_at`` in [5, 200), the tail constant
   to the bit), and with no option set the plain ``run_adabelief`` to
   the bit;
15c. ``FisherCovariance`` on phase 5b's ROI-100 fit: the flux sigmas
   bit-equal to ``get_flux_uncertainties`` of the same kwargs and noise,
   within 1e-5 of the fit's own errors, and every other leaf NaN;
15d. ``native.load()`` on the card's host (None fails: the host has
   g++), then on phase 12's frame ``background_mesh`` (the example
   config's 3 x 3 boxes), ``extract_sources`` (its threshold and area)
   and ``detect_cosmics`` (the 32 px stamps of phase 12's first 200
   stars) against their numpy twins at the JAX package's bars (1e-5, the
   same catalogue rows, the cosmics to the bit), with the walls of both.
16. the bench helpers of ``utilities/benchmarking.py``, each loop one
   CUDA graph replayed best of 3 between CUDA events (after eager steps
   on a side stream): 16a ``time_compiled_loop`` of the starlet at
   (m 128, batch 1) and (128, 16), beside phases 3 and 3c's K1 times;
   16b ``psf_pixel_phase_cost`` at the PSF bench's shape (16 frames of 8
   stars, 64 px, s 2, ``dft_pad`` 16) and 16c ``star_fit_phase_cost`` at
   (8 stars, 50 epochs, 16 px, s 2), on each render: bytes and FLOPs an
   iteration (``compiled_cost``, K1 and K2 as units of their work
   formulas), the per-iteration time of ``time_vg_loop`` captured and
   eager, and bytes and FLOPs over the captured time as shares of the
   card's memory rate and fp32 peak; gates: finite values, costs > 0,
   each captured first step within ``HELPER_FIRST_STEP`` of the same step
   run eagerly, no share over 105 %; 16d both costs at a small shape
   on each render, counted on the card and on the CPU, which must give
   the same bytes and FLOPs (autograd runs the card's backward on its
   own thread). ``make_psf_task_workdir`` needs h5py, which the card's
   machine lacks: one line says so.

Then one JSON line on the kernels, each with its bound (the larger of
its bytes over the card's memory rate and its operations over the peak
rate of the units that can run them, from the shapes of this run and the
port's work formulas, ``starlet_cuda.work`` and
``fused_render_cuda.work``) and its launches over every run of the main
path (phases 5, 5b, 7, 7b, 9 to 9d, 10, 10b, 11's pipelined runs, 13's
pipeline run, 14a, both ranks of 14b, 15a and 16, whose graph replays
are counted from the launches each capture recorded), and, last, the
device line. There is no CPU path:
without a card the script fails.
"""

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

HERE = Path(__file__).resolve().parent
TOL = 1e-5
K2_TOL = 1e-5       # 3xTF32 forward and backward: float32 accuracy
DMAG_MATMUL_MAX = 0.15e-3   # median |dmag| of the matmul vs the fft fit
PSF_CHI2_RANGE = (0.5, 1.0)  # the JAX package's records: 0.728-0.744

# Published H100 SXM peaks (NVIDIA's data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12        # CUDA cores
TF32_FLOPS = 495e12       # tensor cores, dense


class SmokeFailure(RuntimeError):
    pass


class SmokeKill(Exception):
    """The simulated kill of a checkpointed fit (phases 10 to 10c)."""


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
    """K1 forward or adjoint at the port's work formula
    (``starlet_cuda.work``: one plane in, n_scales + 1 out, or back; 21
    FLOPs a pixel a level), all on the CUDA cores."""
    from lightcurver_tpu_torch.ops.starlet_cuda import work

    n_bytes, flops = work(m, batch, n_scales)
    return bound(n_bytes, [(flops, FP32_FLOPS)])


def k2_work(ops, backward, include_h):
    """``(bytes, products, rest)`` of K2 at the shapes of ``ops``, the
    port's work formula (``fused_render_cuda.operand_work``): the
    products are those the tensor cores can take (the two DFT stages);
    with h the background is G planes when h is (G, L, Lh), one shared
    plane when it is (L, Lh)."""
    from lightcurver_tpu_torch.ops.fused_render_cuda import (h_groups,
                                                            operand_work)

    u_re, v, ayp = ops[0], ops[2], ops[10]
    G = h_groups(ops[8], u_re.shape[0]) if include_h else None
    return operand_work(u_re, v, ayp, backward, include_h, G)


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


def phase_k1_at(torch, starlet_cuda, plain, card, phase, m, batch):
    """K1 forward and adjoint at (m, batch) against the twin, timed from a
    CUDA graph: 3c at the frame-batched PSF fit's shape (m 128, 16
    frames), 3d at the star fit's (m 48, 32 stars; 6400 noise samples)
    and the single star's (m 48, one star; 200 noise samples). Returns the
    largest differences and the kernels' times from the graph."""
    n_scales = plain.n_starlet_scales(m)
    cluster = starlet_cuda.cluster_for(torch.device("cuda"), m, batch)
    gen = torch.Generator().manual_seed(batch)
    x = torch.randn(batch, m, m, generator=gen).cuda()
    g = torch.randn(batch, n_scales + 1, m, m, generator=gen).cuda()
    errs, times = {}, {}
    for name, inp, kernel, twin in (
            ("starlet_forward", x, lambda: starlet_cuda.starlet_forward(x),
             lambda: plain.starlet_transform(x)),
            ("starlet_adjoint", g, lambda: starlet_cuda.starlet_adjoint(g),
             lambda: plain.starlet_adjoint(g))):
        out = kernel()
        torch.cuda.synchronize()
        err = (out - twin()).abs().max().item()
        tol = TOL * inp.abs().max().item()
        check(err <= tol, f"{name} m={m} B={batch}: max|diff| {err:.3e} > "
              f"{tol:.3e}")
        reps = 200 if batch < 1000 else 20
        ms, loop_ms = graph_ms(kernel, reps), cuda_ms(kernel, reps)
        plain_ms = cuda_ms(twin, 20 if batch < 1000 else 3)
        bound_ms, bound_by = k1_bound(m, batch, n_scales)
        errs[name], times[name] = err, ms
        say(phase, f"{name} m={m} B={batch} C={cluster}: max|diff| {err:.3e} "
            f"(bound {tol:.3e}); kernel {ms:.4f} ms (CUDA graph; "
            f"{loop_ms:.4f} ms a call in a loop), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}; card {card})")
    return errs, times


def psf_loss_point(psf_pixel_phase_point, n_frames, backend, device):
    """The batched pixel-phase loss (F,) and its gradients at full width
    (8 stars, 64 px) at one parameter point, on ``device``."""
    loss, free, consts = psf_pixel_phase_point(n_frames, 8, 64, backend,
                                               device)
    leaves = [v.requires_grad_(True) for d in free.values()
              for v in d.values()]
    value = loss(free, consts)
    value.sum().backward()
    return value.detach().cpu(), [x.grad.cpu() for x in leaves]


# The small fit's budget. AdaBelief's first steps move every grid pixel
# by the learning rate whatever its gradient's size (mu_hat / sqrt(nu_hat)
# = +-1), so a relative 1e-7 change of the data (the rounding of cuFFT
# against pocketfft, or of K1 against its twin) flips the pixels whose
# gradient is near zero: after 200 Moffat and 100 pixel-phase iterations
# of these 3 x 4 x 24 px stamps the full PSF moves by up to 1.1e-2 of its
# peak and the chi2 by up to 1.4 %. The Moffat phase settles such a
# change once it has converged: after 400 L-BFGS iterations it moves the
# chi2 by < 1e-6 and the full PSF by <= 7.8e-4 of its peak (both on the
# CPU, three draws: tools/torch_psf_rounding.py sensitivity). So the fit
# is held there, with one pixel-phase evaluation (its first loss, K1
# included).
SMALL_PSF_BUDGET = dict(n_iter_analytic=400, n_iter_adabelief=1)

# phases 4 and 4b: the small scene's budget, the shipped recipe's 300 +
# 2000 iterations cut to 100 + 1000, which halves the two phases' walls
# (most of them the CPU's fits). A 1e-7 change of the data moves its
# fluxes by <= 0.18 mmag at this budget and by <= 0.095 at the recipe's
# (both on the CPU, each render), so the 1 mmag bar still measures the
# device, not the float32 floor.
SMALL_ROI_BUDGET = dict(roi_deconv_translations_iters=100,
                        roi_deconv_all_iters=1000)


def phase_psf_small(np, build_psf_batched, psf_bench_frames,
                    psf_pixel_phase_point, starlet_cuda, backend, phase):
    """6 / 6b: the PSF fit on the card against the CPU."""
    pad = 16 if backend == "matmul" else None
    want, want_grads = psf_loss_point(psf_pixel_phase_point, 16, backend,
                                      "cpu")
    starlet_cuda.launches.reset()
    got, got_grads = psf_loss_point(psf_pixel_phase_point, 16, backend,
                                    "cuda")
    launches = (starlet_cuda.launches.forward, starlet_cuda.launches.adjoint)
    check(launches == (1, 1), f"PSF loss ({backend}): K1 launches {launches}"
          ", (1, 1) expected")
    err = (got - want).abs().max().item() / want.abs().max().item()
    gerr = max((g - w).abs().max().item() / w.abs().max().item()
               for g, w in zip(got_grads, want_grads))
    say(phase, f"PSF pixel-phase loss, 16 x 8 x 64 px, {backend}, card vs "
        f"cpu: loss {err:.2e}, gradient {gerr:.2e} of max (one K1 launch "
        "each way)")
    check(err <= TOL and gerr <= 1e-4, f"PSF loss ({backend}): card vs cpu "
          f"loss {err:.2e} > {TOL} or gradient {gerr:.2e} > 1e-4")

    data, sigma = psf_bench_frames(3, 4, 24)
    fits, walls = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        fits[device] = build_psf_batched(data, sigma, 2, device=device,
                                         irfft_backend=backend, dft_pad=pad,
                                         **SMALL_PSF_BUDGET)
        walls[device] = time.perf_counter() - t0
    card, cpu = fits["cuda"], fits["cpu"]
    dchi2 = np.abs(card["chi2"] / cpu["chi2"] - 1).max()
    peak = np.abs(cpu["full_psf"]).max(axis=(1, 2), keepdims=True)
    dfull = (np.abs(card["full_psf"] - cpu["full_psf"]) / peak).max()
    first = np.abs(card["loss_history_pixels"][:, 0]
                   / cpu["loss_history_pixels"][:, 0] - 1).max()
    say(phase, f"small build_psf_batched (3 x 4 x 24 px, {backend}), card "
        f"vs cpu: max |dchi2|/chi2 {dchi2:.2e}, max |dfull|/peak "
        f"{dfull:.2e}, pixel phase's first loss {first:.2e}; chi2 "
        f"{np.round(card['chi2'], 4).tolist()}; wall card "
        f"{walls['cuda']:.2f} s, cpu {walls['cpu']:.2f} s")
    check(dchi2 <= 0.01, f"small PSF fit ({backend}): chi2 differs by > 1 %")
    check(dfull <= 1e-2, f"small PSF fit ({backend}): full PSF differs by "
          "> 1e-2 of its peak")
    check(first <= 1e-4, f"small PSF fit ({backend}): the pixel phase's "
          "first loss differs by > 1e-4")


def phase_psf_full(np, torch, build_psf_batched, psf_bench_frames,
                   starlet_cuda, backend, phase, card):
    """7 / 7b: the full-width frame-batched PSF fit (the frames of the JAX
    package's PSF bench); returns ((K1 forward, K1 adjoint) launches of
    the fit, its result, its wall)."""
    pad = 16 if backend == "matmul" else None
    data, sigma = psf_bench_frames(16, 8, 64)
    torch.cuda.synchronize()
    starlet_cuda.launches.reset()
    t0 = time.perf_counter()
    out = build_psf_batched(data, sigma, 2, n_iter_analytic=100,
                            n_iter_adabelief=3000, device="cuda",
                            irfft_backend=backend, dft_pad=pad)
    wall = time.perf_counter() - t0
    n_fwd, n_adj = starlet_cuda.launches.forward, starlet_cuda.launches.adjoint
    chi2 = float(np.mean(out["chi2"]))
    say(phase, f"full-width build_psf_batched (16 frames x 8 stars, 64 px, "
        f"s 2, 100 + 3000 iterations, {backend}"
        f"{', dft_pad 16' if pad else ''}) on the card: {wall:.3f} s wall, "
        f"{16 / wall:.4f} PSF fits/s (card {card}); K1 launches forward "
        f"{n_fwd}, adjoint {n_adj}; mean reduced chi2 {chi2:.4f} (the JAX "
        "package's records: 0.728-0.744); chi2 per frame "
        f"{np.round(out['chi2'], 4).tolist()}")
    check(n_fwd >= 3000 and n_adj >= 3000,
          f"the PSF fit ({backend}) did not run through K1 every iteration")
    check(all(np.all(np.isfinite(out[k])) for k in ("narrow_psf",
                                                    "full_psf", "chi2")),
          f"PSF fit ({backend}): non-finite PSFs or chi2")
    check(PSF_CHI2_RANGE[0] <= chi2 <= PSF_CHI2_RANGE[1],
          f"PSF fit ({backend}): mean reduced chi2 {chi2} outside "
          f"{PSF_CHI2_RANGE}")
    return (n_fwd, n_adj), out, wall


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


def k2_against_twin(torch, k2_cuda, twin, ops, g, n_groups, label, card,
                    errs):
    """K2 forward and backward on ``ops`` (cotangent ``g``, ``n_groups``
    background groups, None for one shared plane) against the plain
    twins at phase 3b's bar, timed beside their bounds; the largest
    difference of each goes into ``errs``."""
    bwd_ops = (*ops[:8], *ops[10:])
    for name, kernel, plain in (
            ("fused_render_forward", lambda: [k2_cuda.forward(*ops)],
             lambda: [twin.render_plain(*ops)]),
            ("fused_render_backward",
             lambda: k2_cuda.backward(g, *bwd_ops, n_groups=n_groups),
             lambda: twin.render_backward_plain(g, *bwd_ops,
                                                n_groups=n_groups))):
        outs = kernel()
        torch.cuda.synchronize()
        err, rel = 0.0, []
        for got, want in zip(outs, plain()):
            diff = (got - want).abs().max().item()
            scale = want.abs().max().item()
            check(diff <= K2_TOL * scale, f"{name} {label}: max|diff| "
                  f"{diff:.3e} > {K2_TOL * scale:.3e}")
            err = max(err, diff)
            rel.append(f"{diff / scale:.2e}")
        ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 5)
        (bound_ms, bound_by), (fp32_ms, _), flops = k2_bounds(
            ops, name.endswith("backward"), True)
        errs[name] = max(errs.get(name, 0.0), err)
        say("3d", f"{name} {label}, n 24, L 96: max|diff| {err:.3e} (/ "
            f"max|plain| per output: {', '.join(rel)}); kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
            f"({bound_by}; fp32 bound {fp32_ms:.4f} ms), "
            f"{bound_ms / ms:.1%} of it; {flops / ms * 1e-9:.2f} TFLOP/s "
            f"(card {card})")


def phase_k2_stars(torch, k2_cuda, twin, star_k2_operands, roi, card):
    """3d: K2 against its plain twins at the star shapes: a per-star
    background at the full bucket (G 32 x 100 epochs), and the single
    star of phase 15a (100 epochs, one shared plane (L, Lh), as its fit
    renders it); then one group against the shared plane to the bit
    (``roi``: phase 3b's ROI-100 operands and cotangent). Returns the
    largest differences."""
    errs = {}
    ops, g = star_k2_operands(32, 100, 24, "cuda", seed=32)
    k2_against_twin(torch, k2_cuda, twin, ops, g, 32,
                    "stars: G=32 x 100 epochs", card, errs)
    ops, g = star_k2_operands(1, 100, 24, "cuda", seed=1)
    shared = (*ops[:8], ops[8][0], ops[9][0], *ops[10:])
    k2_against_twin(torch, k2_cuda, twin, shared, g, None,
                    "single star: 100 epochs, one shared plane", card, errs)
    roi_ops, roi_g = roi
    one = (*roi_ops[:8], roi_ops[8][None], roi_ops[9][None], *roi_ops[10:])
    same = torch.equal(k2_cuda.forward(*one), k2_cuda.forward(*roi_ops))
    bwd = (*roi_ops[:8], *roi_ops[10:])
    grouped = k2_cuda.backward(roi_g, *bwd, n_groups=1)
    shared = k2_cuda.backward(roi_g, *bwd)
    same = same and all(torch.equal(x.reshape(y.shape), y)
                        for x, y in zip(grouped, shared))
    verdict = "the same bits" if same else "DIFFER"
    say("3d", f"K2 at ROI-100, h (1, L, Lh) against the shared (L, Lh) "
        f"plane, forward and backward: {verdict}")
    check(same, "K2 with one group differs from the shared plane")
    return errs


def phase_star_small(np, fit_stars_batched, star_photometry_scene,
                     starlet_cuda, k2, backend, phase):
    """8 / 8b: a small star fit with a starlet background per star, card
    against CPU, and the card run's exact launches."""
    sc = star_photometry_scene(3, 6, 16, 2, n_real=(6, 5, 4))
    args = (sc["data"], sc["sigma"], sc["psf"], 2)
    kw = dict(n_iter=60, starlet_global_background=True,
              irfft_backend=backend)
    starlet_cuda.launches.reset()
    k2.reset()
    t0 = time.perf_counter()
    card = fit_stars_batched(*args, device="cuda", **kw)
    t_card = time.perf_counter() - t0
    k1 = (starlet_cuda.launches.forward, starlet_cuda.launches.adjoint)
    k2_runs = (k2.forward, k2.backward, k2.forward_h, k2.backward_h)
    t0 = time.perf_counter()
    cpu = fit_stars_batched(*args, device="cpu", **kw)
    t_cpu = time.perf_counter() - t0
    real = np.isfinite(sc["a_true"])
    dmag = np.abs(2.5 * np.log10(card["fluxes"][real] / cpu["fluxes"][real]))
    dchi2 = np.abs(card["chi2"] / cpu["chi2"] - 1)
    say(phase, f"small star fit (3 stars, 6/5/4 real epochs, 16 px, 60 "
        f"iterations, starlet background, {backend}), card vs cpu: max "
        f"|dmag| {dmag.max() * 1e3:.4f} mmag, max |dchi2|/chi2 "
        f"{dchi2.max():.2e}; chi2 {np.round(card['chi2'], 4).tolist()}; "
        f"card launches K1 forward {k1[0]}, adjoint {k1[1]}, K2 forward "
        f"{k2_runs[0]}, backward {k2_runs[1]}; wall card {t_card:.2f} s, "
        f"cpu {t_cpu:.2f} s")
    check(dmag.max() <= 1e-3, f"small star fit ({backend}): fluxes differ "
          "by > 1 mmag")
    check(dchi2.max() <= 0.01, f"small star fit ({backend}): chi2 differs "
          "by > 1 %")
    check(k1 == (61, 60), f"small star fit ({backend}): K1 launches {k1}, "
          "(61, 60) expected")
    want = (60,) * 4 if backend == "matmul" else (0,) * 4
    check(k2_runs == want, f"small star fit ({backend}): K2 launches "
          f"{k2_runs}, {want} expected")


def phase_star_full(np, torch, fit_stars_batched, sc, starlet_cuda, k2,
                    backend, starlet, phase, card):
    """9 to 9d: the full-width star fit; returns (K1 forward, K1 adjoint,
    K2 forward, K2 backward) launches of the fit."""
    n_stars = sc["data"].shape[0]
    torch.cuda.synchronize()
    starlet_cuda.launches.reset()
    k2.reset()
    t0 = time.perf_counter()
    out = fit_stars_batched(sc["data"], sc["sigma"], sc["psf"], sc["s"],
                            n_iter=2000, starlet_global_background=starlet,
                            irfft_backend=backend)
    wall = time.perf_counter() - t0
    runs = (starlet_cuda.launches.forward, starlet_cuda.launches.adjoint,
            k2.forward, k2.backward)
    chi2 = float(np.mean(out["chi2"]))
    dmag = np.abs(2.5 * np.log10(out["fluxes"] / sc["a_true"]))
    pull = (out["fluxes"] - sc["a_true"]) / out["fluxes_uncertainties"]
    flags = "starlet background" if starlet else "shipped flags"
    say(phase, f"full-width star fit (32 stars x 100 epochs, 24 px, s 2, "
        f"2000 iterations, {flags}, {backend}) on the card: {wall:.3f} s "
        f"wall, {n_stars / wall:.4f} star fits/s (card {card}); K1 launches "
        f"forward {runs[0]}, adjoint {runs[1]}; K2 forward {runs[2]}, "
        f"backward {runs[3]} (with h {k2.forward_h}, {k2.backward_h}); mean "
        f"reduced chi2 {chi2:.4f}; flux vs a_true: median |dmag| "
        f"{np.median(dmag) * 1e3:.3f} mmag, pull rms "
        f"{np.sqrt(np.mean(pull**2)):.3f}")
    check(np.all(np.isfinite(out["fluxes"]))
          and np.all(np.isfinite(out["fluxes_uncertainties"])),
          f"star fit ({flags}, {backend}): non-finite fluxes or errors")
    check(0.9 <= chi2 <= 1.1, f"star fit ({flags}, {backend}): mean reduced "
          f"chi2 {chi2} outside [0.9, 1.1]")
    want = (2001, 2000) if starlet else (0, 0)
    want += (2000, 2000) if starlet and backend == "matmul" else (0, 0)
    check(runs == want, f"star fit ({flags}, {backend}): launches {runs}, "
          f"{want} expected")
    check(k2.forward_h == runs[2] and k2.backward_h == runs[3],
          f"star fit ({flags}, {backend}): K2 ran without the background")
    return runs, out, wall


def scene_args(scene, config):
    """``fit_roi``'s positional arguments for a synthetic scene."""
    n = scene["data"].shape[-1]
    n_epochs = scene["data"].shape[0]
    return (scene["data"], scene["sigma_2"] ** 0.5, scene["psf"],
            scene["xs"] + (n - 1) / 2.0, scene["ys"] + (n - 1) / 2.0,
            scene["s"], scene["fwhm"], 1.0, [0.0] * n_epochs, config)


def fit_scene(fit_roi, config, scene, device, irfft_backend="fft", **kw):
    return fit_roi(*scene_args(scene, config), device=device,
                   irfft_backend=irfft_backend, **kw)


class CheckpointWrites:
    """Wraps ``core.optimize.save_checkpoint`` for one run: counts and
    times the writes, and raises :class:`SmokeKill` instead of the
    ``kill_at``-th one (never when None)."""

    def __init__(self, optimize, kill_at=None):
        self.optimize, self.kill_at = optimize, kill_at
        self.done, self.seconds = [], []

    def __enter__(self):
        save = self.save = self.optimize.save_checkpoint

        def wrapped(path, carry, n_iter, done, *args, **kwargs):
            if self.kill_at is not None \
                    and len(self.done) + 1 == self.kill_at:
                raise SmokeKill(f"killed at checkpoint write {self.kill_at}")
            t0 = time.perf_counter()
            save(path, carry, n_iter, done, *args, **kwargs)
            self.seconds.append(time.perf_counter() - t0)
            self.done.append(done)

        self.optimize.save_checkpoint = wrapped
        return self

    def __exit__(self, *exc):
        self.optimize.save_checkpoint = self.save
        return False


def killed_and_resumed(np, torch, optimize, run, path, kill_at, counters):
    """Run ``run()`` with its ``kill_at``-th checkpoint write raising
    :class:`SmokeKill`, read the file's ``done``, then run it again to the
    end. Returns (result, done at the kill, [killed, resumed] walls,
    [killed, resumed] CheckpointWrites, [killed, resumed] launch counts as
    ``counters()`` reads them after resetting them)."""
    walls, writes, launches = [], [], []
    for kill in (kill_at, None):
        counters(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CheckpointWrites(optimize, kill) as w:
            try:
                out = run()
            except SmokeKill:
                out = None
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        writes.append(w)
        launches.append(counters())
        if kill is not None:
            check(out is None, "the checkpointed fit was not killed")
            with np.load(path, allow_pickle=False) as z:
                done_at_kill = int(z["done"])
        else:
            check(out is not None, "the resumed fit was killed")
    return out, done_at_kill, walls, writes, launches


def same_bits(np, a, b, keys):
    return all(np.array_equal(a[k], b[k]) for k in keys)


def write_times(writes):
    return ", ".join(f"{d}: {t * 1e3:.1f} ms"
                     for w in writes for d, t in zip(w.done, w.seconds))


def phase_roi_resumed(np, torch, fit_roi, roi_checkpoint_digest, optimize,
                      config, scene, counters, reference, noise_launches,
                      work, card):
    """10: ROI-100 on matmul, stage 2 checkpointed every 500 iterations,
    killed at the third write and resumed, against phase 5b's fit
    (``reference``: (result, wall, stage-1 K2 launches)). Returns the
    launches (K1 fwd, K1 adj, K2 fwd, K2 bwd) of both runs."""
    want, wall_5b, stage1_5b = reference
    path = work / "roi100_stage2.ckpt"
    args = scene_args(scene, config)
    digest = roi_checkpoint_digest(*args[:5], args[8], config)
    out, done, walls, writes, runs = killed_and_resumed(
        np, torch, optimize,
        lambda: fit_roi(*args, device="cuda", irfft_backend="matmul",
                        checkpoint_path=path, checkpoint_every=500,
                        checkpoint_inputs_digest=digest),
        path, 3, counters)
    check(done == 1000, f"the killed fit's checkpoint holds {done} "
          "iterations, 1000 expected")
    check(not path.exists(), "the checkpoint is left after the fit")
    dmag = np.abs(2.5 * np.log10(out["fluxes"] / want["fluxes"]))
    dchi2 = np.abs(out["reduced_chi2"] / want["reduced_chi2"] - 1)
    bits = same_bits(np, out, want, ("fluxes", "flux_errors",
                                      "reduced_chi2"))
    # K1 fwd, K1 adj, K2 fwd, K2 bwd, K2 fwd with h, K2 bwd with h
    killed, resumed = runs
    stage2 = tuple(k + r for k, r in zip(killed[4:], resumed[4:]))
    k1 = (killed[0] + resumed[0], killed[1] + resumed[1])
    stage1 = [(r[2] - r[4], r[3] - r[5]) for r in runs]
    say(10, f"ROI-100 matmul, stage 2 checkpointed every 500 and killed at "
        f"the third write: the file held {done} iterations; writes "
        f"{write_times(writes)}; wall killed {walls[0]:.3f} s + resumed "
        f"{walls[1]:.3f} s against {wall_5b:.3f} s uninterrupted (5b) "
        f"(card {card})")
    say(10, f"resumed vs 5b: max |dmag| {dmag.max() * 1e3:.4f} mmag, max "
        f"|dchi2|/chi2 {dchi2.max():.2e}, fluxes, errors and chi2 "
        f"{'bit-equal' if bits else 'not bit-equal'}; launches (killed + "
        f"resumed) K2 with h {stage2[0]}/{stage2[1]} (1500 + 1000 expected), "
        f"K1 {k1[0]}/{k1[1]}; stage 1 K2 forward/backward {stage1} (5b: "
        f"{stage1_5b})")
    check(dmag.max() <= 1e-3, "the resumed ROI-100 fit's fluxes differ from "
          "5b's by > 1 mmag")
    check(dchi2.max() <= 0.01, "the resumed ROI-100 fit's chi2 differs from "
          "5b's by > 1 %")
    check(stage2 == (2500, 2500), f"stage 2 K2 launches {stage2}, (2500, "
          "2500) expected: 1500 iterations killed, 1000 resumed")
    want_k1 = (2500 + 2 * noise_launches, 2500)
    check(k1 == want_k1, f"K1 launches {k1}, {want_k1} expected")
    check(all(min(s1) > 0 for s1 in stage1), "stage 1 did not run K2")
    return (k1[0], k1[1], killed[2] + resumed[2], killed[3] + resumed[3])


def phase_star_resumed(np, torch, fit_stars_batched, optimize, sc, counters,
                       reference, work, card):
    """10b: the star fit of 9d (starlet background, matmul) checkpointed
    every 500 iterations, killed at the third write and resumed, against
    9d's result (``reference``: (result, wall)). Returns the launches."""
    want, wall_9d = reference
    path = work / "star32.ckpt"
    out, done, walls, writes, runs = killed_and_resumed(
        np, torch, optimize,
        lambda: fit_stars_batched(
            sc["data"], sc["sigma"], sc["psf"], sc["s"], n_iter=2000,
            starlet_global_background=True, irfft_backend="matmul",
            checkpoint_path=path, checkpoint_every=500),
        path, 3, counters)
    check(done == 1000, f"the killed star fit's checkpoint holds {done} "
          "iterations, 1000 expected")
    with np.load(path, allow_pickle=False) as z:
        # the core leaves the finished file; the pipeline tasks delete it
        check(int(z["done"]) == 2000, "the star fit's last checkpoint is "
              "not at 2000 iterations")
    path.unlink()
    dmag = np.abs(2.5 * np.log10(out["fluxes"] / want["fluxes"]))
    dchi2 = np.abs(out["chi2"] / want["chi2"] - 1)
    bits = same_bits(np, out, want, ("fluxes", "fluxes_uncertainties",
                                      "chi2"))
    total = tuple(k + r for k, r in zip(*runs))
    say("10b", f"STAR-32 starlet matmul, checkpointed every 500 and killed "
        f"at the third write: the file held {done} iterations; writes "
        f"{write_times(writes)}; wall killed {walls[0]:.3f} s + resumed "
        f"{walls[1]:.3f} s against {wall_9d:.3f} s uninterrupted (9d) "
        f"(card {card})")
    say("10b", f"resumed vs 9d: max |dmag| {dmag.max() * 1e3:.4f} mmag, max "
        f"|dchi2|/chi2 {dchi2.max():.2e}, fluxes, errors and chi2 "
        f"{'bit-equal' if bits else 'not bit-equal'}; launches (killed + "
        f"resumed) K1 {total[0]}/{total[1]}, K2 {total[2]}/{total[3]} "
        "(K1 2502/2500 and K2 2500/2500 expected)")
    check(dmag.max() <= 1e-3, "the resumed star fit's fluxes differ from "
          "9d's by > 1 mmag")
    check(dchi2.max() <= 0.01, "the resumed star fit's chi2 differs from "
          "9d's by > 1 %")
    check(total[:4] == (2502, 2500, 2500, 2500),
          f"star fit launches {total[:4]}, (2502, 2500, 2500, 2500) "
          "expected")
    return total[:4]


def phase_bits(np, torch, fit_roi, optimize, config, scene, work):
    """10c: is a fit on the card bit-reproducible, and is a killed and
    resumed fit the uninterrupted one to the bit?"""
    small = {**config, "roi_deconv_translations_iters": 50,
             "roi_deconv_all_iters": 300}
    keys = ("fluxes", "flux_errors", "reduced_chi2", "loss_history_stage1",
            "loss_history_stage2")
    path = work / "small_stage2.ckpt"
    for backend in ("fft", "matmul"):
        t0 = time.perf_counter()
        first, second = (fit_scene(fit_roi, small, scene, "cuda", backend)
                         for _ in range(2))
        out, done, *_ = killed_and_resumed(
            np, torch, optimize,
            lambda: fit_scene(fit_roi, small, scene, "cuda", backend,
                              checkpoint_path=path, checkpoint_every=100),
            path, 2, lambda reset=False: None)
        wall = time.perf_counter() - t0
        check(done == 100 and not path.exists(),
              "small scene: the checkpoint was not at 100 or is left")
        twice = same_bits(np, first, second, keys)
        resumed = same_bits(np, out, first, keys)
        dmag2 = np.abs(2.5 * np.log10(second["fluxes"] / first["fluxes"]))
        dmag = np.abs(2.5 * np.log10(out["fluxes"] / first["fluxes"]))
        say("10c", f"small scene (16 epochs, 32 px, 50 + 300 iterations), "
            f"{backend}, {wall:.1f} s: two uninterrupted fits "
            f"{'bit-equal' if twice else 'NOT bit-equal'} (max |dmag| "
            f"{dmag2.max() * 1e3:.4f} mmag); killed at 100 and resumed vs "
            f"the first: {'bit-equal' if resumed else 'NOT bit-equal'} "
            f"(max |dmag| {dmag.max() * 1e3:.4f} mmag)")
        check(dmag.max() <= 1e-3, f"small scene ({backend}): the resumed "
              "fit differs by > 1 mmag")


# phase 11's tasks: bucket 1 at the shipped budgets, bucket 2 (ragged) at
# a smaller one to keep the script's time
TASK_PSF_CONFIGS = [
    {"subsampling_factor": 2, "psf_n_iter_analytic": 100,
     "psf_n_iter_pixels": pixels, "field_distortion": False,
     "psf_dft_pad": 16} for pixels in (3000, 1000)]
TASK_STAR_CONFIGS = [
    {"subsampling_factor": 2, "star_deconv_n_iter": n_iter,
     "star_photometry_uniform_background_per_epoch": False,
     "star_photometry_starlet_global_background": True,
     "deconv_checkpoint_every": 0} for n_iter in (2000, 500)]
TASK_STAR_CHECKPOINT_EVERY = 100


def psf_task_jobs(np, mask_surrounding_stars, bucket, data, sigma, n_real,
                  seeing):
    """The PSF task's jobs for frames of star stamps, as
    ``_prepare_frame_job`` makes them from the regions HDF5: the first
    ``n_real[f]`` stars of frame f, their neighbours masked, the seeing
    guess ``seeing[f]`` (None: unknown); each frame's id names its
    bucket."""
    jobs = []
    for f, (k, guess) in enumerate(zip(n_real, seeing)):
        d, n = data[f, :k].copy(), sigma[f, :k].copy()
        jobs.append({
            "frame": {"id": 100 * bucket + f, "seeing_pixels": guess},
            "data": d, "noisemap": n, "stamp_coords": np.zeros((k, 2)),
            "masks": np.array([mask_surrounding_stars(a, b)
                               for a, b in zip(d, n)]),
            "names": [chr(97 + j) for j in range(k)], "n_before": k})
    return jobs


def pipelined(torch, run_pipelined_buckets, buckets, prepare, dispatch,
              collect):
    """Drive ``run_pipelined_buckets``; returns ([(chunk, results)] in
    store order, [each bucket's wall from its dispatch to its stored
    results], the whole wall)."""
    stored, starts, walls = [], [], []

    def timed_dispatch(chunk):
        starts.append(time.perf_counter())
        return dispatch(chunk)

    def store(chunk, out, t0):
        stored.append((chunk, collect(out, chunk)))
        walls.append(time.perf_counter() - starts[len(walls)])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_pipelined_buckets(buckets, prepare, timed_dispatch, store)
    torch.cuda.synchronize()
    return stored, walls, time.perf_counter() - t0


def same_arrays(np, a, b):
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)


def psf_results_equal(np, results, ref, jobs):
    """Are the task's per-frame results ``ref``'s (a ``build_psf_batched``
    result on the host) to the bit?"""
    for i, (res, job) in enumerate(zip(results, jobs)):
        k = len(job["data"])
        pairs = [(res["narrow_psf"], ref["narrow_psf"][i]),
                 (res["full_psf"], ref["full_psf"][i]),
                 (res["chi2"], ref["chi2"][i]),
                 (res["chi2_per_star"], ref["chi2_per_star"][i, :k]),
                 (res["residuals"], ref["residuals"][i, :k]),
                 (res["adabelief_extra_fields"]["loss_history"],
                  ref["loss_history_pixels"][i])]
        for group in ("kwargs_moffat", "kwargs_distortion"):
            pairs += [(value, ref[group][key][i]) for key, value
                      in res["kwargs_psf"][group].items()]
        if not all(np.array_equal(a, b) for a, b in pairs):
            return False
    return True


def phase_psf_task(np, torch, psf_modelling, build_psf_batched,
                   psf_bench_frames, starlet_cuda, reference, card):
    """11, the PSF task's device path: ``run_pipelined_buckets`` over two
    buckets of 16 frames x 8 stars, 64 px (the first phase 7's frames at
    its budget, the second 16 more with 6 stars in every other frame, a
    seeing guess and a smaller budget), prepared by
    ``mask_surrounding_stars``, dispatched by ``_dispatch_fit_jobs`` on
    cuFFT and collected by ``_collect_fit_results``. Each bucket is held
    to the bit to phase 7's result when its padded arrays and budget are
    phase 7's, else to a direct ``build_psf_batched`` call on them.
    Returns the launches of the pipelined run."""
    ref7, wall7 = reference
    configs = TASK_PSF_CONFIGS
    data, sigma = psf_bench_frames(32, 8, 64)
    n_real = [[8] * 16, [8 if f % 2 == 0 else 6 for f in range(16)]]
    seeing = [[None] * 16, [2.4 + 0.1 * f for f in range(16, 32)]]
    buckets = [(b, data[16 * b:16 * (b + 1)], sigma[16 * b:16 * (b + 1)],
                n_real[b], seeing[b]) for b in range(2)]
    starlet_cuda.launches.reset()
    stored, walls, wall = pipelined(
        torch, psf_modelling.run_pipelined_buckets, buckets,
        lambda b: psf_task_jobs(np, psf_modelling.mask_surrounding_stars,
                                *b),
        lambda chunk: psf_modelling._dispatch_fit_jobs(
            configs[chunk[0]["frame"]["id"] // 100], chunk, device="cuda",
            irfft_backend="fft"),
        psf_modelling._collect_fit_results)
    runs = (starlet_cuda.launches.forward, starlet_cuda.launches.adjoint)
    check(len(stored) == 2, f"the PSF task stored {len(stored)} buckets")
    # phase 7's call: no masks, no coordinates, no seeing guess
    as_phase7 = {"images": data[:16], "noisemaps": sigma[:16],
                 "masks": np.ones(data[:16].shape, bool),
                 "stamp_coordinates": np.zeros((16, 8, 2), np.float32),
                 "guess_fwhm_pixels": np.full(16, 3.0, np.float32)}
    serial = []
    for b, (jobs, results) in enumerate(stored):
        config = configs[b]
        arrays = psf_modelling._pad_fit_jobs(jobs)
        budget = (config["psf_n_iter_analytic"], config["psf_n_iter_pixels"])
        if same_arrays(np, arrays, as_phase7) and budget == (100, 3000):
            ref, against, t_ref = ref7, "phase 7's fit", wall7
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = build_psf_batched(
                subsampling_factor=config["subsampling_factor"],
                n_iter_analytic=budget[0], n_iter_adabelief=budget[1],
                dft_pad=config["psf_dft_pad"], device="cuda",
                irfft_backend="fft", **arrays)
            t_ref = time.perf_counter() - t0
            against = "a direct build_psf_batched call"
        serial.append(t_ref)
        chi2 = np.array([r["chi2"] for r in results])
        bits = psf_results_equal(np, results, ref, jobs)
        say(11, f"PSF task bucket {b + 1} ({len(jobs)} frames, stars "
            f"{sorted(set(len(j['data']) for j in jobs))}, padded to "
            f"{arrays['images'].shape[1]}; masked pixels "
            f"{int((~arrays['masks']).sum())}; {budget[0]} + {budget[1]} "
            f"iterations): {walls[b]:.3f} s from dispatch to stored "
            f"results; held to {against} ({t_ref:.3f} s alone): "
            f"{'bit-equal' if bits else 'NOT bit-equal'}; mean reduced "
            f"chi2 {chi2.mean():.4f}")
        check(bits, f"PSF task bucket {b + 1}: not bit-equal to {against}")
        check(all(np.all(np.isfinite(r[k])) for r in results
                  for k in ("narrow_psf", "full_psf", "chi2")),
              f"PSF task bucket {b + 1}: non-finite PSFs or chi2")
        check(PSF_CHI2_RANGE[0] <= chi2.mean() <= PSF_CHI2_RANGE[1],
              f"PSF task bucket {b + 1}: mean reduced chi2 {chi2.mean()} "
              f"outside {PSF_CHI2_RANGE}")
    want = sum(c["psf_n_iter_pixels"] for c in configs)
    say(11, f"PSF task, 2 buckets of 16 frames (fft): pipelined "
        f"{wall:.3f} s against {sum(serial):.3f} s for the buckets one by "
        f"one ({wall / sum(serial):.3f}) (card {card}); K1 launches forward "
        f"{runs[0]}, adjoint {runs[1]} ({want} each expected)")
    check(runs == (want, want), f"PSF task: K1 launches {runs}, one each "
          "way per pixel-phase iteration expected")
    return runs + (0, 0)


def star_task_jobs(sc, n_real, bucket):
    """The star task's jobs: star i's first ``n_real[i]`` epochs; each
    star names its bucket."""
    return [{"star": {"gaia_id": f"s{bucket}_{i}", "bucket": bucket},
             "data": sc["data"][i, :k], "noisemap": sc["sigma"][i, :k],
             "psf": sc["psf"][i, :k]} for i, k in enumerate(n_real)]


def star_results_equal(np, results, ref, jobs):
    """Are the task's per-star results ``ref``'s (a ``fit_stars_batched``
    result on the host) to the bit?"""
    for i, (res, job) in enumerate(zip(results, jobs)):
        k = len(job["data"])
        pairs = [(res[key], ref[key][i, :k]) for key in
                 ("fluxes", "fluxes_uncertainties", "chi2_per_frame",
                  "residuals")]
        pairs += [(res["loss_curve"], ref["loss_history"][i]),
                  (res["starlet_background"], ref["starlet_background"][i])]
        if not all(np.array_equal(a, b) for a, b in pairs):
            return False
    return True


def phase_star_task(np, torch, star_photometry, run_pipelined_buckets,
                    fit_stars_batched, star_photometry_scene, optimize, sc,
                    counters, reference, work, card):
    """11, the star task's device path: ``_dispatch_star_jobs``
    (``fetch="device"``) pipelined over two buckets of 32 stars x 100
    epochs, 24 px, with the starlet background on matmul (K1 and K2): the
    first phase 9d's stars at its budget, the second 32 more with 100, 90,
    80 and 70 real epochs in turn, at a smaller budget. Each bucket is
    held to the bit to phase 9d's result when its padded arrays and budget
    are 9d's, else to a direct ``fit_stars_batched`` call on them; then
    the second bucket once more through the task with
    ``deconv_checkpoint_every``, to the same bits and with its checkpoint
    deleted. Returns the launches of the pipelined run."""
    ref9d, wall9d = reference
    configs = [{**c, "checkpoints_dir": work / "star_task"}
               for c in TASK_STAR_CONFIGS]
    other = star_photometry_scene(32, 100, 24, 2, seed0=70)
    buckets = [star_task_jobs(sc, [100] * 32, 0),
               star_task_jobs(other, [100 - 10 * (i % 4) for i in
                                      range(32)], 1)]
    counters(reset=True)
    stored, walls, wall = pipelined(
        torch, run_pipelined_buckets, buckets, lambda b: b,
        lambda b: star_photometry._dispatch_star_jobs(
            configs[b[0]["star"]["bucket"]], b, fetch="device",
            device="cuda", irfft_backend="matmul"),
        star_photometry._collect_star_results)
    runs = counters()
    check(len(stored) == 2, f"the star task stored {len(stored)} buckets")
    serial, refs = [], []
    for b, (jobs, results) in enumerate(stored):
        n_iter = configs[b]["star_deconv_n_iter"]
        arrays = star_photometry._pad_star_jobs(jobs)
        if n_iter == 2000 and all(
                np.array_equal(a, sc[k]) and a.dtype == sc[k].dtype
                for a, k in zip(arrays, ("data", "sigma", "psf"))):
            ref, against, t_ref = ref9d, "phase 9d's fit", wall9d
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = fit_stars_batched(
                *arrays, configs[b]["subsampling_factor"], n_iter=n_iter,
                starlet_global_background=True, irfft_backend="matmul")
            t_ref = time.perf_counter() - t0
            against = "a direct fit_stars_batched call"
        serial.append(t_ref)
        refs.append(ref)
        chi2 = np.array([r["chi2"] for r in results])
        bits = star_results_equal(np, results, ref, jobs)
        say(11, f"star task bucket {b + 1} (32 stars, epochs "
            f"{sorted(set(len(j['data']) for j in jobs))} padded to "
            f"{arrays[0].shape[1]}; {n_iter} iterations): {walls[b]:.3f} s "
            f"from dispatch to stored results; held to {against} "
            f"({t_ref:.3f} s alone): "
            f"{'bit-equal' if bits else 'NOT bit-equal'}; mean reduced "
            f"chi2 {chi2.mean():.4f}")
        check(bits, f"star task bucket {b + 1}: not bit-equal to {against}")
        check(all(np.all(np.isfinite(r[k])) for r in results
                  for k in ("fluxes", "fluxes_uncertainties")),
              f"star task bucket {b + 1}: non-finite fluxes or errors")
        check(0.9 <= chi2.mean() <= 1.1, f"star task bucket {b + 1}: mean "
              f"reduced chi2 {chi2.mean()} outside [0.9, 1.1]")
    iters = [c["star_deconv_n_iter"] for c in configs]
    want = (sum(iters) + 2, sum(iters), sum(iters), sum(iters))
    say(11, f"star task, 2 buckets of 32 stars (starlet background, "
        f"matmul): pipelined {wall:.3f} s against {sum(serial):.3f} s for "
        f"the buckets one by one ({wall / sum(serial):.3f}) (card {card}); "
        f"K1 launches {runs[0]}/{runs[1]}, K2 {runs[2]}/{runs[3]} "
        f"({want[0]}/{want[1]} and {want[2]}/{want[3]} expected)")
    check(runs[:4] == want, f"star task: launches {runs[:4]}, K1 n + 1 / n "
          "(one noise batch) and K2 n / n per bucket of n iterations "
          "expected")
    check(runs[4:] == runs[2:4], "star task: K2 ran without the background")

    # the second bucket checkpointed: the task deletes the file
    every = TASK_STAR_CHECKPOINT_EVERY
    ckpt = {**configs[1], "deconv_checkpoint_every": every}
    jobs = stored[1][0]
    with CheckpointWrites(optimize) as w:
        results = star_photometry._fit_star_jobs_batched(
            ckpt, jobs, device="cuda", irfft_backend="matmul")
    left = sorted(p.name for p in ckpt["checkpoints_dir"].glob("*"))
    bits = star_results_equal(np, results, refs[1], jobs)
    say(11, f"star task bucket 2 checkpointed every {every}: writes "
        f"{write_times([w])}; {'bit-equal' if bits else 'NOT bit-equal'} "
        f"to the direct call; files left {left}")
    check(w.done == list(range(every, iters[1] + 1, every)),
          f"star task: checkpoint writes at {w.done}")
    check(bits, "star task: the checkpointed bucket is not bit-equal")
    check(not left, f"star task: the checkpoint was left: {left}")
    return runs[:4]


# phase 12: the front's host bodies at one real frame (a 2048 px detector,
# ~300 stars, the example config's box count, threshold, area, stamp and
# cosmics settings)
FRONT = dict(size=2048, grid=(18, 17), fwhm=3.0, exptime=30.0, sky=10.0,
             hits=200, stamp=32, n_boxes=3, threshold=2.0, min_area=20,
             cosmics={"sigclip": 4.5, "sigfrac": 0.3, "objlim": 5.0})
FRONT_STAR_PX, FRONT_TRANSFORM_PX = 0.5, 0.05
FRONT_RECOVERED, FRONT_HITS_MASKED = 0.95, 0.90


def front_frame(np, seed=12, size=FRONT["size"], grid=FRONT["grid"],
                n_hits=FRONT["hits"]):
    """A seeded float32 frame in e-/s: a sky gradient, Gaussian stars of
    FWHM 3 px on a jittered grid (fluxes 500-5000 e-/s, 85-850 sky
    sigma at the peak), the pixel noise of its electrons, and one cosmic-ray hit
    of 1 or 2 pixels (50-200 sigma) 9-13 px from each of the first
    ``n_hits`` stars: inside its stamp, clear of its light. Returns
    (frame, stars' (x, y), hits' (y, x) pixels, each hit's star)."""
    rng = np.random.default_rng(seed)
    exptime, sky = FRONT["exptime"], FRONT["sky"]
    yy, xx = np.mgrid[0:size, 0:size]
    frame = sky + 2e-3 * xx + 1e-3 * yy
    gy, gx = grid
    step_x, step_y = size / gx, size / gy
    centres = np.array([((i + 0.5) * step_x, (j + 0.5) * step_y)
                        for j in range(gy) for i in range(gx)])
    stars = centres + rng.uniform(-0.2, 0.2, centres.shape) * (step_x, step_y)
    sigma = FRONT["fwhm"] / 2.3548
    for (x, y), flux in zip(stars, rng.uniform(500.0, 5000.0, len(stars))):
        x0, y0 = int(x) - 12, int(y) - 12
        py, px = np.mgrid[y0:y0 + 25, x0:x0 + 25]
        frame[y0:y0 + 25, x0:x0 + 25] += flux / (2 * np.pi * sigma**2) * \
            np.exp(-0.5 * ((px - x) ** 2 + (py - y) ** 2) / sigma**2)
    frame = rng.normal(frame * exptime, np.sqrt(frame * exptime)) / exptime
    sky_sigma = np.sqrt(sky * exptime) / exptime
    hits = []
    for k in range(n_hits):
        angle, radius = rng.uniform(0, 2 * np.pi), rng.uniform(9.0, 13.0)
        hy = int(round(stars[k, 1] + radius * np.sin(angle)))
        hx = int(round(stars[k, 0] + radius * np.cos(angle)))
        for dy in range(rng.integers(1, 3)):
            frame[hy + dy, hx] += rng.uniform(50.0, 200.0) * sky_sigma
            hits.append((hy + dy, hx, k))
    hits = np.array(hits)
    return frame.astype(np.float32), stars, hits[:, :2], hits[:, 2]


def phase_front(np, card, size=FRONT["size"], grid=FRONT["grid"],
                n_hits=FRONT["hits"]):
    """12, the front's host bodies on one real frame: the background
    subtraction at the example config's box count, the segmentation and
    moments at its threshold and area, the pattern matcher against a
    rotated, shifted copy of the sources, and the stamps and their masks
    of the first ``n_hits`` stars. Checks: >= 95 % of the stars found
    within 0.5 px, the transform within 0.05 px over the frame, >= 90 %
    of the cosmic-ray pixels masked. Prints each body's wall beside the
    card line (host work, no kernel of ours: the background and the
    stamps' cosmics in the host C++ of ``native/`` when it loads, whose
    first use builds it before the timers; the segmentation and moments
    in numpy and scipy)."""
    from lightcurver_tpu_torch import native
    from lightcurver_tpu_torch.io.fits import Header
    from lightcurver_tpu_torch.io.wcs import TanWCS
    from lightcurver_tpu_torch.processes.background_estimation import \
        subtract_background
    from lightcurver_tpu_torch.processes.cutout_making import (
        extract_stamp, mask_cutout)
    from lightcurver_tpu_torch.processes.star_extraction import (
        _moments, _segment)
    from lightcurver_tpu_torch.utilities.pattern_matching import (
        SimilarityTransform, find_transform)

    t0 = time.perf_counter()
    cxx = native.load() is not None
    first_use = time.perf_counter() - t0
    frame, stars, hits, hit_star = front_frame(np, size=size, grid=grid,
                                               n_hits=n_hits)
    walls = {}
    t0 = time.perf_counter()
    data_sub, bkg = subtract_background(frame, n_boxes=FRONT["n_boxes"])
    walls["subtract_background"] = time.perf_counter() - t0

    # the import's detection variance, (e-/s)^2
    variance = bkg.globalrms**2 + np.abs(data_sub) / FRONT["exptime"]
    image = np.asarray(data_sub, dtype=np.float32)
    t0 = time.perf_counter()
    labels, seg = _segment(image, variance, FRONT["threshold"],
                           FRONT["min_area"])
    rows = _moments(image, seg, labels)
    walls["segment_moments"] = time.perf_counter() - t0
    found = np.array([(r["x"], r["y"], r["flux"]) for r in rows])
    found = found[np.argsort(-found[:, 2])]
    dist = np.hypot(stars[:, None, 0] - found[None, :, 0],
                    stars[:, None, 1] - found[None, :, 1]).min(axis=1)
    recovered = float(np.mean(dist <= FRONT_STAR_PX))

    angle = np.radians(0.7)
    truth = SimilarityTransform(
        [[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]],
        [13.7, -8.2])
    rng = np.random.default_rng(1)
    copy = truth(found[:, :2]) + rng.normal(0.0, 0.01, (len(found), 2))
    t0 = time.perf_counter()
    transform, (inliers, _) = find_transform(found[:, :2], copy)
    walls["find_transform"] = time.perf_counter() - t0
    probe = np.array([(x, y) for x in (0, size - 1) for y in (0, size - 1)]
                     + [(size / 2, size / 2)], dtype=float)
    transform_px = float(np.hypot(*(transform(probe) - truth(probe)).T).max())

    scale = 0.2 / 3600.0
    wcs = TanWCS(42.2031, 19.22528, (size + 1) / 2, (size + 1) / 2,
                 [[-scale, 0.0], [0.0, scale]])
    header = Header()
    header.update(wcs.to_header_cards())
    ra, dec = wcs.pixel_to_world(stars[:n_hits, 0], stars[:n_hits, 1])
    masked = np.zeros(len(hits), bool)
    half = (FRONT["stamp"] - 1) / 2.0
    t0 = time.perf_counter()
    for k in range(n_hits):
        stamp, noise, _, centre = extract_stamp(
            data_sub, header, FRONT["exptime"], (float(ra[k]), float(dec[k])),
            FRONT["stamp"], bkg.globalrms)
        mask = mask_cutout(stamp, noise, True, True, FRONT["cosmics"])
        ix, iy = (int(round(c - half)) for c in centre)
        for i in np.flatnonzero(hit_star == k):
            masked[i] = mask[hits[i, 0] - iy, hits[i, 1] - ix]
    walls["stamps_and_masks"] = time.perf_counter() - t0
    hits_masked = float(masked.mean())

    say(12, f"front host bodies, {size} x {size} frame, {len(stars)} stars, "
        f"{len(hits)} cosmic-ray pixels (card {card}; host C++ "
        f"{'on, first use' if cxx else 'off, numpy twins, load'} "
        f"{first_use:.3f} s): "
        + ", ".join(f"{name} {wall:.3f} s" for name, wall in walls.items()))
    say(12, f"{len(rows)} sources, {recovered:.1%} of the stars within "
        f"{FRONT_STAR_PX} px; transform off by {transform_px:.2e} px over "
        f"the frame ({len(inliers)} inliers); {hits_masked:.1%} of the hit "
        f"pixels masked in {n_hits} stamps of {FRONT['stamp']} px")
    check(recovered >= FRONT_RECOVERED, f"front: only {recovered:.1%} of "
          f"the stars found within {FRONT_STAR_PX} px")
    check(transform_px <= FRONT_TRANSFORM_PX, f"front: the transform is off "
          f"by {transform_px:.3f} px")
    check(hits_masked >= FRONT_HITS_MASKED, f"front: only {hits_masked:.1%} "
          "of the cosmic-ray pixels masked")
    return walls


# the synthetic scene of tests/test_e2e_pipeline.py: 3 frames of 160 px at
# 0.2"/px, 8 stars around the ROI, two blended ROI sources, a recorded Gaia
# fixture and that test's config (the example config plus small budgets)
E2E = dict(ra=42.2031, dec=19.22528, scale=0.2 / 3600.0, size=160,
           exptime=30.0, gain=1.2, sky=10.0, n_frames=3, seed=42)
E2E_STARS = [((-6, -6), 800.0), ((6, -6), 600.0), ((-6, 6), 1000.0),
             ((6, 6), 700.0), ((8, 0), 500.0), ((0, 8), 900.0),
             ((-8, 0), 650.0), ((0, -8), 750.0)]   # offsets ("), e-/s
E2E_PS = {"A": ((-0.8, 0.5), [300.0, 360.0, 330.0]),
          "B": ((0.7, -0.6), [150.0, 120.0, 135.0])}
E2E_FWHM_PX = [2.6, 3.1, 2.8]
E2E_DITHER_PX = [(0.0, 0.0), (1.4, -0.8), (-1.1, 0.6)]
E2E_CONFIG = {
    "already_plate_solved": 1, "multiprocessing_cpu_count": 1,
    "background_estimation_n_boxes": 3, "source_extraction_threshold": 3.0,
    "source_extraction_min_area": 5, "source_extraction_do_plots": 0,
    "star_selection_strategy": "ROI_disk", "ROI_disk_radius_arcseconds": 30,
    "min_number_stars": 5, "stamp_size_stars": 16, "stamp_size_ROI": 24,
    "cosmics_masking_params": {"sigclip": 6.0, "sigfrac": 0.3,
                               "objlim": 5.0},
    "subsampling_factor": 2, "psf_n_iter_analytic": 40,
    "psf_n_iter_pixels": 150, "star_deconv_n_iter": 250,
    "roi_deconv_translations_iters": 40, "roi_deconv_all_iters": 400,
    "deconv_checkpoint_every": 100, "fix_point_source_astrometry": 0.5,
    "constraints_on_frame_columns_for_roi": {},
    "constraints_on_normalization_coeff": {},
}


def e2e_sky(np, dx, dy):
    """(ra, dec) of an offset in arcsec from the ROI."""
    return (E2E["ra"] + dx / 3600.0 / np.cos(np.radians(E2E["dec"])),
            E2E["dec"] + dy / 3600.0)


def e2e_wcs(dither_px):
    from lightcurver_tpu_torch.io.wcs import TanWCS

    c = (E2E["size"] + 1) / 2.0  # 1-based centre
    return TanWCS(E2E["ra"], E2E["dec"], c + dither_px[0], c + dither_px[1],
                  [[-E2E["scale"], 0.0], [0.0, E2E["scale"]]])


def e2e_frame(np, k, star_world, wcs):
    """Frame k's clean e-/s image: the stars and ROI sources, each an
    analytic Moffat (beta 2.8) of the frame's FWHM."""
    size, fwhm = E2E["size"], E2E_FWHM_PX[k]
    img = np.zeros((size, size))
    yy, xx = np.mgrid[0:size, 0:size]

    def add_source(x, y, flux):
        beta = 2.8
        root = np.sqrt(2.0 ** (1.0 / beta) - 1.0)
        alpha = fwhm / (2 * root)
        rr2 = (xx - x) ** 2 + (yy - y) ** 2
        norm = (beta - 1.0) / (np.pi * alpha**2)
        img[:] += flux * norm * (1.0 + rr2 / alpha**2) ** (-beta)

    for (ra, dec), flux in star_world:
        x, y = wcs.world_to_pixel(ra, dec)
        add_source(float(x), float(y), flux)
    for (dx, dy), fluxes in E2E_PS.values():
        x, y = wcs.world_to_pixel(*e2e_sky(np, dx, dy))
        add_source(float(x), float(y), fluxes[k])
    return img


def write_e2e_scene(np, root):
    """Write the e2e scene into ``root``: raw frames (ADU, float32), the
    Gaia fixture CSV, the header parser and ``config.yaml`` (the port's
    example config with ``E2E_CONFIG``). Returns (config, fixture) paths.
    Needs pandas and PyYAML."""
    import pandas as pd
    import yaml
    from lightcurver_tpu_torch.io.fits import Header, write_fits

    raw_dir = root / "raw"
    raw_dir.mkdir(parents=True)
    rng = np.random.default_rng(E2E["seed"])
    stars = []
    for i, ((dx, dy), flux) in enumerate(E2E_STARS):
        ra, dec = e2e_sky(np, dx, dy)
        gmag = 20.0 - 2.5 * np.log10(flux)
        stars.append({
            "ra": ra, "dec": dec, "source_id": 1000 + i,
            "phot_g_mean_mag": gmag, "phot_bp_mean_mag": gmag + 0.5,
            "phot_rp_mean_mag": gmag - 0.5, "pmra": 0.0, "pmdec": 0.0,
            "ref_epoch": 2016.0})
    fixture = root / "gaia_fixture.csv"
    pd.DataFrame(stars).to_csv(fixture, index=False)
    star_world = [((s["ra"], s["dec"]), flux)
                  for s, (_, flux) in zip(stars, E2E_STARS)]
    for k in range(E2E["n_frames"]):
        wcs = e2e_wcs(E2E_DITHER_PX[k])
        total_e = (e2e_frame(np, k, star_world, wcs) + E2E["sky"]) \
            * E2E["exptime"]
        adu = (total_e + rng.normal(0, np.sqrt(total_e))) / E2E["gain"]
        header = Header()
        header["MJD-OBS"] = 60000.0 + 2.0 * k
        header["EXPTIME"] = E2E["exptime"]
        header["GAIN"] = E2E["gain"]
        header.update(wcs.to_header_cards())
        write_fits(raw_dir / f"frame_{k:02d}.fits", adu.astype(np.float32),
                   header)
    (root / "header_parser").mkdir()
    (root / "header_parser" / "parse_header.py").write_text(
        "def parse_header(header):\n"
        "    return {'mjd': header['MJD-OBS'], 'gain': header['GAIN'],\n"
        "            'exptime': header['EXPTIME']}\n")
    template = (HERE / "lightcurver_tpu_torch" / "pipeline"
                / "example_config_file" / "config.yaml")
    config = yaml.safe_load(template.read_text())
    config.update(E2E_CONFIG, workdir=str(root), raw_dirs=[str(raw_dir)],
                  point_sources={ps: [float(v) for v in e2e_sky(np, *off)]
                                 for ps, (off, _) in E2E_PS.items()})
    config_path = root / "config.yaml"
    config_path.write_text(yaml.dump(config))
    return config_path, fixture


@contextmanager
def e2e_env(config, fixture):
    """LIGHTCURVER_CONFIG and LIGHTCURVER_GAIA_FIXTURE for one scene."""
    old = {k: os.environ.get(k) for k in ("LIGHTCURVER_CONFIG",
                                          "LIGHTCURVER_GAIA_FIXTURE")}
    os.environ["LIGHTCURVER_CONFIG"] = str(config)
    os.environ["LIGHTCURVER_GAIA_FIXTURE"] = str(fixture)
    try:
        yield
    finally:
        for key, value in old.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def db_rows(root):
    """Every table's rows, sorted, with the scene's root in strings made
    relative (two scenes differ only there)."""
    import sqlite3

    def value(v):
        return v.replace(str(root), "<root>") if isinstance(v, str) else v

    with sqlite3.connect(root / "database.sqlite3") as conn:
        names = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type = 'table' "
            "ORDER BY name")]
        return {name: sorted((tuple(value(v) for v in row) for row in
                              conn.execute(f"SELECT * FROM {name}")),
                             key=repr)
                for name in names}


def timed_tasks(manager):
    """Wrap ``manager.execute_task`` to record each task's wall."""
    walls = {}
    inner = manager.execute_task

    def execute(task):
        t0 = time.perf_counter()
        inner(task)
        walls[task["name"]] = time.perf_counter() - t0

    manager.execute_task = execute
    return walls


def phase_pipeline(np, torch, starlet_cuda, k2, card, work, device="cuda"):
    """13, the port's pipeline shell on the card's machine: the e2e scene
    through ``WorkflowManager(device="cuda")`` to ``query_gaia_for_stars``
    and the same through ``python -m lightcurver_tpu_torch.scripts.run``
    on a fresh copy (the same DB rows); then, where h5py is installed,
    the rest of the pipeline from ``stamp_extraction`` with the e2e test's
    invariants. Returns the K1 and K2 launches of that run. (``device``
    "cpu" runs the same on a host without a card.)"""
    import shutil
    import sqlite3

    from lightcurver_tpu_torch.pipeline.workflow_manager import \
        WorkflowManager

    root = work / "e2e"
    shutil.rmtree(root, ignore_errors=True)
    front = "query_gaia_for_stars"
    manager_dir, cli_dir = root / "manager", root / "cli"
    config, fixture = write_e2e_scene(np, manager_dir)
    cli_config, cli_fixture = write_e2e_scene(np, cli_dir)

    with e2e_env(config, fixture):
        manager = WorkflowManager(device=device)
        walls = timed_tasks(manager)
        manager.run(stop_step=front)
    say(13, f"WorkflowManager(device={device!r}).run(stop_step={front!r}) "
        f"(card {card}): " + ", ".join(f"{name} {wall:.3f} s"
                                       for name, wall in walls.items()))

    def query(sql):
        with sqlite3.connect(manager_dir / "database.sqlite3") as conn:
            return conn.execute(sql).fetchone()

    n, n_stars = E2E["n_frames"], len(E2E_STARS)
    (n_frames,) = query("SELECT COUNT(*) FROM frames")
    (solved,) = query("SELECT COUNT(*) FROM frames WHERE plate_solved = 1 "
                      "AND eliminated = 0 AND roi_in_footprint = 1")
    (stars,) = query("SELECT COUNT(*) FROM stars")
    assigned = query("SELECT COUNT(DISTINCT star_gaia_id), COUNT(*) "
                     "FROM stars_in_frames")
    say(13, f"{n_frames} frames imported, {solved} solved, kept and "
        f"holding the ROI; {stars} stars, {assigned[0]} of them in "
        f"{assigned[1]} (frame, star) pairs")
    check(n_frames == n and solved == n, "e2e: the frames were not all "
          "imported, plate-solved and kept with the ROI in their footprint")
    check(stars == n_stars and assigned == (n_stars, n * n_stars),
          "e2e: the stars were not all selected and assigned to frames")

    env = {**os.environ, "LIGHTCURVER_GAIA_FIXTURE": str(cli_fixture)}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lightcurver_tpu_torch.scripts.run",
         str(cli_config), "--stop", front, "--device", device], cwd=HERE,
        env=env, capture_output=True, text=True, timeout=600)
    cli_wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"e2e CLI failed:\n{proc.stderr[-3000:]}")
    same = db_rows(cli_dir) == db_rows(manager_dir)
    say(13, f"python -m lightcurver_tpu_torch.scripts.run --stop {front}: "
        f"{cli_wall:.3f} s wall, process start included (card {card}); "
        f"the same DB rows as the manager's run: {same}")
    check(same, "e2e: the CLI's database differs from the manager's")

    try:
        import h5py  # noqa: F401
    except ImportError as e:
        say(13, f"stopped before stamp_extraction: {e}; the tasks from "
            "stamp_extraction on (regions.h5) need h5py and did not run")
        return (0, 0, 0, 0)
    return phase_pipeline_rest(np, torch, starlet_cuda, k2, card,
                               manager_dir, config, fixture, manager, device)


def phase_pipeline_rest(np, torch, starlet_cuda, k2, card, root, config,
                        fixture, manager, device):
    """13, continued where h5py is installed: the pipeline from
    ``stamp_extraction`` to the light curves on the card, each task's wall
    and the K1 and K2 launches of the run, then the eight invariants of
    tests/test_e2e_pipeline.py."""
    import csv
    import sqlite3

    import yaml
    from lightcurver_tpu_torch.io.fits import read_fits
    from lightcurver_tpu_torch.io.wcs import TanWCS
    from lightcurver_tpu_torch.pipeline.workflow_manager import \
        WorkflowManager
    from lightcurver_tpu_torch.processes.\
        alternate_plate_solving_adapt_existing_wcs import \
        alternate_plate_solve_adapt_ref

    def query(sql):
        with sqlite3.connect(root / "database.sqlite3") as conn:
            return conn.execute(sql).fetchall()

    def edit_config(**values):
        cfg = yaml.safe_load(config.read_text())
        cfg.update(values)
        config.write_text(yaml.dump(cfg))

    n, n_stars = E2E["n_frames"], len(E2E_STARS)
    with e2e_env(config, fixture):
        walls = timed_tasks(manager)
        starlet_cuda.launches.reset()
        k2.reset()
        manager.run(start_step="stamp_extraction")
        launches = (starlet_cuda.launches.forward,
                    starlet_cuda.launches.adjoint, k2.forward, k2.backward)
        say(13, f"run(start_step='stamp_extraction') (card {card}): "
            + ", ".join(f"{name} {wall:.3f} s" for name, wall in
                        walls.items())
            + f"; launches K1 forward {launches[0]}, adjoint {launches[1]}, "
            f"K2 forward {launches[2]}, backward {launches[3]}")

        seeing = sorted(r[0] for r in query(
            "SELECT seeing_pixels FROM frames"))
        check(np.allclose(seeing, sorted(E2E_FWHM_PX), atol=0.8),
              f"e2e: seeing {seeing} off the injected FWHM")
        psf_chi2 = [r[0] for r in query("SELECT chi2 FROM PSFs")]
        check(len(psf_chi2) == n and max(psf_chi2) < 2.0,
              f"e2e: PSF chi2 {psf_chi2}")
        fluxes = query("SELECT star_gaia_id, flux, chi2 FROM "
                       "star_flux_in_frame")
        check(len(fluxes) == n * n_stars
              and max(r[2] for r in fluxes) < 2.0,
              "e2e: star fluxes missing or chi2 >= 2")
        for i, (_, flux) in enumerate(E2E_STARS):
            got = np.median([r[1] for r in fluxes if r[0] == str(1000 + i)])
            check(abs(got / flux - 1) <= 0.1, f"e2e: star {1000 + i} flux "
                  f"{got} against {flux}")
        coeffs = [r[0] for r in query(
            "SELECT coefficient FROM normalization_coefficients")]
        check(len(coeffs) == n and np.allclose(coeffs, 1.0, atol=0.05),
              f"e2e: normalization coefficients {coeffs}")
        check(len(query("SELECT * FROM absolute_zeropoints")) == n,
              "e2e: zeropoints missing")

        out_dir = root / "prepared_roi_cutouts"
        (per_epoch,) = out_dir.glob("*_photometry_per_epoch.csv")
        with open(per_epoch) as f:
            rows = list(csv.DictReader(f))
        check(len(rows) == n and all(float(r["reduced_chi2"]) < 2.0
                                     for r in rows),
              "e2e: ROI photometry rows missing or chi2 >= 2")
        dmag = []
        for ps, ((dx, dy), truth) in E2E_PS.items():
            got = np.array([float(r[f"{ps}_flux"]) for r in rows])
            check(np.allclose(got, truth, rtol=0.15),
                  f"e2e: ROI source {ps} fluxes {got} against {truth}")
            dmag += list(np.abs(2.5 * np.log10(got / truth)))
        (astrometry,) = out_dir.glob("*_astrometry.json")
        fitted = json.loads(astrometry.read_text())
        for ps, ((dx, dy), _) in E2E_PS.items():
            ra, dec = e2e_sky(np, dx, dy)
            check(abs(fitted[ps][0] - ra) * 3600 < 0.3
                  and abs(fitted[ps][1] - dec) * 3600 < 0.3,
                  f"e2e: ROI source {ps} astrometry off by > 0.3 arcsec")
        check(any(out_dir.glob("*_high_res_model.fits"))
              and any(out_dir.glob("*_stack.fits")),
              "e2e: the high-resolution model or the stacks are missing")
        check(not any((root / "checkpoints").glob("*.ckpt")),
              "e2e: a checkpoint was left behind")
        say(13, f"invariants 1-5 held: seeing {np.round(seeing, 3)}, PSF "
            f"chi2 max {max(psf_chi2):.3f}, ROI fluxes max |dmag| to the "
            f"injected {max(dmag) * 1e3:.2f} mmag")

        counts = [len(query(f"SELECT * FROM {t}")) for t in
                  ("frames", "PSFs", "star_flux_in_frame")]
        WorkflowManager(device=device).run(
            stop_step="calculate_normalization_coefficient")
        check([len(query(f"SELECT * FROM {t}")) for t in
               ("frames", "PSFs", "star_flux_in_frame")] == counts,
              "e2e: the rerun was not incremental")

        with sqlite3.connect(root / "database.sqlite3") as conn:
            conn.execute("UPDATE frames SET plate_solved = 0, "
                         "attempted_plate_solve = 0 WHERE id = 2")
        edit_config(plate_solve_frames="all_not_plate_solved",
                    reference_frame_for_wcs=1)
        alternate_plate_solve_adapt_ref()
        (relpath, solved), = query("SELECT image_relpath, plate_solved "
                                   "FROM frames WHERE id = 2")
        _, header = read_fits(root / relpath, header_only=True)
        x, y = TanWCS.from_header(header).world_to_pixel(E2E["ra"],
                                                         E2E["dec"])
        xt, yt = e2e_wcs(E2E_DITHER_PX[1]).world_to_pixel(E2E["ra"],
                                                          E2E["dec"])
        wcs_px = max(abs(float(x) - float(xt)), abs(float(y) - float(yt)))
        check(solved == 1 and wcs_px < 0.3, f"e2e: the adapted WCS is off "
              f"by {wcs_px:.3f} px")
        edit_config(plate_solve_frames="all_never_attempted",
                    reference_frame_for_wcs=None)

        edit_config(field_distortion=True, redo_psf=True,
                    psf_n_iter_analytic=20, psf_n_iter_pixels=60)
        WorkflowManager(device=device).run(start_step="psf_modeling",
                                           stop_step="psf_modeling")
        redo = [r[0] for r in query("SELECT chi2 FROM PSFs")]
        check(len(redo) == n and max(redo) < 3.0,
              f"e2e: field-distortion PSF chi2 {redo}")
        say(13, f"invariants 6-8 held: the rerun fitted nothing new, the "
            f"adapted WCS within {wcs_px:.3f} px, the field-distortion "
            f"PSFs' chi2 max {max(redo):.3f}")
    return launches


# ROI-100 (phase 5's scene, noise 0.3) is held to 1 mmag against its
# unsharded fit at 100 + 1000 iterations, where that fit's own rounding
# floor (its spread under one-ulp changes of the data) lies below the bar;
# at 50 + 300 iterations or at the shipped recipe the floor reaches it
# (PERF.md section 6; tools/torch_shard_probe.py measures it)
SHARD_ROI_BUDGET = dict(roi_deconv_translations_iters=100,
                        roi_deconv_all_iters=1000)
SHARD_PSF_BUDGET = dict(n_iter_analytic=100, n_iter_adabelief=300)
SHARD_STAR_ITERS = 300
# the scenes' sizes: ROI (epochs, px, noise), PSF (frames, stars, px),
# stars (stars, epochs, px)
SHARD_SCENES = dict(roi=(100, 64, 0.3), psf=(16, 8, 64),
                    stars=(32, 100, 24))
SHARD_TIMEOUT_S = 420

# phase 15: the single star's budget (half phase 9's: at 1000 iterations
# the starlet fit's mean reduced chi2 is 0.982 against 0.981 at 2000, on
# the CPU), its bar against the batched fit of the same star (JAX's test
# holds 1e-3, as the CPU test does; on an H100 at 2000 iterations the two
# paths measured 2.4e-7 to 4.8e-7 apart, so 1e-5 keeps a plumbing fault
# from hiding under the bar), its bar against the same fit on the CPU (on
# an H100 at 2000 iterations 1.4e-6 apart in the fluxes, the card fit's
# one-ulp floor 2.4e-7), and the optimizer options' budget
SINGLE_STAR_ITERS = 1000
SINGLE_VS_BATCHED = 1e-5
SINGLE_CARD_VS_CPU = 1e-5
OPTION_ITERS = 200

# phase 16: the iterations of each time_vg_loop, and the bar of a captured
# first step against the same step run eagerly (the same kernels on the
# same inputs)
HELPER_VG_REPS = 100
HELPER_FIRST_STEP = 1e-6


def launch_counters(starlet_cuda, k2):
    """``counters(reset=False)``: with ``reset`` sets K1's and K2's launch
    counts to 0, else reads (K1 forward, K1 adjoint, K2 forward, K2
    backward, K2 forward with h, K2 backward with h)."""
    def counters(reset=False):
        if reset:
            starlet_cuda.launches.reset()
            k2.reset()
            return None
        return (starlet_cuda.launches.forward, starlet_cuda.launches.adjoint,
                k2.forward, k2.backward, k2.forward_h, k2.backward_h)

    return counters


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def shard_fits(np, torch, mesh, counters, names, perturb=None):
    """The fits ``names`` of phase 14b on ``mesh`` ("auto": over the ranks
    of this world; None: unsharded): ``{name: (result, wall, launches)}``.
    "roi" is ROI-100 (matmul, ``SHARD_ROI_BUDGET``); "psf" PSF-16,
    "psf/R/N" the unsharded fit of the frames rank R of N fits; "stars"
    STAR-32 with the starlet background, "star1" its first star.
    ``perturb`` multiplies the PSF frames (a rounding floor)."""
    from lightcurver_tpu_torch.core.deconv.batched import fit_stars_batched
    from lightcurver_tpu_torch.core.psf.batched import build_psf_batched
    from lightcurver_tpu_torch.processes.roi_modelling import (ROI_CONFIG,
                                                               fit_roi)
    from lightcurver_tpu_torch.utilities.synthetic import (
        make_roi_scene, psf_bench_frames, star_photometry_scene)

    n_epochs, n_pix, noise = SHARD_SCENES["roi"]
    scene = make_roi_scene(n_epochs=n_epochs, n_pix=n_pix, s=2, n_sources=4,
                           seed=7, noise_sigma=noise)
    frames = psf_bench_frames(*SHARD_SCENES["psf"])
    if perturb is not None:
        frames = (frames[0] * np.float32(perturb), frames[1])
    sc = star_photometry_scene(*SHARD_SCENES["stars"], 2)

    def stars(n):
        return fit_stars_batched(
            sc["data"][:n], sc["sigma"][:n], sc["psf"][:n], sc["s"],
            n_iter=SHARD_STAR_ITERS, starlet_global_background=True,
            irfft_backend="matmul", mesh=mesh, device="cuda")

    def psf(rank=0, n_ranks=1):
        share = len(frames[0]) // n_ranks
        part = slice(rank * share, (rank + 1) * share)
        return build_psf_batched(
            frames[0][part], frames[1][part], 2, **SHARD_PSF_BUDGET,
            irfft_backend="matmul", dft_pad=16, mesh=mesh, device="cuda")

    runs = {
        "roi": lambda: fit_scene(fit_roi, {**ROI_CONFIG, **SHARD_ROI_BUDGET},
                                 scene, "cuda", "matmul", mesh=mesh),
        "psf": psf,
        "stars": lambda: stars(len(sc["data"])),
        "star1": lambda: stars(1),
    }
    for name in names:
        if name.startswith("psf/"):
            rank, n_ranks = map(int, name.split("/")[1:])
            runs[name] = lambda r=rank, n=n_ranks: psf(r, n)

    out = {}
    for name in names:
        run = runs[name]
        counters(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        out[name] = (result, time.perf_counter() - t0, counters())
    return out


def shard_arrays(np, fits):
    """The arrays of ``shard_fits``' results, flat, for an npz."""
    keys = {"roi": ("fluxes", "flux_errors", "reduced_chi2", "W"),
            "psf": ("narrow_psf", "full_psf", "chi2"),
            "stars": ("fluxes", "fluxes_uncertainties", "chi2"),
            "star1": ("fluxes", "fluxes_uncertainties", "chi2")}
    return {f"{name}.{key}": np.asarray(fits[name][0][key])
            for name in fits for key in keys[name.split("/")[0]]}


def shard_rank(rank, work):
    """One rank of phase 14b, run as ``chip_smoke.py --shard-rank``:
    bootstrap from torchrun's variables, run ``shard_fits`` on
    ``mesh="auto"``, write the results to ``work/rank{rank}.npz`` and
    print the launches and walls on one JSON line."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(HERE))
    from lightcurver_tpu_torch.ops import fused_render_cuda, starlet_cuda
    from lightcurver_tpu_torch.parallel.distributed import (
        backend_for, initialize_distributed)

    initialize_distributed()
    world = int(os.environ["WORLD_SIZE"])
    check(dist.get_rank() == rank and dist.get_world_size() == world,
          f"rank {dist.get_rank()} of {dist.get_world_size()}, expected "
          f"{rank} of {world}")
    # two ranks on one card need gloo; a card each, NCCL
    want = backend_for(world)
    check(dist.get_backend() == want, f"backend {dist.get_backend()}, "
          f"{want} expected")
    counters = launch_counters(starlet_cuda, fused_render_cuda.launches)
    fits = shard_fits(np, torch, "auto", counters,
                      ("roi", "psf", "stars", "star1"))
    np.savez(Path(work) / f"rank{rank}.npz", **shard_arrays(np, fits))
    print("SHARD " + json.dumps({
        "rank": rank, "walls": {k: v[1] for k, v in fits.items()},
        "launches": {k: v[2] for k, v in fits.items()}}), flush=True)
    dist.destroy_process_group()
    return 0


def phase_shard_one(np, torch, fit_roi, scene, ref, counters, card):
    """14a: ROI-100 through the sharded path at world 1 (NCCL), against
    phase 5b's fit; returns the launches."""
    import torch.distributed as dist
    from lightcurver_tpu_torch.parallel.distributed import \
        initialize_distributed
    from lightcurver_tpu_torch.parallel.mesh import epoch_mesh
    from lightcurver_tpu_torch.processes.roi_modelling import ROI_CONFIG

    initialize_distributed(f"localhost:{free_port()}", 1, 0)
    try:
        check(dist.get_backend() == "nccl", f"world 1 on a card: backend "
              f"{dist.get_backend()}, NCCL expected")
        counters(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit_scene(fit_roi, ROI_CONFIG, scene, "cuda", "matmul",
                        mesh=epoch_mesh())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs = counters()
    finally:
        dist.destroy_process_group()
    check_fit(np, out)
    dmag = np.abs(2.5 * np.log10(out["fluxes"] / ref["fluxes"]))
    dchi2 = np.abs(out["reduced_chi2"] / ref["reduced_chi2"] - 1)
    bits = same_bits(np, out, ref, ("fluxes", "flux_errors", "reduced_chi2",
                                    "W"))
    say("14a", f"ROI-100 fit_roi matmul on an epoch mesh of one rank (NCCL, "
        f"card {card}): {wall:.3f} s wall; K1 launches forward {runs[0]}, "
        f"adjoint {runs[1]}; K2 forward {runs[2]}, backward {runs[3]} (with "
        f"h {runs[4]}, {runs[5]}); vs phase 5b: max |dmag| "
        f"{dmag.max() * 1e3:.4f} mmag, max |dchi2|/chi2 {dchi2.max():.2e}, "
        f"bit-equal {bits}")
    check(dmag.max() <= 1e-3, "14a: fluxes differ from phase 5b by > 1 mmag")
    check(dchi2.max() <= 0.01, "14a: reduced chi2 differs from phase 5b by "
          "> 1 %")
    check(min(runs[4:6]) >= 2000, "14a: stage 2 did not run through K2 "
          "every iteration")
    return runs[:4]


def shard_expected(name, rank):
    """The exact (K1 fwd, K1 adj, K2 fwd, K2 bwd) launches of a 14b fit
    on ``rank`` (None: not gated), from its budget: K2 renders the
    rank's epochs once each way an evaluation; K1 runs on the group's
    rank 0 only for the ROI's and the star's own l1 term and noise
    weights, on every rank for the frames and stars of its share."""
    n = SHARD_STAR_ITERS
    if name == "psf":
        return (SHARD_PSF_BUDGET["n_iter_adabelief"],) * 2 + (0, 0)
    if name == "stars":
        return (n + 1, n, n, n)
    if name == "star1":
        return ((n + 1, n) if rank == 0 else (0, 0)) + (n, n)
    return None


def phase_shard_two(np, torch, counters, work, card):
    """14b: two ranks on the one card against the unsharded fits here;
    returns the launches of both ranks' fits, summed."""
    reports, wall = run_shard_ranks(work)
    return check_shard_ranks(np, torch, counters, work, reports, wall, card)


def run_shard_ranks(work, n_ranks=2):
    """Start the ranks of phase 14b (two on the card; ``n_ranks`` on as
    many cards, ``tools/torch_shard_probe.py --ranks``) and wait for them
    (killed at ``SHARD_TIMEOUT_S``); returns (their JSON reports, the
    wall)."""
    work.mkdir(parents=True, exist_ok=True)
    for old in work.glob("rank*.npz"):
        old.unlink()
    port = free_port()
    env = {**os.environ, "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port), "WORLD_SIZE": str(n_ranks),
           "LOCAL_WORLD_SIZE": str(n_ranks)}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "chip_smoke.py"), "--shard-rank",
         str(rank), str(work)],
        env={**env, "RANK": str(rank), "LOCAL_RANK": str(rank)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(HERE)) for rank in range(n_ranks)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(
                timeout=max(SHARD_TIMEOUT_S - (time.perf_counter() - t0),
                            1))[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    wall = time.perf_counter() - t0
    reports = []
    for rank, (proc, text) in enumerate(zip(procs, outputs)):
        lines = [ln for ln in text.splitlines() if ln.startswith("SHARD ")]
        check(proc.returncode == 0 and len(lines) == 1,
              f"14b: rank {rank} exited {proc.returncode}:\n{text[-3000:]}")
        reports.append(json.loads(lines[0][len("SHARD "):]))
    return reports, wall


def check_shard_ranks(np, torch, counters, work, reports, wall, card):
    """Phase 14b's gates on the ranks' results and launches; returns the
    launches of the ranks' fits, summed."""
    n_ranks = len(reports)
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(n_ranks)]
    for other in ranks[1:]:
        for key in ranks[0]:
            check(np.array_equal(ranks[0][key], other[key]),
                  f"14b: the ranks' {key} differ")
    shares = [f"psf/{r}/{n_ranks}" for r in range(n_ranks)]
    refs = shard_fits(np, torch, None, counters,
                      ("roi", "psf", *shares, "stars", "star1"))
    ref = shard_arrays(np, refs)
    res = ranks[0]
    for name in ("roi", "stars", "star1"):
        flux, chi2 = ("fluxes", "reduced_chi2") if name == "roi" \
            else ("fluxes", "chi2")
        dmag = np.abs(2.5 * np.log10(res[f"{name}.{flux}"]
                                     / ref[f"{name}.{flux}"]))
        dchi2 = np.abs(res[f"{name}.{chi2}"] / ref[f"{name}.{chi2}"] - 1)
        say("14b", f"{name}: {n_ranks} ranks vs unsharded: max |dmag| "
            f"{dmag.max() * 1e3:.4f} mmag, median "
            f"{np.median(dmag) * 1e3:.4f} mmag, max |dchi2|/chi2 "
            f"{dchi2.max():.2e}; bit-equal "
            f"{np.array_equal(res[f'{name}.{flux}'], ref[f'{name}.{flux}'])}")
        check(dmag.max() <= 1e-3, f"14b {name}: fluxes differ by > 1 mmag")
        check(dchi2.max() <= 0.01, f"14b {name}: chi2 differs by > 1 %")

    # PSF-16 is chaotic in float32 at this budget: the card's kernels run
    # a batch of 8 frames with other bits than one of 16, and a 1e-7
    # change of the data moves a frame's PSF by more than its peak (the
    # floor printed below). So the ranks are held against the unsharded
    # fit of the same frames in the same batches (each rank's share),
    # which isolates what the sharding does: pad, split, fit, gather and
    # strip; the 16-frame fit is printed beside its own floor.
    def psf_gap(a, b, key):
        peak = np.abs(b[key]).max(axis=(1, 2))
        return (np.abs(a[key] - b[key]).max(axis=(1, 2)) / peak).max()

    whole = {k: ref[f"psf.{k}"] for k in ("narrow_psf", "full_psf", "chi2")}
    same = {k: np.concatenate([ref[f"{sh}.{k}"] for sh in shares])
            for k in whole}
    got = {k: res[f"psf.{k}"] for k in whole}
    floor = shard_fits(np, torch, None, counters, ("psf",),
                       perturb=1 + 1e-7)["psf"][0]
    for key in ("narrow_psf", "full_psf"):
        gap = psf_gap(got, same, key)
        say("14b", f"psf: {n_ranks} ranks vs the unsharded fit of each "
            f"rank's frames: max |d{key}| / its frame's peak {gap:.2e}, "
            f"bit-equal {np.array_equal(got[key], same[key])}; vs the "
            f"{len(whole['chi2'])}-frame fit {psf_gap(got, whole, key):.2e}, "
            f"whose own "
            f"rounding floor (data x (1 + 1e-7)) is "
            f"{psf_gap(floor, whole, key):.2e}")
        check(gap <= 1e-2, f"14b psf: {key} differs by > 1e-2 of its peak")
    dchi2 = np.abs(got["chi2"] / same["chi2"] - 1).max()
    say("14b", f"psf: max |dchi2|/chi2 {dchi2:.2e} (vs the whole fit "
        f"{np.abs(got['chi2'] / whole['chi2'] - 1).max():.2e})")
    check(dchi2 <= 0.01, "14b psf: chi2 differs by > 1 %")
    total = [0, 0, 0, 0]
    for report in reports:
        rank = report["rank"]
        for name, runs in report["launches"].items():
            say("14b", f"rank {rank} {name}: {report['walls'][name]:.3f} s "
                f"wall (unsharded {refs[name][1]:.3f} s; card {card}); "
                f"K1 launches forward {runs[0]}, adjoint {runs[1]}; K2 "
                f"forward {runs[2]}, backward {runs[3]}")
            want = shard_expected(name, rank)
            check(want is None or tuple(runs[:4]) == want,
                  f"14b rank {rank} {name}: launches {runs[:4]}, {want} "
                  "expected")
            total = [t + r for t, r in zip(total, runs[:4])]
        roi = report["launches"]["roi"]
        n = SHARD_ROI_BUDGET["roi_deconv_all_iters"]
        check(roi[4] == roi[5] == n and min(roi[2:4]) > n,
              f"14b rank {rank} roi: K2 launches {roi[2:]}: stage 2 one each "
              "way an iteration, stage 1 some, expected")
        # the l1 term and the noise weights are rank 0's
        want = (n + 1, n) if rank == 0 else (0, 0)
        check(tuple(roi[:2]) == want, f"14b rank {rank} roi: K1 launches "
              f"{roi[:2]}, {want} expected")
    say("14b", f"{len(ranks)} ranks in {wall:.1f} s, process start "
        "included; the ranks' results equal to the bit")
    return total


def one_ulp(np, data, seed):
    """``data`` (float32) with each pixel moved one ulp up or down at
    random."""
    up = np.random.default_rng(seed).random(data.shape) < 0.5
    toward = np.where(up, np.float32(np.inf), np.float32(-np.inf))
    return np.nextafter(data, toward.astype(data.dtype))


def relative_gaps(np, a, b, index=None):
    """Max relative gap of fluxes, chi2 per frame and errors of two fits
    (``b[key][index]`` with an ``index``: a batched fit's star)."""
    return {key: float(np.max(np.abs(
        a[key] / (b[key] if index is None else b[key][index]) - 1)))
        for key in ("fluxes", "chi2_per_frame", "fluxes_uncertainties")}


def single_star_args(sc, star=0):
    return sc["data"][star], sc["sigma"][star], sc["psf"][star], sc["s"]


def phase_single_star(np, torch, sc, counters, card):
    """15a: the single-star fit against the batched fit of the same star,
    on both renders with the background fixed, then with the starlet
    background on matmul, held against the same call on the CPU (the
    plain twins) beside its floor (its gap to the card's fit of the data
    moved one ulp); returns the (K1 forward, K1 adjoint, K2 forward, K2
    backward) launches of the single-star runs counted on the main path
    (not the floor's). With the
    background fixed its loss still takes the starlet l1 of the fixed
    (zero) background, as JAX's does: K1 forward once an iteration, no
    adjoint; the batched fit skips that term and launches nothing."""
    from lightcurver_tpu_torch.core.deconv.batched import fit_stars_batched
    from lightcurver_tpu_torch.processes.star_photometry import \
        do_one_star_forward_modelling

    data, sigma, psf, s = single_star_args(sc)
    n_iter = SINGLE_STAR_ITERS

    def timed(fn, *args, **kw):
        counters(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, counters()[:4]

    total = (0, 0, 0, 0)
    for backend in ("fft", "matmul"):
        single, wall, runs = timed(
            do_one_star_forward_modelling, data, sigma, psf, s,
            n_iter=n_iter, starlet_global_background=False,
            irfft_backend=backend)
        batched, wall_b, runs_b = timed(
            fit_stars_batched, data[None], sigma[None], psf[None], s,
            n_iter=n_iter, mesh=None, irfft_backend=backend)
        gaps = relative_gaps(np, single, batched, 0)
        say("15a", f"single star ({data.shape[0]} epochs, {data.shape[-1]} "
            f"px, s {s}, {n_iter} "
            f"iterations, background fixed, {backend}): {wall:.3f} s wall, "
            f"the batched fit of the same star {wall_b:.3f} s (card {card});"
            " max relative gap single vs batched: "
            + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
        for key, gap in gaps.items():
            check(gap <= SINGLE_VS_BATCHED, f"single star ({backend}): "
                  f"{key} differs from the batched fit by {gap:.3e}")
        check(runs == (n_iter, 0, 0, 0) and runs_b == (0, 0, 0, 0),
              f"single star ({backend}): launches {runs} / batched "
              f"{runs_b}, {(n_iter, 0, 0, 0)} / none expected with the "
              "background fixed")
        total = tuple(a + b for a, b in zip(total, runs))

    out, wall, runs = timed(do_one_star_forward_modelling, data, sigma, psf,
                            s, n_iter=n_iter, irfft_backend="matmul")
    chi2 = float(np.mean(out["chi2_per_frame"]))
    dmag = np.abs(2.5 * np.log10(out["fluxes"] / sc["a_true"][0]))
    say("15a", f"single star, starlet background, matmul: {wall:.3f} s "
        f"wall (card {card}); K1 forward {runs[0]}, adjoint {runs[1]}; K2 "
        f"forward {runs[2]}, backward {runs[3]}; mean reduced chi2 "
        f"{chi2:.4f}; median |dmag| vs a_true {np.median(dmag) * 1e3:.3f} "
        "mmag")
    finite = all(np.all(np.isfinite(out[key])) for key in (
        "fluxes", "fluxes_uncertainties", "chi2_per_frame", "residuals",
        "deconvolved_image", "starlet_background", "loss_curve"))
    check(finite, "single star (starlet, matmul): non-finite outputs")
    check(0.9 <= chi2 <= 1.1, f"single star (starlet, matmul): mean reduced "
          f"chi2 {chi2} outside [0.9, 1.1]")
    want = (n_iter + 1, n_iter, n_iter, n_iter)
    check(runs == want, f"single star (starlet, matmul): launches {runs}, "
          f"{want} expected")

    t0 = time.perf_counter()
    on_cpu = do_one_star_forward_modelling(
        data, sigma, psf, s, n_iter=n_iter, irfft_backend="matmul",
        device="cpu")
    wall_cpu = time.perf_counter() - t0
    moved = do_one_star_forward_modelling(
        one_ulp(np, data, 1), sigma, psf, s, n_iter=n_iter,
        irfft_backend="matmul")
    gaps, floor = relative_gaps(np, out, on_cpu), relative_gaps(np, moved,
                                                                out)
    say("15a", f"single star, starlet background, matmul, card vs cpu "
        f"({wall_cpu:.3f} s on the card's host CPU; card {card}): max "
        "relative gap "
        + ", ".join(f"{k} {v:.3e} (one-ulp floor {floor[k]:.3e})"
                    for k, v in gaps.items()))
    for key, gap in gaps.items():
        check(gap <= SINGLE_CARD_VS_CPU, f"single star (starlet, matmul): "
              f"{key} on the card differs from the CPU fit by {gap:.3e}")
    return tuple(a + b for a, b in zip(total, runs))


def snapshot_iterations(n_iter, slots):
    """JAX's snapshot ring: every ``max(1, n // slots)`` iterations into
    slot ``min(it // every, slots - 1)`` of ``min(slots, n)``."""
    every, n_slots = max(1, n_iter // slots), min(slots, n_iter)
    out = [0] * n_slots
    for it in range(0, n_iter, every):
        out[min(it // every, n_slots - 1)] = it
    return out


def phase_optimizer_options(np, torch, sc, card):
    """15b: the Optimizer's options on the single star's problem (cuFFT,
    background fixed, as ``do_one_star_forward_modelling`` builds it)."""
    from lightcurver_tpu_torch import Loss, Optimizer, Params, setup_model
    from lightcurver_tpu_torch.core import optimize

    data, sigma, psf, s = single_star_args(sc)
    scale = float(np.max(data))
    data, sigma = data / scale, sigma / scale
    model, ki, ku, kd, kf = setup_model(
        data, sigma**2, psf, np.array([0.0]), np.array([0.0]), s,
        np.sum(data, axis=(1, 2)), device="cuda")

    def problem():
        params = Params(ki, kf, ku, kd)
        loss = Loss(data, model, params, sigma**2)
        return params, loss, Optimizer(loss, params)

    n_iter = OPTION_ITERS
    t0 = time.perf_counter()
    params, loss, optim = problem()
    _, _, plain, _ = optim.minimize(max_iterations=n_iter,
                                    restart_from_init=True)
    best, _, hist = optimize.run_adabelief(
        loss.loss_fn, params.free0, params.lower, params.upper, n_iter)
    same = np.array_equal(plain["loss_history"], hist) and all(
        torch.equal(params.best_fit_values(False)[g][k], best[g][k])
        for g in best for k in best[g])
    _, _, ph, _ = problem()[2].minimize(max_iterations=n_iter,
                                        restart_from_init=True,
                                        return_param_history=True)
    iters = ph["param_history_iterations"].tolist()
    want = snapshot_iterations(n_iter, optimize.N_PARAM_SNAPSHOTS)
    a_hist = ph["param_history"]["kwargs_analytic"]["a"]
    _, _, st, _ = problem()[2].minimize(
        max_iterations=n_iter, init_learning_rate=0.5,
        schedule_learning_rate=False, restart_from_init=True,
        stop_at_loss_increase=True, min_iterations=5)
    wall = time.perf_counter() - t0
    stop, tail = st["stopped_at"], st["loss_history"][st["stopped_at"] + 1:]
    say("15b", f"Optimizer options on the single star ({n_iter} iterations "
        f"each, cuFFT, background fixed; {wall:.2f} s for four runs, card "
        f"{card}): no option = run_adabelief to the bit: {same}; "
        f"param history {a_hist.shape[0]} snapshots, iterations "
        f"{iters[:3]}...{iters[-3:]} (JAX's rule: {iters == want}), its loss "
        f"history the plain one's to the bit: "
        f"{np.array_equal(ph['loss_history'], hist)}; stop at loss increase "
        f"(lr 0.5, min_iterations 5): stopped_at {stop}, tail of "
        f"{tail.size} constant: {bool(np.all(tail == tail[:1]))}")
    check(same, "minimize without options is not run_adabelief's bits")
    check(iters == want, f"snapshot iterations {iters}, {want} expected")
    check(a_hist.shape == (len(want), data.shape[0]), "param history of "
          f"shape {a_hist.shape}")
    check(np.array_equal(ph["loss_history"], hist), "the history with "
          "return_param_history is not the plain loop's")
    check(5 <= stop < n_iter, f"stopped_at {stop} outside [5, {n_iter})")
    check(bool(np.all(tail == tail[:1])), "the tail after the stop moves")


def phase_fisher(np, torch, out, scene, card):
    """15c: FisherCovariance on a ROI-100 fit's parameters."""
    from lightcurver_tpu_torch import (FisherCovariance, Loss, Optimizer,
                                       Params, get_flux_uncertainties)
    from lightcurver_tpu_torch.core.params import kwargs_from_numpy

    scale, model = out["scale"], out["model"]
    data = np.array(scene["data"], dtype=np.float32)
    noise = np.array(scene["sigma_2"] ** 0.5, dtype=np.float32)
    data /= scale
    noise /= scale
    params = Params(kwargs_from_numpy(out["kwargs"], "cuda"))
    loss = Loss(data, model, params, noise**2)
    t0 = time.perf_counter()
    sigmas = FisherCovariance(params, Optimizer(loss, params),
                              diagonal_only=True).get_kwargs_sigma()
    wall = time.perf_counter() - t0
    flux = sigmas["kwargs_analytic"]["a"]
    ref = get_flux_uncertainties(params.best_fit_values(), None, None, None,
                                 torch.sqrt(loss.sigma_2), model)
    rel = float(np.max(np.abs(flux * scale / out["flux_errors"].ravel()
                              - 1)))
    others = [(g, k) for g in sigmas for k in sigmas[g]
              if (g, k) != ("kwargs_analytic", "a")]
    all_nan = all(np.all(np.isnan(sigmas[g][k])) for g, k in others)
    say("15c", f"FisherCovariance on phase 5b's ROI-100 fit ({wall:.3f} s, "
        f"card {card}): {flux.size} flux sigmas, bit-equal to "
        f"get_flux_uncertainties: {np.array_equal(flux, ref)}, max relative "
        f"gap to the fit's errors {rel:.2e}; {len(others)} other leaves, "
        f"all NaN: {all_nan}")
    check(np.array_equal(flux, ref), "FisherCovariance's flux sigmas are not "
          "get_flux_uncertainties' bits")
    check(rel <= 1e-5, f"FisherCovariance vs the fit's errors: {rel:.2e}")
    check(all_nan and others, "FisherCovariance: a leaf other than the "
          "fluxes is not NaN")


def phase_native(np, card):
    """15d: the host C++ against its numpy twins on phase 12's frame;
    returns the walls {body: (C++ s, numpy s)}."""
    from lightcurver_tpu_torch import native
    from lightcurver_tpu_torch.io.fits import Header
    from lightcurver_tpu_torch.io.wcs import TanWCS
    from lightcurver_tpu_torch.processes import cosmics
    from lightcurver_tpu_torch.processes.background_estimation import (
        _mesh_stats_numpy, subtract_background)
    from lightcurver_tpu_torch.processes.cutout_making import extract_stamp
    from lightcurver_tpu_torch.processes.star_extraction import (
        _moments, _segment)

    t0 = time.perf_counter()
    lib = native.load()
    t_load = time.perf_counter() - t0
    check(lib is not None, "native.load() returned None on the card's host "
          "(it has g++)")
    frame, stars, _, _ = front_frame(np)
    size, walls = frame.shape[0], {}

    def both(name, fast, slow):
        t0 = time.perf_counter()
        a = fast()
        t1 = time.perf_counter()
        b = slow()
        walls[name] = (t1 - t0, time.perf_counter() - t1)
        return a, b

    n_boxes = FRONT["n_boxes"]
    (back, rms), (back_np, rms_np) = both(
        "background_mesh", lambda: native.background_mesh(frame, n_boxes,
                                                          n_boxes),
        lambda: _mesh_stats_numpy(frame, n_boxes, n_boxes))
    bg_gap = float(max(np.max(np.abs(back - back_np)),
                       np.max(np.abs(rms - rms_np))))

    data_sub, bkg = subtract_background(frame, n_boxes=n_boxes)
    variance = bkg.globalrms**2 + np.abs(data_sub) / FRONT["exptime"]
    image = np.asarray(data_sub, dtype=np.float32)

    def numpy_catalogue():
        labels, seg = _segment(image, variance, FRONT["threshold"],
                               FRONT["min_area"])
        return np.array([[r[k] for k in ("x", "y", "flux", "a", "b", "npix",
                                         "peak")]
                         for r in _moments(image, seg, labels)])

    rows, rows_np = both(
        "extract_sources",
        lambda: native.extract_sources(image, variance, FRONT["threshold"],
                                       FRONT["min_area"])[:, :7],
        numpy_catalogue)
    same_rows = rows.shape == rows_np.shape and np.allclose(
        rows, rows_np, rtol=1e-4, atol=1e-3) \
        and np.array_equal(rows[:, 5], rows_np[:, 5])

    scale = 0.2 / 3600.0
    wcs = TanWCS(42.2031, 19.22528, (size + 1) / 2, (size + 1) / 2,
                 [[-scale, 0.0], [0.0, scale]])
    header = Header()
    header.update(wcs.to_header_cards())
    ra, dec = wcs.pixel_to_world(stars[:FRONT["hits"], 0],
                                 stars[:FRONT["hits"], 1])
    stamps = [extract_stamp(data_sub, header, FRONT["exptime"],
                            (float(r), float(d)), FRONT["stamp"],
                            bkg.globalrms)[:2] for r, d in zip(ra, dec)]
    kw = FRONT["cosmics"]
    masks, masks_np = both(
        "detect_cosmics",
        lambda: [native.detect_cosmics(st, invar=no**2, **kw)
                 for st, no in stamps],
        lambda: [cosmics.detect_cosmics_numpy(st, invar=no**2, **kw)
                 for st, no in stamps])
    same_cosmics = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1],
                                                                     b[1])
                       for a, b in zip(masks, masks_np))
    n_masked = sum(int(m.sum()) for m, _ in masks)
    say("15d", f"native library loaded in {t_load:.2f} s (built at its "
        f"first use, phase 12); on phase 12's "
        f"{size} px frame (card's host, card {card}), C++ against numpy: "
        + ", ".join(f"{name} {c:.4f} s vs {n:.4f} s"
                    for name, (c, n) in walls.items()))
    say("15d", f"background grids max |diff| {bg_gap:.2e}; {len(rows)} "
        f"sources against {len(rows_np)}, the same rows: {same_rows}; "
        f"{len(stamps)} stamps of {FRONT['stamp']} px, {n_masked} pixels "
        f"masked, masks and cleaned stamps bit-equal: {same_cosmics}")
    check(bg_gap <= 1e-5, f"native background differs by {bg_gap:.2e}")
    check(same_rows, "native extraction: not the numpy twin's catalogue")
    check(same_cosmics, "native cosmics: not the numpy twin's bits")
    return walls


def phase_helpers(torch, card, k1_graph_ms):
    """16: the bench helpers of ``utilities/benchmarking.py`` on the card.
    16a ``time_compiled_loop`` of the starlet at (m 128, batch 1) and
    (128, 16), beside K1's own time from phases 3 and 3c
    (``k1_graph_ms``: batch -> ms); 16b ``psf_pixel_phase_cost`` at the
    PSF bench's shape and 16c ``star_fit_phase_cost`` at (8, 50, 16, 2),
    each render: bytes and FLOPs an iteration, the captured and eager
    times of ``time_vg_loop`` and the shares of the peaks. Fails on a
    non-finite value or time, a cost <= 0, a captured first step more
    than ``HELPER_FIRST_STEP`` from the same step run eagerly, or a share
    of a peak over 105 %; 16d fails unless both costs at a small shape
    count the same on the card as on the CPU. Returns the K1 and K2
    launches of the phase: the wrappers' counts, which see a captured
    launch once, plus each captured launch once more for every further
    replay."""
    from lightcurver_tpu_torch.ops.starlet_op import starlet_transform
    from lightcurver_tpu_torch.utilities import benchmarking as bench

    before = bench.launch_counts()
    replayed = [0, 0, 0, 0]

    def captured(record, label):
        first, want = record["first_value"], record["eager_first_value"]
        rel = abs(first - want) / max(abs(want), 1e-30)
        check(math.isfinite(first) and rel <= HELPER_FIRST_STEP,
              f"{label}: the captured first step {first!r} against the "
              f"eager {want!r} ({rel:.1e} relative)")
        for i, n in enumerate(record["captured_launches"]):
            replayed[i] += n * (record["replays"] - 1)
        return rel

    gen = torch.Generator().manual_seed(16)
    for batch, n_rep in ((1, 200), (16, 100)):
        img = torch.rand(batch, 128, 128, generator=gen).cuda()
        record = {}
        t = bench.time_compiled_loop(starlet_transform, img, n_rep,
                                     record=record)
        label = f"time_compiled_loop(starlet, m 128, batch {batch})"
        check(math.isfinite(t) and t > 0, f"{label}: {t!r} s")
        rel = captured(record, label)
        say("16a", f"{label}: {t * 1e3:.4f} ms an iteration (a CUDA graph "
            f"of {n_rep} iterations: K1 forward, the sum, the carry), K1 "
            f"alone {k1_graph_ms[batch]:.4f} ms (phase "
            f"{'3' if batch == 1 else '3c'}, graph_ms); first step captured "
            f"vs eager {rel:.1e}; K1 launches captured "
            f"{record['captured_launches'][0]}, replays "
            f"{record['replays']} (card {card})")

    for phase, label, make in (
            ("16b", "psf_pixel_phase_cost(16 frames x 8 stars, 64 px, s 2, "
             "dft_pad 16)",
             lambda backend: bench.psf_pixel_phase_cost(
                 16, 8, 64, 2, 16, device="cuda", irfft_backend=backend)),
            ("16c", "star_fit_phase_cost(8 stars, 50 epochs, 16 px, s 2)",
             lambda backend: bench.star_fit_phase_cost(
                 8, 50, 16, 2, device="cuda", irfft_backend=backend))):
        for backend in ("fft", "matmul"):
            (n_bytes, flops), (vg, free, consts) = make(backend)
            what = f"{label}, {backend}"
            check(all(math.isfinite(x) and x > 0 for x in (n_bytes, flops)),
                  f"{what}: cost {n_bytes!r} bytes, {flops!r} FLOPs")
            record = {}
            t_graph = bench.time_vg_loop(vg, free, consts, HELPER_VG_REPS,
                                         record=record)
            t_eager = bench.time_vg_loop(vg, free, consts, HELPER_VG_REPS,
                                         eager=True)
            check(all(math.isfinite(t) and t > 0 for t in (t_graph,
                                                            t_eager)),
                  f"{what}: times {t_graph!r}, {t_eager!r} s")
            rel = captured(record, what)
            bytes_share = n_bytes / t_graph / HBM_BYTES_PER_S
            flops_share = flops / t_graph / FP32_FLOPS
            check(max(bytes_share, flops_share) <= 1.05,
                  f"{what}: {bytes_share:.1%} of the memory rate, "
                  f"{flops_share:.1%} of the fp32 peak")
            say(phase, f"{what}: {n_bytes:.6g} bytes, {flops:.6g} FLOPs an "
                f"iteration (compiled_cost); time_vg_loop of "
                f"{HELPER_VG_REPS}: {t_graph * 1e3:.4f} ms captured, "
                f"{t_eager * 1e3:.4f} ms eager ({1 - t_graph / t_eager:.1%} "
                f"of the eager iteration is what the graph removes); bytes "
                f"/ captured time {bytes_share:.2%} of 3.35 TB/s, FLOPs "
                f"{flops_share:.2%} of 67 TFLOP/s fp32; first step captured "
                f"vs eager {rel:.1e}; K1, K2 launches captured "
                f"{record['captured_launches']} (card {card})")
    # autograd runs a CUDA backward on its device thread: the count must
    # see those ops as it sees the CPU's, which run on the calling thread
    for label, make in (
            ("psf_pixel_phase_cost(2, 3, 16, 2)",
             lambda device, backend: bench.psf_pixel_phase_cost(
                 2, 3, 16, 2, device=device, irfft_backend=backend)),
            ("star_fit_phase_cost(2, 4, 8, 2)",
             lambda device, backend: bench.star_fit_phase_cost(
                 2, 4, 8, 2, device=device, irfft_backend=backend))):
        for backend in ("fft", "matmul"):
            on_card, on_cpu = (make(device, backend)[0]
                               for device in ("cuda", "cpu"))
            say("16d", f"{label}, {backend}: card {on_card[0]:.6g} bytes, "
                f"{on_card[1]:.6g} FLOPs; cpu {on_cpu[0]:.6g} bytes, "
                f"{on_cpu[1]:.6g} FLOPs")
            check(on_card == on_cpu, f"{label}, {backend}: the card's count "
                  f"{on_card} is not the CPU's {on_cpu}")
    say(16, "make_psf_task_workdir writes an HDF5 file through h5py, "
        "which this machine lacks: it is held against JAX's on a CPU host "
        "(tests/test_torch_benchmarking.py), not here")
    return tuple(b - a + r for a, b, r in zip(before, bench.launch_counts(),
                                             replayed))


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

    started = time.perf_counter()

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
    from lightcurver_tpu_torch.core.deconv.batched import fit_stars_batched
    from lightcurver_tpu_torch.core.deconv.model import setup_model
    from lightcurver_tpu_torch.core.psf.batched import build_psf_batched
    from lightcurver_tpu_torch.ops import (cuda_build, enforce_fp32,
                                           fused_render, fused_render_cuda,
                                           starlet_cuda)
    from lightcurver_tpu_torch.core import optimize
    from lightcurver_tpu_torch.processes import (psf_modelling,
                                                 star_photometry)
    from lightcurver_tpu_torch.processes.roi_modelling import (
        ROI_CONFIG, fit_roi, roi_checkpoint_digest)
    from lightcurver_tpu_torch.utilities.synthetic import (
        make_roi_scene, psf_bench_frames, psf_pixel_phase_point,
        star_k2_operands, star_photometry_scene)

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
    k1_3c, k1_3c_ms = phase_k1_at(torch, starlet_cuda, plain, card, "3c",
                                  128, 16)
    errs = [k1_3c]
    roi = k2_operands(torch, setup_model,
                      make_roi_scene(n_epochs=100, n_pix=64, s=2,
                                     n_sources=4, seed=11), seed=64)
    errs.append(phase_k2_stars(torch, fused_render_cuda, fused_render,
                               star_k2_operands, roi, card))
    errs += [phase_k1_at(torch, starlet_cuda, plain, card, "3d", 48,
                         batch)[0]
             for batch in (32, 6400, 1, 200)]
    for found in errs:
        for name, err in found.items():
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                               err)

    # noise 0.03, not the default 0.3: at 0.3 the float32 loss pins the
    # faintest epoch's flux only to ~1 mmag (0.02 sigma), so a relative
    # 1e-7 change of the data alone moves it by 1.0 mmag on the CPU and
    # the comparison would measure that, not the device; at 0.03 the
    # same change moves the fluxes by 0.13 mmag at most
    small = make_roi_scene(n_epochs=16, n_pix=32, s=2, n_sources=4, seed=3,
                           noise_sigma=0.03)
    small_config = {**ROI_CONFIG, **SMALL_ROI_BUDGET}
    card_vs_cpu(np, fit_roi, small_config, small, "fft", 4)
    card_vs_cpu(np, fit_roi, small_config, small, "matmul", "4b")

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
    k2_fwd, k2_bwd = k2.forward, k2.backward
    noise_launches = n_fwd_mm - n_adj_mm

    for backend, phase in (("fft", 6), ("matmul", "6b")):
        phase_psf_small(np, build_psf_batched, psf_bench_frames,
                        psf_pixel_phase_point, starlet_cuda, backend, phase)
    psf_fits = [phase_psf_full(np, torch, build_psf_batched,
                               psf_bench_frames, starlet_cuda, backend,
                               phase, card)
                for backend, phase in (("fft", 7), ("matmul", "7b"))]
    k1_psf = [runs for runs, _, _ in psf_fits]
    for backend, phase in (("fft", 8), ("matmul", "8b")):
        phase_star_small(np, fit_stars_batched, star_photometry_scene,
                         starlet_cuda, k2, backend, phase)
    stars = star_photometry_scene(32, 100, 24, 2)
    star_fits = [phase_star_full(np, torch, fit_stars_batched, stars,
                                 starlet_cuda, k2, backend, starlet, phase,
                                 card)
                 for starlet, backend, phase in (
                     (False, "fft", 9), (False, "matmul", "9b"),
                     (True, "fft", "9c"), (True, "matmul", "9d"))]
    star_runs = [runs for runs, _, _ in star_fits]

    counters = launch_counters(starlet_cuda, k2)
    work = HERE / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    resumed_runs = [
        phase_roi_resumed(np, torch, fit_roi, roi_checkpoint_digest,
                          optimize, ROI_CONFIG, scene, counters,
                          (out_mm, wall_mm, stage1), noise_launches, work,
                          card),
        phase_star_resumed(np, torch, fit_stars_batched, optimize, stars,
                           counters, star_fits[3][1:], work, card)]
    phase_bits(np, torch, fit_roi, optimize, ROI_CONFIG, small, work)
    task_runs = [
        phase_psf_task(np, torch, psf_modelling, build_psf_batched,
                       psf_bench_frames, starlet_cuda, psf_fits[0][1:],
                       card),
        phase_star_task(np, torch, star_photometry,
                        psf_modelling.run_pipelined_buckets,
                        fit_stars_batched, star_photometry_scene, optimize,
                        stars, counters, star_fits[3][1:], work, card)]
    phase_front(np, card)
    pipeline_run = phase_pipeline(np, torch, starlet_cuda, k2, card, work)
    # NCCL bootstraps over this host's loopback: one host, one card
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    shard_runs = [phase_shard_one(np, torch, fit_roi, scene, out_mm,
                                  counters, card),
                  phase_shard_two(np, torch, counters, work / "shard", card)]
    t0 = time.perf_counter()
    single_run = phase_single_star(np, torch, stars, counters, card)
    phase_optimizer_options(np, torch, stars, card)
    phase_fisher(np, torch, out_mm, scene, card)
    phase_native(np, card)
    say(15, f"phase 15 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    helper_run = phase_helpers(torch, card, {
        1: records["starlet_forward"]["ms"],
        16: k1_3c_ms["starlet_forward"]})
    say(16, f"phase 16 took {time.perf_counter() - t0:.1f} s; launches K1 "
        f"forward {helper_run[0]}, adjoint {helper_run[1]}, K2 forward "
        f"{helper_run[2]}, backward {helper_run[3]} (graph replays "
        f"counted); chip_smoke.py so far {time.perf_counter() - started:.1f} "
        "s")
    # launches over every run of the main path: ROI-100 and the
    # full-width PSF fit on both renders, the full-width star fits, the
    # checkpointed ROI-100 and star fits with their replayed segments,
    # the PSF and star tasks' pipelined buckets, the pipeline run of
    # phase 13 from stamp_extraction (none where h5py is missing), the
    # sharded fits of phase 14 (both ranks of 14b), the single-star fit of
    # phase 15a, and the helpers' loops of phase 16 with their replays
    main_runs = star_runs + resumed_runs + task_runs + [pipeline_run] \
        + shard_runs + [single_run, helper_run]
    n_fwd += n_fwd_mm + sum(f for f, _ in k1_psf) \
        + sum(r[0] for r in main_runs)
    n_adj += n_adj_mm + sum(a for _, a in k1_psf) \
        + sum(r[1] for r in main_runs)
    k2_fwd += sum(r[2] for r in main_runs)
    k2_bwd += sum(r[3] for r in main_runs)

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
            k2_fwd),
        # the JAX kernel's VJP was planned there and never built
        "fused_render_backward": (
            "fused_render.cu",
            "lightcurver_tpu/ops/experimental/fused_render.py:20",
            k2_bwd),
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
    if sys.argv[1:2] == ["--shard-rank"]:
        sys.exit(shard_rank(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
