"""Frame-batched narrow-PSF fitting: ``build_psf_batched``.

Twin of ``lightcurver_tpu/core/psf/batched.py``. The JAX package writes
the two-phase fit for one frame and vmaps it over the frame axis; here
the same fit runs on tensors with a leading frame axis F, through the
frame-batched optimizers of ``core/optimize.py``. Every frame is an
independent problem: its own scale, noise weights, line search and best
loss. Frames with fewer stars are padded with fully masked dummy stars,
which drop out of the chi2 and of the noise-weight statistics.

The starlet l1 of all F frames is one K1 launch forward and one adjoint
per phase-2 loss evaluation (``ops.starlet_op``).

Under several ranks (``parallel/``) the frames are padded and split over
a ``batch`` mesh: each rank fits its frames alone, K1 at the local batch
(so the wrapper's cluster size may differ from the unsharded fit's), and
the results are all-gathered to every rank and stripped.
"""

import numpy as np
import torch

from ..optimize import run_adabelief_batched, run_lbfgsb_batched
from ..params import kwargs_to_numpy
from ..starlet import n_starlet_scales
from ...ops import enforce_fp32
from ...parallel.batch import (BATCH_AXIS, auto_batch_mesh, gather_to_host,
                               pad_batch_arrays, strip_batch)
from ...parallel.mesh import resolve_mesh
from .build import (_grid_noise_weights_closed, _masked_chi2_per_star,
                    phase_losses, psf_bound_values, psf_dft_mats)
from .distortion import DISTORTION_BASIS_SIZE, zero_distortion_kwargs


def _bounds(n_stars, n_pix, m, device):
    """(lower, upper) trees of per-frame shapes, from psf_bound_values."""
    kwargs_up, kwargs_down = psf_bound_values(n_pix)
    shapes = {
        "kwargs_moffat": {"fwhm_x": (), "fwhm_y": (), "beta": ()},
        "kwargs_gaussian": {"a": (n_stars,), "x0": (n_stars,),
                            "y0": (n_stars,)},
        "kwargs_background": {"background": (m * m,)},
        "kwargs_distortion": {k: (DISTORTION_BASIS_SIZE,)
                              for k in ("dilation_x", "dilation_y",
                                        "shear")},
    }

    def broadcast(values):
        return {group: {key: torch.full(shapes[group][key],
                                        float(values[group][key]),
                                        dtype=torch.float32, device=device)
                        for key in keys}
                for group, keys in shapes.items()}

    return broadcast(kwargs_down), broadcast(kwargs_up)


def _subset(tree, like):
    """The groups of ``tree`` named in ``like``."""
    return {k: tree[k] for k in like}


def _fit_frames(data, noisemap, masks, stamp_coords, fwhm0, n_pix, s,
                field_distortion, n_iter_analytic, n_iter_adabelief,
                regularization_strength, adabelief_lr, dft_mats):
    """The two-phase fit of F frames; tensors in, tensors out."""
    n_frames, n_stars = data.shape[:2]
    device = data.device
    model, loss_moffat, loss_pixels = phase_losses(
        n_stars, n_pix, s, field_distortion)
    m = n_pix * s

    scale = torch.where(masks, data, torch.full_like(data, -float("inf"))) \
        .amax(dim=(1, 2, 3))
    scale = torch.where(torch.isfinite(scale) & (scale > 0), scale,
                        torch.ones_like(scale))
    per_pixel = scale[:, None, None, None]
    d = torch.nan_to_num(data / per_pixel)
    sig = torch.nan_to_num(noisemap / per_pixel, nan=1e8)
    # masked pixels: unit variance, so a zero-noise padding convention
    # cannot give inf partials whose zero-cotangent VJP is NaN
    sigma_2 = torch.where(masks, sig**2, torch.ones_like(sig))
    # fully masked stars are dummy padding: kept out of the statistics
    star_valid = masks.any(dim=-1).any(dim=-1)

    fwhm0 = torch.clamp(fwhm0, 1.2, 0.45 * n_pix)
    a0 = torch.clamp(torch.where(masks, d, torch.zeros_like(d)).sum(
        dim=(2, 3)), min=1e-3)
    zeros = torch.zeros(n_frames, dtype=torch.float32, device=device)
    lower, upper = _bounds(n_stars, n_pix, m, device)
    distortion0 = zero_distortion_kwargs((n_frames,), device=device)
    base_consts = {"data": d, "sigma_2": sigma_2, "masks": masks,
                   "stamp_coordinates": stamp_coords, "dft_mats": dft_mats}

    # ---- phase 1: Moffat (grid and distortion fixed) -------------------
    free1 = {"kwargs_moffat": {"fwhm_x": fwhm0, "fwhm_y": fwhm0.clone(),
                               "beta": zeros + 2.5},
             "kwargs_gaussian": {"a": a0,
                                 "x0": torch.zeros_like(a0),
                                 "y0": torch.zeros_like(a0)}}
    consts1 = {**base_consts, "fixed": {
        "kwargs_background": {"background": torch.zeros(
            n_frames, m * m, dtype=torch.float32, device=device)},
        "kwargs_distortion": distortion0}}
    best1, _, hist1 = run_lbfgsb_batched(
        lambda free: loss_moffat(free, consts1), free1,
        _subset(lower, free1), _subset(upper, free1), n_iter_analytic)

    # ---- phase 2: pixel grid (+ distortion), Moffat fixed ---------------
    free2 = {"kwargs_gaussian": best1["kwargs_gaussian"],
             "kwargs_background": {"background": torch.zeros(
                 n_frames, m * m, dtype=torch.float32, device=device)}}
    fixed2 = {"kwargs_moffat": best1["kwargs_moffat"]}
    if field_distortion:
        free2["kwargs_distortion"] = distortion0
    else:
        fixed2["kwargs_distortion"] = distortion0

    # noise median over REAL stars only (NaN noise pixels excluded), over
    # the mean amplitude of the real stars
    with torch.no_grad():
        sig_w = torch.where(torch.isfinite(noisemap), noisemap / per_pixel,
                            torch.full_like(noisemap, float("nan")))
        sig_w = torch.where(star_valid[:, :, None, None], sig_w,
                            torch.full_like(sig_w, float("nan")))
        sigma_med = torch.nanquantile(sig_w, 0.5, dim=1)
        n_valid = torch.clamp(star_valid.sum(dim=1), min=1)
        mean_amp = torch.where(star_valid, a0, torch.zeros_like(a0)).sum(
            dim=1) / n_valid
        sigma_med = sigma_med / torch.clamp(mean_amp, min=1e-12)[:, None,
                                                                 None]
        W = _grid_noise_weights_closed(sigma_med, m, s, n_starlet_scales(m),
                                       dft_mats)
    consts2 = {**base_consts, "W": W,
               "lam": torch.tensor(float(regularization_strength),
                                   dtype=torch.float32, device=device),
               "fixed": fixed2}
    best2, _, hist2 = run_adabelief_batched(
        lambda free: loss_pixels(free, consts2), free2,
        _subset(lower, free2), _subset(upper, free2), n_iter_adabelief,
        init_learning_rate=adabelief_lr, schedule_learning_rate=True)

    kwargs_final = {**fixed2, **best2}
    with torch.no_grad():
        narrow = model.narrow_psf(kwargs_final)
        full = model.full_psf(kwargs_final, dft_mats=dft_mats)
        model_imgs = model.model(kwargs_final, stamp_coords, dft_mats)
        chi2_per_star = _masked_chi2_per_star(d, model_imgs, sigma_2, masks)
        has_data = masks.sum(dim=(2, 3)) > 0
        chi2 = torch.where(has_data, chi2_per_star,
                           torch.zeros_like(chi2_per_star)).sum(dim=1) \
            / torch.clamp(has_data.sum(dim=1), min=1)
    return {
        "narrow_psf": narrow,
        "full_psf": full,
        "chi2": chi2,
        "chi2_per_star": chi2_per_star,
        "scale": scale,
        "kwargs_moffat": kwargs_final["kwargs_moffat"],
        "kwargs_distortion": kwargs_final["kwargs_distortion"],
        "residuals": per_pixel * (d - model_imgs),
        "loss_history_analytic": hist1,
        "loss_history_pixels": hist2,
    }


def build_psf_batched(images, noisemaps, subsampling_factor, masks=None,
                      stamp_coordinates=None, guess_fwhm_pixels=None,
                      n_iter_analytic=100, n_iter_adabelief=3000,
                      field_distortion=False, regularization_strength=1.0,
                      adabelief_lr=5e-4, seed=0, mesh="auto", fetch="numpy",
                      dft_pad=None, *, device="cuda", irfft_backend="fft"):
    """Fit the narrow PSFs of many frames at once.

    Args:
        images: (F, N, n, n) star stamps: F frames, N stars each (pad
            missing stars with zeros and masks=False; masked pixels get
            unit variance, so any noise padding value works).
        noisemaps: (F, N, n, n) noise sigmas.
        subsampling_factor: int s.
        masks: (F, N, n, n) bool, True = good pixel; composed with the
            finite guard of images and noise.
        stamp_coordinates: (F, N, 2) rescaled star positions (distortion).
        guess_fwhm_pixels: (F,) per-frame seeing guess (NaN: 3 px).
        seed: accepted and unused, as in JAX: the grid's noise weights
            are in closed form and draw nothing.
        device: torch device of the fit ("cuda" unless the caller asks
            for the CPU; there is no fallback).
        irfft_backend, dft_pad: the render, as for
            :func:`..build.build_psf`.
        mesh: "auto" (default) shards the frame axis over every rank when
            ``torch.distributed`` has more than one
            (``parallel.batch.auto_batch_mesh``; the per-frame fits are
            independent, so no collective runs until the results are
            gathered); None forces the unsharded fit; or an explicit 1-D
            ``batch`` mesh. Frame counts that do not divide the mesh are
            padded with duplicate frames, stripped from the result. Above
            one rank the render is "matmul", as JAX forces "mxu".
        fetch: "numpy" (default) returns host arrays; "device" returns
            the tensors on the device, unsynchronised, so the caller can
            queue more work before reading them (on the host, gathered,
            under a mesh of several ranks).

    Returns:
        dict of stacked per-frame results: narrow_psf, full_psf, chi2,
        chi2_per_star, scale, kwargs_moffat, kwargs_distortion, residuals,
        loss_history_analytic, loss_history_pixels.
    """
    enforce_fp32()
    if fetch not in ("numpy", "device"):
        raise ValueError(f"fetch={fetch!r}: 'numpy' or 'device' expected")
    images = np.asarray(images, dtype=np.float32)
    noisemaps = np.asarray(noisemaps, dtype=np.float32)
    n_frames, n_stars, n_pix = images.shape[:3]
    if masks is None:
        masks = np.isfinite(images)
    else:
        # compose with, never replace, the finite guard: a NaN pixel
        # marked good would enter as a zero-flux measurement
        masks = np.asarray(masks, dtype=bool) & np.isfinite(images) \
            & np.isfinite(noisemaps)
    if stamp_coordinates is None:
        stamp_coordinates = np.zeros((n_frames, n_stars, 2), np.float32)
    if guess_fwhm_pixels is None:
        guess_fwhm_pixels = np.full((n_frames,), 3.0, np.float32)
    guess_fwhm_pixels = np.where(np.isfinite(guess_fwhm_pixels),
                                 guess_fwhm_pixels, 3.0)

    def on(x, dtype=np.float32):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=dtype),
                               device=device)

    mesh = resolve_mesh(mesh, auto_batch_mesh)
    arrays = (images, noisemaps, masks, stamp_coordinates, guess_fwhm_pixels)
    sharded = mesh is not None and mesh.size() > 1
    n_pad = 0
    if mesh is not None:
        if tuple(mesh.mesh_dim_names or ()) != (BATCH_AXIS,):
            raise ValueError("build_psf_batched shards frames over a 1-D "
                             f"'{BATCH_AXIS}' mesh, not "
                             f"{mesh.mesh_dim_names}")
        arrays, n_pad = pad_batch_arrays(mesh, *arrays)
    if sharded:
        irfft_backend = "matmul"
    images, noisemaps, masks, stamp_coordinates, guess_fwhm_pixels = arrays
    s = int(subsampling_factor)
    out = _fit_frames(
        on(images), on(noisemaps), on(masks, bool), on(stamp_coordinates),
        on(guess_fwhm_pixels), int(n_pix), s, bool(field_distortion),
        int(n_iter_analytic), int(n_iter_adabelief),
        float(regularization_strength), float(adabelief_lr),
        psf_dft_mats(int(n_pix) * s, s, irfft_backend, dft_pad, device))
    if mesh is not None:
        out = strip_batch(gather_to_host(mesh, out), n_pad)
    if fetch == "device":
        return out
    return kwargs_to_numpy(out)
