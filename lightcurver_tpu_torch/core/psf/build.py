"""Two-phase narrow-PSF fit: ``build_psf``.

Twin of ``lightcurver_tpu/core/psf/build.py``:

    phase 1: bounded L-BFGS on the analytic Moffat (+ per-star fluxes and
             sub-pixel positions), ``n_iter_analytic`` iterations;
    phase 2: AdaBelief on the free pixel grid (+ fluxes, positions, and
             optionally the field-distortion polynomials),
             ``n_iter_adabelief`` iterations, with a starlet-l1 term whose
             per-coefficient weights are the closed-form propagation of
             the data noise onto the grid.

Masked pixels are excluded from the chi2 by weight, and the reduced chi2
is computed per star over unmasked pixels only.

The losses (:func:`phase_losses`) take any leading batch shape B of
frames, so the frame-batched fit (``batched.py``) uses the same ones. The
starlet of the l1 term runs through ``ops.starlet_op``: the K1 kernels of
``csrc/starlet.cu`` forward and adjoint on a CUDA tensor, their plain
twins on a CPU tensor; B frames are one launch.

Numbers: fit times quoted for this module in PERF.md were taken on an
NVIDIA H100 and carry the card's name and power limit; no TPU figure
applies here.
"""

import math

import numpy as np
import torch

from ..grids import upsample_transpose
from ..noise import epoch_nanmedian
from ..optimize import run_adabelief, run_lbfgsb
from ..params import Params, kwargs_to_numpy, merge_free
from ..starlet import n_starlet_scales
from .. import convolution as conv
from ...ops import check_irfft_backend, dft, enforce_fp32
from ...ops.starlet_op import starlet_transform
from .distortion import zero_distortion_kwargs
from .model import PSFModel, mats_length


def _masked_chi2_per_star(data, model_imgs, sigma_2, masks):
    res2 = (data - model_imgs) ** 2 / sigma_2
    res2 = torch.where(masks, res2, torch.zeros_like(res2))
    good = masks.sum(dim=(-2, -1))
    return res2.sum(dim=(-2, -1)) / torch.clamp(good, min=1)


def _abs(x):
    """|x| with derivative +1 at 0, as ``jnp.abs``."""
    return torch.where(x >= 0, x, -x)


def phase_losses(n_stars, n_pix, s, field_distortion):
    """The model and the two phase losses of one fit geometry.

    Each loss is ``loss(free, consts) -> B`` (a scalar for one frame);
    ``consts`` holds data, sigma_2, masks, stamp_coordinates, dft_mats
    (None for cuFFT), fixed (the fixed parameters) and, for phase 2, W
    and lam.
    """
    model = PSFModel(n_stars, n_pix, s, field_distortion=field_distortion)
    m = n_pix * s
    n_sc = n_starlet_scales(m)

    def pin_term(kwargs, consts):
        # pin the FIRST star with any unmasked pixel (breaks the global
        # shift degeneracy between the stars' offsets and the grid), as a
        # one-hot weighted sum, as in JAX
        kg = kwargs["kwargs_gaussian"]
        valid = consts["masks"].any(dim=-1).any(dim=-1)
        first = (valid & (torch.cumsum(valid, dim=-1) == 1)).to(
            kg["x0"].dtype)
        px = (first * kg["x0"]).sum(-1)
        py = (first * kg["y0"]).sum(-1)
        return 0.5 * ((px / 1e-3) ** 2 + (py / 1e-3) ** 2)

    def data_term(kwargs, consts):
        imgs = model.model(kwargs, consts["stamp_coordinates"],
                           consts["dft_mats"])
        chi2 = _masked_chi2_per_star(consts["data"], imgs,
                                     consts["sigma_2"], consts["masks"])
        return 0.5 * chi2.sum(-1) * n_pix**2 + pin_term(kwargs, consts)

    def loss_moffat(free, consts):
        return data_term(merge_free(free, consts["fixed"]), consts)

    def loss_pixels(free, consts):
        kwargs = merge_free(free, consts["fixed"])
        g = kwargs["kwargs_background"]["background"]
        g = g.reshape(*g.shape[:-1], m, m)
        # l1 with per-coefficient noise weights: soft-thresholding at
        # ~lambda sigma_coeff (starlet k-sigma denoising)
        coeffs = starlet_transform(g.contiguous(), n_scales=n_sc)
        reg = consts["lam"] * (consts["W"][..., :-1, :, :]
                               * _abs(coeffs[..., :-1, :, :])).sum(
                                   dim=(-3, -2, -1))
        return data_term(kwargs, consts) + reg

    return model, loss_moffat, loss_pixels


def _grid_noise_weights_impl(sigma, m, s, num_samples, n_scales, generator,
                             dft_mats=None):
    """Monte-Carlo per-scale noise std of the grid's starlet coefficients.

    The operator from the grid to the stamps is ``a_i down(conv(g, r))``;
    its adjoint applied to noise realizations gives the coefficient noise
    (ddof 0 over samples, floored at 1e-12). The standard-normal draws come
    from ``generator`` on the CPU and move to sigma's device. No fit calls
    this: it is the oracle of :func:`_grid_noise_weights_closed`, as in
    the JAX package's tests.
    """
    L = mats_length(dft_mats) or conv.pad_len(m)
    r_hat = conv.r_kernel_fft(m, s, device=sigma.device, L=L)
    sigma = torch.where(torch.isfinite(sigma), sigma,
                        torch.zeros_like(sigma))
    draws = torch.randn((int(num_samples),) + tuple(sigma.shape),
                        generator=generator).to(sigma.device)
    fine = upsample_transpose(sigma * draws, s)
    if dft_mats is not None:
        back = dft.irfft2_crop_matmul(
            dft.rfft2_pad_matmul(fine, dft_mats) * r_hat, dft_mats)
    else:
        fine_hat = torch.fft.rfft2(fine, s=(L, L))
        back = torch.fft.irfft2(fine_hat * torch.conj(r_hat),
                                s=(L, L))[..., :m, :m]
    coeffs = starlet_transform(back.contiguous(), n_scales=n_scales)
    return torch.clamp(torch.std(coeffs, dim=0, correction=0), min=1e-12)


def _starlet_transfer_fns(L, n_scales, device=None):
    """Fourier transfer functions of the starlet scales at length L.

    The separable B3 a-trous smoothing at dilation d has the 1-D transfer
    (6 + 8 cos(w d) + 2 cos(2 w d)) / 16; detail scale j is
    C_j (1 - S_{2^j}) with C_j the product of the coarser smoothings.
    Returns (n_scales + 1, L, L//2+1), coarse last, all real.
    """
    wy = 2.0 * math.pi * torch.fft.fftfreq(L, device=device)[:, None]
    wx = 2.0 * math.pi * torch.fft.rfftfreq(L, device=device)[None, :]

    def smooth_1d(w, d):
        return (6.0 + 8.0 * torch.cos(w * d) + 2.0 * torch.cos(2.0 * w * d)) \
            / 16.0

    out = []
    c = torch.ones(L, L // 2 + 1, device=device)
    for j in range(n_scales):
        d = float(2**j)
        s_j = smooth_1d(wy, d) * smooth_1d(wx, d)
        out.append(c * (1.0 - s_j))
        c = c * s_j
    out.append(c)
    return torch.stack(out)


def _grid_noise_weights_closed(sigma, m, s, n_scales, dft_mats=None):
    """Closed-form per-scale starlet coefficient noise of the PSF grid.

    The map from data noise to the starlet coefficients of the
    r-correlated, block-repeated field is linear, so the coefficient
    variance is exact:

        Var_j[p] = sum_q b_j(p - s q)^2 sigma_q^2
                 = conv(zero_insert(sigma^2), b_j^2)[p],

    with b_j = (starlet_j kernel) * r * (s x s box), the box summing the
    block repeat of upsample_transpose. The chain is modelled as circular
    convolutions on the padded L-grid (the Monte-Carlo oracle applies the
    mirror-boundary starlet to the m-grid, so the coarse scales differ
    near the borders). ``sigma``: B + (n, n); returns B + (J+1, m, m).
    The squared-kernel spectra are computed once for all frames; the
    per-frame part is one forward and (J+1) inverse transforms, on cuFFT
    or on the matmul DFT of ``dft_mats``.
    """
    L = mats_length(dft_mats) or conv.pad_len(m)
    device = sigma.device
    r_hat = conv.r_kernel_fft(m, s, device=device, L=L)
    sigma = torch.where(torch.isfinite(sigma), sigma,
                        torch.zeros_like(sigma))

    # frame-invariant squared-kernel spectra (n_scales+1, L, L//2+1)
    d_hat = _starlet_transfer_fns(L, n_scales, device=device)
    wy = 2.0 * math.pi * torch.fft.fftfreq(L, device=device)[:, None]
    wx = 2.0 * math.pi * torch.fft.rfftfreq(L, device=device)[None, :]

    def box_1d(w):
        re = sum(torch.cos(w * k) for k in range(s))
        im = -sum(torch.sin(w * k) for k in range(s))
        return torch.complex(re, im)

    k_hat = d_hat * r_hat * (box_1d(wy) * box_1d(wx))
    b = torch.fft.irfft2(k_hat, s=(L, L))
    b2_hat = torch.fft.rfft2(b * b)

    # per-frame part: conv(zero-inserted sigma^2, b_j^2)
    sig2_up = torch.zeros(*sigma.shape[:-2], m, m, device=device)
    sig2_up[..., ::s, ::s] = sigma.to(torch.float32) ** 2
    if dft_mats is not None:
        sig2_hat = dft.rfft2_pad_matmul(sig2_up, dft_mats)
        var = dft.irfft2_crop_matmul(sig2_hat[..., None, :, :] * b2_hat,
                                     dft_mats)
    else:
        sig2_hat = torch.fft.rfft2(sig2_up, s=(L, L))
        var = torch.fft.irfft2(sig2_hat[..., None, :, :] * b2_hat,
                               s=(L, L))[..., :m, :m]
    return torch.sqrt(torch.clamp(var, min=1e-24))


def _propagate_noise_to_grid_weights(model, noisemap, mean_amp,
                                     dft_mats=None):
    """Starlet l1 weights of the PSF grid (the closed form above) from
    (N, n, n) noise maps: their per-pixel NaN-median over stars over the
    mean amplitude."""
    sigma = epoch_nanmedian(noisemap) / torch.clamp(mean_amp, min=1e-12)
    return _grid_noise_weights_closed(sigma, model.m, model.s,
                                      n_starlet_scales(model.m), dft_mats)


def psf_fft_length(m, s, dft_pad=None):
    """FFT length of the PSF fit's DFT matrices (see build_psf dft_pad)."""
    if dft_pad is None:
        return 2 * m
    pad = int(dft_pad)
    if pad < 4 * s:
        raise ValueError(
            f"dft_pad={pad} is below the safe minimum 4*s={4 * s}: the "
            "position bound is 3 data px = 3*s fine px and the wrap-free "
            "margin must exceed it")
    # a length beyond the exact L = 2m would cost more for no benefit
    return min(m + 2 * pad, 2 * m)


def psf_bound_values(n_pix):
    """(kwargs_up, kwargs_down) scalar bound values of the PSF fit, the
    single source of both fits' bounds."""
    kwargs_up = {
        "kwargs_moffat": {"fwhm_x": 0.9 * n_pix, "fwhm_y": 0.9 * n_pix,
                          "beta": 10.0},
        "kwargs_gaussian": {"a": np.inf, "x0": 3.0, "y0": 3.0},
        "kwargs_background": {"background": np.inf},
        "kwargs_distortion": {"dilation_x": 0.5, "dilation_y": 0.5,
                              "shear": 0.5},
    }
    kwargs_down = {
        "kwargs_moffat": {"fwhm_x": 0.8, "fwhm_y": 0.8, "beta": 1.15},
        "kwargs_gaussian": {"a": 0.0, "x0": -3.0, "y0": -3.0},
        "kwargs_background": {"background": -np.inf},
        "kwargs_distortion": {"dilation_x": -0.5, "dilation_y": -0.5,
                              "shear": -0.5},
    }
    return kwargs_up, kwargs_down


def psf_dft_mats(m, s, irfft_backend, dft_pad, device):
    """The matmul render's matrices (pooled by s), or None for cuFFT."""
    check_irfft_backend(irfft_backend)
    if irfft_backend != "matmul":
        return None
    return dft.make_dft_mats(psf_fft_length(m, s, dft_pad), m, pool=s,
                             device=device)


def build_psf(image, noisemap, subsampling_factor, n_iter_analytic=100,
              n_iter_adabelief=3000, masks=None,
              guess_method_star_position="center", guess_fwhm_pixels=None,
              field_distortion=False, stamp_coordinates=None,
              regularization_strength=1.0, adabelief_lr=5e-4, dft_pad=None,
              *, device="cuda", irfft_backend="fft"):
    """Fit a narrow PSF on a stack of star stamps.

    Args:
        image: (N, n, n) star stamps (background-subtracted, e-/s).
        noisemap: (N, n, n) noise sigmas.
        subsampling_factor: int s; fine grid is (n*s, n*s).
        n_iter_analytic: L-BFGS iterations for the Moffat phase.
        n_iter_adabelief: AdaBelief iterations for the pixel phase.
        masks: (N, n, n) bool, True = good pixel; composed with the
            finite guard of image and noise.
        guess_method_star_position: only 'center' is supported.
        guess_fwhm_pixels: seeing-based initial FWHM in data pixels.
        field_distortion: fit the distortion polynomials too.
        stamp_coordinates: (N, 2) rescaled [-1, 1] star positions.
        regularization_strength: starlet-l1 strength for the pixel grid.
        adabelief_lr: learning rate of the pixel phase.
        device: torch device of the fit ("cuda" unless the caller asks
            for the CPU; there is no fallback).
        irfft_backend: "fft" (cuFFT) or "matmul" (JAX's "mxu": the matmul
            DFT, rank-1 per star).
        dft_pad: fine-pixel zero-padding margin of the matmul render's
            DFT matrices; None keeps L = 2m. ``psf_fft_length`` bounds it
            (at least 4 s). The cuFFT render ignores it.

    Returns:
        dict with narrow_psf, full_psf, chi2, chi2_per_star, residuals,
        scale, kwargs_psf, adabelief_extra_fields{'loss_history'},
        lbfgs_extra_fields{'loss_history'}, as numpy.
    """
    enforce_fp32()
    if guess_method_star_position != "center":
        raise NotImplementedError(
            "only guess_method_star_position='center' is supported")
    image = np.asarray(image, dtype=np.float32)
    noisemap = np.asarray(noisemap, dtype=np.float32)
    n_stars, n_pix = image.shape[0], image.shape[-1]
    s = int(subsampling_factor)
    m = n_pix * s
    if masks is None:
        masks = np.isfinite(image)
    else:
        # the finite guard composes with a user mask: a NaN pixel marked
        # good would otherwise enter as a zero-flux measurement
        masks = np.asarray(masks, dtype=bool) & np.isfinite(image) \
            & np.isfinite(noisemap)
    masks = np.asarray(masks, dtype=bool)

    def on(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    scale = float(np.nanmax(np.where(masks, image, np.nan))) \
        if masks.any() else float("nan")
    if not np.isfinite(scale) or scale <= 0:
        scale = 1.0
    masks_t = on(masks)
    data = on(np.nan_to_num(image / scale))
    sigma = on(np.nan_to_num(noisemap / scale, nan=1e8))
    # masked pixels: unit variance (a zero or NaN noise there would give
    # inf partials whose zero-cotangent VJP is NaN)
    sigma_2 = torch.where(masks_t, sigma**2, torch.ones_like(sigma))

    model, loss_moffat, loss_pixels = phase_losses(
        n_stars, n_pix, s, bool(field_distortion))
    if stamp_coordinates is None:
        stamp_coordinates = np.zeros((n_stars, 2), dtype=np.float32)
    coords = on(np.asarray(stamp_coordinates, dtype=np.float32))

    fwhm0 = float(guess_fwhm_pixels) if guess_fwhm_pixels else 3.0
    fwhm0 = float(np.clip(fwhm0, 1.2, 0.45 * n_pix))
    a0 = np.clip(np.nansum(image / scale, axis=(1, 2)), 1e-3, None)
    a0 = a0.astype(np.float32)

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    zeros_grid = torch.zeros(m * m, device=device)
    kwargs_init = {
        "kwargs_moffat": {"fwhm_x": scalar(fwhm0), "fwhm_y": scalar(fwhm0),
                          "beta": scalar(2.5)},
        "kwargs_gaussian": {"a": on(a0),
                            "x0": torch.zeros(n_stars, device=device),
                            "y0": torch.zeros(n_stars, device=device)},
        "kwargs_background": {"background": zeros_grid},
        "kwargs_distortion": zero_distortion_kwargs(device=device),
    }
    kwargs_up, kwargs_down = psf_bound_values(n_pix)

    # --- phase 1: analytic Moffat (grid and distortion fixed at zero) ---
    params1 = Params(kwargs_init,
                     {"kwargs_background": {"background": zeros_grid},
                      "kwargs_distortion": zero_distortion_kwargs(
                          device=device)},
                     kwargs_up, kwargs_down)
    dft_mats = psf_dft_mats(m, s, irfft_backend, dft_pad, device)
    base_consts = {"data": data, "sigma_2": sigma_2, "masks": masks_t,
                   "stamp_coordinates": coords, "dft_mats": dft_mats}
    consts1 = {**base_consts, "fixed": params1.fixed}
    best1, _, hist1 = run_lbfgsb(lambda free: loss_moffat(free, consts1),
                                 params1.free0, params1.lower,
                                 params1.upper, n_iter_analytic)
    kwargs_1 = params1.merge(best1)

    # --- phase 2: pixel grid (+ optional distortion), Moffat fixed ------
    kwargs_fixed_2 = {"kwargs_moffat": dict(kwargs_1["kwargs_moffat"])}
    if not field_distortion:
        kwargs_fixed_2["kwargs_distortion"] = zero_distortion_kwargs(
            device=device)
    params2 = Params(kwargs_1, kwargs_fixed_2, kwargs_up, kwargs_down)

    with torch.no_grad():
        W = _propagate_noise_to_grid_weights(
            model, on(noisemap / scale), on(a0).mean(), dft_mats=dft_mats)
    consts2 = {**base_consts, "W": W, "lam": scalar(regularization_strength),
               "fixed": params2.fixed}
    best2, _, hist2 = run_adabelief(
        lambda free: loss_pixels(free, consts2), params2.free0,
        params2.lower, params2.upper, n_iter_adabelief,
        init_learning_rate=adabelief_lr, schedule_learning_rate=True)
    kwargs_final = params2.merge(best2)

    with torch.no_grad():
        narrow = model.narrow_psf(kwargs_final)
        full = model.full_psf(kwargs_final, dft_mats=dft_mats)
        model_imgs = model.model(kwargs_final, coords, dft_mats)
        chi2_per_star = _masked_chi2_per_star(data, model_imgs, sigma_2,
                                              masks_t)
        residuals = scale * (data - model_imgs)
    return {
        "narrow_psf": narrow.cpu().numpy(),
        "full_psf": full.cpu().numpy(),
        "chi2": float(chi2_per_star.mean()),
        "chi2_per_star": chi2_per_star.cpu().numpy(),
        "residuals": residuals.cpu().numpy(),
        "scale": scale,
        "kwargs_psf": kwargs_to_numpy(kwargs_final),
        "adabelief_extra_fields": {"loss_history": hist2},
        "lbfgs_extra_fields": {"loss_history": hist1},
    }
