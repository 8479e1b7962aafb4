"""Monte-Carlo propagation of data noise into starlet weights W.

Twin of ``lightcurver_tpu/core/noise.py``: per starlet scale and fine-grid
pixel, the standard deviation that data noise induces on the starlet
coefficients of the background channel. Noise realizations on the data
grid are pushed through the adjoint of the forward operator (upsample
transpose, then correlation with the mean PSF) and starlet-transformed;
W is their per-coefficient standard deviation over samples (ddof 0).

The MC core, :func:`mc_starlet_noise`, takes the standard-normal draws as
a tensor, so tests can hand both packages the same numpy draws. In
production :func:`propagate_noise` draws them from a seeded CPU
``torch.Generator`` and moves them to the device, which makes W the same
on every device up to rounding. The starlet over the batch of samples
runs through ``ops.starlet_op`` (the CUDA kernel on the card). With
``irfft_backend="matmul"`` (JAX's "mxu") the adjoint convolution runs as
the matmul DFT of ``ops/dft.py``, as the JAX package does on that backend.
"""

import torch
import torch.distributed as dist

from .grids import upsample_transpose
from .starlet import n_starlet_scales
from . import convolution as conv
from ..ops import check_irfft_backend, dft
from ..ops.starlet_op import starlet_transform


def mc_starlet_noise(sigma, mean_ps_hat, m, s, draws, dft_mats=None,
                     n_scales=None):
    """Per-coefficient std of starlet(adjoint(sigma * draws)).

    Leading dims B (none for one problem; the star axis S of the star
    photometry, JAX's ``_mc_starlet_noise`` under ``jax.vmap``) are shared
    by all inputs and kept; the starlet of all B x K samples is one call.

    Args:
        sigma: (B..., n, n) data-grid noise sigma; non-finite pixels
            contribute no noise.
        mean_ps_hat: (B..., L, L/2+1) complex mean point-source spectrum.
        draws: (B..., K, n, n) standard-normal samples.
        dft_mats: ``ops.dft.make_dft_mats(L, m)`` to correlate by matmul
            DFT; None for cuFFT.
        n_scales: starlet scales J (default ``n_starlet_scales(m)``).

    Returns:
        (B..., J + 1, m, m), floored at 1e-12.
    """
    L = conv.pad_len(m)
    sigma = torch.where(torch.isfinite(sigma), sigma, torch.zeros_like(sigma))
    fine = upsample_transpose(sigma[..., None, :, :] * draws, s)
    conj_ps = torch.conj(mean_ps_hat)[..., None, :, :]
    if dft_mats is not None:
        back = dft.irfft2_crop_matmul(
            dft.rfft2_pad_matmul(fine, dft_mats) * conj_ps, dft_mats)
    else:
        fine_hat = torch.fft.rfft2(fine, s=(L, L))
        back = conv.hermitian_irfft2(fine_hat * conj_ps, L)[..., :m, :m]
    coeffs = starlet_transform(back.contiguous(),
                               n_scales)      # (B..., K, J+1, m, m)
    return torch.clamp(torch.std(coeffs, dim=-4, correction=0), min=1e-12)


def epoch_nanmedian(stack, dim=0):
    """Per-pixel NaN-median over the epoch axis ``dim``.

    For an even count of finite values it is the mean of the two middle
    ones, as ``jnp.nanmedian``; ``torch.nanmedian`` returns the lower one.
    """
    return torch.nanquantile(stack, 0.5, dim=dim)


def propagate_noise(model, noisemap, kwargs, wavelet_type_list=("starlet",),
                    method="SLIT", num_samples=200, seed=1,
                    likelihood_type="chi2", verbose=False,
                    upsampling_factor=None, n_scales=None, *,
                    irfft_backend="fft", group=None):
    """Starlet noise weights, in the JAX package's (and STARRED's) call
    form: a list whose one element is W, (n_scales + 1, m, m), on the
    model's device.

    ``noisemap``: (N, n, n) noise sigmas (tensor or array); the per-pixel
    sigma is their :func:`epoch_nanmedian`. ``kwargs``,
    ``wavelet_type_list``, ``method``, ``likelihood_type`` and ``verbose``
    are accepted and unused, as in JAX. ``upsampling_factor`` defaults to
    the model's s, ``n_scales`` to ``n_starlet_scales(m)``.
    ``irfft_backend``: "fft" or "matmul", as for ``Loss``. With a process
    ``group`` (an epoch-sharded fit), rank 0 of the group computes W and
    broadcasts it, so every rank fits with the same bits.
    """
    del kwargs, wavelet_type_list, method, likelihood_type, verbose
    check_irfft_backend(irfft_backend)
    m = model.m
    s = int(upsampling_factor) if upsampling_factor else model.s
    n_scales = n_starlet_scales(m) if n_scales is None else int(n_scales)
    if group is not None:
        if dist.get_rank(group) == 0:
            W, = propagate_noise(model, noisemap, None,
                                 num_samples=num_samples, seed=seed,
                                 upsampling_factor=s, n_scales=n_scales,
                                 irfft_backend=irfft_backend)
        else:
            W = torch.empty((n_scales + 1, m, m), dtype=torch.float32,
                            device=model.device)
        dist.broadcast(W, group=group, group_src=0)
        return [W]
    noisemap = torch.as_tensor(noisemap, dtype=torch.float32,
                               device=model.device)
    sigma = epoch_nanmedian(noisemap)
    gen = torch.Generator().manual_seed(int(seed))
    draws = torch.randn((int(num_samples),) + tuple(sigma.shape),
                        generator=gen, dtype=torch.float32).to(model.device)
    mats = None
    if irfft_backend == "matmul":
        mats = dft.make_dft_mats(conv.pad_len(m), m, device=model.device)
    with torch.no_grad():
        return [mc_starlet_noise(sigma, model.ps_hat.mean(dim=0), m, s,
                                 draws, mats, n_scales)]
