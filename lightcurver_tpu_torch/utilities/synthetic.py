"""Synthetic multi-epoch ROI scenes in numpy.

A copy of ``make_roi_scene``, ``render_epochs_np`` and ``moffat_np`` from
``lightcurver_tpu/utilities/synthetic.py``: a machine without jax cannot
import the original, since importing any ``lightcurver_tpu`` module loads
the JAX core. The same seed gives the same scene as the original (the
tests check this).
"""

import math

import numpy as np

from ..core.conventions import fwhm_to_sigma, TARGET_FWHM_FINE_PIX


def _freqs(L):
    fy = np.fft.fftfreq(L).reshape(L, 1)
    fx = np.fft.rfftfreq(L).reshape(1, L // 2 + 1)
    return fy, fx


def r_kernel_fft_np(m):
    """Analytic rfft2 of the target Gaussian at L = 2m."""
    sigma_f = fwhm_to_sigma(TARGET_FWHM_FINE_PIX)
    fy, fx = _freqs(2 * m)
    return np.exp(-2.0 * np.pi**2 * sigma_f**2 * (fy**2 + fx**2))


def moffat_np(m, s, fwhm_x, fwhm_y, beta):
    """Unit-integral elliptical Moffat on the fine grid."""
    c = (m - 1) / 2.0
    idx = (np.arange(m) - c) / s
    y, x = np.meshgrid(idx, idx, indexing="ij")
    root = math.sqrt(2.0 ** (1.0 / beta) - 1.0)
    ax, ay = fwhm_x / (2 * root), fwhm_y / (2 * root)
    u = (x / ax) ** 2 + (y / ay) ** 2
    norm = (beta - 1.0) / (math.pi * ax * ay * s**2)
    return (norm * (1.0 + u) ** (-beta)).astype(np.float32)


def render_epochs_np(psf, a, px, py, s, h=None):
    """Clean (N, n, n) float32 stamps from PSFs (N, m, m), fluxes (N, M),
    positions (M,) or (N, M) in data px (centre origin) and an optional
    (m, m) background."""
    psf = np.asarray(psf, dtype=np.float64)
    N, m = psf.shape[0], psf.shape[-1]
    n = m // s
    L = 2 * m
    a = np.asarray(a, dtype=np.float64)
    M = a.shape[1]
    px = np.broadcast_to(np.asarray(px, dtype=np.float64), (N, M))
    py = np.broadcast_to(np.asarray(py, dtype=np.float64), (N, M))
    fy, fx = _freqs(L)
    r_hat = r_kernel_fft_np(m)
    c = (m - 1) / 2.0
    center_phase = np.exp(1j * 2 * np.pi * (fy + fx) * c)

    h_hat = None if h is None \
        else np.fft.rfft2(h, s=(L, L)) * center_phase
    out = np.empty((N, n, n), dtype=np.float32)
    for e in range(N):
        t = psf[e] / psf[e].sum()
        t_hat = np.fft.rfft2(t, s=(L, L))
        spec = np.zeros_like(t_hat)
        for j in range(M):
            ang = -2 * np.pi * (fy * s * py[e, j] + fx * s * px[e, j])
            spec += a[e, j] * np.exp(1j * ang)
        total = spec * t_hat * r_hat
        if h_hat is not None:
            total += h_hat * t_hat
        fine = np.fft.irfft2(total, s=(L, L))[:m, :m]
        out[e] = fine.reshape(n, s, n, s).sum(axis=(1, 3)).astype(np.float32)
    return out


def make_roi_scene(n_epochs=100, n_pix=64, s=2, n_sources=4, noise_sigma=0.3,
                   seed=7, fwhm_range=(2.2, 4.0), flux_range=(40.0, 120.0)):
    """Blended point sources over many epochs with Moffat PSFs and noise.

    Returns:
        dict with data, sigma_2, psf, xs, ys (centre-origin data px), s,
        a_true (N, M) and fwhm (N,).
    """
    rng = np.random.default_rng(seed)
    m = n_pix * s
    fwhms = rng.uniform(*fwhm_range, n_epochs)
    psf = np.stack([moffat_np(m, s, f, f, beta=2.8) for f in fwhms])
    xs = np.array([-4.0, 4.0, 0.0, -1.5], np.float32)[:n_sources]
    ys = np.array([2.0, -3.0, 4.5, -1.0], np.float32)[:n_sources]
    a_true = rng.uniform(*flux_range,
                         size=(n_epochs, n_sources)).astype(np.float32)
    clean = render_epochs_np(psf, a_true, xs[None, :], ys[None, :], s)
    sigma = np.full_like(clean, noise_sigma)
    data = clean + rng.normal(0, noise_sigma, clean.shape).astype(np.float32)
    return {
        "data": data, "sigma_2": (sigma**2).astype(np.float32),
        "psf": psf.astype(np.float32), "xs": xs, "ys": ys, "s": s,
        "a_true": a_true, "fwhm": fwhms.astype(np.float32),
    }
