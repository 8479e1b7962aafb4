"""Multi-epoch forward model of a blended region (FFT branch).

Twin of ``lightcurver_tpu/core/deconv/model.py``. Per epoch ``e``:

    D_e = down( conv(t_e, h) + sum_j a_{e,j} (t_e * r)(. - p_{e,j}) ) + mean_e

with ``t_e`` the epoch's narrow PSF on the fine grid, ``h`` the shared
pixelated background, ``r`` the target Gaussian, ``p_{e,j} = R(alpha_e) c_j
+ (dx_e, dy_e)`` and ``down`` sum-pooling.

kwargs for N epochs, M sources and an m x m fine grid:
    kwargs_analytic: a (N*M), c_x (M), c_y (M), dx (N), dy (N), alpha (N)
    kwargs_background: h (m*m), mean (N)
    kwargs_sersic: {}
``a[e * M + j]`` is the flux of source j at epoch e.

Only the FFT branch of the JAX model is ported: the matmul-DFT, all-real
and rank-1 render paths are what JAX selects on the TPU alone. The PSF
spectra are computed once, at construction, on the PSF's device.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..grids import downsample
from ..profiles import gaussian_r_kernel
from .. import convolution as conv


def pad_psf_to(narrow_psf, m):
    """Centre-pad or centre-crop PSFs (..., mp, mp) to (..., m, m)."""
    mp = narrow_psf.shape[-1]
    if mp == m:
        return narrow_psf
    if mp > m:
        lo = (mp - m) // 2
        return narrow_psf[..., lo:lo + m, lo:lo + m]
    off = (m - mp) // 2
    return F.pad(narrow_psf, (off, m - mp - off, off, m - mp - off))


class DeconvModel:
    """Model geometry plus the per-epoch PSF spectra.

    Attributes:
        ps_hat: (N, L, L/2+1) complex64, PSF spectra times the r kernel
            (multiplies point-source phase ramps).
        grid_hat: (N, L, L/2+1) complex64, PSF spectra times the centre
            phase (convolves the gridded channel h).
    """

    def __init__(self, psf, subsampling_factor, image_size, n_epochs,
                 n_sources):
        """
        Args:
            psf: (N, mp, mp) float32 tensor, per-epoch narrow PSFs on the
                fine grid; its device is the model's.
            subsampling_factor: s.
            image_size: n, the data stamp side.
            n_epochs: N.
            n_sources: M.
        """
        self.s = int(subsampling_factor)
        self.image_size = int(image_size)
        self.n_epochs = int(n_epochs)
        self.n_sources = int(n_sources)
        self.m = self.image_size * self.s
        self.device = psf.device
        psf = pad_psf_to(psf.to(torch.float32), self.m)
        # unit flux per epoch, so `a` is total flux
        self.psf_pad = psf / psf.sum(dim=(-2, -1), keepdim=True)
        t_hat = conv.psf_fft(self.psf_pad)
        self.ps_hat = t_hat * conv.r_kernel_fft(self.m, self.s, self.device)
        self.grid_hat = t_hat * conv.grid_center_phase(self.m, self.device)

    def source_positions(self, kwargs):
        """Per-epoch positions (px, py), each (N, M), data px, centre origin."""
        ka = kwargs["kwargs_analytic"]
        th = torch.deg2rad(ka["alpha"])[:, None]
        px = torch.cos(th) * ka["c_x"] - torch.sin(th) * ka["c_y"] \
            + ka["dx"][:, None]
        py = torch.sin(th) * ka["c_x"] + torch.cos(th) * ka["c_y"] \
            + ka["dy"][:, None]
        return px, py

    def _h_render(self, h_flat):
        """down(conv(t_e, h)) for every epoch: (N, n, n)."""
        m = self.m
        L = conv.pad_len(m)
        h_hat = torch.fft.rfft2(h_flat.reshape(m, m), s=(L, L))
        return downsample(conv.render_from_fft(h_hat * self.grid_hat, m),
                          self.s)

    def model(self, kwargs, fixed_h_render=None):
        """Modelled data stamps (N, n, n).

        ``fixed_h_render``: the precomputed :meth:`_h_render` of a FIXED
        background (``Loss`` passes it); then ``h`` is not rendered again.
        """
        m, s, M = self.m, self.s, self.n_sources
        ka = kwargs["kwargs_analytic"]
        kb = kwargs["kwargs_background"]
        a = ka["a"].reshape(self.n_epochs, M)
        px, py = self.source_positions(kwargs)
        total_hat = conv.point_source_spectrum(m, s, a, px, py) * self.ps_hat
        if fixed_h_render is None:
            L = conv.pad_len(m)
            h_hat = torch.fft.rfft2(kb["h"].reshape(m, m), s=(L, L))
            total_hat = total_hat + h_hat * self.grid_hat
        data = downsample(conv.render_from_fft(total_hat, m), s)
        if fixed_h_render is not None:
            data = data + fixed_h_render
        return data + kb["mean"][:, None, None]

    def background_only(self, kwargs, fixed_h_render=None):
        """The flux-independent channels: h render + per-epoch mean."""
        kb = kwargs["kwargs_background"]
        h_part = fixed_h_render if fixed_h_render is not None \
            else self._h_render(kb["h"])
        return h_part + kb["mean"][:, None, None]

    def point_source_basis(self, kwargs):
        """Unit-flux data-grid images of each source: (N, M, n, n)."""
        m, s = self.m, self.s
        px, py = self.source_positions(kwargs)
        ones = torch.ones_like(px[:, :1])
        basis = []
        for j in range(self.n_sources):
            prod = conv.point_source_spectrum(
                m, s, ones, px[:, j, None], py[:, j, None]) * self.ps_hat
            basis.append(downsample(conv.render_from_fft(prod, m), s))
        return torch.stack(basis, dim=1)

    def getDeconvolved(self, kwargs, epoch=0):
        """(deconvolved, background) at the fine grid for one epoch.

        The background h plus each source as an ``r`` profile at its
        epoch position; both (m, m), data-flux units per fine pixel.
        """
        m, s, M = self.m, self.s, self.n_sources
        h = kwargs["kwargs_background"]["h"].reshape(m, m)
        a = kwargs["kwargs_analytic"]["a"].reshape(self.n_epochs, M)
        px, py = self.source_positions(kwargs)
        img = h
        for j in range(M):
            img = img + a[epoch, j] * gaussian_r_kernel(
                m, s, x0=px[epoch, j], y0=py[epoch, j], device=self.device)
        return img, h


def setup_model(data, sigma_2, psf, xs, ys, subsampling_factor,
                initial_a=None, astrometric_bound=5.0, translation_bound=5.0,
                device="cpu"):
    """Build a DeconvModel and its parameter trees from host arrays.

    Twin of the JAX ``setup_model``: ``data`` (N, n, n), ``psf``
    (N, mp, mp), ``xs``/``ys`` (M,) centre-origin data-pixel positions,
    ``initial_a`` of length N*M or M (tiled); ``sigma_2`` is unused.
    Returns ``(model, kwargs_init, kwargs_up, kwargs_down, kwargs_fixed)``
    with float32 tensors on ``device``.
    """
    del sigma_2
    data = np.asarray(data)
    n_epochs, image_size = data.shape[0], data.shape[-1]
    xs = np.atleast_1d(np.asarray(xs, dtype=np.float32))
    ys = np.atleast_1d(np.asarray(ys, dtype=np.float32))
    n_sources = xs.size
    model = DeconvModel(
        torch.tensor(np.asarray(psf, dtype=np.float32), device=device),
        subsampling_factor, image_size, n_epochs, n_sources)

    if initial_a is None:
        initial_a = np.tile(np.nansum(data, axis=(1, 2)) / n_sources,
                            (n_sources, 1)).T.ravel()
    initial_a = np.asarray(initial_a, dtype=np.float32).ravel()
    if initial_a.size == n_sources:
        initial_a = np.tile(initial_a, n_epochs)
    if initial_a.size != n_epochs * n_sources:
        raise ValueError(f"initial_a has {initial_a.size} entries, "
                         f"expected {n_epochs * n_sources}")

    def t(x):
        return torch.tensor(np.asarray(x, dtype=np.float32), device=device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    m, big = model.m, np.inf
    kwargs_init = {
        "kwargs_analytic": {"a": t(initial_a), "c_x": t(xs), "c_y": t(ys),
                            "dx": zeros(n_epochs), "dy": zeros(n_epochs),
                            "alpha": zeros(n_epochs)},
        "kwargs_background": {"h": zeros(m * m), "mean": zeros(n_epochs)},
        "kwargs_sersic": {},
    }
    kwargs_up = {
        "kwargs_analytic": {"a": t(big), "c_x": t(xs + astrometric_bound),
                            "c_y": t(ys + astrometric_bound),
                            "dx": t(translation_bound),
                            "dy": t(translation_bound), "alpha": t(big)},
        "kwargs_background": {"h": t(big), "mean": t(big)},
        "kwargs_sersic": {},
    }
    kwargs_down = {
        "kwargs_analytic": {"a": t(-big), "c_x": t(xs - astrometric_bound),
                            "c_y": t(ys - astrometric_bound),
                            "dx": t(-translation_bound),
                            "dy": t(-translation_bound), "alpha": t(-big)},
        "kwargs_background": {"h": t(-big), "mean": t(-big)},
        "kwargs_sersic": {},
    }
    kwargs_fixed = {
        "kwargs_analytic": {"alpha": zeros(n_epochs)},
        "kwargs_background": {"h": zeros(m * m), "mean": zeros(n_epochs)},
        "kwargs_sersic": {},
    }
    return model, kwargs_init, kwargs_up, kwargs_down, kwargs_fixed
