"""Multi-epoch forward model of a blended region.

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

Two renders, as in the JAX model. Without render constants, the cuFFT
branch (JAX's "fft" backend). With the constants of :meth:`matmul_consts`
(JAX's "mxu" backend, which the port calls "matmul"; ``Loss`` builds
them when asked for that backend), the all-real matmul-DFT render of
:meth:`_model_all_real`: point sources as stacked rank-1 ramps against
the raw PSF spectra, through the fused kernel K2 (``ops/fused_render.py``;
hand-written CUDA on the card), or, for one source with a fixed
background, the rank-1 modulated inverse ``ops.dft.irfft2_pool_shift_matmul``.
With constants that carry the DFT matrices but no raw spectra (JAX's star
finalize), the pooled branches: one source through the rank-1 inverse on
``ps_hat``, the background through the pooled ``_h_render``.
The PSF spectra are computed once, at construction, on the PSF's device:
by cuFFT, or by the matmul DFT when the model is given ``dft_mats`` (as
the JAX star photometry computes them on "mxu").

Groups (the star photometry): with ``n_groups`` G the N epochs are G
problems of N / G consecutive epochs each, as the JAX package's
``jax.vmap`` over stars: ``c_x``, ``c_y`` are (G, M) and ``h`` is
(G, m*m), one per group; everything else is per epoch.
"""

import copy

import numpy as np
import torch
import torch.nn.functional as F

from ..grids import downsample
from ..profiles import gaussian_r_kernel
from .. import convolution as conv
from ...ops import dft
from ...ops.fused_render import fused_render


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
                 n_sources, *, n_groups=None, dft_mats=None):
        """
        Args:
            psf: (N, mp, mp) float32 tensor, per-epoch narrow PSFs on the
                fine grid; its device is the model's.
            subsampling_factor: s.
            image_size: n, the data stamp side.
            n_epochs: N.
            n_sources: M.
            n_groups: None (one background and one set of positions for
                all epochs) or G dividing N (see the module docstring).
            dft_mats: ``ops.dft.make_dft_mats(2m, m, pool=s)`` to compute
                the PSF spectra by matmul DFT (and to serve as the matrices
                of :meth:`matmul_consts`); None for cuFFT.
        """
        self.s = int(subsampling_factor)
        self.image_size = int(image_size)
        self.n_epochs = int(n_epochs)
        self.n_sources = int(n_sources)
        self.m = self.image_size * self.s
        if n_groups is not None and (n_groups < 1
                                     or self.n_epochs % n_groups):
            raise ValueError(f"n_groups={n_groups} does not divide the "
                             f"{self.n_epochs} epochs")
        self.n_groups = n_groups
        self.device = psf.device
        self._dft_mats = dft_mats
        psf = pad_psf_to(psf.to(torch.float32), self.m)
        # unit flux per epoch, so `a` is total flux; an all-zero PSF (a
        # dummy epoch) stays zero instead of 0/0
        psf_sum = psf.sum(dim=(-2, -1), keepdim=True)
        self.psf_pad = psf / torch.where(psf_sum > 0, psf_sum,
                                         torch.ones_like(psf_sum))
        t_hat = conv.psf_fft(self.psf_pad) if dft_mats is None \
            else dft.rfft2_pad_matmul(self.psf_pad, dft_mats)
        self.ps_hat = t_hat * conv.r_kernel_fft(self.m, self.s, self.device)
        self.grid_hat = t_hat * conv.grid_center_phase(self.m, self.device)

    def epoch_slice(self, start, stop):
        """The model of epochs ``[start, stop)`` only (with groups, those
        of every group): a rank's share of an epoch-sharded fit
        (``parallel/``). It shares this model's PSF spectra, so it renders
        those epochs with the same bits, and its render constants
        (:meth:`matmul_consts`, hence K2's operands) cover those epochs
        only."""
        n_groups = self.n_groups or 1

        def cut(x):
            return x.unflatten(0, (n_groups, -1))[:, start:stop].flatten(0, 1)

        part = copy.copy(self)
        part.n_epochs = n_groups * (int(stop) - int(start))
        part.psf_pad = cut(self.psf_pad)
        part.ps_hat = cut(self.ps_hat)
        part.grid_hat = cut(self.grid_hat)
        return part

    def source_positions(self, kwargs):
        """Per-epoch positions (px, py), each (N, M), data px, centre origin."""
        ka = kwargs["kwargs_analytic"]
        cx, cy = ka["c_x"], ka["c_y"]
        if self.n_groups is not None:
            # (G, M): each group's positions, repeated over its epochs
            per = self.n_epochs // self.n_groups
            cx = cx.repeat_interleave(per, dim=0)
            cy = cy.repeat_interleave(per, dim=0)
        th = torch.deg2rad(ka["alpha"])[:, None]
        px = torch.cos(th) * cx - torch.sin(th) * cy + ka["dx"][:, None]
        py = torch.sin(th) * cx + torch.cos(th) * cy + ka["dy"][:, None]
        return px, py

    def _h_planes(self, h_flat):
        """The background as (m, m), or (G, m, m) with groups."""
        m = self.m
        if self.n_groups is None:
            return h_flat.reshape(m, m)
        return h_flat.reshape(self.n_groups, m, m)

    def _per_epoch(self, h_part, spectra):
        """``h_part * spectra``: an (L, Lh) plane broadcast over the (N, L,
        Lh) epochs, or (G, L, Lh) planes, each over its group's epochs."""
        if self.n_groups is None:
            return h_part * spectra
        return (h_part[:, None] * spectra.unflatten(0, (self.n_groups, -1))
                ).flatten(0, 1)

    def spectra_real(self):
        """Raw per-epoch PSF spectra ``{"t_re", "t_im"}``, (N, L, L/2+1)
        float32 each (cuFFT, as the JAX ``Loss`` computes them, or the
        matmul DFT when the model was given ``dft_mats``)."""
        if self._dft_mats is not None:
            t_re, t_im = dft.rfft2_pad_matmul_parts(self.psf_pad,
                                                    self._dft_mats)
            return {"t_re": t_re, "t_im": t_im}
        t_hat = conv.psf_fft(self.psf_pad)
        return {"t_re": t_hat.real.contiguous(),
                "t_im": t_hat.imag.contiguous()}

    def matmul_consts(self):
        """Constants of the matmul-DFT render, on the model's device.

        ``dft_mats`` (``ops.dft.make_dft_mats(2m, m, pool=s)``), the raw
        spectra of :meth:`spectra_real`, the target kernel ``r_hat`` and
        the centre phase ``pc + i ps``, all (L, L/2+1) float32.
        """
        m = self.m
        # the centre phase from its 1-D factors, as JAX's _model_all_real
        gy_re, gy_im, gx_re, gx_im = conv.grid_center_phase_1d(m, self.device)
        mats = self._dft_mats if self._dft_mats is not None \
            else dft.make_dft_mats(2 * m, m, pool=self.s, device=self.device)
        return {"dft_mats": mats,
                **self.spectra_real(),
                "r_hat": conv.r_kernel_fft(m, self.s, self.device),
                "pc": gy_re[:, None] * gx_re - gy_im[:, None] * gx_im,
                "ps": gy_re[:, None] * gx_im + gy_im[:, None] * gx_re}

    def _h_render(self, h_flat, consts=None):
        """down(conv(t_e, h)) for every epoch: (N, n, n); with constants
        that carry ``dft_mats``, by the pooled matmul DFT."""
        m = self.m
        h = self._h_planes(h_flat)
        if consts is not None:
            mats = consts["dft_mats"]
            h_hat = dft.rfft2_pad_matmul(h, mats)
            return dft.irfft2_pool_matmul(self._per_epoch(h_hat,
                                                          self.grid_hat),
                                          mats)
        L = conv.pad_len(m)
        h_hat = torch.fft.rfft2(h, s=(L, L))
        return downsample(conv.render_from_fft(
            self._per_epoch(h_hat, self.grid_hat), m), self.s)

    def model(self, kwargs, fixed_h_render=None, consts=None):
        """Modelled data stamps (N, n, n).

        ``fixed_h_render``: the precomputed :meth:`_h_render` of a FIXED
        background (``Loss`` passes it); then ``h`` is not rendered again.
        ``consts``: those of :meth:`matmul_consts` select the all-real
        matmul-DFT render; ``{"dft_mats": ...}`` alone (no raw spectra)
        the pooled rank-1 render of one source on ``ps_hat``, as the JAX
        model's ``pooled and M == 1`` branch; None the cuFFT one.
        """
        m, s, M = self.m, self.s, self.n_sources
        ka = kwargs["kwargs_analytic"]
        kb = kwargs["kwargs_background"]
        a = ka["a"].reshape(self.n_epochs, M)
        px, py = self.source_positions(kwargs)
        if consts is not None and "t_re" in consts:
            return self._model_all_real(a, px, py, kb, consts,
                                        fixed_h_render)
        if consts is not None:
            return self._model_pooled_rank1(a, px, py, kb, consts,
                                            fixed_h_render)
        total_hat = conv.point_source_spectrum(m, s, a, px, py) * self.ps_hat
        if fixed_h_render is None:
            L = conv.pad_len(m)
            h_hat = torch.fft.rfft2(self._h_planes(kb["h"]), s=(L, L))
            total_hat = total_hat + self._per_epoch(h_hat, self.grid_hat)
        data = downsample(conv.render_from_fft(total_hat, m), s)
        if fixed_h_render is not None:
            data = data + fixed_h_render
        return data + kb["mean"][:, None, None]

    def fused_render_operands(self, a, px, py, h, consts):
        """The 14 operands of K2 (``ops.fused_render``), in its order.

        ``a``, ``px``, ``py``: (N, M); ``h``: the flat background, or None
        when it is not rendered (then ``h_re``, ``h_im`` are None);
        ``consts``: those of :meth:`matmul_consts`.
        """
        m, s = self.m, self.s
        mats = consts["dft_mats"]
        u_re, u_im, v = conv.point_source_ramp_stacks(m, s, a, px, py)
        h_re = h_im = None
        if h is not None:
            # (L, Lh), or with groups (G, L, Lh): one plane per group
            h_re, h_im = dft.rfft2_pad_matmul_parts(self._h_planes(h), mats)
        return (u_re, u_im, v, consts["t_re"], consts["t_im"],
                consts["r_hat"], consts["pc"], consts["ps"], h_re, h_im,
                mats["Ayp"], mats["Byp"], mats["Cxp"], mats["Sxp"])

    def _model_all_real(self, a, px, py, kb, consts, fixed_h):
        """All-real matmul-DFT render on the raw PSF spectra.

        Twin of the JAX ``_model_all_real``. Its general branch renders
        through K2: the stacked ramps, ``t_hat * r_hat`` and, with h free,
        ``h_hat * t_hat * (pc + i ps)``, inverted by the pooled DFT
        matrices (JAX folds ``r_hat`` into the ramps and ``h_hat`` into
        the spectrum first: the same sum, rounded in another order). One
        source with a fixed background renders through the rank-1
        modulated inverse, as in JAX, in plain torch.
        """
        m, s, M = self.m, self.s, self.n_sources
        mats = consts["dft_mats"]
        if M == 1 and fixed_h is not None:
            ry, rx = conv.r_kernel_fft_1d(m, s, self.device)
            u_re, u_im, v_re, v_im = conv.point_source_ramps(
                m, s, a[:, 0], px[:, 0], py[:, 0], ry=ry, rx=rx)
            data = dft.irfft2_pool_shift_matmul(
                consts["t_re"], consts["t_im"], u_re, u_im, v_re, v_im, mats)
            return data + fixed_h + kb["mean"][:, None, None]
        h = kb["h"] if fixed_h is None else None
        data = fused_render(*self.fused_render_operands(a, px, py, h, consts),
                            include_h=h is not None)
        if fixed_h is not None:
            data = data + fixed_h
        return data + kb["mean"][:, None, None]

    def _model_pooled_rank1(self, a, px, py, kb, consts, fixed_h):
        """One source through the rank-1 modulated inverse on ``ps_hat``
        (the r kernel already in it), plus the pooled background: the JAX
        model's ``pooled and M == 1`` branch."""
        if self.n_sources != 1:
            raise ValueError("the pooled render without raw spectra takes "
                             f"one source, not {self.n_sources}")
        u_re, u_im, v_re, v_im = conv.point_source_ramps(
            self.m, self.s, a[:, 0], px[:, 0], py[:, 0])
        data = dft.irfft2_pool_shift_matmul(
            self.ps_hat.real, self.ps_hat.imag, u_re, u_im, v_re, v_im,
            consts["dft_mats"])
        h_part = fixed_h if fixed_h is not None \
            else self._h_render(kb["h"], consts)
        return data + h_part + kb["mean"][:, None, None]

    def background_only(self, kwargs, fixed_h_render=None, consts=None):
        """The flux-independent channels: h render + per-epoch mean.

        Twin of the JAX ``background_only``: each branch has the h
        expression of the matching :meth:`model` branch, in its order of
        association (the GLS polish baseline depends on it): the fixed
        render; with :meth:`matmul_consts`, h on the raw spectra as in
        :meth:`_model_all_real`; else the pooled (``consts`` with
        ``dft_mats``) or cuFFT :meth:`_h_render`.
        """
        kb = kwargs["kwargs_background"]
        if fixed_h_render is not None:
            h_part = fixed_h_render
        elif consts is not None and "t_re" in consts:
            mats = consts["dft_mats"]
            h_re, h_im = dft.rfft2_pad_matmul_parts(
                self._h_planes(kb["h"]), mats)
            cp_re, cp_im = consts["pc"], consts["ps"]
            hp_re = h_re * cp_re - h_im * cp_im
            hp_im = h_re * cp_im + h_im * cp_re
            t_re, t_im = consts["t_re"], consts["t_im"]
            x_re = self._per_epoch(hp_re, t_re) - self._per_epoch(hp_im, t_im)
            x_im = self._per_epoch(hp_re, t_im) + self._per_epoch(hp_im, t_re)
            h_part = dft.irfft2_pool_matmul_parts(x_re, x_im, mats)
        else:
            h_part = self._h_render(kb["h"], consts)
        return h_part + kb["mean"][:, None, None]

    def point_source_basis(self, kwargs, consts=None):
        """Unit-flux data-grid images of each source: (N, M, n, n);
        with ``consts`` carrying ``dft_mats``, by the pooled matmul DFT
        (the JAX ``point_source_basis`` on "mxu"), else by cuFFT."""
        m, s = self.m, self.s
        px, py = self.source_positions(kwargs)
        ones = torch.ones_like(px[:, :1])
        basis = []
        for j in range(self.n_sources):
            prod = conv.point_source_spectrum(
                m, s, ones, px[:, j, None], py[:, j, None]) * self.ps_hat
            if consts is not None:
                basis.append(dft.irfft2_pool_matmul(prod,
                                                    consts["dft_mats"]))
            else:
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


def setup_model(data, sigma_2, s, xs, ys, subsampling_factor,
                initial_a=None, astrometric_bound=5.0, translation_bound=5.0,
                *, device="cuda"):
    """Build a DeconvModel and its parameter trees from host arrays.

    Twin of the JAX ``setup_model``, whose argument names it keeps:
    ``data`` (N, n, n), ``s`` the narrow PSFs (N, mp, mp), ``xs``/``ys``
    (M,) centre-origin data-pixel positions,
    ``initial_a`` of length N*M or M (tiled); ``sigma_2`` is unused.
    Returns ``(model, kwargs_init, kwargs_up, kwargs_down, kwargs_fixed)``
    with float32 tensors on ``device``: the card unless the caller asks
    for ``"cpu"``.
    """
    del sigma_2
    data = np.asarray(data)
    n_epochs, image_size = data.shape[0], data.shape[-1]
    xs = np.atleast_1d(np.asarray(xs, dtype=np.float32))
    ys = np.atleast_1d(np.asarray(ys, dtype=np.float32))
    n_sources = xs.size
    model = DeconvModel(
        torch.tensor(np.asarray(s, dtype=np.float32), device=device),
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
