"""Plain render of blended point sources over many epochs.

The forward model of a joint multi-epoch fit, written from its definition
and nothing else: per epoch e,

    D_e = down( t_e * h + sum_j a_ej (t_e * r)(. - s p_ej) ) + mean_e,

with t_e the epoch's narrow PSF on the fine grid (unit sum), h the
background on the fine grid, r the target Gaussian of FWHM 2 fine pixels
(taken as its analytic transform), p_ej the source positions in data
pixels (centre origin), * a linear convolution (zero padding to L = 2m;
the background's convolution peak-aligned by the centre phase) and
``down`` the s x s sum-pool.

Every transform is a dense DFT by matrix products, over the full
(Hermitian) spectrum, so the same code runs in float64 (the reference) and
in float32 with its products' inputs rounded to TF32 (the control: the
precision below the float32-with-TF32-off that the configurations state).
"""

import math

import torch

TARGET_FWHM_FINE_PIX = 2.0


def tf32(x):
    """``x`` (float32) rounded to TF32: 10 mantissa bits, to nearest."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Precision:
    """The arithmetic of one side: float64, or float32 with TF32 products."""

    def __init__(self, name, device):
        if name not in ("float64", "tf32"):
            raise ValueError(f"precision {name!r}: float64 or tf32")
        self.name = name
        self.device = torch.device(device)
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def t(self, x):
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    def mm(self, a, b):
        if self.name == "tf32":
            a, b = tf32(a), tf32(b)
        return torch.matmul(a, b)


def moffat(m, s, fwhm, beta, device, dtype=torch.float64):
    """Unit-integral circular Moffats (N, m, m) on the fine grid; ``fwhm``
    (N,) in data pixels."""
    fwhm = torch.as_tensor(fwhm, dtype=dtype, device=device)
    c = (m - 1) / 2.0
    idx = (torch.arange(m, dtype=dtype, device=device) - c) / s
    y, x = torch.meshgrid(idx, idx, indexing="ij")
    root = math.sqrt(2.0 ** (1.0 / beta) - 1.0)
    alpha = (fwhm / (2 * root))[:, None, None]
    u = (x**2 + y**2) / alpha**2
    norm = (beta - 1.0) / (math.pi * alpha * alpha * s**2)
    return norm * (1.0 + u) ** (-beta)


class Renderer:
    """Dense-DFT renders of an (m, m) fine grid at one precision."""

    def __init__(self, m, s, precision):
        self.m, self.s, self.p = int(m), int(s), precision
        self.L = 2 * self.m
        p, L, m = precision, self.L, self.m
        f = torch.fft.fftfreq(L, dtype=torch.float64)
        k = torch.arange(L, dtype=torch.float64)
        x = torch.arange(m, dtype=torch.float64)
        fwd = -2.0 * math.pi * k[:, None] * x[None, :] / L      # (L, m)
        self.F = (p.t(torch.cos(fwd)), p.t(torch.sin(fwd)))
        inv = 2.0 * math.pi * x[:, None] * k[None, :] / L       # (m, L)
        self.G = (p.t(torch.cos(inv) / L), p.t(torch.sin(inv) / L))
        self.f = p.t(f)
        sigma = TARGET_FWHM_FINE_PIX / (2.0 * math.sqrt(2.0 * math.log(2.0)))
        self.r_hat = p.t(torch.exp(-2.0 * math.pi**2 * sigma**2
                                   * (f[:, None] ** 2 + f[None, :] ** 2)))
        ang = 2.0 * math.pi * (f[:, None] + f[None, :]) * (m - 1) / 2.0
        self.centre = (p.t(torch.cos(ang)), p.t(torch.sin(ang)))

    def spectrum(self, img):
        """Full spectrum (re, im), (..., L, L), of real (..., m, m) images
        zero-padded to L."""
        mm = self.p.mm
        Fr, Fi = self.F
        ar, ai = mm(Fr, img), mm(Fi, img)
        return (mm(ar, Fr.T) - mm(ai, Fi.T), mm(ar, Fi.T) + mm(ai, Fr.T))

    def inverse(self, re, im):
        """The real part of the inverse of a full spectrum, cropped to the
        first (m, m) corner."""
        mm = self.p.mm
        Gr, Gi = self.G
        ar = mm(Gr, re) - mm(Gi, im)
        ai = mm(Gr, im) + mm(Gi, re)
        return mm(ar, Gr.T) - mm(ai, Gi.T)

    def down(self, fine):
        *lead, m, _ = fine.shape
        s = self.s
        return fine.reshape(*lead, m // s, s, m // s, s).sum(dim=(-3, -1))

    def psf_spectra(self, psf):
        """Spectra of the narrow PSFs (N, m, m), each scaled to unit sum."""
        psf = self.p.t(psf)
        return self.spectrum(psf / psf.sum(dim=(-2, -1), keepdim=True))

    def sources(self, a, px, py):
        """Spectrum (re, im), (N, L, L), of sum_j a_j delta(. - s p_j)
        (N, M each)."""
        p, s, f = self.p, self.s, self.f
        a, px, py = p.t(a), p.t(px), p.t(py)
        ay = -2.0 * math.pi * (s * py)[..., :, None] * f   # (N, M, L)
        ax = -2.0 * math.pi * (s * px)[..., :, None] * f
        ur, ui = a[..., None] * torch.cos(ay), a[..., None] * torch.sin(ay)
        vr, vi = torch.cos(ax), torch.sin(ax)
        mm = p.mm
        return (mm(ur.transpose(-1, -2), vr) - mm(ui.transpose(-1, -2), vi),
                mm(ur.transpose(-1, -2), vi) + mm(ui.transpose(-1, -2), vr))

    def render(self, psf, a, px, py, h=None, mean=None, block=125):
        """Data-grid stamps (N, n, n): the model of the module docstring.
        ``psf`` (N, m, m); ``a``, ``px``, ``py`` (N, M); ``h`` (m, m) or
        None; ``mean`` (N,) or None."""
        h_hat = None if h is None else self.spectrum(self.p.t(h))
        out = []
        for lo in range(0, psf.shape[0], block):
            sl = slice(lo, lo + block)
            tr, ti = self.psf_spectra(psf[sl])
            xr, xi = self.sources(a[sl], px[sl], py[sl])
            xr, xi = xr * self.r_hat, xi * self.r_hat
            if h_hat is not None:
                cr, ci = self.centre
                xr = xr + h_hat[0] * cr - h_hat[1] * ci
                xi = xi + h_hat[0] * ci + h_hat[1] * cr
            data = self.down(self.inverse(tr * xr - ti * xi,
                                          tr * xi + ti * xr))
            if mean is not None:
                data = data + self.p.t(mean[sl])[:, None, None]
            out.append(data)
        return torch.cat(out)


def starlet(img, n_scales):
    """Starlet (isotropic undecimated wavelet) coefficients
    (..., n_scales + 1, m, m): B3-spline a-trous smoothing, separable,
    mirror boundary (index -1 reads 0, index m reads m - 1); the detail
    scales, then the last smooth plane."""
    taps = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)
    m = img.shape[-1]

    def mirror(offset):
        i = torch.arange(m, device=img.device) + offset
        i = torch.where(i < 0, -1 - i, i)
        return torch.where(i >= m, 2 * m - 1 - i, i)

    def smooth(x, d, dim):
        return sum(w * torch.index_select(x, dim, mirror((k - 2) * d))
                   for k, w in enumerate(taps))

    planes, current = [], img
    for j in range(n_scales):
        smoothed = smooth(smooth(current, 2**j, -1), 2**j, -2)
        planes.append(current - smoothed)
        current = smoothed
    planes.append(current)
    return torch.stack(planes, dim=-3)
