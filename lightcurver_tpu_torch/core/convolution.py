"""Zero-padded FFT convolution with Fourier-analytic source placement.

Twin of the FFT branch of ``lightcurver_tpu/core/convolution.py``:

- exact LINEAR convolution of (m, m) fine-grid images with (m, m) PSFs
  through zero-padding to ``L = 2m`` (``torch.fft.rfft2/irfft2`` with
  ``s=(L, L)``),
- sub-pixel placement of point sources by separable phase ramps on the
  PSF transform (images are never interpolated),
- the target Gaussian ``r`` as its analytic transform.

Alignment: folding ``exp(+2 pi i k.c / L)`` with ``c = (m - 1) / 2`` into
a PSF transform re-centres it at index 0, so convolving a gridded image
is peak-aligned and the output is the corner crop ``[0:m, 0:m]``.

The 1-D factors below (:func:`r_kernel_fft_1d`,
:func:`grid_center_phase_1d`, the ramps and ramp stacks) serve the
matmul-DFT render (``ops/dft.py``, JAX's "mxu" backend, called "matmul"
here): the all-real render of ``core/deconv/model.py`` and its fused
kernel (``ops/fused_render.py``) take the point sources as stacked
rank-1 factors instead of a formed spectrum.
"""

import math

import torch

from .conventions import fwhm_to_sigma, TARGET_FWHM_FINE_PIX


def pad_len(m):
    """FFT length for an (m, m) fine grid (exact linear convolution)."""
    return 2 * m


def _length(m, L):
    return pad_len(m) if L is None else int(L)


def freq_grids(m, device=None, dtype=torch.float32, L=None):
    """``(fy, fx)`` of shapes (L, 1) and (1, L // 2 + 1), cycles / fine px.

    ``L`` defaults to :func:`pad_len`; the PSF fit passes a reduced length
    (``core/psf/build.py::psf_fft_length``), so every helper below that
    takes ``L`` follows the DFT matrices' actual length.
    """
    L = _length(m, L)
    fy = torch.fft.fftfreq(L, device=device, dtype=dtype).reshape(L, 1)
    fx = torch.fft.rfftfreq(L, device=device, dtype=dtype).reshape(
        1, L // 2 + 1)
    return fy, fx


def r_kernel_fft(m, s, device=None, dtype=torch.float32, L=None):
    """Analytic rfft2 of the unit-integral target Gaussian at the origin."""
    del s
    sigma_f = fwhm_to_sigma(TARGET_FWHM_FINE_PIX)
    fy, fx = freq_grids(m, device=device, dtype=dtype, L=L)
    return torch.exp(-2.0 * math.pi**2 * sigma_f**2 * (fy**2 + fx**2))


def r_kernel_fft_1d(m, s, device=None, dtype=torch.float32, L=None):
    """Separable factors ``(ry, rx)`` of :func:`r_kernel_fft`, lengths
    L and L // 2 + 1: ``r_kernel_fft = ry[:, None] * rx[None, :]``."""
    del s
    sigma_f = fwhm_to_sigma(TARGET_FWHM_FINE_PIX)
    L = _length(m, L)
    fy = torch.fft.fftfreq(L, device=device, dtype=dtype)
    fx = torch.fft.rfftfreq(L, device=device, dtype=dtype)
    c = -2.0 * math.pi**2 * sigma_f**2
    return torch.exp(c * fy**2), torch.exp(c * fx**2)


def grid_center_phase_1d(m, device=None, dtype=torch.float32):
    """``(gy_re, gy_im, gx_re, gx_im)``, the separable factors of
    :func:`grid_center_phase` = ``(gy_re + i gy_im)[:, None] *
    (gx_re + i gx_im)``."""
    c = (m - 1) / 2.0
    L = pad_len(m)
    ay = 2.0 * math.pi * torch.fft.fftfreq(L, device=device, dtype=dtype) * c
    ax = 2.0 * math.pi * torch.fft.rfftfreq(L, device=device,
                                            dtype=dtype) * c
    return torch.cos(ay), torch.sin(ay), torch.cos(ax), torch.sin(ax)


def grid_center_phase(m, device=None, dtype=torch.float32):
    """The constant phase ``exp(+2 pi i (fy + fx) c)``, ``c = (m - 1) / 2``."""
    c = (m - 1) / 2.0
    fy, fx = freq_grids(m, device=device, dtype=dtype)
    ang = 2.0 * math.pi * (fy + fx) * c
    return torch.complex(torch.cos(ang), torch.sin(ang))


def shift_phase(m, sx, sy, device=None, dtype=torch.float32):
    """Phase ramp translating by (sx, sy) FINE pixels (real shifts): a
    complex tensor that broadcasts against rfft2 output at L = 2m. ``sx``
    and ``sy`` are scalars or tensors of the same leading batch dims; two
    trailing frequency axes are appended."""
    fy, fx = freq_grids(m, device=device, dtype=dtype)
    sx = torch.as_tensor(sx, dtype=dtype, device=device)[..., None, None]
    sy = torch.as_tensor(sy, dtype=dtype, device=device)[..., None, None]
    ang = -2.0 * math.pi * (fy * sy + fx * sx)
    return torch.complex(torch.cos(ang), torch.sin(ang))


def psf_fft(t):
    """rfft2 of zero-padded PSF arrays ``(..., m, m)`` (complex64)."""
    L = pad_len(t.shape[-1])
    return torch.fft.rfft2(t, s=(L, L))


def psf_fft_for_grid(t):
    """A PSF's transform ready to convolve gridded images: the centre
    phase folded in, so the convolution is peak-aligned (module doc)."""
    return psf_fft(t) * grid_center_phase(t.shape[-1], t.device)


def convolve_grid(img, t_hat_grid):
    """Linear 'same' convolution of (..., m, m) fine-grid images with a
    :func:`psf_fft_for_grid` transform: each pixel spawns a peak-aligned
    copy of the PSF. The inverse goes through :func:`hermitian_irfft2`,
    as every render of the port does."""
    m = img.shape[-1]
    L = pad_len(m)
    return render_from_fft(torch.fft.rfft2(img, s=(L, L)) * t_hat_grid, m)


def hermitian_irfft2(total_hat, L):
    """``irfft2(total_hat, s=(L, L))`` of the spectrum whose DC and (at even
    L) Nyquist columns are replaced by their Hermitian parts along the full
    axis, ``(X[k] + conj(X[-k])) / 2``.

    A shifted source's spectrum is not Hermitian in those columns: there
    its phase ramp is a complex constant (``exp(-i pi s px)`` at Nyquist).
    A C2R transform of such input is undefined: pocketfft (torch and JAX
    on the CPU) keeps the Hermitian part, cuFFT does not, and a free
    grid's spectrum gives that column weight (the batched PSF fit's grid
    gradient differed card against CPU by 2e-4 of its maximum, on the
    edge columns). Both devices now transform the same Hermitian input:
    on the CPU the result moves by rounding only, and the gradient not at
    all (the C2R adjoint is Hermitian in those columns).
    """
    # columns 0 and (even L) Lh - 1 as a strided view: an index list would
    # be copied from the host at every call, which a CUDA graph cannot hold
    last = total_hat.shape[-1] - 1
    edges = slice(0, None, last) if L % 2 == 0 else slice(0, 1)
    cols = total_hat[..., edges]
    mirror = torch.conj(torch.roll(torch.flip(cols, dims=[-2]), 1, dims=-2))
    total_hat = total_hat.clone()
    total_hat[..., edges] = 0.5 * (cols + mirror)
    return torch.fft.irfft2(total_hat, s=(L, L))


def render_from_fft(total_hat, m):
    """Inverse transform of an assembled spectrum + corner crop to (m, m)."""
    return hermitian_irfft2(total_hat, pad_len(m))[..., :m, :m]


def _ramp_angles(m, s, px, py, device, dtype, L):
    L = _length(m, L)
    fy = torch.fft.fftfreq(L, device=device, dtype=dtype)
    fx = torch.fft.rfftfreq(L, device=device, dtype=dtype)
    ay = -2.0 * math.pi * fy * (s * py)[..., None]
    ax = -2.0 * math.pi * fx * (s * px)[..., None]
    return ay, ax


def point_source_ramps(m, s, a, px, py, ry=None, rx=None, L=None):
    """1-D factors ``(u_re, u_im, v_re, v_im)`` of the separable ramps.

    The spectrum of ``a r(. - p)`` relative to a PSF transform is
    ``u v^T`` with ``u = a exp(-2 pi i fy s py)`` (length L) and
    ``v = exp(-2 pi i fx s px)`` (length L // 2 + 1); a frequency axis is
    appended to the shapes of ``a``/``px``/``py``. ``ry``/``rx`` (from
    :func:`r_kernel_fft_1d`) fold the target Gaussian in, so the ramps
    pair with the raw PSF spectrum.
    """
    ay, ax = _ramp_angles(m, s, px, py, a.device, a.dtype, L)
    uy = a[..., None] if ry is None else a[..., None] * ry
    vx_c, vx_s = torch.cos(ax), torch.sin(ax)
    if rx is not None:
        vx_c, vx_s = rx * vx_c, rx * vx_s
    return uy * torch.cos(ay), uy * torch.sin(ay), vx_c, vx_s


def point_source_ramp_stacks(m, s, a, px, py, ry=None, rx=None, L=None):
    """Stacked rank-1 factors ``(u_re, u_im, v)`` of the point sources.

    Shapes (..., 2M, L), (..., 2M, L), (..., 2M, L // 2 + 1), with

        spec_re = sum_c u_re[c] (x) v[c],   spec_im = sum_c u_im[c] (x) v[c]

    equal to :func:`point_source_spectrum`: with ``cy + i sy`` and
    ``cx + i sx`` the two ramps, ``u_re = [a cy, -a sy]``,
    ``u_im = [a sy, a cy]`` and ``v = [cx, sx]``. ``ry``/``rx`` as in
    :func:`point_source_ramps`.
    """
    ay, ax = _ramp_angles(m, s, px, py, a.device, a.dtype, L)
    cy, sy = torch.cos(ay), torch.sin(ay)                 # (..., M, L)
    cx, sx = torch.cos(ax), torch.sin(ax)                 # (..., M, Lh)
    uy = a[..., None] if ry is None else a[..., None] * ry
    u_re = torch.cat([uy * cy, -uy * sy], dim=-2)
    u_im = torch.cat([uy * sy, uy * cy], dim=-2)
    if rx is not None:
        cx, sx = rx * cx, rx * sx
    return u_re, u_im, torch.cat([cx, sx], dim=-2)


def point_source_spectrum_parts(m, s, a, px, py, ry=None, rx=None, L=None):
    """(re, im) of the point-source spectrum as two real tensors, by two
    contractions over the stacked axis 2M."""
    u_re, u_im, v = point_source_ramp_stacks(m, s, a, px, py, ry=ry, rx=rx,
                                             L=L)
    return torch.einsum("...jy,...jx->...yx", u_re, v), \
        torch.einsum("...jy,...jx->...yx", u_im, v)


def point_source_spectrum(m, s, a, px, py, L=None):
    """Spectrum of ``sum_j a_j r(. - p_j)`` relative to a PSF transform.

    Args:
        a, px, py: (..., M) tensors; positions in data pixels, centre
            origin.

    Returns:
        complex64 (..., L, L // 2 + 1).

    The phase is separable, ``exp(-2 pi i fy sy) (x) exp(-2 pi i fx sx)``,
    so the source sum is two contractions over the stacked axis 2M:
    ``re = [a cy, -a sy] @ [cx, sx]`` and ``im = [a sy, a cy] @ [cx, sx]``;
    a single source is a plain outer product (the same two branches as
    the JAX twin, so both round alike). ``L`` as in :func:`freq_grids`.
    """
    ay, ax = _ramp_angles(m, s, px, py, a.device, a.dtype, L)
    amps = a[..., None]
    if a.shape[-1] == 1:
        u_re = (amps * torch.cos(ay))[..., 0, :, None]
        u_im = (amps * torch.sin(ay))[..., 0, :, None]
        vx_c = torch.cos(ax)[..., 0, None, :]
        vx_s = torch.sin(ax)[..., 0, None, :]
        re = u_re * vx_c - u_im * vx_s
        im = u_re * vx_s + u_im * vx_c
        return torch.complex(re, im)
    return torch.complex(*point_source_spectrum_parts(m, s, a, px, py,
                                                      L=L))
