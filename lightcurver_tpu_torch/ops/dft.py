"""Real 2-D DFTs as pairs of real matmuls (twin of ``lightcurver_tpu/ops/dft.py``).

    out[y, x] = Re sum_{k, j} X[k, j] w[j] e^{2 pi i k y / L}
                                          e^{2 pi i j x / L} / L^2

with ``w`` the Hermitian doubling weights of the half spectrum. The crop to
the (m, m) model region, the zero padding of a forward transform and the
s x s sum-pool onto the data grid are folded into the matrix shapes.

The matrices are built in float64 numpy by the same formulas as the JAX
package and cast to float32 once, on an explicit device, so both packages
hold the same float32 matrices. The transforms are plain torch matmuls in
float32 with TF32 off (``ops.enforce_fp32``); the JAX package's bf16
precision names are TPU modes and have no counterpart here. The matmul
render of the deconvolution model (``core/deconv/model.py``,
``_model_all_real``) runs through the fused kernel of
``ops/fused_render.py`` instead of :func:`irfft2_pool_matmul_parts`.
"""

import numpy as np
import torch


def _crop_mats_np(L, m):
    """float64 irfft2-crop matrices ``(Ay, By, Cx, Sx)``."""
    Lh = L // 2 + 1
    k = np.arange(L)
    y = np.arange(m)
    Ay = np.cos(2 * np.pi * np.outer(y, k) / L) / L
    By = np.sin(2 * np.pi * np.outer(y, k) / L) / L
    j = np.arange(Lh)
    x = np.arange(m)
    w = np.ones(Lh)
    if L % 2 == 0:
        w[1:-1] = 2.0  # every non-DC, non-Nyquist bin appears twice
    else:
        w[1:] = 2.0    # odd L: no Nyquist bin, every non-DC bin doubles
    Cx = (np.cos(2 * np.pi * np.outer(j, x) / L) * w[:, None]) / L
    Sx = (np.sin(2 * np.pi * np.outer(j, x) / L) * w[:, None]) / L
    return Ay, By, Cx, Sx


def _f32(mats, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            .to(device) for k, v in mats.items()}


def make_irfft2_crop_mats(L, m, device=None):
    """irfft2 at length L cropped to the leading (m, m).

    ``Ay``, ``By`` (m, L) act on the full-spectrum axis, ``Cx``, ``Sx``
    (L//2+1, m) on the half axis with Hermitian doubling; ``ABy`` is
    ``[Ay; By]`` stacked (stage 1 reads each spectrum part once).
    """
    Ay, By, Cx, Sx = _crop_mats_np(L, m)
    return _f32({"Ay": Ay, "By": By, "Cx": Cx, "Sx": Sx,
                 "ABy": np.concatenate([Ay, By], axis=0)}, device)


def make_irfft2_pool_mats(L, m, s, device=None):
    """irfft2 at L, crop to (m, m), then s x s sum-pool, as matrices.

    The pool is linear, so it folds into the matrices (rows of Ay/By and
    columns of Cx/Sx summed in groups of s, in float64): the product lands
    on the (m/s, m/s) data grid directly.
    """
    if m % s:
        raise ValueError(f"m={m} is not a multiple of s={s}")
    n = m // s
    Ay, By, Cx, Sx = _crop_mats_np(L, m)
    ayp = Ay.reshape(n, s, L).sum(axis=1)
    byp = By.reshape(n, s, L).sum(axis=1)
    return _f32({"Ayp": ayp, "Byp": byp,
                 "Cxp": Cx.reshape(L // 2 + 1, n, s).sum(axis=2),
                 "Sxp": Sx.reshape(L // 2 + 1, n, s).sum(axis=2),
                 "AByp": np.concatenate([ayp, byp], axis=0)}, device)


def make_rfft2_pad_mats(L, m, device=None):
    """rfft2 of an (m, m) image zero-padded to (L, L), as matrices."""
    Lh = L // 2 + 1
    k = np.arange(L)
    y = np.arange(m)
    j = np.arange(Lh)
    x = np.arange(m)
    return _f32({"fCy": np.cos(2 * np.pi * np.outer(k, y) / L),
                 "fSy": np.sin(2 * np.pi * np.outer(k, y) / L),
                 "fCx": np.cos(2 * np.pi * np.outer(x, j) / L),
                 "fSx": np.sin(2 * np.pi * np.outer(x, j) / L)}, device)


def make_dft_mats(L, m, pool=None, device=None):
    """Forward (rfft2-pad) and inverse (irfft2-crop) matrices together;
    with ``pool=s`` also the pooled inverse of
    :func:`make_irfft2_pool_mats`."""
    mats = {**make_irfft2_crop_mats(L, m, device),
            **make_rfft2_pad_mats(L, m, device)}
    if pool is not None and m % int(pool) == 0:
        mats.update(make_irfft2_pool_mats(L, m, int(pool), device))
    return mats


def _stage1(AB, Xr, Xi, rows):
    """``A + iB = (Ay + i By) @ X`` from the stacked ``[Ay; By]``."""
    P = torch.matmul(AB, Xr)
    Q = torch.matmul(AB, Xi)
    return P[..., :rows, :] - Q[..., rows:, :], \
        Q[..., :rows, :] + P[..., rows:, :]


def irfft2_pool_matmul_parts(Xr, Xi, mats):
    """``downsample(irfft2(Xr + i Xi)[..., :m, :m], s)``: (..., n, n).

    The full-length axis is contracted first, then the half axis.
    """
    A, B = _stage1(mats["AByp"], Xr, Xi, mats["Ayp"].shape[0])
    return torch.matmul(A, mats["Cxp"]) - torch.matmul(B, mats["Sxp"])


def irfft2_pool_matmul(total_hat, mats):
    """:func:`irfft2_pool_matmul_parts` of a complex spectrum."""
    return irfft2_pool_matmul_parts(total_hat.real, total_hat.imag, mats)


def irfft2_crop_matmul(total_hat, mats):
    """``irfft2(total_hat, s=(L, L))[..., :m, :m]`` as matmuls."""
    A, B = _stage1(mats["ABy"], total_hat.real, total_hat.imag,
                   mats["Ay"].shape[0])
    return torch.matmul(A, mats["Cx"]) - torch.matmul(B, mats["Sx"])


def rfft2_pad_matmul_parts(img, mats):
    """(re, im) of ``rfft2(img, s=(L, L))`` for (..., m, m) input.

    ``X = (Cy - i Sy) @ img @ (Cx - i Sx)``, the half axis contracted
    first.
    """
    U = torch.matmul(img, mats["fCx"])
    V = torch.matmul(img, mats["fSx"])
    re = torch.matmul(mats["fCy"], U) - torch.matmul(mats["fSy"], V)
    im = -(torch.matmul(mats["fCy"], V) + torch.matmul(mats["fSy"], U))
    return re, im


def rfft2_pad_matmul(img, mats):
    """:func:`rfft2_pad_matmul_parts` as one complex tensor."""
    return torch.complex(*rfft2_pad_matmul_parts(img, mats))


def irfft2_pool_shift_matmul(S_re, S_im, u_re, u_im, v_re, v_im, mats):
    """Pooled renders of shifted copies of one spectrum, per batch element:

        out_i = Re{ (Ayp + i Byp) diag(u_i) (S_re + i S_im)
                                  diag(v_i) (Cxp + i Sxp) }

    The rank-1 ramp ``u_i v_i^T`` modulates the (n, L) inverse matrices, so
    no (..., L, L//2+1) spectrum is formed. ``S``: (L, L//2+1) shared, or
    (..., L, L//2+1) with the ramps' batch dims (JAX's
    ``batched_spectrum=True``; matmul broadcasting covers both);
    ``u``: (..., L); ``v``: (..., L//2+1). Returns (..., n, n).
    """
    ayp, byp = mats["Ayp"], mats["Byp"]
    R1 = ayp * u_re[..., None, :] - byp * u_im[..., None, :]
    I1 = ayp * u_im[..., None, :] + byp * u_re[..., None, :]
    Tr = torch.matmul(R1, S_re) - torch.matmul(I1, S_im)
    Ti = torch.matmul(R1, S_im) + torch.matmul(I1, S_re)
    U = Tr * v_re[..., None, :] - Ti * v_im[..., None, :]
    V = Tr * v_im[..., None, :] + Ti * v_re[..., None, :]
    return torch.matmul(U, mats["Cxp"]) - torch.matmul(V, mats["Sxp"])
