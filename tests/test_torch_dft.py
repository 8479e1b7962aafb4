"""Port parity: the matmul DFT (``ops/dft.py``) and the 1-D factors of
``core/convolution.py`` that the all-real render takes.

Inputs are seeded numpy arrays handed to both packages; JAX runs on the
CPU at its default precision name ("highest", exact float32). Sizes:
n 16, s 2, m 32, L 64. Tolerance: max|diff| <= 1e-5 max|ref| (float32 on
both sides, products summed in different orders); the matrices
themselves are equal to the last bit.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lightcurver_tpu.core import convolution as jconv
from lightcurver_tpu.ops import dft as jdft

from lightcurver_tpu_torch.core import convolution as tconv
from lightcurver_tpu_torch.ops import dft as tdft

n, s = 16, 2
m = n * s
L = 2 * m
Lh = L // 2 + 1


def close(out, ref, rel=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _spectrum(rng, *lead):
    return (rng.normal(size=(*lead, L, Lh))
            + 1j * rng.normal(size=(*lead, L, Lh))).astype(np.complex64)


@pytest.mark.parametrize("make,args", [
    ("make_irfft2_crop_mats", (L, m)),
    ("make_irfft2_pool_mats", (L, m, s)),
    ("make_rfft2_pad_mats", (L, m)),
    ("make_dft_mats", (L, m)),
])
def test_matrices_equal_to_the_last_bit(make, args):
    out = getattr(tdft, make)(*args)
    ref = getattr(jdft, make)(*args)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == torch.float32
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


def test_pooled_dft_mats_equal_to_the_last_bit():
    """The matrices of the "matmul" Loss: make_dft_mats(2m, m, pool=s)."""
    out = tdft.make_dft_mats(L, m, pool=s, device="cpu")
    ref = jdft.make_dft_mats(L, m, pool=s)
    assert set(out) == set(ref)
    assert {"Ayp", "Byp", "Cxp", "Sxp", "AByp"} <= set(out)
    for k in ref:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    for length in (L, L + 1):   # even and odd: other doubling weights
        for a, b in zip(tdft._crop_mats_np(length, m),
                        jdft._crop_mats_np(length, m)):
            np.testing.assert_array_equal(a, b)


def test_inverse_transforms():
    rng = np.random.default_rng(0)
    spec = _spectrum(rng, 3)
    tmats = tdft.make_dft_mats(L, m, pool=s)
    jmats = jdft.make_dft_mats(L, m, pool=s)
    ts, js = torch.from_numpy(spec), jnp.asarray(spec)
    close(tdft.irfft2_pool_matmul(ts, tmats),
          jdft.irfft2_pool_matmul(js, jmats))
    close(tdft.irfft2_pool_matmul_parts(ts.real.contiguous(),
                                        ts.imag.contiguous(), tmats),
          jdft.irfft2_pool_matmul_parts(js.real, js.imag, jmats))
    close(tdft.irfft2_crop_matmul(ts, tmats),
          jdft.irfft2_crop_matmul(js, jmats))
    # and both are the cropped (and pooled) irfft2
    fine = np.fft.irfft2(spec.astype(np.complex128), s=(L, L))[..., :m, :m]
    close(tdft.irfft2_crop_matmul(ts, tmats), fine)
    close(tdft.irfft2_pool_matmul(ts, tmats),
          fine.reshape(3, n, s, n, s).sum(axis=(2, 4)))


def test_forward_transforms():
    rng = np.random.default_rng(1)
    img = rng.normal(size=(2, m, m)).astype(np.float32)
    tmats = tdft.make_rfft2_pad_mats(L, m)
    jmats = jdft.make_rfft2_pad_mats(L, m)
    for out, ref in zip(tdft.rfft2_pad_matmul_parts(torch.from_numpy(img),
                                                    tmats),
                        jdft.rfft2_pad_matmul_parts(jnp.asarray(img),
                                                    jmats)):
        close(out, ref)
    out = tdft.rfft2_pad_matmul(torch.from_numpy(img), tmats)
    ref = np.fft.rfft2(img.astype(np.float64), s=(L, L))
    close(torch.view_as_real(out), np.stack([ref.real, ref.imag], -1))


@pytest.mark.parametrize("batched", [False, True])
def test_pool_shift_matmul(batched):
    rng = np.random.default_rng(2)
    N = 3
    S = _spectrum(rng, N) if batched else _spectrum(rng)
    u = rng.normal(size=(2, N, L)).astype(np.float32)
    v = rng.normal(size=(2, N, Lh)).astype(np.float32)
    tmats = tdft.make_irfft2_pool_mats(L, m, s)
    jmats = jdft.make_irfft2_pool_mats(L, m, s)
    out = tdft.irfft2_pool_shift_matmul(
        torch.from_numpy(S.real.copy()), torch.from_numpy(S.imag.copy()),
        *map(torch.from_numpy, (u[0], u[1], v[0], v[1])), tmats)
    ref = jdft.irfft2_pool_shift_matmul(
        jnp.asarray(S.real), jnp.asarray(S.imag), *map(jnp.asarray, (
            u[0], u[1], v[0], v[1])), jmats, batched_spectrum=batched)
    close(out, ref)


@pytest.mark.parametrize("n_src", [1, 3])
def test_convolution_factors_and_ramps(n_src):
    rng = np.random.default_rng(3)
    for out, ref in zip(tconv.r_kernel_fft_1d(m, s),
                        jconv.r_kernel_fft_1d(m, s)):
        close(out, ref)
    for out, ref in zip(tconv.grid_center_phase_1d(m),
                        jconv.grid_center_phase_1d(m)):
        close(out, ref)
    a, px, py = (rng.uniform(-3, 3, (4, n_src)).astype(np.float32)
                 for _ in range(3))
    ta, tpx, tpy = map(torch.from_numpy, (a, px, py))
    ry, rx = tconv.r_kernel_fft_1d(m, s)
    jry, jrx = jconv.r_kernel_fft_1d(m, s)
    for fold in (False, True):
        kw_t = dict(ry=ry, rx=rx) if fold else {}
        kw_j = dict(ry=jry, rx=jrx) if fold else {}
        for out, ref in zip(
                tconv.point_source_ramps(m, s, ta[:, 0], tpx[:, 0],
                                         tpy[:, 0], **kw_t),
                jconv.point_source_ramps(m, s, a[:, 0], px[:, 0], py[:, 0],
                                         **kw_j)):
            close(out, ref)
        for out, ref in zip(
                tconv.point_source_ramp_stacks(m, s, ta, tpx, tpy, **kw_t),
                jconv.point_source_ramp_stacks(m, s, a, px, py, **kw_j)):
            close(out, ref)
        for out, ref in zip(
                tconv.point_source_spectrum_parts(m, s, ta, tpx, tpy,
                                                  **kw_t),
                jconv.point_source_spectrum_parts(m, s, a, px, py, **kw_j)):
            close(out, ref)
