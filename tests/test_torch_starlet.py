"""Port parity: the starlet twin, its adjoint and the differentiable op.

The torch twin (lightcurver_tpu_torch/core/starlet.py) is held to the JAX
starlet and to the Pallas kernel in interpret mode; the plain adjoint to
torch autograd; the differentiable op to the JAX custom VJP. The CUDA
kernels' own tests are in test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from lightcurver_tpu.core.starlet import starlet_transform as jax_starlet
from lightcurver_tpu.ops.starlet_pallas import starlet_transform_pallas
from lightcurver_tpu_torch.core import starlet as twin
from lightcurver_tpu_torch.ops import starlet_op


def _image(m, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (m, m)).astype(
        np.float32)


@pytest.mark.parametrize("m", [16, 24, 32])
def test_twin_matches_jax_starlet(m):
    x = _image(m)
    ref = np.asarray(jax_starlet(jnp.asarray(x)))
    out = twin.starlet_transform(torch.from_numpy(x)).numpy()
    assert out.shape == (twin.n_starlet_scales(m) + 1, m, m)
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("m", [16, 24, 32])
def test_twin_matches_pallas_interpret(m):
    x = _image(m, seed=1)
    ref = np.asarray(starlet_transform_pallas(jnp.asarray(x),
                                              interpret=True))
    out = twin.starlet_transform(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    np.testing.assert_allclose(twin.starlet_reconstruct(
        torch.from_numpy(out)).numpy(), x, atol=1e-6)


@pytest.mark.parametrize("m", [16, 24])
def test_plain_adjoint_matches_autograd(m):
    """<T x, g> = <x, T^T g>: the explicit adjoint equals autograd's."""
    rng = np.random.default_rng(2)
    x = torch.tensor(_image(m), dtype=torch.float64, requires_grad=True)
    g = torch.tensor(rng.normal(size=(twin.n_starlet_scales(m) + 1, m, m)))
    (twin.starlet_transform(x) * g).sum().backward()
    np.testing.assert_allclose(twin.starlet_adjoint(g).numpy(),
                               x.grad.numpy(), atol=1e-12)
    # batched input, float32
    gb = g.to(torch.float32).expand(3, -1, -1, -1)
    np.testing.assert_allclose(twin.starlet_adjoint(gb)[1].numpy(),
                               x.grad.numpy(), atol=1e-5)


@pytest.mark.parametrize("start", ["random", "zeros"])
def test_weighted_l1_gradient_matches_pallas_vjp(start, monkeypatch):
    """grad of sum W |T(x)| through the op equals the JAX custom VJP with
    the interpret-mode Pallas forward (16x16, 3 scales); at x = 0 this
    also pins |x|' = +1 at zero, as jnp.abs."""
    from lightcurver_tpu.ops import starlet_op as jax_op
    from lightcurver_tpu_torch.core.deconv.loss import _abs

    monkeypatch.setattr(
        jax_op, "starlet_transform_pallas",
        lambda img, n_scales=None: starlet_transform_pallas(
            img, n_scales=n_scales, interpret=True))
    rng = np.random.default_rng(5)
    x = _image(16, seed=3) if start == "random" \
        else np.zeros((16, 16), np.float32)
    W = rng.uniform(0.5, 2.0, (4, 16, 16)).astype(np.float32)

    g_ref = jax.grad(lambda v: (jnp.asarray(W) * jnp.abs(
        jax_op._starlet_pallas_ad(v, 3))).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (torch.from_numpy(W) * _abs(starlet_op.starlet_transform(xt, 3))) \
        .sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_ref),
                               atol=1e-5)


def _mirror(i, m):
    i = np.where(i < 0, -1 - i, i)
    return np.where(i >= m, 2 * m - 1 - i, i)


def _banded(planes, n_clusters, adjoint):
    """The cluster kernels' schedule (``csrc/starlet.cu``) on one image, in
    plain torch: the forward of ``planes`` (m, m), or the adjoint of
    ``planes`` (J + 1, m, m).

    Band r of C = ``n_clusters`` holds rows [r R, min((r + 1) R, m)),
    R = ceil(m / C); the rows past m (short or empty last bands) are NaN,
    so any read of them shows. A level smooths each band's rows along x
    through the mirrored column indices, into the row-smoothed buffer of
    its parity; the column pass then takes each tap's row from the band
    that the row table (row i in [-m, 2m) -> owner, row in its band, through
    the mirror) names, and updates the band in place.
    """
    m = planes.shape[-1]
    n_scales = planes.shape[0] - 1 if adjoint else twin.n_starlet_scales(m)
    w = twin._W
    R = -(-m // n_clusters)
    rows = _mirror(np.arange(-m, 2 * m), m)
    owner, local = rows // R, rows % R
    nan = torch.full((n_clusters * R - m, m), float("nan"))

    def bands(plane):
        return torch.cat([plane, nan]).reshape(n_clusters, R, m)

    tmp = [bands(torch.zeros(m, m)) for _ in range(2)]
    if adjoint:
        g = planes
        cur = bands(g[-1] - g[-2] if n_scales else g[-1])
        levels = range(n_scales - 1, -1, -1)
    else:
        cur, out = bands(planes), []
        levels = range(n_scales)
    y = np.arange(n_clusters * R)[:m]
    for j in levels:
        d = 2**j
        t = tmp[j % 2]
        cols = [torch.from_numpy(_mirror(np.arange(m) + (k - 2) * d, m))
                for k in range(5)]
        t[:] = sum((w[k] * cur[:, :, cols[k]] for k in range(1, 5)),
                   w[0] * cur[:, :, cols[0]])
        taps = [t[owner[y + (k - 2) * d + m], local[y + (k - 2) * d + m]]
                for k in range(5)]
        s = taps[0] * w[0]
        for k in range(1, 5):
            s = s + w[k] * taps[k]
        flat = cur.reshape(-1, m)[:m]
        if adjoint:
            s = s + g[j] - (g[j - 1] if j > 0 else 0)
        else:
            out.append(flat - s)
        cur = bands(s)
    result = cur.reshape(-1, m)[:m]
    return result if adjoint else torch.stack(out + [result])


@jax.jit
def _jax_adjoint(x, g):
    """``jax.vjp`` of JAX's starlet at x, applied to g (jitted: applied
    eagerly it takes seconds at m 256 on the CPU)."""
    return jax.vjp(jax_starlet, x)[1](g)[0]


@pytest.mark.parametrize("n_clusters", [1, 8, 16])
@pytest.mark.parametrize("m", [24, 62, 128, 256])
def test_banded_schedule_matches_twin_and_jax(m, n_clusters):
    """The cluster kernels' schedule, rehearsed on the CPU (bands, owner
    table, halo rows from the owning band, two alternating buffers): the
    forward against the twin and JAX's starlet, the adjoint against the
    twin's and ``jax.vjp`` of JAX's starlet, unit-normal images."""
    x = _image(m, seed=m)
    J = twin.n_starlet_scales(m)
    g = np.random.default_rng(m + 1).normal(0, 1, (J + 1, m, m)).astype(
        np.float32)
    fwd = _banded(torch.from_numpy(x), n_clusters, adjoint=False).numpy()
    adj = _banded(torch.from_numpy(g), n_clusters, adjoint=True).numpy()
    np.testing.assert_allclose(fwd, twin.starlet_transform(
        torch.from_numpy(x)).numpy(), atol=1e-6)
    np.testing.assert_allclose(adj, twin.starlet_adjoint(
        torch.from_numpy(g)).numpy(), atol=1e-6)
    np.testing.assert_allclose(fwd, np.asarray(jax_starlet(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_allclose(
        adj, np.asarray(_jax_adjoint(jnp.asarray(x), jnp.asarray(g))),
        atol=1e-6)
