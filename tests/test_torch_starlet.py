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
