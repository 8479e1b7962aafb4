"""BASELINE.json's config 5 at the survey's depth: 1000 epochs, at a narrow
width, on the CPU against the JAX package.

- The ROI ``Loss`` (chi2, the starlet-l1 of a free background with noise
  weights, positivity, point-source proximity and flux uniformity) at
  1000 epochs of 16 px, s 2, four sources, on each render ("fft", and
  "matmul", JAX's "mxu", whose background gradient is a sum over every
  epoch): the value within rtol 1e-5, each gradient leaf within 1e-5 of
  its largest entry, but the fluxes and the per-epoch constants, which
  are held at 5e-5: the float32 floor that
  ``tests/test_torch_fused_render.py`` documents on its matmul loss test
  (one-ulp differences of torch's and XLA's sin and cos in the
  point-source ramps, summed with cancellation by the DFT, put the port's
  flux gradient 0.6-3.4e-5 of its maximum from JAX's). The constant's
  gradient is the epoch's sum of residuals, which carries the same render
  difference: on this scene its gap to JAX is 1.2e-5 of its maximum over
  the first 4 epochs and 2.6e-5 over all 1000, on each render, and the
  two leaves' per-epoch gaps correlate at 0.92, while a one-ulp change
  of the data moves either leaf by < 5e-7 in JAX and in the port.
- The epoch padding, stripping and cutting of the sharded fits at 1000
  epochs over 3 ranks (padded to 1002) and 4 (250 a rank): the port's
  numpy helpers against JAX's ``pad_epoch_stacks``, ``pad_epoch_kwargs``
  and ``strip_epoch_kwargs`` to the bit, and each rank's share
  (``epoch_range``, ``shard_pytree``, ``shard_consts``) against the
  shard JAX places on that device of its epoch mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightcurver_tpu.core.deconv import loss as jloss
from lightcurver_tpu.core.deconv import model as jmodel
from lightcurver_tpu.core import params as jparams
from lightcurver_tpu.parallel import deconv as jdeconv
from lightcurver_tpu.parallel.mesh import epoch_mesh as jax_epoch_mesh

from lightcurver_tpu_torch.core.deconv import loss as tloss
from lightcurver_tpu_torch.core.deconv import model as tmodel
from lightcurver_tpu_torch.core import params as tparams
from lightcurver_tpu_torch.parallel import deconv as tdeconv
from lightcurver_tpu_torch.parallel.mesh import EPOCH_AXIS
from lightcurver_tpu_torch.utilities.synthetic import make_roi_scene

N_EPOCHS, N_PIX, S, M = 1000, 16, 2, 4
LEAF_BAR, FLOOR_BAR = 1e-5, 5e-5
FLOOR_LEAVES = ("a", "mean")   # the fluxes and the per-epoch constants
JAX_BACKEND = {"fft": "fft", "matmul": "mxu"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    """The survey scene at 16 px and a parameter point near its truth, the
    background and the noise weights random (numpy)."""
    scene = make_roi_scene(n_epochs=N_EPOCHS, n_pix=N_PIX, s=S,
                           n_sources=M, seed=5)
    rng = np.random.default_rng(50)
    m = N_PIX * S
    kw = {
        "kwargs_analytic": {
            "a": (scene["a_true"] * rng.uniform(0.9, 1.1, (N_EPOCHS, M)))
            .ravel().astype(np.float32),
            "c_x": scene["xs"] + np.float32(0.1),
            "c_y": scene["ys"] - np.float32(0.1),
            "dx": rng.uniform(-0.2, 0.2, N_EPOCHS).astype(np.float32),
            "dy": rng.uniform(-0.2, 0.2, N_EPOCHS).astype(np.float32),
            "alpha": rng.uniform(-10, 10, N_EPOCHS).astype(np.float32),
        },
        "kwargs_background": {
            "h": rng.normal(0, 0.02, m * m).astype(np.float32),
            "mean": rng.normal(0, 0.05, N_EPOCHS).astype(np.float32),
        },
        "kwargs_sersic": {},
    }
    W = rng.uniform(0.5, 2.0, (int(np.log2(m)) + 1, m, m)).astype(np.float32)
    return dict(scene, kw=kw, W=W)


def _losses(p, backend):
    """JAX's Loss and the port's, with every term, the rotations fixed."""
    args = (p["data"], p["sigma_2"], p["psf"], p["xs"], p["ys"], S)
    jm, _, jup, jdown, _ = jmodel.setup_model(*args)
    tm, _, tup, tdown, _ = tmodel.setup_model(*args, device="cpu")
    fixed = {"kwargs_analytic": {
        "alpha": p["kw"]["kwargs_analytic"]["alpha"]}}
    terms = dict(regularization_terms="l1_starlet",
                 regularization_strength_scales=1.3,
                 regularization_strength_hf=0.7,
                 regularization_strength_positivity=100.0,
                 regularization_strength_pts_source=0.01,
                 regularization_strength_flux_uniformity=0.5, W=p["W"])
    jp = jparams.Params(jax.tree_util.tree_map(jnp.asarray, p["kw"]),
                        jax.tree_util.tree_map(jnp.asarray, fixed), jup,
                        jdown)
    tp = tparams.Params(tparams.kwargs_from_numpy(p["kw"], "cpu"),
                        tparams.kwargs_from_numpy(fixed, "cpu"), tup, tdown)
    jl = jloss.Loss(p["data"], jm, jp, p["sigma_2"],
                    irfft_backend=JAX_BACKEND[backend], **terms)
    tl = tloss.Loss(p["data"], tm, tp, p["sigma_2"],
                    irfft_backend=backend, **terms)
    return jl, jp, tl, tp


@pytest.mark.parametrize("backend", ["fft", "matmul"])
def test_loss_value_and_gradient_at_1000_epochs(problem, backend):
    jl, jp, tl, tp = _losses(problem, backend)
    value_j, grad_j = jax.jit(jax.value_and_grad(jl.loss_fn))(jp.free0,
                                                              jl.consts)
    free = {k: {kk: v.clone().requires_grad_(True) for kk, v in d.items()}
            for k, d in tp.free0.items()}
    value_t = tl.loss_fn(free)
    value_t.backward()
    np.testing.assert_allclose(value_t.item(), float(value_j), rtol=1e-5)
    gaps = {}
    for k, d in free.items():
        for leaf, v in d.items():
            got, want = v.grad.numpy(), np.asarray(grad_j[k][leaf])
            assert got.shape == want.shape
            gaps[leaf] = np.abs(got - want).max() / np.abs(want).max()
    print(f"{backend}: gradient gaps to JAX / max|leaf|: "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
    for leaf, gap in gaps.items():
        assert gap <= (FLOOR_BAR if leaf in FLOOR_LEAVES else LEAF_BAR), \
            leaf


class _EpochMesh:
    """The two methods of a ``DeviceMesh`` that ``epoch_range`` reads, for
    rank ``rank`` of a 1-D epoch mesh of ``n`` ranks."""

    mesh_dim_names = (EPOCH_AXIS,)

    def __init__(self, n, rank):
        self.shape, self.rank = (n,), rank

    def get_local_rank(self, name):
        assert name == EPOCH_AXIS
        return self.rank


def _kwargs(rng, n):
    return {
        "kwargs_analytic": {
            "a": rng.uniform(40, 120, n * M).astype(np.float32),
            "c_x": rng.normal(size=M).astype(np.float32),
            "c_y": rng.normal(size=M).astype(np.float32),
            "dx": rng.normal(size=n).astype(np.float32),
            "dy": rng.normal(size=n).astype(np.float32),
            "alpha": rng.normal(size=n).astype(np.float32)},
        "kwargs_background": {"mean": rng.normal(size=n).astype(np.float32),
                              "h": rng.normal(size=64).astype(np.float32)},
    }


def _leaves(tree):
    return {(g, k): np.asarray(v) for g, d in tree.items()
            for k, v in d.items()}


@pytest.mark.parametrize("n_ranks", [3, 4])
def test_pad_strip_and_cut_match_jax_at_1000_epochs(n_ranks):
    rng = np.random.default_rng(n_ranks)
    data = rng.normal(size=(N_EPOCHS, 6, 6)).astype(np.float32)
    sigma_2 = rng.uniform(1, 2, (N_EPOCHS, 6, 6)).astype(np.float32)
    psf = rng.uniform(0, 1, (N_EPOCHS, 12, 12)).astype(np.float32)
    got = tdeconv.pad_epoch_stacks(data, sigma_2, psf, n_ranks)
    want = jdeconv.pad_epoch_stacks(data, sigma_2, psf, n_ranks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    n_all = got[0].shape[0]
    n_pad = n_all - N_EPOCHS
    assert n_all % n_ranks == 0 and n_pad == (-N_EPOCHS) % n_ranks
    # the dummy epochs weigh exactly nothing
    np.testing.assert_array_equal(got[3], np.r_[np.ones(N_EPOCHS),
                                                np.zeros(n_pad)])

    kwargs = _kwargs(rng, N_EPOCHS)
    padded = tdeconv.pad_epoch_kwargs(kwargs, N_EPOCHS, n_pad, M)
    jpadded = jdeconv.pad_epoch_kwargs(kwargs, N_EPOCHS, n_pad, M)
    assert _leaves(padded).keys() == _leaves(jpadded).keys()
    for key, value in _leaves(jpadded).items():
        np.testing.assert_array_equal(_leaves(padded)[key], value)
    stripped = tdeconv.strip_epoch_kwargs(padded, N_EPOCHS, n_pad, M)
    for key, value in _leaves(kwargs).items():
        np.testing.assert_array_equal(_leaves(stripped)[key], value)
        np.testing.assert_array_equal(np.asarray(_leaves(
            jdeconv.strip_epoch_kwargs(jpadded, N_EPOCHS, n_pad, M))[key]),
            value)

    # each rank's share against the shard JAX places on that device
    mesh = jax_epoch_mesh(n_ranks)
    jtree = jdeconv.shard_pytree(mesh, jax.tree_util.tree_map(jnp.asarray,
                                                              jpadded))
    jconsts = jdeconv.shard_consts(mesh, {"data": jnp.asarray(got[0]),
                                          "epoch_w": jnp.asarray(got[3])})
    ttree = tparams.kwargs_from_numpy(padded, "cpu")
    tconsts = {"data": torch.from_numpy(got[0]),
               "epoch_w": torch.from_numpy(got[3])}
    for rank, device in enumerate(mesh.devices.ravel()):
        epochs = tdeconv.epoch_range(_EpochMesh(n_ranks, rank), n_all)
        assert epochs[1] - epochs[0] == n_all // n_ranks
        part = _leaves(tdeconv.shard_pytree(ttree, epochs, M))
        consts = tdeconv.shard_consts(tconsts, epochs)

        def shard(array):
            (piece,) = [s.data for s in array.addressable_shards
                        if s.device == device]
            return np.asarray(piece)

        for group, leaves in jtree.items():
            for key, value in leaves.items():
                np.testing.assert_array_equal(part[group, key], shard(value),
                                              err_msg=key)
        for key, value in jconsts.items():
            np.testing.assert_array_equal(consts[key].numpy(), shard(value))
