"""Port parity for the bench helpers (``utilities/benchmarking.py``) and the
PSF task's synthetic workdir (``utilities/synthetic.make_psf_task_workdir``).

Held against the JAX package on the CPU, in one process:

- the five names keep JAX's positional signatures;
- ``compiled_cost`` of a product gives XLA's FLOPs; K1 and K2 count as
  units from their shapes (``starlet_cuda.work``,
  ``fused_render_cuda.work``), whether the plain twin runs or not: K1 at
  (m 128, batch 1) the 589 824 bytes, K2 at ROI-100's stage-2 shape the
  work of its 11.5 us bound (PERF.md);
- the pixel-phase PSF and batched star value-and-grads on JAX's trees,
  carried across as numpy (JAX's own point and a seeded perturbation of
  it), to 1e-5 of JAX's value and of the gradient's largest element,
  on both renders; their FLOPs double, within 1 %, with the
  batch;
- the timing loops on the CPU (eager: the CUDA-graph path needs a card,
  ``chip_smoke.py`` phase 16): a positive finite time, each step's input
  different from the last, ``n_best_of`` timed runs;
- ``make_psf_task_workdir``: the same DB rows and bit-equal HDF5 datasets
  as JAX's at (4 frames, 3 stars, 16 px, seed 11), and the port's PSF
  task runs on it.
"""

import contextlib
import inspect
import math
import os
import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightcurver_tpu import ops as jops
from lightcurver_tpu.utilities import benchmarking as jbench
from lightcurver_tpu.utilities import synthetic as jsynth

from lightcurver_tpu_torch.ops import fused_render, starlet_cuda
from lightcurver_tpu_torch.ops import fused_render_cuda
from lightcurver_tpu_torch.ops.starlet_op import starlet_transform
from lightcurver_tpu_torch.utilities import benchmarking as tbench
from lightcurver_tpu_torch.utilities import synthetic as tsynth

TOL = 1e-5
BACKENDS = ("fft", "matmul")
NAMES = ("time_compiled_loop", "compiled_cost", "psf_pixel_phase_cost",
         "star_fit_phase_cost", "time_vg_loop")
# keyword-only extras of the port's helpers
EXTRAS = {"device", "irfft_backend", "eager", "record"}
# H100 SXM peaks of chip_smoke.py's bounds
HBM_BYTES_PER_S, FP32_FLOPS, TF32_FLOPS = 3.35e12, 67e12, 495e12


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """As in the calibration chain's file: one intra-op thread beside the
    suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _jax_render(backend):
    prev = jops.get_irfft_backend()
    jops.set_irfft_backend("mxu" if backend == "matmul" else "fft")
    try:
        yield
    finally:
        jops.set_irfft_backend(prev)


def _positional(fn):
    return [(p.name, p.default)
            for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def _keyword_only(fn):
    return {p.name for p in inspect.signature(fn).parameters.values()
            if p.kind is p.KEYWORD_ONLY}


@pytest.mark.parametrize("module, name", [
    *((("benchmarking", jbench, tbench), n) for n in NAMES),
    (("synthetic", jsynth, tsynth), "make_psf_task_workdir")])
def test_signature_matches_jax(module, name):
    _, jmod, tmod = module
    jfn, tfn = getattr(jmod, name), getattr(tmod, name)
    assert _positional(tfn) == _positional(jfn)
    assert _keyword_only(tfn) - _keyword_only(jfn) <= EXTRAS


def test_product_flops_are_xlas():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 128)).astype(np.float32)
    b = rng.normal(size=(128, 32)).astype(np.float32)
    _, jflops = jbench.compiled_cost(jnp.matmul, a, b)
    n_bytes, flops = tbench.compiled_cost(torch.matmul, torch.from_numpy(a),
                                          torch.from_numpy(b))
    assert flops == jflops == 2 * 64 * 128 * 32
    assert n_bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)


@pytest.mark.parametrize("twin", [True, False], ids=["twin", "no_twin"])
def test_k1_is_one_unit(monkeypatch, twin):
    """Forward and adjoint each count ``starlet_cuda.work``: 589 824 bytes
    at (m 128, batch 1, 7 scales), the same when the call computes
    nothing that a dispatch sees (the card's kernel)."""
    if not twin:
        monkeypatch.setattr(starlet_cuda, "starlet_forward",
                            lambda img, n: torch.empty(1, n + 1, 128, 128))
        monkeypatch.setattr(starlet_cuda, "starlet_adjoint",
                            lambda g: torch.empty(1, 128, 128))
    img = torch.randn(1, 128, 128, generator=torch.Generator().manual_seed(1))
    assert tbench.compiled_cost(starlet_transform, img) \
        == (589824.0, 21.0 * 7 * 128 * 128)

    def forward_and_adjoint(x):
        x = x.detach().requires_grad_(True)
        torch.autograd.grad(starlet_transform(x), x,
                            torch.ones(1, 8, 128, 128))

    n_bytes, flops = tbench.compiled_cost(forward_and_adjoint, img)
    # the two units, the cotangent's fill and nothing of the twin
    assert n_bytes == 2 * 589824 + 4 * 8 * 128 * 128
    assert flops == 2 * 21 * 7 * 128 * 128


def _k2_operands(N, C, L, n):
    gen = torch.Generator().manual_seed(2)
    Lh = L // 2 + 1

    def rand(*shape):
        return torch.randn(*shape, generator=gen)

    return (rand(N, C, L), rand(N, C, L), rand(N, C, Lh), rand(N, L, Lh),
            rand(N, L, Lh), rand(L, Lh), rand(L, Lh), rand(L, Lh),
            rand(L, Lh), rand(L, Lh), rand(n, L), rand(n, L), rand(Lh, n),
            rand(Lh, n))


def test_k2_counts_the_work_of_its_roi100_bound():
    """K2 forward and backward at ROI-100's stage 2 (N 100, n 64, L 256,
    2M 8, with h) count ``fused_render_cuda.work``: 3xTF32 products of
    11.5 us on the tensor cores, the bound PERF.md gives both ways."""
    N, C, L, n = 100, 8, 256, 64
    ops = _k2_operands(N, C, L, n)
    works = [fused_render_cuda.work(N, C, L, L // 2 + 1, n, backward, True)
             for backward in (False, True)]
    assert tbench.compiled_cost(fused_render.fused_render, *ops) \
        == (works[0][0], works[0][1] + works[0][2])

    def forward_and_backward(*ops):
        free = [x.detach().requires_grad_(True) for x in ops[:3]]
        h = [x.detach().requires_grad_(True) for x in ops[8:10]]
        out = fused_render.fused_render(*free, *ops[3:8], *h, *ops[10:])
        torch.autograd.grad(out, free + h, torch.ones(N, n, n))

    n_bytes, flops = tbench.compiled_cost(forward_and_backward, *ops)
    assert n_bytes == works[0][0] + works[1][0] + 4 * N * n * n
    assert flops == sum(w[1] + w[2] for w in works)
    for n_bytes, products, rest in works:
        bound_s = max(n_bytes / HBM_BYTES_PER_S, 3 * products / TF32_FLOPS,
                      rest / FP32_FLOPS)
        assert round(bound_s * 1e6, 1) == 11.5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _assert_vg_close(got, want):
    """Values to 1e-5 relative; the gradient, one vector over the leaves,
    to 1e-5 of its largest element (at JAX's symmetric point the position
    leaves are rounding noise of ~1e-10)."""
    (tv, tg), (jv, jg) = got, want
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=0)
    pairs = [(g.numpy(), np.asarray(jg[group][key]))
             for group, leaves in tg.items() for key, g in leaves.items()]
    scale = max(np.abs(w).max() for _, w in pairs)
    err = max(np.abs(g - w).max() for g, w in pairs)
    assert err <= TOL * scale, (err, scale)


def _psf_points(jfree, jconsts):
    """JAX's point, and one perturbed from a seed: the fluxes, positions
    and grid of ``free`` and the data, variances and weights."""
    yield jfree, jconsts
    rng = np.random.default_rng(5)
    free = _np_tree(jfree)
    g = free["kwargs_gaussian"]
    g["a"] = g["a"] * rng.uniform(0.8, 1.2, g["a"].shape).astype(np.float32)
    for key in ("x0", "y0"):
        g[key] = rng.uniform(-0.3, 0.3, g[key].shape).astype(np.float32)
    bg = free["kwargs_background"]
    bg["background"] = rng.normal(0, 1e-3, bg["background"].shape).astype(
        np.float32)
    consts = dict(jconsts)
    for key, (lo, hi) in (("data", (-0.05, 0.2)), ("sigma_2", (0.5, 1.5)),
                          ("W", (0.5, 1.5))):
        consts[key] = rng.uniform(lo, hi, jconsts[key].shape).astype(
            np.float32)
    yield free, consts


@pytest.mark.parametrize("backend", BACKENDS)
def test_psf_pixel_phase_vg_matches_jax(backend):
    with _jax_render(backend):
        jcost, (jvg, jfree, jconsts) = jbench.psf_pixel_phase_cost(2, 3, 16, 2)
        jvg = jax.jit(jvg)
        cost, (vg, free, consts) = tbench.psf_pixel_phase_cost(
            2, 3, 16, 2, device="cpu", irfft_backend=backend)
        assert min(jcost + cost) > 0
        assert jax.tree_util.tree_map(np.shape, _np_tree(jfree)) \
            == {g: {k: tuple(v.shape) for k, v in leaves.items()}
                for g, leaves in free.items()}
        for f, c in _psf_points(jfree, jconsts):
            port_consts = {**_to_torch({k: v for k, v in c.items()
                                        if k != "dft_mats"}),
                           "dft_mats": consts["dft_mats"]}
            _assert_vg_close(vg(_to_torch(_np_tree(f)), port_consts),
                             jvg(f, c))


@pytest.mark.parametrize("backend", BACKENDS)
def test_star_fit_phase_vg_matches_jax(backend):
    """The port's consts are its own (the model holds the PSF spectra of
    the same unit PSFs); JAX's data, variances and epoch weights are
    carried into them."""
    S, N, n = 2, 4, 8
    with _jax_render(backend):
        jcost, (jvg, jfree, jpair) = jbench.star_fit_phase_cost(S, N, n, 2)
        jvg = jax.jit(jvg)
        cost, (vg, free, consts) = tbench.star_fit_phase_cost(
            S, N, n, 2, device="cpu", irfft_backend=backend)
        assert min(jcost + cost) > 0
        jfree = _np_tree(jfree)
        for key, leaf in free["kwargs_analytic"].items():
            np.testing.assert_allclose(leaf.numpy(),
                                       jfree["kwargs_analytic"][key],
                                       rtol=TOL, atol=0)
        rng = np.random.default_rng(6)
        shifted = _np_tree(jfree)
        a = shifted["kwargs_analytic"]
        a["a"] = a["a"] * rng.uniform(0.8, 1.2, a["a"].shape).astype(
            np.float32)
        for key in ("c_x", "c_y", "dx", "dy"):
            a[key] = rng.uniform(-0.3, 0.3, a[key].shape).astype(np.float32)
        data = np.asarray(jpair[0]["data"])
        noisy = (data + rng.normal(0, 0.05, data.shape)).astype(np.float32)
        for f, d in ((jfree, data), (shifted, noisy)):
            jconsts = {**jpair[0], "data": d}
            port_consts = {
                **consts, "data": torch.tensor(d.reshape(S * N, n, n)),
                "sigma_2": torch.tensor(np.asarray(
                    jpair[0]["sigma_2"]).reshape(S * N, n, n)),
                "epoch_w": torch.tensor(np.asarray(jpair[0]["epoch_w"]))}
            port_free = {"kwargs_analytic": _to_torch(f["kwargs_analytic"]),
                         "kwargs_background": {}}
            _assert_vg_close(vg(port_free, port_consts),
                             jvg(f, (jconsts, jpair[1])))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("phase", ["psf", "star"])
def test_flops_double_with_the_batch(phase, backend):
    if phase == "psf":
        counts = [tbench.psf_pixel_phase_cost(b, 3, 16, 2, device="cpu",
                                              irfft_backend=backend)[0]
                  for b in (2, 4)]
    else:
        counts = [tbench.star_fit_phase_cost(b, 4, 8, 2, device="cpu",
                                             irfft_backend=backend)[0]
                  for b in (2, 4)]
    (_, small), (_, large) = counts
    assert small > 0
    assert abs(large / small - 2) <= 0.02


def test_time_compiled_loop_on_the_cpu():
    """Each step's input is the last one's times 1 + 1e-12 sum(fn(x)): a
    first untimed run and three timed runs of ``n_rep`` steps. (A change
    of 1e-12 relative is below float32's resolution unless the sum is
    large, so this image's sum is ~5e6.)"""
    seen = []

    def fn(x):
        seen.append(x.clone())
        return starlet_transform(x)

    gen = torch.Generator().manual_seed(3)
    img = 1e4 * torch.rand(1, 32, 32, generator=gen)
    t = tbench.time_compiled_loop(fn, img, 5)
    assert math.isfinite(t) and t > 0
    assert len(seen) == (1 + 3) * 5
    for run in range(4):
        steps = seen[5 * run:5 * run + 5]
        assert all(not torch.equal(a, b) for a, b in zip(steps, steps[1:]))


@pytest.mark.parametrize("eager", [False, True])
def test_time_vg_loop_on_the_cpu(eager):
    """A gradient-descent carry from perturbed restarts: a first untimed
    run and ``n_best_of`` timed ones (the CPU runs eagerly either way).
    A linear loss with a gradient of 1e6 moves each step by 1e-3."""
    seen = []

    def vg(free, consts):
        seen.append(free["p"]["x"].clone())
        return (free["p"]["x"] * consts["g"]).sum(-1), {"p": {
            "x": consts["g"]}}

    free = {"p": {"x": torch.ones(2, 3)}}
    t = tbench.time_vg_loop(vg, free, {"g": torch.full((2, 3), 1e6)}, 4, 2,
                            eager=eager)
    assert math.isfinite(t) and t > 0
    assert len(seen) == (1 + 2) * 4
    starts = seen[::4]
    assert all(not torch.equal(a, b) for a, b in zip(starts, starts[1:]))
    for run in range(3):
        steps = seen[4 * run:4 * run + 4]
        assert all(not torch.equal(a, b) for a, b in zip(steps, steps[1:]))


def test_time_vg_loop_times_the_star_phase():
    _, (vg, free, consts) = tbench.star_fit_phase_cost(
        2, 4, 8, 2, device="cpu")
    t = tbench.time_vg_loop(vg, free, consts, 3, 2)
    assert math.isfinite(t) and t > 0


def _rows(path):
    with sqlite3.connect(path / "database.sqlite3") as conn:
        return {table: sorted(conn.execute(f"SELECT * FROM {table}"))
                for table in ("frames", "stars", "stars_in_frames")}


def _datasets(path):
    import h5py

    found = {}
    with h5py.File(path / "regions.h5", "r") as f:
        f.visititems(lambda name, obj: found.update({name: obj[()]})
                     if isinstance(obj, h5py.Dataset) else None)
    return found


@pytest.fixture(scope="module")
def workdirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("psf_task")
    kw = dict(n_frames=4, n_stars=3, n_pix=16, seed=11,
              config_overrides={"psf_n_iter_analytic": 5,
                                "psf_n_iter_pixels": 10,
                                "psf_do_plots": 0})
    return {name: maker(root / name, **kw).parent
            for name, maker in (("jax", jsynth.make_psf_task_workdir),
                                ("port", tsynth.make_psf_task_workdir))}


def test_psf_task_workdir_matches_jax(workdirs):
    import yaml

    assert _rows(workdirs["port"]) == _rows(workdirs["jax"])
    assert len(_rows(workdirs["port"])["stars_in_frames"]) == 4 * 3
    ours, theirs = _datasets(workdirs["port"]), _datasets(workdirs["jax"])
    assert ours.keys() == theirs.keys() and len(ours) == 4 * (1 + 4 * 3)
    for name, value in theirs.items():
        assert ours[name].dtype == value.dtype, name
        np.testing.assert_array_equal(ours[name], value, err_msg=name)
    configs = [yaml.safe_load((workdirs[k] / "config.yaml").read_text())
               for k in ("port", "jax")]
    for config, k in zip(configs, ("port", "jax")):
        config["workdir"] = config["workdir"].replace(k, "")
        config["raw_dirs"] = [d.replace(k, "") for d in config["raw_dirs"]]
    assert configs[0] == configs[1]


def test_psf_task_runs_on_the_ports_workdir(workdirs):
    from lightcurver_tpu_torch.processes.psf_modelling import model_all_psfs

    path = workdirs["port"]
    old = os.environ.get("LIGHTCURVER_CONFIG")
    os.environ["LIGHTCURVER_CONFIG"] = str(path / "config.yaml")
    try:
        model_all_psfs(device="cpu")
    finally:
        if old is None:
            os.environ.pop("LIGHTCURVER_CONFIG", None)
        else:
            os.environ["LIGHTCURVER_CONFIG"] = old
    with sqlite3.connect(path / "database.sqlite3") as conn:
        chi2 = [row[0] for row in conn.execute("SELECT chi2 FROM PSFs")]
    assert len(chi2) == 4 and all(np.isfinite(chi2))
