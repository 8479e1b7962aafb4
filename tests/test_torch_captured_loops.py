"""The optimizer loops as replayable steps (``core/optimize.py``).

Every loop is a step closure over a state of tensors, driven by
``StepLoop``: on the CPU by calling the step once an iteration, on the card
by replaying a CUDA graph of it. What a capture needs can be held here on
the CPU: the step reads nothing back to the host and copies nothing from
it (a guard over the aten ops each step dispatches, through every fit's
entry point), it runs exactly once an iteration with its counter on the
device, a killed checkpointed run resumes to the uninterrupted bits, the
graph driver's copy of a step's outputs survives their aliasing, and a
replay adds the launches its capture recorded. On the card (``gpu``): the
batched PSF fit's plan captures its loops once a bucket shape and replays
them for the later buckets, to the same bits.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lightcurver_tpu_torch.core import optimize as topt
from lightcurver_tpu_torch.core.deconv.batched import fit_stars_batched
from lightcurver_tpu_torch.core.psf.batched import (build_psf_batched,
                                                    clear_plans)
from lightcurver_tpu_torch.core.psf.build import build_psf
from lightcurver_tpu_torch.ops import fused_render_cuda, starlet_cuda
from lightcurver_tpu_torch.processes.roi_modelling import ROI_CONFIG, fit_roi
from lightcurver_tpu_torch.processes.star_photometry import \
    do_one_star_forward_modelling
from lightcurver_tpu_torch.utilities.synthetic import (make_roi_scene,
                                                       psf_bench_frames,
                                                       star_photometry_scene)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op torch thread beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# aten ops that read a value back to the host, make a tensor of host data,
# or size their output by the data: each breaks a CUDA graph's capture
HOST_ROUND_TRIPS = {"_local_scalar_dense", "item", "is_nonzero", "equal",
                    "nonzero", "masked_select", "lift_fresh", "unique",
                    "_unique2", "tolist"}


class NoHostRoundTrip(TorchDispatchMode):
    """Raises on a host round trip (:data:`HOST_ROUND_TRIPS`, or an index
    by a boolean mask) in the ops dispatched under it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        masked = name.startswith("index") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for a in args if isinstance(a, (list, tuple)) for i in a)
        if name in HOST_ROUND_TRIPS or masked:
            raise AssertionError(f"the step calls aten.{name}, which a CUDA "
                                 "graph cannot capture")
        return func(*args, **(kwargs or {}))


@pytest.fixture()
def guarded(monkeypatch):
    """Every step of every loop runs under :class:`NoHostRoundTrip`;
    yields the list of the loops (their final state and step count). The
    batched PSF fit's plans are cleared first, so its loops are built
    here and not found in a plan of an earlier test."""
    clear_plans()
    loops = []
    call = topt.StepLoop._call

    def guarded_call(self, n):
        if not any(loop is self for loop in loops):
            loops.append(self)
        self.steps = getattr(self, "steps", 0) + n
        with NoHostRoundTrip():
            call(self, n)

    monkeypatch.setattr(topt.StepLoop, "_call", guarded_call)
    yield loops


def _roi():
    sc = make_roi_scene(n_epochs=4, n_pix=12, s=2, n_sources=2,
                        noise_sigma=0.5, seed=0, fwhm_range=(2.5, 2.5),
                        flux_range=(50.0, 100.0))
    n = sc["data"].shape[-1]
    return (sc["data"], sc["sigma_2"] ** 0.5, sc["psf"],
            sc["xs"] + (n - 1) / 2.0, sc["ys"] + (n - 1) / 2.0, sc["s"],
            sc["fwhm"], 1.0, [0.0] * 4,
            {**ROI_CONFIG, "roi_deconv_translations_iters": 3,
             "roi_deconv_all_iters": 4})


FITS = {
    "fit_roi fft": lambda: fit_roi(*_roi(), device="cpu"),
    "fit_roi matmul": lambda: fit_roi(*_roi(), device="cpu",
                                      irfft_backend="matmul"),
    "build_psf": lambda: build_psf(*[x[0] for x in psf_bench_frames(
        1, 3, 12)], 2, n_iter_analytic=3, n_iter_adabelief=4,
        device="cpu"),
    "build_psf_batched matmul": lambda: build_psf_batched(
        *psf_bench_frames(2, 3, 12), 2, n_iter_analytic=3,
        n_iter_adabelief=4, device="cpu", irfft_backend="matmul",
        dft_pad=8),
    "fit_stars_batched starlet matmul": lambda: fit_stars_batched(
        *(star_photometry_scene(2, 4, 8, 2)[k] for k in ("data", "sigma",
                                                         "psf", "s")),
        n_iter=4, starlet_global_background=True, irfft_backend="matmul",
        device="cpu"),
    "single star starlet fft": lambda: do_one_star_forward_modelling(
        *(star_photometry_scene(1, 4, 8, 2)[k][0] for k in ("data", "sigma",
                                                            "psf")), 2,
        n_iter=4, device="cpu"),
}
# (steps of each loop) of each fit
STEPS = {"fit_roi fft": [3, 4], "fit_roi matmul": [3, 4],
         "build_psf": [3, 4], "build_psf_batched matmul": [3, 4],
         "fit_stars_batched starlet matmul": [4],
         "single star starlet fft": [4]}


@pytest.mark.parametrize("name", list(FITS))
def test_every_fit_step_keeps_to_the_device(guarded, name):
    """Through each fit's entry point on the CPU: every step of its loops
    dispatches no host round trip, runs once an iteration, and leaves its
    device counter at the loop's budget."""
    FITS[name]()
    assert [loop.steps for loop in guarded] == STEPS[name]
    for loop in guarded:
        assert not loop.graphed and loop.graph is None
        counter = [x for x in loop.state if x.dtype == torch.int64
                   and x.dim() == 0][0]
        assert int(counter) == loop.steps


def test_the_guard_catches_a_host_read(guarded):
    """A loss that branches on a tensor is refused by the guard."""
    def loss(free):
        x = free["x"]
        return (x**2).sum() if bool((x > 0).all()) else (x**4).sum()

    free = {"x": torch.ones(3)}
    bound = {"x": torch.full((3,), 10.0)}
    with pytest.raises(AssertionError, match="_local_scalar_dense"):
        topt.run_adabelief(loss, free, {"x": -bound["x"]}, bound, 2)


def _quadratic(batched):
    c = torch.tensor([[0.5, -2.0, 3.0], [1.0, 0.2, -0.7]])
    w = torch.tensor([[1.0, 10.0, 0.1], [2.0, 1.0, 5.0]])

    def loss(free):
        x = free["x"]
        return (w * (x - c) ** 2).sum(-1) if batched \
            else (w[0] * (x - c[0]) ** 2).sum()

    free = {"x": torch.zeros(2, 3) if batched else torch.zeros(3)}
    lo, hi = {"x": torch.full((3,), -1.5)}, {"x": torch.full((3,), 1.5)}
    return loss, free, lo, hi


@pytest.mark.parametrize("loop, evaluations", [
    ("adabelief", lambda n: n), ("adabelief_batched", lambda n: n),
    ("lbfgsb", lambda n: 7 * n), ("lbfgsb_batched", lambda n: 6 * n + 1)])
def test_loss_evaluations_an_iteration(loop, evaluations):
    """AdaBelief evaluates once an iteration; the single L-BFGS once at x
    (JAX's exact_bounds retake, a select in a graph) and six line-search
    trials; the batched one only the trials, and once at the start."""
    batched = loop.endswith("batched")
    loss, free, lo, hi = _quadratic(batched)
    calls = []

    def counted(tree):
        calls.append(1)
        return loss(tree)

    run = getattr(topt, f"run_{loop}")
    run(counted, free, lo, hi, 9)
    assert len(calls) == evaluations(9)


def test_lbfgs_on_a_box_lands_on_the_bound():
    """The single L-BFGS (JAX's exact_bounds) ends with the clipped
    coordinate on its bound (c = 3 lies outside the box [-1.5, 1.5]) and
    the free ones at their minimum; the batched one, which carries the
    unprojected pair, keeps to the box and solves its unbounded frame."""
    loss, free, lo, hi = _quadratic(False)
    x = topt.run_lbfgsb(loss, free, lo, hi, 25)[0]["x"]
    np.testing.assert_allclose(x.numpy(), [0.5, -1.5, 1.5], atol=1e-5)
    assert float(x[2]) == 1.5
    loss, free, lo, hi = _quadratic(True)
    x = topt.run_lbfgsb_batched(loss, free, lo, hi, 25)[0]["x"]
    assert bool(((x >= -1.5) & (x <= 1.5)).all())
    np.testing.assert_allclose(x[1].numpy(), [1.0, 0.2, -0.7], atol=1e-5)


class Killed(Exception):
    """The simulated kill; only this class is caught."""


@pytest.mark.parametrize("schedule", [False, True])
def test_batched_adabelief_resumed_is_the_uninterrupted_run(
        tmp_path, monkeypatch, schedule):
    """Killed after its first segment of 7 (of 20 iterations, so the last
    segment is short), the batched fit resumes with its counter at 7 and
    ends on the uninterrupted fit's bits: the rate and the bias
    corrections come from the restored counter."""
    loss, free, lo, hi = _quadratic(True)
    args = (loss, free, lo, hi, 20, 0.05, schedule)
    want = topt.run_adabelief_batched(*args)
    path = tmp_path / "ck.npz"
    save, writes = topt.save_checkpoint, []

    def save_then_kill(*a, **kw):
        if writes:
            raise Killed
        save(*a, **kw)
        writes.append(a[3])

    monkeypatch.setattr(topt, "save_checkpoint", save_then_kill)
    with pytest.raises(Killed):
        topt.run_adabelief_batched(*args, checkpoint_path=path,
                                   checkpoint_every=7)
    assert writes == [7]
    monkeypatch.setattr(topt, "save_checkpoint", save)
    got = topt.run_adabelief_batched(*args, checkpoint_path=path,
                                     checkpoint_every=7)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a["x"].numpy(), b["x"].numpy())
    np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())


def test_copy_into_survives_aliased_outputs():
    """A step that hands the old x back as its previous point: the copy
    into the state clones it before x is overwritten."""
    x, prev, other = torch.tensor([1.0, 2.0]), torch.zeros(2), torch.ones(2)
    state = (x, prev, other)
    topt._copy_into(state, (x + 10.0, x, other))
    np.testing.assert_array_equal(x.numpy(), [11.0, 12.0])
    np.testing.assert_array_equal(prev.numpy(), [1.0, 2.0])
    np.testing.assert_array_equal(other.numpy(), [1.0, 1.0])


def test_replays_add_the_launches_their_capture_recorded(monkeypatch):
    """Each further replay adds the capture's K1 and K2 launches (forward,
    adjoint; forward, backward and those with h) to the wrappers' counts."""
    monkeypatch.setattr(starlet_cuda, "launches", starlet_cuda.LaunchCounts())
    monkeypatch.setattr(fused_render_cuda, "launches",
                        fused_render_cuda.LaunchCounts())
    starlet_cuda.launches.forward = 2
    topt._add_launches((1, 1, 2, 2, 2, 0), 5)
    assert topt._launch_counts() == (7, 5, 10, 10, 10, 0)


def test_the_cpu_driver_calls_the_step():
    """On the CPU a StepLoop never builds a graph, whatever ``eager``; a
    run of 0 steps leaves the state as it was."""
    state = (torch.zeros(()),)
    for eager in (False, True):
        loop = topt.StepLoop(lambda s: (s[0] + 1,), state, eager=eager)
        assert not loop.graphed
        assert loop.run(0) is loop.state
        assert float(loop.run(3)[0]) == 3.0 and loop.graph is None


def _psf_jobs(data, sigma):
    """One bucket of the PSF task's jobs (every pixel good)."""
    return [{"frame": {"seeing_pixels": 3.0}, "data": d, "noisemap": n,
             "masks": np.ones(d.shape, dtype=bool),
             "stamp_coords": np.zeros((len(d), 2), dtype=np.float32)}
            for d, n in zip(data, sigma)]


@pytest.mark.gpu
def test_psf_plan_on_the_card_captures_once_a_shape():
    """Three buckets of one shape through the task's dispatch, under the
    profiler: the first builds the plan and captures its two loops, the
    other two replay them with no warm-up, drain or capture; each bucket
    adds the same K1 launches; the third, the first's frames again,
    gives the first's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and K1 have no CPU "
                    "mode")
    from lightcurver_tpu_torch.core.params import kwargs_to_numpy
    from lightcurver_tpu_torch.processes.psf_modelling import \
        _dispatch_fit_jobs
    from lightcurver_tpu_torch.utilities import tracing
    from lightcurver_tpu_torch.utilities.benchmarking import launch_counts

    data, sigma = psf_bench_frames(6, 4, 24)
    buckets = [_psf_jobs(data[:3], sigma[:3]), _psf_jobs(data[3:], sigma[3:])]
    config = {"subsampling_factor": 2, "psf_n_iter_analytic": 20,
              "psf_n_iter_pixels": 300, "field_distortion": False,
              "psf_dft_pad": 16}
    clear_plans()
    tracing.clear()
    outs, k1 = [], []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for jobs in (buckets[0], buckets[1], buckets[0]):
            before = launch_counts()
            outs.append(kwargs_to_numpy(_dispatch_fit_jobs(
                config, jobs, device="cuda", irfft_backend="fft")))
            k1.append(tuple(b - a for a, b in
                            zip(before, launch_counts()))[:2])
    spans = tracing.spans()
    tracing.clear()
    clear_plans()
    dispatches = [s for s in spans if s["name"] == "psf.dispatch"]
    assert [s["attrs"]["plan"] for s in dispatches] == ["miss", "hit", "hit"]
    loops = {"optimizer.warmup", "optimizer.drain", "optimizer.capture"}
    for dispatch in dispatches:
        inside = [s["name"] for s in spans if s["root"] == dispatch["id"]
                  and s["name"] in loops]
        if dispatch["attrs"]["plan"] == "hit":
            assert inside == [], inside
        else:
            assert inside.count("optimizer.capture") == 2, inside
    assert sum(s["name"] == "optimizer.capture" for s in spans) == 2
    assert k1[0] == k1[1] == k1[2] and k1[0][0] > 0, k1
    assert outs[0].keys() == outs[2].keys()
    for key in outs[0]:
        for a, b in zip(_leaves_of(outs[0][key]), _leaves_of(outs[2][key])):
            np.testing.assert_array_equal(a, b, err_msg=key)


def _leaves_of(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_of(tree[k])]
    return [np.asarray(tree)]
