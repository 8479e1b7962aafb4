"""The batched PSF fit's plans (``core/psf/batched.py``): one per bucket
shape, whose two optimizer loops later buckets of that shape rewind and
run again (on the card, replays of the graphs the first bucket captured).

On the CPU the loops call their steps, so what a plan keeps can be held
here at tiny shapes: a bucket fitted through a plan is the fresh fit of
it to the bit; a bucket's results on the device survive the next
bucket's dispatch; every value of the key misses when changed and hits
when not, as the dispatch span says; the plan least recently used is the
one evicted.
"""

import numpy as np
import pytest
import torch

from lightcurver_tpu_torch.core.params import kwargs_to_numpy
from lightcurver_tpu_torch.core.psf import batched
from lightcurver_tpu_torch.processes.psf_modelling import _dispatch_fit_jobs
from lightcurver_tpu_torch.utilities import tracing
from lightcurver_tpu_torch.utilities.synthetic import psf_bench_frames

DATA, SIGMA = psf_bench_frames(5, 3, 12)
BUDGET = {"n_iter_analytic": 3, "n_iter_adabelief": 6}


@pytest.fixture(autouse=True)
def _fresh_plans():
    """One intra-op thread beside the suite's other workers; no plan of
    an earlier test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    batched.clear_plans()
    yield
    batched.clear_plans()
    torch.set_num_threads(threads)


def bucket(first, n_frames=2, n_stars=3):
    return DATA[first:first + n_frames, :n_stars], \
        SIGMA[first:first + n_frames, :n_stars]


def fit(frames, fetch="numpy", **kw):
    return batched.build_psf_batched(
        *frames, 2, mesh=None, fetch=fetch, device="cpu",
        **{**BUDGET, **kw})


def leaves(tree, path=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves(tree[key], f"{path}/{key}")
    else:
        yield path, np.asarray(tree)


def assert_same_bits(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("render", [
    {"irfft_backend": "fft"},
    {"irfft_backend": "matmul", "dft_pad": 8},
    {"irfft_backend": "fft", "field_distortion": True,
     "stamp_coordinates": np.linspace(-1, 1, 12, dtype=np.float32)
     .reshape(2, 3, 2)}])
def test_a_bucket_through_a_plan_is_its_fresh_fit(render):
    """Bucket B after bucket A of its shape (a hit) holds B's fresh fit to
    the bit in every returned number: PSFs, chi2, residuals, kwargs and
    both histories."""
    fit(bucket(0), **render)
    through_plan = fit(bucket(2), **render)
    assert batched.plan_counts() == {"hits": 1, "misses": 1, "evictions": 0}
    batched.clear_plans()
    assert_same_bits(through_plan, fit(bucket(2), **render))
    assert batched.plan_counts()["misses"] == 1


def test_device_results_survive_the_next_dispatch():
    """A's results on the device, collected after B's dispatch has
    rewritten the plan and rewound its loops, are still A's fresh fit."""
    a = fit(bucket(0), fetch="device")
    b = fit(bucket(2), fetch="device")
    assert batched.plan_counts()["hits"] == 1
    got_a, got_b = kwargs_to_numpy(a), kwargs_to_numpy(b)
    batched.clear_plans()
    assert_same_bits(got_a, fit(bucket(0)))
    batched.clear_plans()
    assert_same_bits(got_b, fit(bucket(2)))


def jobs(frames):
    data, sigma = frames
    return [{"frame": {"seeing_pixels": 3.0}, "data": d, "noisemap": n,
             "masks": np.ones(d.shape, dtype=bool),
             "stamp_coords": np.zeros((len(d), 2), dtype=np.float32)}
            for d, n in zip(data, sigma)]


def config(n_iter_analytic=3, n_iter_adabelief=6):
    return {"subsampling_factor": 2, "psf_n_iter_analytic": n_iter_analytic,
            "psf_n_iter_pixels": n_iter_adabelief, "field_distortion": False,
            "psf_dft_pad": None}


def test_every_key_value_misses_and_the_same_key_hits():
    """Dispatched as the task dispatches, under the profiler: another
    frame count, star count or either budget builds a plan, the same
    shape and budgets find it; the ``psf.dispatch`` spans say which, as
    the counts do."""
    calls = [(bucket(0), config()), (bucket(2), config()),
             (bucket(0, n_frames=3), config()),
             (bucket(0, n_stars=2), config()),
             (bucket(1), config(n_iter_analytic=4)),
             (bucket(3), config()),
             (bucket(1), config(n_iter_adabelief=5))]
    expected = ["miss", "hit", "miss", "miss", "miss", "hit", "miss"]
    tracing.clear()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    counts = []
    try:
        for frames, user_config in calls:
            _dispatch_fit_jobs(user_config, jobs(frames), device="cpu")
            counts.append(batched.plan_counts())
    finally:
        prof.stop()
    spans = [s for s in tracing.spans() if s["name"] == "psf.dispatch"]
    tracing.clear()
    assert [s["attrs"]["plan"] for s in spans] == expected
    hits = [c["hits"] for c in counts]
    assert hits == list(np.cumsum([p == "hit" for p in expected]))
    assert counts[-1] == {"hits": 2, "misses": 5, "evictions": 1}


def test_the_fifth_shape_evicts_the_plan_least_recently_used():
    """Four shapes, then the first again (now the most recent), then a
    fifth: the second shape's plan is the one evicted."""
    shapes = [bucket(0, n_frames=k) for k in (1, 2, 3, 4)]
    for frames in shapes:
        fit(frames)
    fit(shapes[0])
    assert batched.plan_counts() == {"hits": 1, "misses": 4, "evictions": 0}
    fit(bucket(0, n_frames=5))
    assert batched.plan_counts() == {"hits": 1, "misses": 5, "evictions": 1}
    fit(shapes[0])
    fit(shapes[2])
    assert batched.plan_counts()["hits"] == 3
    fit(shapes[1])
    assert batched.plan_counts() == {"hits": 3, "misses": 6, "evictions": 2}
