"""The port's spans (``lightcurver_tpu_torch/utilities/tracing.py``).

With no profiler running a span records nothing and enters no profiler
range. Under ``torch.profiler`` a CPU ``fit_roi`` records
its stages as children of one ``roi.fit``, each inside its parent and on
the profiler's clock; the bucket pipeline records its waits for a
preparation; an optimizer loop on the card records its warm-up, drain and
capture (here with the CUDA calls replaced by fakes); spans on another
thread keep their own stack.
"""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from lightcurver_tpu_torch.core import optimize
from lightcurver_tpu_torch.processes import roi_modelling as troi
from lightcurver_tpu_torch.processes.psf_modelling import \
    run_pipelined_buckets
from lightcurver_tpu_torch.utilities import tracing
from lightcurver_tpu_torch.utilities.synthetic import make_roi_scene

STAGES = ["roi.stage1", "roi.noise_weights", "roi.stage2", "roi.polish"]


@pytest.fixture(autouse=True)
def _fresh_spans():
    tracing.clear()
    yield
    tracing.clear()


def profiled():
    """A CPU profiler whose session has made its first user range: the
    first range of a session pays the profiler's set-up inside its enter,
    between the span's clock reading and the profiler's."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with torch.profiler.record_function("session warm-up"):
        pass
    return prof


def tiny_fit():
    n_epochs, n, s = 3, 16, 2
    sc = make_roi_scene(n_epochs=n_epochs, n_pix=n, s=s, n_sources=2, seed=2)
    config = dict(troi.ROI_CONFIG, roi_deconv_translations_iters=3,
                  roi_deconv_all_iters=3)
    return troi.fit_roi(
        sc["data"], np.sqrt(sc["sigma_2"]), sc["psf"],
        sc["xs"].astype(np.float64) + (n - 1) / 2,
        sc["ys"].astype(np.float64) + (n - 1) / 2, s,
        np.full(n_epochs, 0.9), 0.3, np.zeros(n_epochs), config,
        device="cpu")


def by_name(spans):
    return {s["name"]: s for s in spans}


def test_no_profiler_no_span(monkeypatch):
    """Neither the profiler's user ranges nor the function-scope ranges
    that spans use are entered."""
    entered = []

    def counted(cls):
        def make(name, *args):
            entered.append(name)
            return cls(name, *args)
        return make

    monkeypatch.setattr(torch.profiler, "record_function",
                        counted(torch.profiler.record_function))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counted(torch._C._profiler._RecordFunctionFast))
    assert not torch.autograd._profiler_enabled()
    with tracing.span("outer", k=1) as attrs:
        attrs["added"] = 2
        with tracing.span("inner"):
            pass
    tiny_fit()
    assert tracing.spans() == []
    assert entered == []


def test_fit_roi_stages_under_the_profiler():
    prof = profiled()
    try:
        tiny_fit()
    finally:
        prof.stop()
    spans = tracing.spans()
    names = [s["name"] for s in spans]
    assert sorted(names) == sorted(STAGES + ["roi.fit"])
    found = by_name(spans)
    fit = found["roi.fit"]
    assert fit["parent"] is None and fit["root"] == fit["id"]
    assert fit["attrs"] == {"epochs": 3}
    previous_end = fit["start_ns"]
    for name in STAGES:
        stage = found[name]
        assert stage["parent"] == fit["id"] and stage["root"] == fit["id"]
        assert stage["thread"] == fit["thread"] == threading.get_ident()
        assert previous_end <= stage["start_ns"] < stage["end_ns"] \
            <= fit["end_ns"], name
        previous_end = stage["end_ns"]
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), e)
    for span in spans:
        event = events[span["name"]]
        assert abs(event.start_ns() - span["start_ns"]) < 1_000_000, \
            span["name"]
        # a function-scope range (0), not a user annotation (7), which the
        # profiler would also draw on the device's timeline over the
        # span's kernels
        assert event.scope() == 0, span["name"]


def test_pipeline_records_its_waits():
    def prepare(bucket):
        time.sleep(0.05)
        return [bucket]

    stored = []
    prof = profiled()
    try:
        run_pipelined_buckets(range(4), prepare, lambda chunk: chunk,
                              lambda chunk, out, t0: stored.append(out))
    finally:
        prof.stop()
    assert stored == [[0], [1], [2], [3]]
    waits = [s for s in tracing.spans()
             if s["name"] == "pipeline.wait_prepare"]
    assert [s["attrs"]["bucket"] for s in waits] == [0, 1, 2, 3]
    assert all(s["parent"] is None for s in waits)
    for s in waits[1:]:
        assert s["end_ns"] - s["start_ns"] >= 40_000_000, s


def test_each_thread_keeps_its_stack(monkeypatch):
    # the profiler follows only the thread that started it; the flag is
    # forced on so that both threads record
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    inside, go_on = threading.Event(), threading.Event()

    def worker():
        with tracing.span("worker.outer"):
            inside.set()
            go_on.wait(10)
            with tracing.span("worker.inner"):
                pass

    with tracing.span("main.outer"):
        thread = threading.Thread(target=worker)
        thread.start()
        assert inside.wait(10)
        with tracing.span("main.inner"):
            go_on.set()
            thread.join(10)
    assert not thread.is_alive()
    found = by_name(tracing.spans())
    main, w = found["main.outer"], found["worker.outer"]
    assert w["parent"] is None and w["root"] == w["id"]
    assert found["worker.inner"]["parent"] == w["id"]
    assert found["worker.inner"]["root"] == w["id"]
    assert found["main.inner"]["parent"] == main["id"]
    assert w["thread"] != main["thread"]


def test_a_worker_thread_outside_the_profiler_records_nothing():
    def worker():
        with tracing.span("worker"):
            pass

    prof = profiled()
    try:
        thread = threading.Thread(target=worker)
        thread.start()
        thread.join(10)
        with tracing.span("main"):
            pass
    finally:
        prof.stop()
    assert not thread.is_alive()
    assert [s["name"] for s in tracing.spans()] == ["main"]


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    def __init__(self, calls):
        self.calls = calls

    def replay(self):
        self.calls.append("replay")


def test_step_loop_spans_warm_up_drain_and_capture(monkeypatch):
    """A loop on the card, its CUDA calls replaced by fakes that log: the
    warm-up steps, then a synchronise outside any capture (the drain),
    then the capture, each in its span, and the replays after them."""
    calls = []

    class FakeCapture:
        def __init__(self, graph):
            pass

        def __enter__(self):
            calls.append("capture")

        def __exit__(self, *exc):
            return False

    cuda = torch.cuda
    monkeypatch.setattr(cuda, "current_stream", lambda device: _FakeStream())
    monkeypatch.setattr(cuda, "Stream", lambda device: _FakeStream())
    monkeypatch.setattr(cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(cuda, "synchronize",
                        lambda device=None: calls.append("synchronize"))
    monkeypatch.setattr(cuda, "CUDAGraph", lambda: _FakeGraph(calls))
    monkeypatch.setattr(cuda, "graph", FakeCapture)

    def step(state):
        calls.append("step")
        x, = state
        return (x + 1,)

    loop = optimize.StepLoop(step, (torch.zeros(2),))
    loop.graphed = True
    prof = profiled()
    try:
        with tracing.span("unit"):
            loop.run(10)
    finally:
        prof.stop()
    assert calls == ["step"] * 3 + ["synchronize", "capture", "step"] \
        + ["replay"] * 7
    assert loop.replays == 7
    spans = tracing.spans()
    assert [s["name"] for s in spans] == [
        "optimizer.warmup", "optimizer.drain", "optimizer.capture", "unit"]
    unit = spans[-1]
    assert all(s["parent"] == unit["id"] for s in spans[:-1])
    assert spans[0]["attrs"] == {"steps": 3}
    assert spans[2]["attrs"] == {"recorded": loop.recorded}
    for before, after in zip(spans[:2], spans[1:3]):
        assert before["end_ns"] <= after["start_ns"]
