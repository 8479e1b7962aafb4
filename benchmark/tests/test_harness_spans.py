"""The span metrics' readers (``benchmark/metrics/*``, ``benchmark/spans.py``)
on synthetic span lists: per-unit normalisation, a window that holds the
next bucket's dispatch too, spans whose unit began before the window left
out, None on an empty window; and a traced CPU run of each cell at a
small size, whose line carries the readers' metrics."""

import pytest

from benchmark import run, spans as span_metrics

MS = 1_000_000
ROI = ("graph_captures_per_fit.roi", "capture_s_per_fit.roi",
       "fixed_s_per_fit.roi")
PSF = ("graph_captures_per_bucket.psf", "capture_s_per_bucket.psf",
       "drain_s_per_bucket.psf", "prepare_wait_s.psf")


class Spans:
    """Builds span records as ``tracing.spans()`` gives them."""

    def __init__(self):
        self.records = []

    def add(self, name, start_ms, end_ms, parent=None, **attrs):
        root = parent["root"] if parent else len(self.records) + 1
        record = {"name": name, "id": len(self.records) + 1,
                  "parent": parent["id"] if parent else None, "root": root,
                  "thread": 1, "start_ns": start_ms * MS,
                  "end_ns": end_ms * MS, "attrs": attrs}
        self.records.append(record)
        return record


def read(name, records, monkeypatch):
    monkeypatch.setattr(span_metrics, "program_spans", lambda: records)
    return run.load_metric(name).read(None, None)


def roi_fit(sp, t0, captures=2):
    """One fit at ``t0`` ms: 1000 ms long, stages 1 and 2 of 300 and 500
    ms, each loop a warm-up of 20 ms and a capture of 30 ms."""
    fit = sp.add("roi.fit", t0, t0 + 1000)
    one = sp.add("roi.stage1", t0 + 100, t0 + 400, fit)
    sp.add("roi.noise_weights", t0 + 400, t0 + 450, fit)
    two = sp.add("roi.stage2", t0 + 450, t0 + 950, fit)
    sp.add("roi.polish", t0 + 950, t0 + 990, fit)
    for stage in (one, two)[:captures]:
        start = stage["start_ns"] // MS
        sp.add("optimizer.warmup", start, start + 20, stage, steps=3)
        sp.add("optimizer.drain", start + 20, start + 25, stage)
        sp.add("optimizer.capture", start + 25, start + 55, stage)
    return fit


def bucket(sp, t0, drain_ms):
    """One dispatch at ``t0`` ms: two loops, each a warm-up of 10 ms, a
    drain of ``drain_ms`` and a capture of 40 ms."""
    unit = sp.add("psf.dispatch", t0, t0 + 2 * (50 + drain_ms) + 10)
    for k in range(2):
        start = t0 + k * (50 + drain_ms)
        sp.add("optimizer.warmup", start, start + 10, unit)
        sp.add("optimizer.drain", start + 10, start + 10 + drain_ms, unit)
        sp.add("optimizer.capture", start + 10 + drain_ms,
               start + 50 + drain_ms, unit)
    return unit


@pytest.mark.parametrize("name", ROI + PSF)
def test_empty_window_reads_none(name, monkeypatch):
    assert read(name, [], monkeypatch) is None


@pytest.mark.parametrize("name", ROI)
def test_a_psf_window_gives_no_roi_metric(name, monkeypatch):
    sp = Spans()
    bucket(sp, 0, 100)
    assert read(name, sp.records, monkeypatch) is None


@pytest.mark.parametrize("name, expected", [
    ("graph_captures_per_fit.roi", 2),
    ("capture_s_per_fit.roi", 0.1),
    ("fixed_s_per_fit.roi", 0.2)])
def test_roi_readers_per_fit(name, expected, monkeypatch):
    sp = Spans()
    roi_fit(sp, 0)
    assert read(name, sp.records, monkeypatch) == pytest.approx(expected)
    # a second fit of another shape: the mean of the two
    roi_fit(sp, 2000, captures=0)
    assert read(name, sp.records, monkeypatch) == pytest.approx(
        {"graph_captures_per_fit.roi": 1, "capture_s_per_fit.roi": 0.05,
         "fixed_s_per_fit.roi": 0.2}[name])


def test_spans_of_a_fit_begun_before_the_window_are_left_out(monkeypatch):
    sp = Spans()
    # the profiler started inside a fit: its stage-2 loop was recorded
    # with no recorded parent, as the program records it then
    sp.add("optimizer.warmup", 0, 20)
    sp.add("optimizer.capture", 25, 55)
    stray = sp.add("roi.stage2", 0, 500)
    sp.add("optimizer.capture", 30, 40, stray)
    # and a parent id that the window does not hold
    sp.records.append({"name": "optimizer.capture", "id": 99, "parent": 98,
                       "root": 98, "thread": 1, "start_ns": 0,
                       "end_ns": 10 * MS, "attrs": {}})
    roi_fit(sp, 1000)
    assert read("graph_captures_per_fit.roi", sp.records, monkeypatch) == 2
    assert read("capture_s_per_fit.roi", sp.records, monkeypatch) \
        == pytest.approx(0.1)


def test_psf_window_with_the_next_dispatch(monkeypatch):
    """The window of one collected bucket holds bucket 1's dispatch too
    (the pipeline dispatches it before collecting bucket 0), and the wait
    for bucket 1's preparation; a capture of another loop outside any
    dispatch (a stray) is left out."""
    sp = Spans()
    bucket(sp, 0, 100)
    sp.add("pipeline.wait_prepare", 330, 333, bucket=1)
    bucket(sp, 340, 1500)
    sp.add("optimizer.capture", 5000, 5100)
    values = {name: read(name, sp.records, monkeypatch) for name in PSF}
    assert values == pytest.approx({
        "graph_captures_per_bucket.psf": 2,
        "capture_s_per_bucket.psf": 0.1,
        "drain_s_per_bucket.psf": (200 + 3000) / 2 / 1000,
        "prepare_wait_s.psf": 0.003})


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.setattr(span_metrics, "program_spans", lambda: [])
    for name in ROI + PSF:
        assert run.load_metric(name).read(None, None) is None


def small(cell_name):
    cell = run.load_json("workloads", cell_name)
    config = run.load_json("configs", cell["config"])
    traffic = run.load_json("traffic", cell["traffic"])
    if "epochs" in config:
        config.update(epochs=4, stamp_size_ROI=16,
                      roi_deconv_translations_iters=5,
                      roi_deconv_all_iters=20)
    else:
        config.update(stamp_size_stars=12, psf_fit_batch_size=2,
                      pool_buckets=2, psf_n_iter_analytic=5,
                      psf_n_iter_pixels=20)
    return cell, config, traffic


@pytest.mark.parametrize("cell_name, names", [("roi100_matmul", ROI),
                                              ("psf_b16_fft", PSF)])
def test_traced_cpu_run_reads_the_spans(cell_name, names):
    """On the CPU the loops run eagerly: no capture, no drain, so the
    counts and seconds of the loops read 0 and the rest is positive."""
    from lightcurver_tpu_torch.utilities import tracing

    tracing.clear()
    cell, config, traffic = small(cell_name)
    result = run.run_cell(cell_name, 2**31 + 5, 0.0, True, device="cpu",
                          cell=cell, config=config, traffic=traffic)
    metrics = result["metrics"]
    assert set(names) <= set(metrics), sorted(metrics)
    for name in names:
        value = metrics[name]["value"]
        loops = name.startswith(("graph_captures", "capture_s", "drain_s"))
        assert value == 0 if loops else value > 0, (name, value)
    tracing.clear()
