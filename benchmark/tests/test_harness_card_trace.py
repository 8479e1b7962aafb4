"""Each cell once on the card with ``--trace 1`` for a few seconds: every
span metric is on the line, and the capture counts equal the CUDA graphs
the program captured in the traced window, counted here apart from the
spans (each ``torch.cuda.graph`` entered while the profiler ran, over the
units the driver started while it ran).

Run on the card's machine from the checkout's root:
``python -m pytest benchmark/tests/test_harness_card_trace.py -q``."""

import pytest

from benchmark import run

CELLS = {
    "roi100_matmul": ("roi_fit", "fit_roi", "graph_captures_per_fit.roi",
                      ("capture_s_per_fit.roi", "fixed_s_per_fit.roi")),
    "psf_b16_fft": ("psf_buckets", "_dispatch_fit_jobs",
                    "graph_captures_per_bucket.psf",
                    ("capture_s_per_bucket.psf", "drain_s_per_bucket.psf",
                     "prepare_wait_s.psf")),
}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_cell_reads_the_spans(cell, monkeypatch):
    import importlib

    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run on the card only")
    from lightcurver_tpu_torch.utilities import tracing

    driver, entry, count_name, timed = CELLS[cell]
    module = importlib.import_module(f"benchmark.drivers.{driver}")
    traced = {"units": 0, "graphs": 0}
    profiling = torch.autograd._profiler_enabled

    def counted(key, fn):
        def wrapped(*args, **kwargs):
            traced[key] += profiling()
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(module, entry, counted("units",
                                               getattr(module, entry)))
    monkeypatch.setattr(torch.cuda, "graph", counted("graphs",
                                                     torch.cuda.graph))
    tracing.clear()
    result = run.run_cell(cell, 2147483999, 3.0, True)
    metrics = result["metrics"]
    assert result["correct"], result["checks"]
    assert {count_name, *timed} <= set(metrics), sorted(metrics)
    assert traced["units"] >= 1 and traced["graphs"] >= 1, traced
    assert metrics[count_name]["value"] == traced["graphs"] / traced["units"]
    for name in timed:
        assert metrics[name]["value"] >= 0, name
    # the spans are host ranges: none is a device operation of the window
    ops = {name for name, _ in result["breakdown"]["device_ops"]}
    assert not ops & {s["name"] for s in tracing.spans()}, ops
    if cell == "roi100_matmul":
        assert metrics["loss_evals_per_fit.roi"]["value"] == 4100
