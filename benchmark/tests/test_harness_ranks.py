"""A cell of two ranks on the CPU, over gloo, through the launcher's real
path (``rank_job.py``) on a tiny ROI cell: 8 epochs of 16 px, s 2,
``chips`` 2, the limits of ``roi100_matmul``; 50 + 200 iterations, the
fewest at which its fits pass ``fit``'s limit. Each case launches its own
run under its own timeout."""

import json

import pytest

from rank_job import fits, gone, launch, pids

TEARDOWN_S = 20
TIMEOUT_S = 300
TINY = dict(epochs=8, stamp_size_ROI=16, roi_deconv_translations_iters=50,
            roi_deconv_all_iters=200)


def two_ranks(**spec):
    spec = dict(ranks=2, device="cpu", config=TINY, seconds=[0.0, 0.0],
                teardown_s=TEARDOWN_S) | spec
    return launch(TIMEOUT_S, **spec)


@pytest.fixture(scope="module")
def sound():
    """Rank 0 closes the window after its second fit; rank 1's own clock
    would close it after its first."""
    return two_ranks(seconds=[1e9, 0.0], units=2)


def test_one_line_from_rank_0(sound):
    code, out, err, _ = sound
    assert code == 0, err[-4000:]
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    line = json.loads(lines[0])
    assert line["device"]["count"] == 2
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"roi_fit_s", "setup_s"}
    # the checks are the last lines of the run's standard error
    assert err.strip().splitlines()[-1].startswith("check ")


def test_every_rank_ran_rank_0s_units(sound):
    code, out, err, _ = sound
    assert code == 0, err[-4000:]
    attempted = json.loads(out)["attempted"]
    assert attempted == 2
    assert fits(err, 0) == fits(err, 1) == attempted


def test_every_rank_is_gone_after_the_line(sound):
    code, _, err, _ = sound
    assert code == 0, err[-4000:]
    found = pids(err)
    assert len(found) == 2 and all(gone(pid) for pid in found), found


def test_a_traced_run_reads_rank_0s_window():
    """Only rank 0 traces: its line carries the span metrics of the cell
    (on the CPU the loops run eagerly, so no capture), and no end-to-end
    metric."""
    code, out, err, _ = two_ranks(trace=True)
    assert code == 0, err[-4000:]
    line = json.loads(out)
    assert line["correct"], line["checks"]
    metrics = line["metrics"]
    assert metrics["graph_captures_per_fit.roi"]["value"] == 0
    assert metrics["fixed_s_per_fit.roi"]["value"] > 0
    assert not {"roi_fit_s", "setup_s"} & set(metrics)
    assert line["device"]["window_s"] > 0


def test_exchange_is_caught():
    code, out, err, _ = two_ranks(fault="exchange")
    assert code == 0, err[-4000:]
    line = json.loads(out)
    assert not line["correct"], line["checks"]


def test_a_rank_killed_in_the_window_fails_the_run():
    code, out, err, seconds = two_ranks(seconds=[60.0, 60.0], die=1)
    assert code != 0 and out == ""
    assert "rank 1 exited with code -9" in err, err[-4000:]
    assert seconds < 60
    assert all(gone(pid) for pid in pids(err))


def test_a_rank_outliving_the_teardown_is_killed_and_named():
    code, out, err, seconds = two_ranks(linger=1)
    assert code != 0 and out == ""
    assert "rank 1 was still running" in err, err[-4000:]
    assert seconds < TIMEOUT_S
    assert all(gone(pid) for pid in pids(err))
