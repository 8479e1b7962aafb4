"""The ``roi100`` configuration over four ranks on NCCL, a card a rank, for
a few seconds, through the launcher's real path (``rank_job.py``): one
line from rank 0, ``correct`` true, ``device.count`` 4, every rank's units
rank 0's and every rank gone after the line; with the ``exchange`` fault
planted, ``correct`` false; traced, rank 0's per-layer metrics of its
card. Skips with fewer than four cards.

Run on the card's machine from the checkout's root:
``python -m pytest benchmark/tests/test_harness_card_ranks.py -q``."""

import json

import pytest

from rank_job import fits, gone, launch, pids

TEARDOWN_S = 120
TIMEOUT_S = 900


@pytest.fixture
def four_cards():
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")


def four_ranks(**spec):
    spec = dict(ranks=4, device="cuda", seconds=[3.0, 0.0, 0.0, 0.0],
                teardown_s=TEARDOWN_S, seed=2**31 + 4242) | spec
    return launch(TIMEOUT_S, **spec)


@pytest.mark.gpu
def test_four_ranks_on_nccl(four_cards):
    code, out, err, _ = four_ranks()
    assert code == 0, err[-6000:]
    print(err[-6000:], out)
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    line = json.loads(lines[0])
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 4
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
    assert all(fits(err, r) == line["attempted"] for r in range(4))
    found = pids(err)
    assert len(found) == 4 and all(gone(pid) for pid in found), found


@pytest.mark.gpu
def test_exchange_is_caught_on_nccl(four_cards):
    code, out, err, _ = four_ranks(fault="exchange")
    assert code == 0, err[-6000:]
    line = json.loads(out)
    print(json.dumps(line["checks"]))
    assert not line["correct"], line["checks"]
    assert all(gone(pid) for pid in pids(err))


@pytest.mark.gpu
def test_a_traced_run_reads_rank_0s_card(four_cards):
    code, out, err, _ = four_ranks(trace=True)
    assert code == 0, err[-6000:]
    line = json.loads(out)
    assert line["correct"], line["checks"]
    metrics = line["metrics"]
    print(json.dumps({"metrics": metrics, "device": line["device"]}))
    assert metrics["loss_evals_per_fit.roi"]["value"] == 4100
    assert 0 < metrics["k2_roofline.roi"]["value"] <= 100
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
