"""The benchmark's own work counts of K1 and K2, and their bounds."""

import json
from pathlib import Path

import pytest

from benchmark import work

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("backward, n_bytes, rest", [
    (False, 30966400, 178329600), (True, 33017600, 284006400)])
def test_k2_counts_at_roi100(backward, n_bytes, rest):
    # ROI-100's stage-2 shape: N 100, four sources (C 8), n 64, L 256,
    # with the background; the numbers fused_render_cuda.work gave there
    assert work.k2_work(100, 8, 256, 129, 64, backward, True) == (
        n_bytes, 1902182400, rest)


def test_k1_counts():
    assert work.k1_work(48, 16, 5) == (1032192, 3870720)


def cell_shapes():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = []
    for cell in spec["workloads"]:
        cfg = json.loads((ROOT / "benchmark" / "configs"
                          / f"{cell['config']}.json").read_text())
        if "stamp_size_ROI" in cfg:
            n, s = cfg["stamp_size_ROI"], cfg["subsampling_factor"]
            N = -(-cfg["epochs"] // cell["chips"])
            out.append((cell["name"], (N, 2 * len(cfg["scene"]["source_x"]),
                                       2 * n * s, n * s + 1, n)))
    return out


@pytest.mark.parametrize("name, shape", cell_shapes(),
                         ids=[c[0] for c in cell_shapes()])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("include_h", [False, True])
def test_k2_bound_is_at_least_the_products_at_tf32(name, shape, backward,
                                                   include_h):
    products = work.k2_work(*shape, backward, include_h)[1]
    assert work.k2_bound_s(*shape, backward, include_h) \
        >= products / work.TF32_FLOPS
