"""A run's comparison catches a broken program: with each fault of
``benchmark/faults.py`` planted under the timed path, a run of the cell
(on the CPU, at a small size, past the look for a card) comes out not
correct; without one it comes out correct. So does a run that judges the
control (``"control"``), the reference in TF32 put in the program's
place."""

import contextlib

import pytest

from benchmark import faults, run


def small(cell_name):
    cell = run.load_json("workloads", cell_name)
    config = run.load_json("configs", cell["config"])
    traffic = run.load_json("traffic", cell["traffic"])
    if "epochs" in config:
        config.update(epochs=6, stamp_size_ROI=16)
    else:
        config.update(stamp_size_stars=12, psf_fit_batch_size=4,
                      pool_buckets=2, psf_n_iter_pixels=1000)
    return cell, config, traffic


def correct(cell_name, fault):
    cell, config, traffic = small(cell_name)
    judge = "control" if fault == "control" else "program"
    planted = fault and judge == "program"
    with faults.FAULTS[fault]() if planted else contextlib.nullcontext():
        result = run.run_cell(cell_name, 2**31 + 77, 0.0, False,
                              device="cpu", cell=cell, config=config,
                              traffic=traffic, judge=judge)
    return result["correct"], result["checks"]


@pytest.mark.parametrize("cell_name, fault", [
    ("roi100_matmul", None), ("roi100_matmul", "noop"),
    ("roi100_matmul", "half"), ("roi100_matmul", "answer"),
    ("psf_b16_fft", None), ("psf_b16_fft", "noop"),
    ("psf_b16_fft", "half"), ("psf_b16_fft", "answer"),
    ("roi100_matmul", "control"), ("roi1000_matmul", "control"),
    ("roi1000_fft", "control"),
    ("psf_b16_fft", "control")])
def test_fault_is_caught(cell_name, fault):
    ok, checks = correct(cell_name, fault)
    assert ok == (fault is None), checks
