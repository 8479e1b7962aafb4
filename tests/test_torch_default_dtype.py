"""The port's fits under a float64 global default dtype.

``torch.set_default_dtype(torch.float64)`` anywhere in a process (a
float64 module imported by an earlier test, a notebook's first cell) used
to turn parts of the port's float32 fits to float64: tensors made with no
``dtype`` (epoch weights, W, the point-source bump, best-loss fills,
histories) took the global default, and the sharded and unsharded
``fit_roi`` then parted by ~4e-6 of a flux. Every tensor a fit makes now
names its dtype, so under either default each fit gives the same float32
bits.

Each case sets the float64 default inside a ``try`` and restores the
float32 default in its ``finally``; nothing here pins the default for
the port.
"""

import contextlib
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lightcurver_tpu_torch.core.deconv.batched import fit_stars_batched
from lightcurver_tpu_torch.core.psf.batched import build_psf_batched
from lightcurver_tpu_torch.parallel.distributed import \
    initialize_distributed
from lightcurver_tpu_torch.parallel.mesh import epoch_mesh
from lightcurver_tpu_torch.processes import roi_modelling as troi
from lightcurver_tpu_torch.utilities.synthetic import (
    make_roi_scene, psf_bench_frames, star_photometry_scene)

# the world-of-one scene and budget of tests/test_torch_parallel.py
ROI_CONFIG = dict(troi.ROI_CONFIG, roi_deconv_translations_iters=20,
                  roi_deconv_all_iters=40)
BACKENDS = ("fft", "matmul")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """As in the calibration chain's file: one intra-op thread beside the
    suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def float64_default():
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(before)


@pytest.fixture(scope="module")
def roi_args():
    sc = make_roi_scene(n_epochs=8, n_pix=12, s=2, n_sources=2,
                        noise_sigma=0.5, seed=0, fwhm_range=(2.5, 2.5),
                        flux_range=(50.0, 100.0))
    c = (sc["data"].shape[-1] - 1) / 2.0
    return (sc["data"], np.sqrt(sc["sigma_2"]), sc["psf"], sc["xs"] + c,
            sc["ys"] + c, sc["s"], sc["fwhm"], 1.0, np.zeros(8))


def _arrays(out, prefix=""):
    """The output's arrays by key, dicts flattened."""
    found = {}
    for key, value in out.items():
        if isinstance(value, dict):
            found.update(_arrays(value, f"{prefix}{key}/"))
        elif isinstance(value, (np.ndarray, torch.Tensor)):
            found[prefix + key] = np.asarray(value)
    return found


def _assert_same_float32(got, want):
    got, want = _arrays(got), _arrays(want)
    assert got.keys() == want.keys()
    for key in want:
        if np.issubdtype(want[key].dtype, np.floating):
            assert got[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _fit_roi(roi_args, backend, mesh=None):
    out = troi.fit_roi(*roi_args, ROI_CONFIG, device="cpu",
                       irfft_backend=backend, mesh=mesh)
    return {k: out[k] for k in ("fluxes", "flux_errors", "reduced_chi2",
                                "residuals", "W", "loss_history_stage1",
                                "loss_history_stage2")}


@pytest.mark.parametrize("backend", BACKENDS)
def test_world_of_one_is_the_unsharded_fit_under_a_float64_default(
        roi_args, backend):
    """The pair of ``test_world_of_one_is_the_unsharded_fit_to_the_bit``,
    under a float64 default: still equal to the bit."""
    with float64_default():
        ref = _fit_roi(roi_args, backend)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        initialize_distributed(f"localhost:{port}", 1, 0)
        try:
            out = _fit_roi(roi_args, backend, mesh=epoch_mesh())
        finally:
            dist.destroy_process_group()
    _assert_same_float32(out, ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fit_roi_ignores_the_default_dtype(roi_args, backend):
    want = _fit_roi(roi_args, backend)
    with float64_default():
        got = _fit_roi(roi_args, backend)
    _assert_same_float32(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fit_stars_batched_ignores_the_default_dtype(backend):
    """The starlet background, so the Monte-Carlo draws and K1 run too."""
    sc = star_photometry_scene(2, 4, 16, 2)

    def fit():
        return fit_stars_batched(
            sc["data"], sc["sigma"], sc["psf"], 2, n_iter=20,
            starlet_global_background=True, mesh=None, device="cpu",
            irfft_backend=backend)

    want = fit()
    with float64_default():
        got = fit()
    _assert_same_float32(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_build_psf_batched_ignores_the_default_dtype(backend):
    data, sigma = psf_bench_frames(n_frames=2, n_stars=3, n_pix=16)

    def fit():
        return build_psf_batched(data, sigma, 2, n_iter_analytic=5,
                                 n_iter_adabelief=10, mesh=None,
                                 dft_pad=16, device="cpu",
                                 irfft_backend=backend)

    want = fit()
    with float64_default():
        got = fit()
    _assert_same_float32(got, want)
