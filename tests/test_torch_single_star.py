"""Port parity for the single-star fit,
``processes/star_photometry.py::do_one_star_forward_modelling``.

Held on the CPU, on one seeded star of ``make_star_stamps`` (6 epochs of
16 px at s = 2, 60 AdaBelief iterations), against the JAX package's
function at both background settings (sub-mmag fluxes, 1 % chi2 per
frame, the flux errors to 1e-3 relative) and against the port's own
``fit_stars_batched`` of the same star alone, as JAX's
``test_single_star_api_matches_batched`` holds its two paths (1e-3
relative in fluxes, chi2 per frame and errors), on both renders. The
starlet background's noise weights come from each package's own
generator, so that setting is held to JAX at the fit's bars only.
"""

import numpy as np
import pytest
import torch

from lightcurver_tpu.processes.star_photometry import \
    do_one_star_forward_modelling as jax_single
from lightcurver_tpu_torch.core.deconv.batched import fit_stars_batched
from lightcurver_tpu_torch.processes.star_photometry import \
    do_one_star_forward_modelling as port_single
from lightcurver_tpu_torch.utilities.synthetic import make_star_stamps

N_ITER = 60
KEYS = {"scale", "kwargs_final", "fluxes", "fluxes_uncertainties", "chi2",
        "chi2_per_frame", "loss_curve", "residuals", "deconvolved_image",
        "starlet_background"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """As in the calibration chain's file: one intra-op thread beside the
    suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def star():
    st = make_star_stamps(n_stars=6, n_pix=16, s=2, seed=0, fwhm_x=2.6,
                          fwhm_y=2.6)
    m = st["psf_true"].shape[-1]
    data = st["data"].copy()
    # one dead pixel: the NaN guard of both packages
    data[2, 3, 4] = np.nan
    return data, st["sigma"], np.broadcast_to(st["psf_true"], (6, m, m))


def _dmag(a, b):
    return np.abs(2.5 * np.log10(np.asarray(a) / np.asarray(b)))


@pytest.mark.parametrize("starlet", [False, True],
                         ids=["fixed_background", "starlet_background"])
def test_single_star_matches_jax(star, starlet):
    data, noise, psf = star
    want = jax_single(data, noise, psf, 2, n_iter=N_ITER,
                      starlet_global_background=starlet)
    got = port_single(data, noise, psf, 2, n_iter=N_ITER,
                      starlet_global_background=starlet, device="cpu")
    assert set(got) == set(want) == KEYS
    assert got["fluxes"].shape == (6,)
    assert got["residuals"].shape == data.shape
    assert got["deconvolved_image"].shape == (32, 32)
    assert got["loss_curve"].shape == (N_ITER,)
    assert got["scale"] == pytest.approx(want["scale"], rel=1e-7)
    assert _dmag(got["fluxes"], want["fluxes"]).max() < 1e-3
    np.testing.assert_allclose(got["chi2_per_frame"],
                               np.asarray(want["chi2_per_frame"]),
                               rtol=0.01)
    np.testing.assert_allclose(got["fluxes_uncertainties"],
                               np.asarray(want["fluxes_uncertainties"]),
                               rtol=1e-3)
    assert np.all(np.isfinite(got["fluxes"]))


@pytest.mark.parametrize("backend", ["fft", "matmul"])
def test_single_star_matches_batched(star, backend):
    data, noise, psf = star
    single = port_single(data, noise, psf, 2, n_iter=N_ITER,
                         starlet_global_background=False, device="cpu",
                         irfft_backend=backend)
    batched = fit_stars_batched(data[None], noise[None], psf[None], 2,
                                n_iter=N_ITER, mesh=None, device="cpu",
                                irfft_backend=backend)
    for key in ("fluxes", "chi2_per_frame", "fluxes_uncertainties"):
        np.testing.assert_allclose(single[key], batched[key][0], rtol=1e-3,
                                   err_msg=key)
