"""The scenes are made from the seed: the same seed gives the same inputs,
another seed others."""

import numpy as np
import pytest

from benchmark import run, scenes


def small_roi():
    cfg = run.load_json("configs", "roi1000")
    cfg.update(epochs=5, stamp_size_ROI=16)
    return cfg


def small_psf():
    cfg = run.load_json("configs", "psf_b16")
    cfg.update(stamp_size_stars=12, psf_fit_batch_size=4, pool_buckets=2)
    return cfg


def roi_inputs(seed):
    scene = scenes.roi_scene(small_roi(), seed, "cpu")
    fit = scenes.roi_fit_input(scene, 3)
    return [scene["psf"], scene["xs"], scene["ys"], scene["seeings"],
            scene["clean"].numpy(), fit["data"]]


def psf_inputs(seed):
    scene = scenes.psf_scene(small_psf(), seed, "cpu")
    return [scene["clean"], scene["fwhm"], scene["n_real"],
            *scenes.psf_bucket(scene, 5)]


@pytest.mark.parametrize("inputs", [roi_inputs, psf_inputs])
def test_same_seed_same_scene(inputs):
    big = 2**31 + 12345
    for a, b in zip(inputs(big), inputs(big)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("inputs", [roi_inputs, psf_inputs])
def test_other_seed_other_scene(inputs):
    first, second = inputs(2**31 + 1), inputs(2**31 + 2)
    assert not any(np.array_equal(a, b) for a, b in zip(first, second)
                   if np.asarray(a).size > 4)


def test_every_psf_bucket_pads_to_the_same_star_count():
    scene = scenes.psf_scene(small_psf(), 9, "cpu")
    n_real = scene["n_real"].reshape(-1, scene["batch"])
    assert (n_real.max(axis=1) == small_psf()["stars_to_use_psf"]).all()
