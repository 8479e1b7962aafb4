"""Scenes made from the seed: the inputs both the program and the
reference are given.

The ROI scene follows the recipe of the JAX package's ``make_roi_scene``
(lightcurver_tpu/utilities/synthetic.py): blended point sources at fixed
offsets, a circular Moffat PSF (beta 2.8) of its own FWHM at every epoch,
fluxes drawn uniformly, Gaussian noise of one sigma. Added: each epoch's
pointing is off by a jitter drawn from the seed, so that the optimizer has
translations to find (without it the final flux solve alone would find
the answer); the source positions handed to the fit may be off by an
error drawn from the seed (``position_error_px``). Parameters and noise
come from numpy and ``torch.Generator`` seeded by the run's seed; a scene
is rendered once, on the device, by the reference's float64 renderer.
"""

import numpy as np
import torch

from .reference.render import Precision, Renderer, moffat


def mix(*words):
    """One 63-bit seed from several non-negative integers."""
    return int(np.random.SeedSequence([int(w) for w in words])
               .generate_state(2, np.uint32).astype(np.uint64)
               .view(np.uint64)[0] >> np.uint64(1))


def roi_scene(cfg, seed, device):
    """The noiseless ROI scene of a run, and everything a fit is given
    besides its data."""
    sc = cfg["scene"]
    N, n, s = cfg["epochs"], cfg["stamp_size_ROI"], cfg["subsampling_factor"]
    m, M = n * s, len(sc["source_x"])
    rng = np.random.default_rng(mix(seed, 1))
    fwhm = rng.uniform(*sc["fwhm_px"], N)
    a_true = rng.uniform(*sc["flux"], (N, M))
    jitter = rng.uniform(-sc["jitter_px"], sc["jitter_px"], (N, 2))
    err = rng.uniform(-sc["position_error_px"], sc["position_error_px"],
                      (M, 2))
    xs0 = np.asarray(sc["source_x"], np.float64)
    ys0 = np.asarray(sc["source_y"], np.float64)

    p = Precision("float64", device)
    psf64 = moffat(m, s, fwhm, sc["beta"], p.device)
    psf = psf64.to(torch.float32)
    clean = Renderer(m, s, p).render(
        psf64, a_true, xs0[None] + jitter[:, :1], ys0[None] + jitter[:, 1:])
    pixel_scale = sc["pixel_scale_arcsec"]
    draws = torch.randn((cfg["noise_samples"], n, n),
                        generator=torch.Generator().manual_seed(
                            cfg["noise_seed"]), dtype=torch.float32)
    return {
        "device": p.device, "n": n, "m": m, "s": s, "N": N,
        "xs": xs0 + err[:, 0] + (n - 1) / 2.0,
        "ys": ys0 + err[:, 1] + (n - 1) / 2.0,
        "psf": psf.cpu().numpy(), "psf_dev": psf.to(torch.float64),
        "clean": clean, "clean32": clean.to(torch.float32),
        "noisemap": np.full((N, n, n), sc["noise_sigma"], np.float32),
        "noise_sigma": float(sc["noise_sigma"]),
        "seeings": fwhm * pixel_scale, "pixel_scale": pixel_scale,
        "angles": np.zeros(N), "noise_draws": draws,
        "n_scales": int(np.log2(m)), "seed": seed,
    }


def roi_fit_input(scene, index):
    """Fit ``index``'s data: the scene plus fresh noise from (seed,
    index), drawn on the device."""
    gen = torch.Generator(device=scene["device"]).manual_seed(
        mix(scene["seed"], 2, index))
    clean = scene["clean32"]
    noise = torch.randn(clean.shape, generator=gen, dtype=torch.float32,
                        device=clean.device) * scene["noise_sigma"]
    return {"index": index, "data": (clean + noise).cpu().numpy()}


def psf_scene(cfg, seed, device):
    """A pool of star frames for the PSF fit, rendered once: frame f has
    its own circular Moffat (FWHM drawn in ``fwhm_px``) and 8 to 10 real
    stars (the first frame of every bucket 10, so every bucket pads to
    the same 10), each with a flux and a sub-pixel offset of its own. The
    noise sigma of a pixel is sqrt(|clean| + 1), as the recipe of
    ``make_star_stamps``; the noise itself is drawn per bucket."""
    sc = cfg["scene"]
    n, s = cfg["stamp_size_stars"], cfg["subsampling_factor"]
    m, S, B = n * s, cfg["stars_to_use_psf"], cfg["psf_fit_batch_size"]
    P = B * cfg["pool_buckets"]
    rng = np.random.default_rng(mix(seed, 6))
    fwhm = rng.uniform(*sc["fwhm_px"], P)
    n_real = rng.integers(sc["stars_min"], S + 1, P)
    n_real[::B] = S
    flux = rng.uniform(*sc["flux"], (P, S))
    offset = rng.uniform(-sc["offset_px"], sc["offset_px"], (P, S, 2))

    p = Precision("float64", device)
    psf = moffat(m, s, fwhm, sc["beta"], p.device)
    stamps = Renderer(m, s, p).render(
        psf.repeat_interleave(S, 0), flux.reshape(-1, 1),
        offset[..., 0].reshape(-1, 1), offset[..., 1].reshape(-1, 1))
    clean = stamps.reshape(P, S, n, n).cpu().numpy()
    clean[np.arange(S)[None, :] >= n_real[:, None]] = 0.0
    return {"device": p.device, "n": n, "m": m, "s": s, "seed": seed,
            "fwhm": fwhm, "n_real": n_real, "clean": clean,
            "sigma": np.sqrt(np.abs(clean) + 1.0), "batch": B, "pool": P}


def psf_bucket(scene, index):
    """Bucket ``index``'s frames: (pool frame ids, data, sigma), the data
    with fresh noise from (seed, index)."""
    B, P = scene["batch"], scene["pool"]
    ids = (index * B + np.arange(B)) % P
    rng = np.random.default_rng(mix(scene["seed"], 7, index))
    sigma = scene["sigma"][ids]
    data = scene["clean"][ids] + rng.standard_normal(sigma.shape) * sigma
    return ids, data.astype(np.float32), sigma.astype(np.float32)
