"""Synthetic multi-epoch ROI scenes and star stamps in numpy.

A copy of ``make_roi_scene``, ``make_star_stamps``, ``render_epochs_np``
and ``moffat_np`` from ``lightcurver_tpu/utilities/synthetic.py``: a
machine without jax cannot import the original, since importing any
``lightcurver_tpu`` module loads the JAX core. The same seed gives the
same scene and the same stamps as the original (the tests check this).

Also :func:`make_psf_task_workdir` (the PSF task's workdir without the
tasks before it, as JAX's), the star photometry's buckets
(:func:`star_photometry_scene`, the stamps of the JAX package's
``bench.py::run_star_photometry_bench``), the frames of the JAX
package's PSF bench (:func:`psf_bench_frames`) and a point of the
batched PSF fit's pixel-phase loss on them (:func:`psf_pixel_phase_point`),
which the kernel tests, ``chip_smoke.py`` and
``tools/torch_psf_rounding.py`` hold card against CPU and float32 against
float64.
"""

import math

import numpy as np

from ..core.conventions import fwhm_to_sigma, TARGET_FWHM_FINE_PIX


def _freqs(L):
    fy = np.fft.fftfreq(L).reshape(L, 1)
    fx = np.fft.rfftfreq(L).reshape(1, L // 2 + 1)
    return fy, fx


def r_kernel_fft_np(m):
    """Analytic rfft2 of the target Gaussian at L = 2m."""
    sigma_f = fwhm_to_sigma(TARGET_FWHM_FINE_PIX)
    fy, fx = _freqs(2 * m)
    return np.exp(-2.0 * np.pi**2 * sigma_f**2 * (fy**2 + fx**2))


def moffat_np(m, s, fwhm_x, fwhm_y, beta):
    """Unit-integral elliptical Moffat on the fine grid."""
    c = (m - 1) / 2.0
    idx = (np.arange(m) - c) / s
    y, x = np.meshgrid(idx, idx, indexing="ij")
    root = math.sqrt(2.0 ** (1.0 / beta) - 1.0)
    ax, ay = fwhm_x / (2 * root), fwhm_y / (2 * root)
    u = (x / ax) ** 2 + (y / ay) ** 2
    norm = (beta - 1.0) / (math.pi * ax * ay * s**2)
    return (norm * (1.0 + u) ** (-beta)).astype(np.float32)


def render_epochs_np(psf, a, px, py, s, h=None):
    """Clean (N, n, n) float32 stamps from PSFs (N, m, m), fluxes (N, M),
    positions (M,) or (N, M) in data px (centre origin) and an optional
    (m, m) background."""
    psf = np.asarray(psf, dtype=np.float64)
    N, m = psf.shape[0], psf.shape[-1]
    n = m // s
    L = 2 * m
    a = np.asarray(a, dtype=np.float64)
    M = a.shape[1]
    px = np.broadcast_to(np.asarray(px, dtype=np.float64), (N, M))
    py = np.broadcast_to(np.asarray(py, dtype=np.float64), (N, M))
    fy, fx = _freqs(L)
    r_hat = r_kernel_fft_np(m)
    c = (m - 1) / 2.0
    center_phase = np.exp(1j * 2 * np.pi * (fy + fx) * c)

    h_hat = None if h is None \
        else np.fft.rfft2(h, s=(L, L)) * center_phase
    out = np.empty((N, n, n), dtype=np.float32)
    for e in range(N):
        t = psf[e] / psf[e].sum()
        t_hat = np.fft.rfft2(t, s=(L, L))
        spec = np.zeros_like(t_hat)
        for j in range(M):
            ang = -2 * np.pi * (fy * s * py[e, j] + fx * s * px[e, j])
            spec += a[e, j] * np.exp(1j * ang)
        total = spec * t_hat * r_hat
        if h_hat is not None:
            total += h_hat * t_hat
        fine = np.fft.irfft2(total, s=(L, L))[:m, :m]
        out[e] = fine.reshape(n, s, n, s).sum(axis=(1, 3)).astype(np.float32)
    return out


def make_roi_scene(n_epochs=100, n_pix=64, s=2, n_sources=4, noise_sigma=0.3,
                   seed=7, fwhm_range=(2.2, 4.0), flux_range=(40.0, 120.0)):
    """Blended point sources over many epochs with Moffat PSFs and noise.

    Returns:
        dict with data, sigma_2, psf, xs, ys (centre-origin data px), s,
        a_true (N, M) and fwhm (N,).
    """
    rng = np.random.default_rng(seed)
    m = n_pix * s
    fwhms = rng.uniform(*fwhm_range, n_epochs)
    psf = np.stack([moffat_np(m, s, f, f, beta=2.8) for f in fwhms])
    xs = np.array([-4.0, 4.0, 0.0, -1.5], np.float32)[:n_sources]
    ys = np.array([2.0, -3.0, 4.5, -1.0], np.float32)[:n_sources]
    a_true = rng.uniform(*flux_range,
                         size=(n_epochs, n_sources)).astype(np.float32)
    clean = render_epochs_np(psf, a_true, xs[None, :], ys[None, :], s)
    sigma = np.full_like(clean, noise_sigma)
    data = clean + rng.normal(0, noise_sigma, clean.shape).astype(np.float32)
    return {
        "data": data, "sigma_2": (sigma**2).astype(np.float32),
        "psf": psf.astype(np.float32), "xs": xs, "ys": ys, "s": s,
        "a_true": a_true, "fwhm": fwhms.astype(np.float32),
    }


def make_psf_task_workdir(workdir, n_frames=64, n_stars=8, n_pix=64, s=2,
                          seed=11, config_overrides=None):
    """A ready-to-run workdir for the PSF-modelling pipeline task.

    Writes exactly what ``processes.psf_modelling.model_all_psfs`` reads:
    the config (the port's example config, with the workdir, the
    ``ROI_disk`` star selection, the stamp size and s, and
    ``config_overrides``), the frames, stars and stars_in_frames rows and
    the regions HDF5 of per-star stamps (frame k: :func:`make_star_stamps`
    of seed ``seed + k``), without running the tasks before it. The same
    rows and datasets as JAX's ``make_psf_task_workdir``.

    Returns the config path (set LIGHTCURVER_CONFIG to it).
    """
    import sqlite3
    from pathlib import Path

    import h5py
    import yaml

    from ..structure.database import initialize_database
    from .star_naming import generate_star_names

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "frames").mkdir(exist_ok=True)

    template = (Path(__file__).parent.parent / "pipeline"
                / "example_config_file" / "config.yaml")
    with open(template) as f:
        config = yaml.safe_load(f)
    config.update({
        "workdir": str(workdir),
        "raw_dirs": [str(workdir / "raw")],
        "already_plate_solved": 1,
        "star_selection_strategy": "ROI_disk",
        "ROI_disk_radius_arcseconds": 30,
        "stamp_size_stars": n_pix,
        "subsampling_factor": s,
    })
    config["ROI"] = {"bench": {"coordinates": [42.2031, 19.22528]}}
    config.update(config_overrides or {})
    config_path = workdir / "config.yaml"
    config_path.write_text(yaml.dump(config))

    initialize_database(workdir / "database.sqlite3")

    # ROI_disk: the footprint hash is the radius hash, frame-independent
    fhash = hash(config["ROI_disk_radius_arcseconds"])
    names = generate_star_names(n_stars)
    conn = sqlite3.connect(workdir / "database.sqlite3")
    try:
        for i, name in enumerate(names):
            conn.execute(
                "INSERT INTO stars (gaia_id, name, ra, dec, gmag, "
                "combined_footprint_hash, distance_to_roi_arcsec) "
                "VALUES (?,?,?,?,?,?,?)",
                (1000 + i, name, 42.2031 + 1e-3 * i, 19.22528, 17.5,
                 fhash, 5.0 * (i + 1)))
        with h5py.File(workdir / "regions.h5", "w") as f:
            for k in range(n_frames):
                rel = f"frames/frame_{k:04d}.fits"
                seeing = 2.4 + 0.01 * (k % 40)
                conn.execute(
                    "INSERT INTO frames (id, mjd, exptime, gain, "
                    "image_relpath, plate_solved, eliminated, "
                    "roi_in_footprint, seeing_pixels, pixel_scale) "
                    "VALUES (?,?,?,?,?,1,0,1,?,?)",
                    (k + 1, 60000.0 + k, 30.0, 1.2, rel, seeing, 0.2))
                for gid in range(1000, 1000 + n_stars):
                    conn.execute(
                        "INSERT INTO stars_in_frames (frame_id, "
                        "star_gaia_id, combined_footprint_hash) "
                        "VALUES (?,?,?)", (k + 1, gid, fhash))
                st = make_star_stamps(n_stars=n_stars, n_pix=n_pix, s=s,
                                      seed=seed + k, fwhm_x=seeing,
                                      fwhm_y=seeing)
                grp = f.create_group(rel)
                grp["frame_shape"] = np.array([2048, 2048])
                for sub in ("data", "noisemap", "cosmicsmask",
                            "image_pixel_coordinates"):
                    grp.create_group(sub)
                for j, gid in enumerate(range(1000, 1000 + n_stars)):
                    grp["data"][str(gid)] = st["data"][j]
                    grp["noisemap"][str(gid)] = st["sigma"][j]
                    grp["cosmicsmask"][str(gid)] = np.zeros(
                        (n_pix, n_pix), dtype=bool)
                    grp["image_pixel_coordinates"][str(gid)] = np.array(
                        [300.0 + 100.0 * j, 400.0 + 80.0 * j])
        conn.commit()
    finally:
        conn.close()
    return config_path


def make_star_stamps(n_stars=8, n_pix=64, s=2, seed=3, fwhm_x=3.0,
                     fwhm_y=2.6, beta=2.6, flux_range=(200.0, 800.0)):
    """Synthetic single-frame star stamps sharing one PSF (for build_psf)."""
    rng = np.random.default_rng(seed)
    m = n_pix * s
    psf = moffat_np(m, s, fwhm_x, fwhm_y, beta)
    a = rng.uniform(*flux_range, n_stars).astype(np.float32)
    x0 = rng.uniform(-0.4, 0.4, n_stars).astype(np.float32)
    y0 = rng.uniform(-0.4, 0.4, n_stars).astype(np.float32)
    psf_stack = np.broadcast_to(psf, (n_stars, m, m))
    clean = render_epochs_np(psf_stack, a[:, None], x0[:, None], y0[:, None],
                             s)
    sigma = np.sqrt(np.abs(clean) + 1.0).astype(np.float32)
    data = clean + rng.normal(0, 1, clean.shape).astype(np.float32) * sigma
    return {"data": data, "sigma": sigma, "psf_true": psf, "a_true": a,
            "x0": x0, "y0": y0, "s": s}


def star_photometry_scene(n_stars, n_epochs, n_pix, s, seed0=30,
                          n_real=None):
    """One bucket of reference stars for ``fit_stars_batched``.

    Star i is :func:`make_star_stamps` with ``n_stars=n_epochs`` (one
    stamp an epoch), seed ``seed0 + i`` and a Moffat FWHM of 2.6 px, its
    true PSF repeated over the epochs, as the JAX package's
    ``bench.py::run_star_photometry_bench`` makes them. ``n_real`` (S,)
    keeps the first ``n_real[i]`` epochs of star i and pads the rest as
    the star-photometry task pads a bucket of unequal epoch counts: data
    0, noise 1e7, the first PSF repeated (``a_true`` NaN there).

    Returns:
        dict with data, sigma (S, N, n, n), psf (S, N, m, m), a_true
        (S, N) and s.
    """
    data, sigma, psf, a_true = [], [], [], []
    for i in range(n_stars):
        st = make_star_stamps(n_stars=n_epochs, n_pix=n_pix, s=s,
                              seed=seed0 + i, fwhm_x=2.6, fwhm_y=2.6)
        data.append(st["data"])
        sigma.append(st["sigma"])
        psf.append(np.broadcast_to(st["psf_true"],
                                   (n_epochs,) + st["psf_true"].shape))
        a_true.append(st["a_true"])
    data, sigma, psf = np.stack(data), np.stack(sigma), np.stack(psf)
    a_true = np.stack(a_true)
    if n_real is not None:
        for i, k in enumerate(n_real):
            data[i, k:] = 0.0
            sigma[i, k:] = 1e7
            psf[i, k:] = psf[i, 0]
            a_true[i, k:] = np.nan
    return {"data": data, "sigma": sigma, "psf": psf, "a_true": a_true,
            "s": s}


def star_k2_operands(n_stars, n_epochs, n_pix, device, seed):
    """``(ops, g)``: K2's 14 operands as the star photometry gives them
    (one source, s = 2, the S stars x N epochs of
    :func:`star_photometry_scene` as S N render epochs, one background per
    star: h_re, h_im (S, L, Lh)), at random positions and backgrounds, and
    a random output cotangent (S N, n, n), on ``device``."""
    import torch

    from ..core.deconv.model import DeconvModel
    from ..ops import dft

    sc = star_photometry_scene(n_stars, n_epochs, n_pix, 2, seed0=seed)
    m = 2 * n_pix
    model = DeconvModel(
        torch.as_tensor(sc["psf"].reshape(-1, m, m), device=device), 2,
        n_pix, n_stars * n_epochs, 1, n_groups=n_stars,
        dft_mats=dft.make_dft_mats(2 * m, m, pool=2, device=device))
    gen = torch.Generator().manual_seed(seed)
    a = torch.as_tensor(sc["a_true"].reshape(-1, 1), device=device)
    px, py = (0.3 * torch.randn(2, n_stars * n_epochs, 1, generator=gen,
                                dtype=torch.float32)).to(device)
    h = (0.01 * torch.randn(n_stars, m * m, generator=gen,
                            dtype=torch.float32)).to(device)
    ops = model.fused_render_operands(a, px, py, h, model.matmul_consts())
    g = torch.randn(n_stars * n_epochs, n_pix, n_pix, generator=gen,
                    dtype=torch.float32).to(device)
    return ops, g


def star_loss_point(n_stars, n_epochs, n_pix, irfft_backend,
                    starlet_global_background, device, seed=9):
    """``(loss, free)``: the star photometry's per-star loss (S,) on
    :func:`star_photometry_scene` (s = 2, every epoch real), at a point
    made from a seed (positions, fluxes and, with a free background, h
    and the noise weights W), on ``device``."""
    import torch

    from ..core.deconv.batched import _prepare_stars, _star_losses
    from ..core.starlet import n_starlet_scales

    sc = star_photometry_scene(n_stars, n_epochs, n_pix, 2)
    m = 2 * n_pix
    rng = np.random.default_rng(seed)

    def on(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=device)

    W = rng.uniform(0.01, 0.05, (n_stars, n_starlet_scales(m) + 1, m, m)) \
        if starlet_global_background else None
    model, free, _, _, consts, _ = _prepare_stars(
        on(sc["data"]), on(sc["sigma"]), on(sc["psf"]), 2, False,
        starlet_global_background, irfft_backend, 0, W)
    ka = free["kwargs_analytic"]
    ka["a"] = ka["a"] * on(1 + 0.02 * rng.normal(size=ka["a"].shape))
    for key, width in (("c_x", 0.3), ("c_y", 0.3), ("dx", 0.2),
                       ("dy", 0.2)):
        ka[key] = on(rng.uniform(-width, width, ka[key].shape))
    if starlet_global_background:
        free["kwargs_background"]["h"] = on(
            1e-3 * rng.normal(size=(n_stars, m * m)))
    return _star_losses(model, consts, n_stars), free


def psf_bench_frames(n_frames=16, n_stars=8, n_pix=64, s=2):
    """(data, sigma), each (F, N, n, n): the frames of the JAX package's
    PSF bench (``bench.py::run_psf_bench``), frame i from seed i with a
    Moffat FWHM of 2.4 + 0.1 i px."""
    frames = [make_star_stamps(n_stars=n_stars, n_pix=n_pix, s=s, seed=i,
                               fwhm_x=2.4 + 0.1 * i, fwhm_y=2.4 + 0.1 * i)
              for i in range(n_frames)]
    return (np.stack([f["data"] for f in frames]),
            np.stack([f["sigma"] for f in frames]))


def psf_pixel_phase_point(n_frames, n_stars, n_pix, irfft_backend, device,
                          dtype=np.float32):
    """``(loss, free, consts)``: the batched PSF fit's pixel-phase loss on
    :func:`psf_bench_frames` (s = 2, ``dft_pad`` 16 on the matmul render)
    at a parameter point made from a seed, in ``dtype`` on ``device``;
    ``loss(free, consts)`` is the (F,) vector of per-frame losses.
    float64 upcasts the data, the parameters and the DFT matrices."""
    import torch

    from ..core.psf.build import phase_losses, psf_dft_mats
    from ..core.starlet import n_starlet_scales

    data, sigma = psf_bench_frames(n_frames, n_stars, n_pix)
    m = 2 * n_pix
    scale = data.max(axis=(1, 2, 3), keepdims=True)
    rng = np.random.default_rng(8)

    def on(x, kind=dtype):
        return torch.as_tensor(np.asarray(x, dtype=kind), device=device)

    mats = psf_dft_mats(m, 2, irfft_backend, 16, device)
    if mats is not None:
        mats = {k: v.to(on(0.0).dtype) for k, v in mats.items()}
    consts = {"data": on(data / scale), "sigma_2": on((sigma / scale) ** 2),
              "masks": on(np.ones(data.shape, bool), bool),
              "stamp_coordinates": on(np.zeros((n_frames, n_stars, 2))),
              "dft_mats": mats,
              "W": on(rng.uniform(0.01, 0.05, (n_frames,
                                               n_starlet_scales(m) + 1,
                                               m, m))),
              "lam": on(1.0),
              "fixed": {"kwargs_moffat": {
                  k: on(np.full(n_frames, v)) for k, v in
                  (("fwhm_x", 2.6), ("fwhm_y", 2.5), ("beta", 2.7))},
                  "kwargs_distortion": {
                      k: on(np.zeros((n_frames, 5))) for k in
                      ("dilation_x", "dilation_y", "shear")}}}
    free = {"kwargs_gaussian": {
        "a": on(data.sum(axis=(2, 3)) / scale[:, :, 0, 0]),
        "x0": on(rng.uniform(-0.3, 0.3, (n_frames, n_stars))),
        "y0": on(rng.uniform(-0.3, 0.3, (n_frames, n_stars)))},
        "kwargs_background": {"background": on(
            1e-4 * rng.normal(0, 1, (n_frames, m * m)))}}
    _, _, loss_pixels = phase_losses(n_stars, n_pix, 2, False)
    return loss_pixels, free, consts
