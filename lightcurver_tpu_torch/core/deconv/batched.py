"""Star-batched joint PSF photometry: ``fit_stars_batched``.

Twin of ``lightcurver_tpu/core/deconv/batched.py``. The JAX package writes
the joint fit of one star (scaling, flux initialisation, the AdaBelief
loop, the GLS flux polish, per-frame chi2 and the Fisher flux errors) and
vmaps it over the star axis. Here the S stars x N epochs of a bucket are
one ``DeconvModel`` of S N render epochs in S groups
(``DeconvModel(n_groups=S)``): each star keeps its own position
``c_x``, ``c_y`` and, with ``starlet_global_background``, its own
pixelated background h, and every per-star sum reshapes the epoch axis
back to (S, N). The optimiser is the frame-batched AdaBelief of
``core/optimize.py`` with one problem per star.

Stars with fewer epochs are padded with dummy epochs (data 0, noise 1e7,
a real PSF repeated); an epoch whose noise is >= 1e6 on every pixel is a
dummy, masked out of the loss through ``epoch_w`` and out of the noise
weights' statistics.

Kernels, per loss evaluation: with ``starlet_global_background`` the l1
term of the S backgrounds is one K1 launch forward and one adjoint
(``ops.starlet_op``), and on ``irfft_backend="matmul"`` the render is one
K2 launch each way with a per-star h (``ops.fused_render``); the
Monte-Carlo noise weights of all stars are one K1 launch at batch S x 200.
With the shipped flags (h fixed at zero) no kernel of ours runs: the
render is cuFFT, or the rank-1 modulated inverse on "matmul".

With ``checkpoint_path`` the AdaBelief loop runs in segments and writes
the per-star carry to disk after each (JAX's ``_fit_stars_checkpointed``,
through ``core/optimize.py``'s checkpoint writer and reader); a killed fit
resumes from its last segment.

Under several ranks (``parallel/``) the stars are split over a ``batch``
mesh, each rank fitting its own; with fewer stars than ranks a
(``batch``, ``epoch``) mesh also splits each star's epochs: in an epoch
group every rank holds its stars' whole parameters, renders its epochs
(K2 with ``n_groups`` = its stars), rank 0 of the group adds each star's
starlet term once, and the per-star losses and the gradient are
all-reduced over the group. The results are gathered to every rank and
the padded stars and epochs stripped.
"""

import numpy as np
import torch
import torch.distributed as dist

from .loss import _abs, sum_over_group
from .model import DeconvModel
from ..fisher import _diag_fisher, linear_flux_solve
from ..noise import epoch_nanmedian, mc_starlet_noise
from ..optimize import arrays_digest, run_adabelief_batched
from ..params import kwargs_to_numpy, merge_free
from ..starlet import n_starlet_scales
from ...ops import check_irfft_backend, dft, enforce_fp32
from ...ops.starlet_op import starlet_transform
from ...parallel.batch import (BATCH_AXIS, CheckpointShare, auto_fit_mesh,
                               gather_to_host, pad_epoch_axis,
                               shard_star_fit_arrays, strip_batch,
                               strip_epoch_axis)
from ...parallel.deconv import PER_EPOCH_KEYS, epoch_range
from ...parallel.mesh import EPOCH_AXIS, axis_size, resolve_mesh

# result keys whose leading axis after the star axis is the epoch axis
EPOCH_AXIS_RESULT_KEYS = frozenset({"fluxes", "fluxes_uncertainties",
                                    "chi2_per_frame", "residuals"})
NOISE_SAMPLES = 200          # Monte-Carlo draws per star
POSITION_BOUND = 5.0         # data px, on c_x, c_y, dx, dy
LAMBDA_HF = LAMBDA_SCALES = 3.0
DUMMY_NOISE = 1e6            # noise >= this on every pixel: a dummy epoch


def _border_background(d):
    """Per-epoch background guess (S, N): the mean of the NaN-medians of
    the four stamp edges (``epoch_nanmedian``'s form: the mean of the two
    middle values of an even count, as ``jnp.nanmedian``)."""
    edges = (d[..., 0, :], d[..., :, 0], d[..., -1, :], d[..., :, -1])
    medians = torch.stack([epoch_nanmedian(e, dim=-1) for e in edges])
    return torch.nan_to_num(torch.nanmean(medians, dim=0))


def _model_kwargs(kw):
    """Per-star kwargs (leaves (S, ...)) as the grouped model's: the
    per-epoch leaves flattened to S N, ``c_x``, ``c_y`` (S, 1) and ``h``
    (S, m*m) kept per star."""
    ka, kb = kw["kwargs_analytic"], kw["kwargs_background"]
    return {"kwargs_analytic": {
        "a": ka["a"].reshape(-1), "c_x": ka["c_x"], "c_y": ka["c_y"],
        "dx": ka["dx"].reshape(-1), "dy": ka["dy"].reshape(-1),
        "alpha": ka["alpha"].reshape(-1)},
        "kwargs_background": {"h": kb["h"],
                              "mean": kb["mean"].reshape(-1)}}


def _noise_draws(n_stars, n_pix, seed):
    """The Monte-Carlo draws of the noise weights, (S, K, n, n), from one
    seeded CPU generator (a star's draws do not depend on the rank that
    fits it)."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn((n_stars, NOISE_SAMPLES, n_pix, n_pix), generator=gen,
                       dtype=torch.float32)


def _prepare_stars(data, noisemap, psf, s, uniform_background_per_epoch,
                   starlet_global_background, irfft_backend, seed,
                   noise_weights, draws=None, group=None):
    """Set-up of the S fits: ``(model, free0, lower, upper, consts,
    scale)``. Tensors in (data, noisemap (S, N, n, n), psf (S, N, mp, mp),
    sanitised, on one device), JAX's ``_prepare_one_star`` under vmap.
    ``draws``: these stars' noise draws (default: :func:`_noise_draws` of
    ``seed``); with a process ``group`` its rank 0 computes the noise
    weights and broadcasts them."""
    device = data.device
    n_stars, n_epochs, n_pix = data.shape[:3]
    m = n_pix * s
    real_epoch = (noisemap < DUMMY_NOISE).any(dim=-1).any(dim=-1)
    n_real = torch.clamp(real_epoch.sum(dim=1), min=1)

    scale = data.amax(dim=(1, 2, 3))
    scale = torch.where(torch.isfinite(scale) & (scale > 0), scale,
                        torch.ones_like(scale))
    d = data / scale[:, None, None, None]
    sig = noisemap / scale[:, None, None, None]
    a0 = torch.nansum(d, dim=(2, 3)) - n_pix**2 * _border_background(d)

    mats = dft.make_dft_mats(2 * m, m, pool=s, device=device) \
        if irfft_backend == "matmul" else None
    model = DeconvModel(psf.reshape(-1, *psf.shape[2:]), s, n_pix,
                        n_stars * n_epochs, 1, n_groups=n_stars,
                        dft_mats=mats)

    def zeros(*shape):
        return torch.zeros(*shape, dtype=torch.float32, device=device)

    free = {"kwargs_analytic": {"a": a0, "c_x": zeros(n_stars, 1),
                                "c_y": zeros(n_stars, 1),
                                "dx": zeros(n_stars, n_epochs),
                                "dy": zeros(n_stars, n_epochs)},
            "kwargs_background": {}}
    fixed = {"kwargs_analytic": {"alpha": zeros(n_stars, n_epochs)},
             "kwargs_background": {}}
    (free if uniform_background_per_epoch else fixed)[
        "kwargs_background"]["mean"] = zeros(n_stars, n_epochs)
    (free if starlet_global_background else fixed)[
        "kwargs_background"]["h"] = zeros(n_stars, m * m)

    def bounds(value, positions):
        out = {"kwargs_analytic": {}, "kwargs_background": {}}
        for group, leaves in free.items():
            for key, leaf in leaves.items():
                v = positions if key in ("c_x", "c_y", "dx", "dy") else value
                out[group][key] = torch.full(leaf.shape[1:], v,
                                             dtype=leaf.dtype,
                                             device=device)
        return out

    consts = {
        "data": d.reshape(-1, n_pix, n_pix),
        "sigma_2": (sig**2).reshape(-1, n_pix, n_pix),
        "epoch_w": real_epoch.to(torch.float32),
        "fixed": fixed,
        # the all-real matmul render (raw spectra, K2 with h free) in the
        # loss; None renders through cuFFT
        "render": model.matmul_consts() if mats is not None else None,
        # the finalize renders as JAX's does, without the raw spectra
        "finalize": {"dft_mats": mats} if mats is not None else None,
        # a fixed zero background renders as a zero: its chain is skipped
        "fixed_h_render": None if starlet_global_background
        else torch.zeros((), dtype=torch.float32, device=device),
    }
    if starlet_global_background:
        if noise_weights is None and group is not None \
                and dist.get_rank(group) != 0:
            noise_weights = torch.empty(
                (n_stars, n_starlet_scales(m) + 1, m, m), dtype=torch.float32,
                device=device)
            dist.broadcast(noise_weights, group=group, group_src=0)
        elif noise_weights is None:
            # statistics over the real epochs only
            sig_real = torch.where(real_epoch[:, :, None, None], sig,
                                   torch.full_like(sig, float("nan")))
            w = real_epoch.to(torch.float32)[:, :, None, None]
            mean_ps_hat = (model.ps_hat.unflatten(0, (n_stars, n_epochs))
                           * w).sum(dim=1) / n_real[:, None, None]
            if draws is None:
                draws = _noise_draws(n_stars, n_pix, seed)
            with torch.no_grad():
                noise_weights = mc_starlet_noise(
                    epoch_nanmedian(sig_real, dim=1), mean_ps_hat, m, s,
                    draws.to(device), mats)
            if group is not None:
                dist.broadcast(noise_weights, group=group, group_src=0)
        if not isinstance(noise_weights, torch.Tensor):
            noise_weights = np.array(noise_weights, dtype=np.float32)
        consts["W"] = torch.as_tensor(noise_weights, dtype=torch.float32,
                                      device=device)
        expected = (n_stars, n_starlet_scales(m) + 1, m, m)
        if tuple(consts["W"].shape) != expected:
            raise ValueError(f"noise_weights of shape "
                             f"{tuple(consts['W'].shape)}, {expected} "
                             "expected")
    return (model, free, bounds(-np.inf, -POSITION_BOUND),
            bounds(np.inf, POSITION_BOUND), consts, scale)


def _epoch_share(model, consts, epochs):
    """(model, consts) of epochs ``[start, stop)`` of every star: a rank's
    share of the loss on a (batch, epoch) mesh. The model renders S x
    (stop - start) epochs in S groups; the finalize keeps the whole."""
    start, stop = epochs
    local = model.epoch_slice(start, stop)
    n_stars = model.n_groups

    def cut(x):
        return x.unflatten(0, (n_stars, -1))[:, start:stop].flatten(0, 1)

    return local, {
        **consts, "data": cut(consts["data"]),
        "sigma_2": cut(consts["sigma_2"]),
        "epoch_w": consts["epoch_w"][:, start:stop],
        "render": local.matmul_consts() if consts["render"] is not None
        else None}


def _star_losses(model, consts, n_stars, epochs=None, group=None):
    """``loss_fn(free) -> (S,)``: per star 0.5 * sum(epoch_w chi2) and,
    with a free background, LAMBDA_HF and LAMBDA_SCALES times the
    weighted starlet l1 of h (JAX's ``_star_loss_fn`` under vmap).

    On a (batch, epoch) mesh ``model`` and ``consts`` are this rank's
    epoch share (:func:`_epoch_share`) of ``epochs`` = ``(start, stop)``:
    the per-epoch leaves are cut to them, rank 0 of the epoch ``group``
    adds the starlet terms, and the per-star losses and the gradient are
    summed over the group."""
    m = model.m
    w = consts["epoch_w"].reshape(-1)[:, None, None]
    first = group is None or dist.get_rank(group) == 0

    def loss_fn(free):
        kw = merge_free(free, consts["fixed"])
        if epochs is not None:
            start, stop = epochs
            kw = {g: {k: v[:, start:stop] if k in PER_EPOCH_KEYS else v
                      for k, v in leaves.items()} for g, leaves in kw.items()}
        modelled = model.model(_model_kwargs(kw), consts["fixed_h_render"],
                               consts["render"])
        res = (consts["data"] - modelled) ** 2 / consts["sigma_2"]
        total = 0.5 * torch.nansum((w * res).reshape(n_stars, -1), dim=1)
        if "W" in consts and first:
            coeffs = starlet_transform(
                kw["kwargs_background"]["h"].reshape(n_stars, m, m))
            wabs = consts["W"] * _abs(coeffs)
            total = total + LAMBDA_HF * wabs[:, 0].sum(dim=(-2, -1)) \
                + LAMBDA_SCALES * wabs[:, 1:-1].sum(dim=(1, 2, 3))
        return total

    if group is None:
        return loss_fn
    return lambda free: sum_over_group(loss_fn, free, group)


def _finalize_stars(model, best, history, consts, scale):
    """GLS flux polish, chi2 and Fisher errors of every star (JAX's
    ``_finalize_one_star`` under vmap)."""
    n_stars, n_epochs = consts["epoch_w"].shape
    n_pix, m = model.image_size, model.m
    d, sigma_2 = consts["data"], consts["sigma_2"]
    render, fixed_h = consts["finalize"], consts["fixed_h_render"]
    kw = _model_kwargs(merge_free(best, consts["fixed"]))
    # exact GLS flux solve at the fitted positions and background
    kw = linear_flux_solve(kw, d, sigma_2, model, render, fixed_h)
    residuals = d - model.model(kw, fixed_h, render)
    chi2_per_frame = (torch.nansum(residuals**2 / sigma_2, dim=(1, 2))
                      / n_pix**2).reshape(n_stars, n_epochs)
    flux_err = _diag_fisher(model.point_source_basis(kw, render), sigma_2)
    w = consts["epoch_w"]
    per_star = scale[:, None]
    return {
        "fluxes": per_star * kw["kwargs_analytic"]["a"].reshape(n_stars, -1),
        "fluxes_uncertainties": per_star * flux_err[:, 0].reshape(n_stars,
                                                                  -1),
        "chi2_per_frame": chi2_per_frame,
        # the mean over real epochs: padding has ~0 chi2
        "chi2": torch.nansum(chi2_per_frame * w, dim=1)
        / torch.clamp(w.sum(dim=1), min=1),
        "loss_history": history,
        "residuals": per_star[:, :, None, None]
        * residuals.reshape(n_stars, n_epochs, n_pix, n_pix),
        "starlet_background": per_star[:, :, None]
        * kw["kwargs_background"]["h"].reshape(n_stars, m, m),
    }


def fit_stars_batched(data, noisemap, psf, subsampling_factor,
                      n_iter=2000, uniform_background_per_epoch=False,
                      starlet_global_background=False, lr=1e-3, seed=0,
                      checkpoint_path=None, checkpoint_every=500,
                      mesh="auto", fetch="numpy", *, device="cuda",
                      irfft_backend="fft", noise_weights=None):
    """Joint PSF photometry of many stars at once.

    Args:
        data, noisemap: (S, N, n, n): S stars, N epochs each (pad missing
            epochs with data 0 and noise 1e7: an epoch with noise >= 1e6
            on every pixel is masked out of the fit).
        psf: (S, N, mp, mp) narrow PSFs; pad missing epochs by repeating
            a real PSF (all-zero pads are tolerated).
        subsampling_factor: int s.
        n_iter, lr: the AdaBelief budget and learning rate (decayed to
            1 % over the fit).
        uniform_background_per_epoch: fit a constant per epoch.
        starlet_global_background: fit a pixelated background per star
            under a starlet l1 penalty weighted by Monte-Carlo noise
            weights (``NOISE_SAMPLES`` draws per star from a CPU
            ``torch.Generator`` seeded with ``seed``).
        checkpoint_path, checkpoint_every: when a path is given, the
            AdaBelief loop runs in ``checkpoint_every``-iteration segments
            with the per-star carry written to this path after each; a
            call that finds the file resumes from it, and refuses
            (``core.optimize.CheckpointMismatch``) a file recorded for
            other data, PSFs, flags, budget or render. Not with
            ``fetch="device"``.
        mesh: "auto" (default) picks the mesh for the star count when
            ``torch.distributed`` has several ranks
            (``parallel.batch.auto_fit_mesh``): a 1-D ``batch`` mesh when
            there are at least as many stars as ranks (the per-star fits
            are independent: no collective until the gather), a 2-D
            (``batch``, ``epoch``) mesh when there are fewer, whose spare
            ranks shard each star's epochs; None forces the unsharded
            fit; explicit meshes of either shape are accepted. Star
            counts that do not divide the batch extent are padded with
            duplicate stars, epoch counts that do not divide the epoch
            extent with dummy epochs; both are stripped from the result.
            Above one rank the render is "matmul", as JAX forces "mxu";
            with ``checkpoint_path`` rank 0 writes and reads the gathered
            carry and broadcasts it.
        fetch: "numpy" (default) returns host arrays; "device" the
            tensors on the device, unsynchronised (on the host, gathered,
            under a mesh of several ranks).
        device: torch device of the fit: the card unless the caller asks
            for "cpu"; there is no fallback.
        irfft_backend: "fft" (cuFFT) or "matmul", the port's name for
            JAX's "mxu" (the matmul DFT; K2 renders with a free
            background).
        noise_weights: optional (S, J + 1, m, m) starlet weights on the
            scaled data, in place of the Monte-Carlo draw (read with
            ``starlet_global_background`` only).

    Returns:
        dict of per-star results: ``fluxes``, ``fluxes_uncertainties``,
        ``chi2_per_frame`` (S, N); ``chi2`` (S,), the mean over real
        epochs; ``loss_history`` (S, n_iter); ``residuals`` (S, N, n, n);
        ``starlet_background`` (S, m, m); fluxes, residuals and background
        in the data's units.
    """
    enforce_fp32()
    check_irfft_backend(irfft_backend)
    if fetch not in ("numpy", "device"):
        raise ValueError(f"fetch={fetch!r}: 'numpy' or 'device' expected")
    if checkpoint_path is not None and fetch == "device":
        raise ValueError("fit_stars_batched: checkpoint_path cannot be "
                         "combined with fetch='device' (every segment "
                         "synchronises)")
    data = np.asarray(data, dtype=np.float32)
    noisemap = np.asarray(noisemap, dtype=np.float32)
    # joint sanitisation: a bad pixel gets data 0 and noise 1e7, so it
    # neither enters as a zero-flux measurement at full weight nor flips
    # its epoch to a dummy (that needs every pixel >= 1e6)
    bad = ~(np.isfinite(data) & np.isfinite(noisemap))
    data = np.where(bad, np.float32(0.0), data)
    noisemap = np.where(bad, np.float32(1e7), noisemap)
    # a NaN PSF pixel would spread through the spectra into the fit
    psf = np.nan_to_num(np.asarray(psf, dtype=np.float32))

    def on(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    n_stars, n_pix = data.shape[0], data.shape[2]
    mesh = resolve_mesh(mesh, lambda: auto_fit_mesh(n_stars))
    names = () if mesh is None else tuple(mesh.mesh_dim_names or ())
    if mesh is not None and names not in ((BATCH_AXIS,),
                                          (BATCH_AXIS, EPOCH_AXIS)):
        raise ValueError("fit_stars_batched takes a 'batch' or a "
                         f"('batch', 'epoch') mesh, not {names}")
    if mesh is not None and mesh.size() > 1:
        irfft_backend = "matmul"

    digest = None
    if checkpoint_path is not None:
        # the flags, the seed of the noise draws and the render change the
        # objective under unchanged data
        flags = (f"{bool(uniform_background_per_epoch)}:"
                 f"{bool(starlet_global_background)}:{float(lr)}:"
                 f"{int(seed)}:{irfft_backend}")
        digest = arrays_digest(
            data, noisemap, psf, np.frombuffer(flags.encode(), np.uint8),
            np.zeros(0, np.float32) if noise_weights is None
            else np.asarray(noise_weights, dtype=np.float32))

    # the draws (or given weights) of each real star, padded and split
    # like its data
    per_star = None
    if starlet_global_background:
        per_star = _noise_draws(n_stars, n_pix, seed).numpy() \
            if noise_weights is None else noise_weights
    n_star_pad = n_epoch_pad = 0
    epochs = group = share = None
    if mesh is not None:
        data, noisemap, psf, n_epoch_pad = pad_epoch_axis(
            data, noisemap, psf, axis_size(mesh, EPOCH_AXIS))
        extra = () if per_star is None else (per_star,)
        (data, noisemap, psf, *extra), n_star_pad = shard_star_fit_arrays(
            mesh, data, noisemap, psf, *extra)
        per_star = extra[0] if extra else None
        if EPOCH_AXIS in names:
            epochs = epoch_range(mesh, data.shape[1])
            group = mesh.get_group(EPOCH_AXIS)
        if checkpoint_path is not None:
            share = CheckpointShare(mesh)
    draws = None if noise_weights is not None or per_star is None \
        else torch.as_tensor(per_star, dtype=torch.float32)
    weights = per_star if noise_weights is not None else None

    n_local = data.shape[0]
    model, free0, lower, upper, consts, scale = _prepare_stars(
        on(data), on(noisemap), on(psf), int(subsampling_factor),
        bool(uniform_background_per_epoch), bool(starlet_global_background),
        irfft_backend, seed, weights, draws=draws, group=group)
    loss_model, loss_consts = (model, consts) if epochs is None \
        else _epoch_share(model, consts, epochs)
    best, _, history = run_adabelief_batched(
        _star_losses(loss_model, loss_consts, n_local, epochs, group),
        free0, lower, upper, int(n_iter), init_learning_rate=float(lr),
        schedule_learning_rate=True, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, inputs_digest=digest,
        checkpoint_share=share)
    with torch.no_grad():
        out = _finalize_stars(model, best, history, consts, scale)
    if mesh is not None:
        out = strip_epoch_axis(
            strip_batch(gather_to_host(mesh, out), n_star_pad), n_epoch_pad)
    if fetch == "device":
        return out
    return kwargs_to_numpy(out)
