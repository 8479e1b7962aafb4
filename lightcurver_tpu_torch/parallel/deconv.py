"""Epoch-sharded joint deconvolution over the ranks of an ``epoch`` mesh.

Twin of ``lightcurver_tpu/parallel/deconv.py``. The joint multi-epoch fit
couples per-epoch parameters (fluxes ``a``, pointing offsets ``dx/dy``,
rotations ``alpha``, pedestals ``mean``) to shared ones (pixelated
background ``h``, source positions ``c_x/c_y``) through a sum of
per-epoch chi2 terms plus terms of the whole tree. The JAX package shards
the per-epoch parameters with the data and lets XLA insert the psum of
the shared gradients. This port does not copy those per-leaf shardings:

- every parameter and all optimizer state are REPLICATED on every rank of
  the epoch group; the optimizers (``torch.optim.LBFGS``, the batched
  L-BFGS and AdaBelief) take inner products over their whole parameter
  vector, which per-epoch shards would turn into distributed dot
  products; replication needs none, and it is small (at ROI-100, h with
  128^2 floats plus 100 x 8 per-epoch values: ~68 KB an all-reduce);
- only the constants are SHARDED along the epoch axis: data, noise
  variance, the per-epoch PSF spectra and the render constants built from
  them, ``epoch_w`` and the fixed-h render (``Loss(epochs=..., group=...)``
  cuts them with :func:`shard_consts` and the model's ``epoch_slice``);
- each loss evaluation: every rank computes the chi2 of its own epochs
  with the per-epoch leaves cut to them (:func:`shard_pytree`); rank 0 of
  the group adds every other term once on the full tree (the starlet l1
  through K1, positivity, the point-source term, flux uniformity over all
  epochs, the priors); one flat ``all_reduce(SUM)`` carries the loss and
  the gradient, so every rank steps identically
  (``core/deconv/loss.py::sum_over_group``).

On a mesh larger than one rank the render is forced to "matmul" (JAX
forces "mxu" there), so every sharded loss evaluation renders the rank's
epochs through K2; JAX also forces its XLA starlet, for want of a
partitioning rule, but the port keeps K1, which computes the same
function. Non-divisible epoch counts are padded with dummy epochs that
``epoch_w`` masks out exactly (:func:`pad_epoch_stacks`), and stripped
from the results. This module makes the 1000-epoch configuration fit by
spreading its render over the ranks' cards.
"""

import numpy as np

from .mesh import EPOCH_AXIS, axis_rank, axis_size

# kwargs leaves with a leading epoch axis ('a' epoch-major flat, epochs x
# sources; per star in the batched star fit, the axis after the star's)
PER_EPOCH_KEYS = frozenset({"a", "dx", "dy", "alpha", "mean"})
_PER_EPOCH_VEC = PER_EPOCH_KEYS - {"a"}
# the epoch-stacked constants a Loss cuts (the model's slice cuts the PSF
# spectra, and renders the fixed background of its epochs only)
_EPOCH_CONST_KEYS = frozenset({"data", "sigma_2", "epoch_w"})


def epoch_range(mesh, n_epochs):
    """``(start, stop)``: this rank's share of ``n_epochs`` (a multiple of
    the mesh's epoch extent) along the ``epoch`` axis. Stands in for JAX's
    ``param_shardings``."""
    n_shards = axis_size(mesh, EPOCH_AXIS)
    if n_epochs % n_shards:
        raise ValueError(f"{n_epochs} epochs do not split over {n_shards} "
                         "ranks: pad them first (pad_epoch_stacks)")
    per = n_epochs // n_shards
    start = axis_rank(mesh, EPOCH_AXIS) * per
    return start, start + per


def shard_pytree(tree, epochs, n_sources):
    """The per-epoch leaves of a kwargs tree cut to ``epochs`` = ``(start,
    stop)``: ``a`` (epoch-major flat) and ``dx/dy/alpha/mean``; the other
    leaves pass through. A rank's share of the tree (JAX's
    ``shard_pytree`` placed it on the mesh instead)."""
    start, stop = epochs
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = shard_pytree(v, epochs, n_sources)
        elif k == "a":
            out[k] = v[start * n_sources:stop * n_sources]
        elif k in _PER_EPOCH_VEC:
            out[k] = v[start:stop]
        else:
            out[k] = v
    return out


def shard_consts(consts, epochs):
    """A Loss constants bundle cut to ``epochs`` = ``(start, stop)``: the
    epoch-stacked arrays (data, noise variance, ``epoch_w``) along axis 0;
    the rest passes through. JAX's ``shard_consts`` placed them on the
    mesh instead."""
    start, stop = epochs
    return {k: v[start:stop] if k in _EPOCH_CONST_KEYS else v
            for k, v in consts.items()}


def pad_epoch_stacks(data, sigma_2, psf, n_devices, var_pad=1e16):
    """Pad (data, sigma_2, psf) epoch stacks to a multiple of n_devices.

    Dummy epochs get zero data, huge noise variance and a copy of the
    last real epoch's PSF (so spectra stay well-conditioned). Returns
    ``(data_p, sigma_2_p, psf_p, epoch_w)`` where ``epoch_w`` is the
    (N_padded,) 1/0 mask that the Loss applies to every per-epoch term:
    dummy epochs contribute exactly zero.
    """
    n = data.shape[0]
    n_pad = (-n) % int(n_devices)
    epoch_w = np.concatenate(
        [np.ones(n, np.float32), np.zeros(n_pad, np.float32)])
    if n_pad == 0:
        return data, sigma_2, psf, epoch_w
    zeros = np.zeros((n_pad,) + data.shape[1:], dtype=np.float32)
    data_p = np.concatenate([np.asarray(data, np.float32), zeros])
    sigma_2_p = np.concatenate(
        [np.asarray(sigma_2, np.float32), np.full_like(zeros, var_pad)])
    psf_p = np.concatenate(
        [np.asarray(psf, np.float32),
         np.repeat(np.asarray(psf, np.float32)[-1:], n_pad, axis=0)])
    return data_p, sigma_2_p, psf_p, epoch_w


def pad_epoch_kwargs(kwargs, n_real, n_pad, n_sources):
    """Extend per-epoch leaves of a kwargs tree by n_pad dummy epochs.

    ``a`` (epoch-major flat, length n_real * n_sources) is padded with
    each source's mean flux so the masked flux-uniformity and positivity
    terms are untouched; ``dx/dy/alpha/mean`` pad with zeros. Leaves of
    other names/shapes pass through unchanged. Numpy in, numpy out.
    """
    if n_pad == 0:
        return kwargs
    out = {}
    for k, v in kwargs.items():
        if isinstance(v, dict):
            out[k] = pad_epoch_kwargs(v, n_real, n_pad, n_sources)
        elif k == "a" and np.size(v) == n_real * n_sources:
            a = np.asarray(v, np.float32).reshape(n_real, n_sources)
            fill = np.broadcast_to(a.mean(axis=0), (n_pad, n_sources))
            out[k] = np.concatenate([a, fill]).ravel()
        elif k in _PER_EPOCH_VEC and np.shape(v) == (n_real,):
            out[k] = np.concatenate(
                [np.asarray(v, np.float32), np.zeros(n_pad, np.float32)])
        else:
            out[k] = v
    return out


def strip_epoch_kwargs(kwargs, n_real, n_pad, n_sources):
    """Inverse of :func:`pad_epoch_kwargs`: drop the dummy epochs."""
    if n_pad == 0:
        return kwargs
    n_all = n_real + n_pad
    out = {}
    for k, v in kwargs.items():
        if isinstance(v, dict):
            out[k] = strip_epoch_kwargs(v, n_real, n_pad, n_sources)
        elif k == "a" and np.size(v) == n_all * n_sources:
            out[k] = np.asarray(v).reshape(n_all, n_sources)[:n_real].ravel()
        elif k in _PER_EPOCH_VEC and np.shape(v) == (n_all,):
            out[k] = np.asarray(v)[:n_real]
        else:
            out[k] = v
    return out


def sharded_deconv_step(loss, params, learning_rate=1e-3):
    """One AdaBelief train step over whatever group the loss sums over.

    Returns ``(step_fn, opt_state0)`` where ``step_fn(free, opt_state,
    lower, upper) -> (free, opt_state, loss_value)``: optax's AdaBelief
    arithmetic at a constant learning rate, then the box projection. The
    JAX step also took the consts bundle; here the Loss holds its rank's
    share. Used by callers that need custom stepping; the production
    path is :func:`fit_deconv_sharded`.
    """
    import torch

    from ..core.optimize import (_adabelief_update, flatten, flatten_like,
                                 unflatten)

    theta0, spec = flatten(params.free0)
    opt_state0 = (torch.zeros_like(theta0), torch.zeros_like(theta0), 0)

    def step(free, opt_state, lower, upper):
        mu, nu, count = opt_state
        theta = flatten(free)[0].detach()
        x = theta.clone().requires_grad_(True)
        value = loss.loss_fn(unflatten(x, spec))
        grad, = torch.autograd.grad(value, x)
        theta, mu, nu = _adabelief_update(
            theta, grad, mu, nu, flatten_like(lower, spec),
            flatten_like(upper, spec), count, 1, learning_rate, False)
        return unflatten(theta, spec), (mu, nu, count + 1), value.detach()

    return step, opt_state0


def fit_deconv_sharded(data, sigma_2, psf, xs, ys, subsampling_factor, mesh,
                       kwargs_fixed=None, n_iter=2000, initial_a=None,
                       init_learning_rate=1e-2, loss_kwargs=None, *,
                       device="cuda"):
    """End-to-end epoch-sharded joint deconvolution fit.

    Args:
        data, sigma_2: (N, n, n) stamps and noise variance.
        psf: (N, mp, mp) per-epoch narrow PSFs.
        xs, ys: (M,) initial source positions (data px, center origin).
        subsampling_factor: int s.
        mesh: a mesh with an ``epoch`` axis
            (:func:`..parallel.mesh.epoch_mesh`); any N works:
            non-divisible epoch counts are padded internally with
            zero-weight dummy epochs (:func:`pad_epoch_stacks`) whose loss
            contribution is exactly masked out, and stripped from the
            returned kwargs.
        kwargs_fixed: fixed-parameter spec (default: the setup_model one).
        n_iter: AdaBelief iterations (the loss history has exactly this
            many entries).
        loss_kwargs: extra keyword args forwarded to the Loss
            (regularization strengths, W, prior, irfft_backend, ...).
        device: this rank's device: the card unless ``"cpu"``.

    Returns:
        (kwargs_best, model, loss_history): kwargs (numpy, on every rank)
        and model are sized for the REAL epoch count.
    """
    import torch

    from ..core.deconv.loss import Loss
    from ..core.deconv.model import DeconvModel, setup_model
    from ..core.optimize import run_adabelief
    from ..core.params import Params, kwargs_from_numpy, kwargs_to_numpy
    from ..ops import enforce_fp32

    enforce_fp32()
    n_real = data.shape[0]
    n_sources = np.atleast_1d(np.asarray(xs)).size
    n_shards = axis_size(mesh, EPOCH_AXIS)
    data_p, sigma_2_p, psf_p, epoch_w = pad_epoch_stacks(
        np.asarray(data, np.float32), np.asarray(sigma_2, np.float32),
        np.asarray(psf, np.float32), n_shards)
    n_pad = data_p.shape[0] - n_real
    if initial_a is not None and n_pad:
        initial_a = np.asarray(initial_a, np.float32).ravel()
        if initial_a.size == n_real * n_sources:
            initial_a = pad_epoch_kwargs({"a": initial_a}, n_real, n_pad,
                                         n_sources)["a"]
    if kwargs_fixed is not None and n_pad:
        kwargs_fixed = kwargs_from_numpy(pad_epoch_kwargs(
            kwargs_to_numpy(kwargs_fixed), n_real, n_pad, n_sources),
            device)
    model_p, kwargs_init, kwargs_up, kwargs_down, default_fixed = setup_model(
        data_p, sigma_2_p, psf_p, xs, ys, subsampling_factor,
        initial_a=initial_a, device=device)
    params = Params(kwargs_init,
                    kwargs_fixed if kwargs_fixed is not None else default_fixed,
                    kwargs_up, kwargs_down)

    loss_kwargs = dict(loss_kwargs or {})
    if mesh.size() > 1:
        loss_kwargs.setdefault("irfft_backend", "matmul")
    loss = Loss(data_p, model_p, params, sigma_2_p, epoch_weights=epoch_w,
                epochs=epoch_range(mesh, data_p.shape[0]),
                group=mesh.get_group(EPOCH_AXIS), **loss_kwargs)
    best, _, history = run_adabelief(
        loss.loss_fn, params.free0, params.lower, params.upper, n_iter,
        init_learning_rate=init_learning_rate)
    params.set_best(best)
    kwargs_best = strip_epoch_kwargs(
        kwargs_to_numpy(params.best_fit_values(as_kwargs=True)),
        n_real, n_pad, n_sources)
    model = model_p
    if n_pad:
        model = DeconvModel(
            torch.as_tensor(np.asarray(psf, np.float32),
                            device=model_p.device),
            subsampling_factor, data.shape[-1], n_real, n_sources)
    return kwargs_best, model, np.asarray(history)
