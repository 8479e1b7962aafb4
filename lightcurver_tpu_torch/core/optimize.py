"""Fixed-iteration optimizers with box projection and best-loss tracking.

Twin of the plain path of ``lightcurver_tpu/core/optimize.py``:

- AdaBelief with optax's exact semantics (b1 0.9, b2 0.999, eps 1e-16,
  eps_root 1e-16 added to the second moment every step, bias correction)
  and optionally ``exponential_decay(lr, n_iter, 0.01)``;
- projected L-BFGS with memory 10: ``torch.optim.LBFGS`` with a
  strong-Wolfe line search, one iteration per step, then a projection onto
  the box. Its path differs from optax's zoom line search; it is held to
  the final loss.

Both run EXACTLY n_iter iterations and return exactly n_iter history
entries, each the loss BEFORE that iteration's update; the best parameters
are those of the lowest recorded loss. The free tree is flattened into one
float32 vector, so each optimizer step is a handful of kernels whatever
the number of leaves; a Python loop takes the place of ``lax.scan``.
AdaBelief is one loop, :func:`run_adabelief_extended` (JAX's
``adabelief_scan_extended``); ``Optimizer.minimize``'s
``stop_at_loss_increase`` and ``return_param_history`` switch on its two
optional steps, which freeze the parameters and the moments once the loss
rises after ``min_iterations``, and keep a ring of parameter snapshots.

Mid-fit checkpoints (JAX's ``run_adabelief_checkpointed``): AdaBelief runs
in segments of ``checkpoint_every`` iterations, and after each the carry
(the flat ``theta``, ``mu``, ``nu``, ``best``, ``best_loss``), the number
of iterations done and the history so far are written to one ``.npz``
(leaves only, read back with ``allow_pickle=False``). A later call with
the same path resumes after the last completed segment, from the global
iteration index, so the learning-rate schedule spans the full run and a
resumed fit takes the uninterrupted fit's steps. A file recorded for
another budget, other inputs or another carry, or one that cannot be
read, is refused with :class:`CheckpointMismatch`. The files are the
port's own; they need not read the JAX package's. Under a mesh
(``checkpoint_share``, ``parallel/batch.CheckpointShare``) the ranks share
one file: global rank 0 writes the carry gathered along the batch axis,
reads it, decides whether to resume and broadcasts its decision and its
carry (the ranks never split, and need no shared disk), and a barrier
before the read and after each write keeps a rank's resume or deletion
from racing another's write.

Frame-batched twins (the JAX package's ``adabelief_scan`` and
``lbfgsb_scan`` under ``jax.vmap``): :func:`run_adabelief_batched` and
:func:`run_lbfgsb_batched` optimize F independent problems at once. The
free tree's leaves carry a leading frame axis, the loss returns the (F,)
vector of per-frame losses, and the gradient of its sum is the per-frame
gradient. Every decision (best loss, line-search acceptance) is a
per-frame mask, so a NaN in one frame changes no other frame, and no
iteration reads a value back to the host (no ``.item()``, no branch on
data), so a CUDA graph can later capture it.
"""

import hashlib
import os
import time

import numpy as np
import torch

from .params import kwargs_to_numpy

UNCONVERGED_RLD_THRESHOLD = 0.02

# optax.adabelief defaults, as the JAX package uses them
B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-16, 1e-16
LBFGS_MEMORY = 10
# evaluations per L-BFGS step, line search included; torch's default for
# max_iter=1 (5/4 of it, i.e. 1) would leave the line search none
LBFGS_MAX_EVAL = 21


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def flatten(tree):
    """(vector, spec) of a tree of tensors, in the tree's key order."""
    spec, parts = [], []
    for path, v in _leaves(tree):
        spec.append((path, tuple(v.shape)))
        parts.append(v.reshape(-1))
    return torch.cat(parts), spec


def flatten_like(tree, spec):
    """Flatten ``tree`` in the order of ``spec`` (e.g. a bounds tree)."""
    parts = []
    for path, _ in spec:
        node = tree
        for k in path:
            node = node[k]
        parts.append(node.reshape(-1))
    return torch.cat(parts)


def unflatten(vec, spec):
    """Nested dict of views into ``vec``, following ``spec``."""
    out, offset = {}, 0
    for path, shape in spec:
        n = int(np.prod(shape, dtype=np.int64))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = vec[offset:offset + n].reshape(shape)
        offset += n
    return out


def _adabelief_update(theta, grad, mu, nu, lo, hi, it, n_iter,
                      init_learning_rate, schedule_learning_rate):
    """One projected AdaBelief step (optax's arithmetic): returns the new
    (theta, mu, nu). Elementwise, so it serves any leading frame axis."""
    mu = (1 - B1) * grad + B1 * mu
    pred_err = grad - mu
    nu = (1 - B2) * pred_err**2 + B2 * nu + EPS_ROOT
    count = it + 1
    mu_hat = mu / np.float32(1 - B1**count)
    nu_hat = nu / np.float32(1 - B2**count)
    lr = init_learning_rate * 0.01 ** (it / max(n_iter, 1)) \
        if schedule_learning_rate else init_learning_rate
    step = np.float32(-lr) * (mu_hat / (torch.sqrt(nu_hat) + EPS))
    return torch.clamp(theta + step, lo, hi), mu, nu


def _adabelief_carry(theta, n_frames=None):
    """A fresh carry (theta, mu, nu, best, best_loss) from the flat start
    ``theta``; ``best_loss`` is one value, or one per frame."""
    shape = () if n_frames is None else (n_frames,)
    return (theta, torch.zeros_like(theta), torch.zeros_like(theta),
            theta.clone(),
            torch.full(shape, float("inf"), device=theta.device))


def _evaluate(loss_fn, spec, theta, best, best_loss):
    """Loss and gradient at the flat ``theta``, with the best-loss
    tracking of that (pre-update) point: ``(theta, value, grad, best,
    best_loss)``, all detached."""
    x = theta.requires_grad_(True)
    value = loss_fn(unflatten(x, spec))
    grad, = torch.autograd.grad(value, x)
    theta, value = theta.detach(), value.detach()
    improved = value < best_loss
    return (theta, value, grad, torch.where(improved, theta, best),
            torch.where(improved, value, best_loss))


def run_adabelief(loss_fn, free0, lower, upper, n_iter,
                  init_learning_rate=1e-3, schedule_learning_rate=True):
    """Projected AdaBelief.

    Returns:
        (best_free, final_free, loss_history) with loss_history a numpy
        array of n_iter float32 values.
    """
    return run_adabelief_checkpointed(
        loss_fn, free0, lower, upper, n_iter, None,
        init_learning_rate=init_learning_rate,
        schedule_learning_rate=schedule_learning_rate)


def run_adabelief_checkpointed(loss_fn, free0, lower, upper, n_iter,
                               checkpoint_path, init_learning_rate=1e-3,
                               schedule_learning_rate=True,
                               checkpoint_every=500, inputs_digest=None,
                               checkpoint_share=None):
    """Projected AdaBelief in resumable segments with on-disk checkpoints.

    With ``checkpoint_path`` None it is one segment and writes nothing.
    Otherwise a checkpoint is written after every ``checkpoint_every``
    iterations, and a call that finds one resumes from it (see the module
    docstring); ``inputs_digest`` (:func:`arrays_digest` of the fit's
    inputs) is stored with it and must match on resume;
    ``checkpoint_share`` shares the file between the ranks of a mesh (see
    the module docstring).

    Returns:
        (best_free, final_free, loss_history[n_iter]) as
        :func:`run_adabelief`.
    """
    return run_adabelief_extended(
        loss_fn, free0, lower, upper, n_iter, init_learning_rate,
        schedule_learning_rate, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, inputs_digest=inputs_digest,
        checkpoint_share=checkpoint_share)[:3]


def run_adabelief_extended(loss_fn, free0, lower, upper, n_iter,
                           init_learning_rate=1e-3,
                           schedule_learning_rate=True,
                           stop_at_loss_increase=False, min_iterations=0,
                           n_param_snapshots=0, checkpoint_path=None,
                           checkpoint_every=500, inputs_digest=None,
                           checkpoint_share=None):
    """The one projected AdaBelief loop, with the reference's optional
    semantics (JAX's ``adabelief_scan_extended``) as steps that run only
    when asked for, so without them it is the plain loop.

    - ``stop_at_loss_increase``: at the first iteration ``it >=
      min_iterations`` whose loss exceeds the previous iteration's, the
      parameters and both moments freeze (that iteration's update is
      discarded), and ``stopped_at`` records ``it`` (``n_iter`` if the
      loss never rose). The history keeps exactly ``n_iter`` entries: the
      tail after the stop is the frozen point's loss.
    - ``n_param_snapshots`` > 0: the parameters after iteration ``it``'s
      update are kept every ``n_iter // n_param_snapshots`` iterations in
      a ring of ``min(n_param_snapshots, n_iter)`` slots, slot
      ``min(it // every, slots - 1)``: when ``n_iter`` is not a multiple,
      later snapshots overwrite the last slot, as in JAX.
    - ``checkpoint_path`` and the keywords after it checkpoint the fit as
      :func:`run_adabelief_checkpointed` says; the two options keep their
      state outside the checkpointed carry, so with a path they raise
      ``ValueError``, as JAX's ``Optimizer.minimize`` does.

    Best-loss tracking is :func:`run_adabelief`'s, and nothing is read
    back to the host inside the loop.

    Returns:
        (best_free, final_free, loss_history[n_iter], stopped_at,
        snapshots, snapshot_iterations): ``stopped_at`` an int;
        ``snapshots`` the free tree with a leading slot axis and
        ``snapshot_iterations`` an int array, or both None without
        snapshots.
    """
    if checkpoint_path is not None and (stop_at_loss_increase
                                        or n_param_snapshots):
        raise ValueError(
            "checkpoint_path cannot be combined with "
            "stop_at_loss_increase / return_param_history (the "
            "extended optimizer path has no checkpointing)")
    n_iter = int(n_iter)
    theta, spec = flatten(free0)
    theta = theta.detach().clone()
    lo, hi = flatten_like(lower, spec), flatten_like(upper, spec)
    history = torch.empty(n_iter, device=theta.device)
    n_snap = min(int(n_param_snapshots), n_iter)
    every = max(1, n_iter // max(int(n_param_snapshots), 1))
    ring = theta.new_zeros(n_snap, theta.numel())
    ring_it = np.zeros(n_snap, dtype=np.int32)
    prev_loss = torch.full((), float("inf"), device=theta.device)
    stopped = torch.zeros((), dtype=torch.bool, device=theta.device)
    stopped_at = torch.full((), n_iter, dtype=torch.int64,
                            device=theta.device)

    def steps(carry, iterations):
        nonlocal prev_loss, stopped, stopped_at
        theta, mu, nu, best, best_loss = carry
        for it in iterations:
            theta, value, grad, best, best_loss = _evaluate(
                loss_fn, spec, theta, best, best_loss)
            history[it] = value
            new = _adabelief_update(
                theta, grad, mu, nu, lo, hi, it, n_iter, init_learning_rate,
                schedule_learning_rate)
            if stop_at_loss_increase:
                if it >= min_iterations:
                    rose = value > prev_loss
                    stopped_at = torch.where(
                        rose & ~stopped, torch.full_like(stopped_at, it),
                        stopped_at)
                    stopped = stopped | rose
                prev_loss = value
                new = tuple(torch.where(stopped, old, upd)
                            for old, upd in zip((theta, mu, nu), new))
            theta, mu, nu = new
            if n_snap and it % every == 0:
                slot = min(it // every, n_snap - 1)
                ring[slot] = theta
                ring_it[slot] = it
        return theta, mu, nu, best, best_loss

    theta, _, _, best, _ = run_segments(
        steps, _adabelief_carry(theta), history, n_iter, checkpoint_path,
        checkpoint_every, inputs_digest, checkpoint_share)
    snapshots = snapshot_iterations = None
    if n_snap:
        snapshots = _free_from(ring, spec, free0, batched=True)
        snapshot_iterations = ring_it
    return (_free_from(best, spec, free0), _free_from(theta, spec, free0),
            history.cpu().numpy(), int(stopped_at), snapshots,
            snapshot_iterations)


def run_lbfgsb(loss_fn, free0, lower, upper, n_iter):
    """Projected L-BFGS (strong-Wolfe line search), projection per step.

    Returns:
        (best_free, final_free, loss_history[n_iter]).
    """
    theta, spec = flatten(free0)
    theta = theta.detach().clone().requires_grad_(True)
    lo, hi = flatten_like(lower, spec), flatten_like(upper, spec)
    opt = torch.optim.LBFGS([theta], lr=1.0, max_iter=1,
                            max_eval=LBFGS_MAX_EVAL,
                            history_size=LBFGS_MEMORY,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        value = loss_fn(unflatten(theta, spec))
        value.backward()
        return value

    best = theta.detach().clone()
    best_loss = torch.tensor(float("inf"), device=theta.device)
    history = torch.empty(n_iter, device=theta.device)
    for it in range(n_iter):
        before = theta.detach().clone()
        value = opt.step(closure).detach()
        history[it] = value
        improved = value < best_loss
        best_loss = torch.where(improved, value, best_loss)
        best = torch.where(improved, before, best)
        with torch.no_grad():
            theta.copy_(torch.clamp(theta, lo, hi))
    return (_free_from(best, spec, free0),
            _free_from(theta.detach(), spec, free0),
            history.cpu().numpy())


def flatten_batched(tree):
    """(vector (F, P), spec) of a tree whose leaves have a leading frame
    axis F; the spec holds the per-frame shapes, so :func:`flatten_like`
    turns per-frame bound trees into (P,) vectors."""
    spec, parts = [], []
    for path, v in _leaves(tree):
        spec.append((path, tuple(v.shape[1:])))
        parts.append(v.reshape(v.shape[0], -1))
    return torch.cat(parts, dim=1), spec


def unflatten_batched(vec, spec):
    """Nested dict of views into ``vec`` (F, P), each leaf (F, *shape)."""
    out, offset = {}, 0
    for path, shape in spec:
        n = int(np.prod(shape, dtype=np.int64))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = vec[:, offset:offset + n].reshape(-1, *shape)
        offset += n
    return out


def _value_and_grad_batched(loss_fn, spec):
    def value_and_grad(vec):
        x = vec.detach().requires_grad_(True)
        value = loss_fn(unflatten_batched(x, spec))
        grad, = torch.autograd.grad(value.sum(), x)
        return value.detach(), grad
    return value_and_grad


def run_adabelief_batched(loss_fn, free0, lower, upper, n_iter,
                          init_learning_rate=1e-3,
                          schedule_learning_rate=True, checkpoint_path=None,
                          checkpoint_every=500, inputs_digest=None,
                          checkpoint_share=None):
    """Projected AdaBelief over F independent problems.

    ``free0``: tree of (F, ...) tensors; ``lower``/``upper``: trees of the
    per-frame shapes (broadcast over frames); ``loss_fn(tree) -> (F,)``.
    The learning-rate schedule is shared; each frame keeps its moments
    and its best loss. ``checkpoint_path``, ``checkpoint_every`` and
    ``inputs_digest`` checkpoint the per-frame carry as
    :func:`run_adabelief_checkpointed` does (JAX's batched star fit,
    ``_fit_stars_checkpointed``); with no path nothing is written;
    ``checkpoint_share`` shares the file between the ranks of a mesh.

    Returns:
        (best_free, final_free, loss_history) with the history an (F,
        n_iter) tensor on the device of the parameters.
    """
    n_iter = int(n_iter)
    theta, spec = flatten_batched(free0)
    theta = theta.detach().clone()
    lo, hi = flatten_like(lower, spec), flatten_like(upper, spec)
    value_and_grad = _value_and_grad_batched(loss_fn, spec)
    history = torch.empty(theta.shape[0], n_iter, device=theta.device)

    def steps(carry, iterations):
        theta, mu, nu, best, best_loss = carry
        for it in iterations:
            value, grad = value_and_grad(theta)
            history[:, it] = value
            improved = value < best_loss
            best_loss = torch.where(improved, value, best_loss)
            best = torch.where(improved[:, None], theta, best)
            theta, mu, nu = _adabelief_update(
                theta, grad, mu, nu, lo, hi, it, n_iter, init_learning_rate,
                schedule_learning_rate)
        return theta, mu, nu, best, best_loss

    theta, _, _, best, _ = run_segments(
        steps, _adabelief_carry(theta, theta.shape[0]), history, n_iter,
        checkpoint_path, checkpoint_every, inputs_digest, checkpoint_share)
    return (unflatten_batched(best, spec), unflatten_batched(theta, spec),
            history)


# optax.scale_by_zoom_linesearch defaults, as lbfgsb_scan builds it
LS_SLOPE_RTOL, LS_CURV_RTOL, LS_APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
LS_INCREASE_FACTOR, LS_INTERVAL_THRESHOLD = 2.0, 1e-5
LBFGS_LINESEARCH_STEPS = 6


def _decrease_error(t, value, slope, value0, slope0):
    """Sufficient decrease (Armijo) or Hager-Zhang's approximate form,
    whichever holds better; NaN counts as infinite."""
    err = value - value0 - LS_SLOPE_RTOL * t * slope0
    approx = torch.maximum(
        slope - (2 * LS_SLOPE_RTOL - 1.0) * slope0,
        value - value0 - LS_APPROX_DEC_RTOL * value0.abs())
    err = torch.clamp(torch.minimum(approx, err), min=0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, float("inf")),
                       err)


def _curvature_error(slope, slope0):
    err = torch.clamp(slope.abs() - LS_CURV_RTOL * slope0.abs(), min=0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, float("inf")),
                       err)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN where there is none)."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    rb, rc = fb - fa - fpa * db, fc - fa - fpa * dc
    A = (dc**2 * rb - db**2 * rc) / denom
    B = (-(dc**3) * rb + db**3 * rc) / denom
    return a + (-B + torch.sqrt(B * B - 3.0 * A * fpa)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / db**2
    return a - fpa / (2.0 * B)


def _zoom_linesearch(value_and_grad, x, value0, grad0, d, max_steps):
    """optax's zoom line search (Nocedal and Wright, algorithms 3.5 and
    3.6), one search per frame, run for exactly ``max_steps`` trial
    evaluations of all frames at once. A frame that is done or has failed
    is frozen by masks (its later trials re-evaluate its last step and
    are discarded). A failed frame takes its best step of sufficient
    decrease, or stays where it is if every trial was outside the
    domain, or else takes its last trial, as optax does.

    Returns (stepsize (F,), value (F,), grad (F, P)) at the accepted step.
    """
    slope0 = (grad0 * d).sum(-1)
    zero = torch.zeros_like(value0)
    t, val, grad, slope = zero, value0, grad0, slope0
    low, f_low, s_low = zero, value0, slope0
    high, f_high, s_high = zero, value0, slope0
    ref, f_ref = zero, value0
    safe_t, safe_f, safe_g = zero, value0, grad0
    dec = torch.full_like(value0, float("inf"))
    found = torch.zeros_like(value0, dtype=torch.bool)
    stop = torch.zeros_like(found)       # done or failed
    failed = torch.zeros_like(found)
    for i in range(max_steps):
        # zoom: a cubic, else quadratic, else bisection step in [low, high]
        delta = (high - low).abs()
        left, right = torch.minimum(low, high), torch.maximum(low, high)
        cubic = _cubicmin(low, f_low, s_low, high, f_high, ref, f_ref)
        use_cubic = (cubic > left + 0.2 * delta) & (cubic < right
                                                    - 0.2 * delta)
        quad = _quadmin(low, f_low, s_low, high, f_high)
        use_quad = ~use_cubic & (quad > left + 0.1 * delta) \
            & (quad < right - 0.1 * delta)
        middle = torch.where(use_cubic, cubic, ref)
        middle = torch.where(use_quad, quad, middle)
        middle = torch.where(~use_cubic & ~use_quad, (low + high) / 2.0,
                             middle)
        search = torch.full_like(t, 1.0) if i == 0 \
            else LS_INCREASE_FACTOR * t
        new_t = torch.where(stop, t, torch.where(found, middle, search))

        new_val, new_grad = value_and_grad(x + new_t[:, None] * d)
        new_slope = (new_grad * d).sum(-1)
        new_dec = _decrease_error(new_t, new_val, new_slope, value0, slope0)
        err = torch.maximum(new_dec, _curvature_error(new_slope, slope0))
        done = err <= 0.0
        last = i + 1 >= max_steps

        # interval search (algorithm 3.5)
        s_high_new = (new_dec > 0.0) | ((new_val >= val) & (i > 0))
        s_low_new = (new_slope >= 0.0) & ~s_high_new
        s_found = s_high_new | s_low_new | done
        s_failed = torch.full_like(done, last) & ~done
        s_safe = new_dec <= 0.0
        s_lh = [torch.where(s_low_new, a, b) for a, b in zip(
            (new_t, new_val, new_slope, t, val, slope),
            (t, val, slope, new_t, new_val, new_slope))]

        # zoom (algorithm 3.6)
        z_safe = (new_dec <= 0.0) & (new_val < safe_f)
        z_high_mid = (new_dec > 0.0) | (new_val >= f_low)
        z_high_low = (new_slope * (high - low) >= 0.0) & ~z_high_mid
        z_high = [torch.where(z_high_low, lo_, torch.where(z_high_mid, mid,
                                                            hi_))
                  for lo_, mid, hi_ in zip((low, f_low, s_low),
                                           (new_t, new_val, new_slope),
                                           (high, f_high, s_high))]
        z_low = [torch.where(z_high_mid, lo_, mid)
                 for lo_, mid in zip((low, f_low, s_low),
                                     (new_t, new_val, new_slope))]
        z_moved = z_high_mid | z_high_low
        z_ref = (torch.where(z_moved, high, low),
                 torch.where(z_moved, f_high, f_low))
        z_safe_t = torch.where(z_safe, new_t, safe_t)
        z_failed = (torch.full_like(done, last)
                    | ((delta <= LS_INTERVAL_THRESHOLD) & (z_safe_t > 0.0))
                    ) & ~done

        take_safe = torch.where(found, z_safe, s_safe) & ~stop
        safe_t = torch.where(take_safe, new_t, safe_t)
        safe_f = torch.where(take_safe, new_val, safe_f)
        safe_g = torch.where(take_safe[:, None], new_grad, safe_g)
        nxt_low = [torch.where(found, z, s) for z, s in zip(z_low, s_lh[:3])]
        nxt_high = [torch.where(found, z, s)
                    for z, s in zip(z_high, s_lh[3:])]
        nxt_ref = (torch.where(found, z_ref[0], nxt_low[0]),
                   torch.where(found, z_ref[1], nxt_low[1]))
        live = ~stop
        low, f_low, s_low = (torch.where(live, n, o) for n, o in zip(
            nxt_low, (low, f_low, s_low)))
        high, f_high, s_high = (torch.where(live, n, o) for n, o in zip(
            nxt_high, (high, f_high, s_high)))
        ref, f_ref = (torch.where(live, n, o)
                      for n, o in zip(nxt_ref, (ref, f_ref)))
        t = torch.where(live, new_t, t)
        val = torch.where(live, new_val, val)
        slope = torch.where(live, new_slope, slope)
        grad = torch.where(live[:, None], new_grad, grad)
        dec = torch.where(live, new_dec, dec)
        now_failed = torch.where(found, z_failed, s_failed) & live
        failed = failed | now_failed
        stop = stop | (done & live) | now_failed
        found = found | (s_found & live)
    use_safe = failed & ((safe_t > 0.0) | torch.isinf(dec))
    return (torch.where(use_safe, safe_t, t),
            torch.where(use_safe, safe_f, val),
            torch.where(use_safe[:, None], safe_g, grad))


def run_lbfgsb_batched(loss_fn, free0, lower, upper, n_iter):
    """Projected L-BFGS over F independent problems, as ``lbfgsb_scan``
    behaves under ``jax.vmap`` with ``exact_bounds=False``.

    Per frame: ``optax.scale_by_lbfgs`` (memory :data:`LBFGS_MEMORY`, the
    initial inverse Hessian scaled by the last pair's curvature, or by the
    capped inverse gradient norm at the first step), optax's zoom line
    search from a unit step (:func:`_zoom_linesearch`, at most
    :data:`LBFGS_LINESEARCH_STEPS` trials, JAX's ``max_linesearch_steps``),
    then a projection onto the box. As with ``exact_bounds=False``, the value and gradient
    carried into the next iteration are the line search's, at the
    unprojected step. Arguments and returns as
    :func:`run_adabelief_batched`. Each iteration costs
    :data:`LBFGS_LINESEARCH_STEPS` evaluations of all frames (one more at
    the start).
    """
    x, spec = flatten_batched(free0)
    x = x.detach().clone()
    lo, hi = flatten_like(lower, spec), flatten_like(upper, spec)
    value_and_grad = _value_and_grad_batched(loss_fn, spec)
    n_frames = x.shape[0]
    memory_size = LBFGS_MEMORY
    dparams = x.new_zeros(n_frames, memory_size, x.shape[1])
    dgrads = torch.zeros_like(dparams)
    rhos = x.new_zeros(n_frames, memory_size)
    best = x.clone()
    best_loss = torch.full((n_frames,), float("inf"), device=x.device)
    history = torch.empty(n_frames, n_iter, device=x.device)
    value, grad = value_and_grad(x)
    prev_x = prev_g = None
    for it in range(n_iter):
        history[:, it] = value
        improved = value < best_loss
        best_loss = torch.where(improved, value, best_loss)
        best = torch.where(improved[:, None], x, best)
        if prev_x is None:
            gamma = torch.clamp(1.0 / grad.norm(dim=-1), max=1.0)
        else:
            dp, dg = x - prev_x, grad - prev_g
            curv = (dg * dp).sum(-1)
            slot = (it - 1) % memory_size
            dparams[:, slot] = dp
            dgrads[:, slot] = dg
            rhos[:, slot] = torch.where(curv == 0.0, torch.zeros_like(curv),
                                        1.0 / curv)
            norm2 = (dg * dg).sum(-1)
            gamma = torch.where(norm2 > 0.0, curv / norm2,
                                torch.ones_like(curv))
        # two-loop recursion, oldest slot first (optax's memory order)
        order = [(it + j) % memory_size for j in range(memory_size)]
        q, alphas = grad, {}
        for k in reversed(order):
            alphas[k] = rhos[:, k] * (dparams[:, k] * q).sum(-1)
            q = q - alphas[k][:, None] * dgrads[:, k]
        q = gamma[:, None] * q
        for k in order:
            beta = rhos[:, k] * (dgrads[:, k] * q).sum(-1)
            q = q + (alphas[k] - beta)[:, None] * dparams[:, k]
        prev_x, prev_g = x, grad
        step, value, grad = _zoom_linesearch(
            value_and_grad, x, value, grad, -q, LBFGS_LINESEARCH_STEPS)
        x = torch.clamp(x - step[:, None] * q, lo, hi)
    return (unflatten_batched(best, spec), unflatten_batched(x, spec),
            history)


def arrays_digest(*arrays):
    """sha256 over the shapes, dtypes and bytes of host arrays: the
    identity of a fit's inputs, stored with its checkpoints so that a
    resume against changed data is refused."""
    h = hashlib.sha256()
    for arr in arrays:
        arr = np.ascontiguousarray(arr)
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


class CheckpointMismatch(ValueError):
    """A mid-fit checkpoint cannot be resumed against the current fit
    (changed inputs, budget or carry structure, or an unreadable file).
    The pipeline tasks catch this type
    (``utilities/checkpoints.run_discarding_stale_checkpoint``) to discard
    the file and start again. ``share``: the ranks' ``CheckpointShare``
    when a sharded fit refused (on every rank at once), else None."""

    share = None


def _check_ckpt_digest(path, stored, expected):
    if expected is None:
        return
    stored = None if stored is None else str(stored)
    if stored != expected:
        raise CheckpointMismatch(
            f"checkpoint {path} was recorded for different input data "
            f"(digest {stored} != {expected}); the upstream products "
            "changed since the interrupted fit: delete the checkpoint to "
            "restart from scratch")


def _load_ckpt_carry(z, fresh, path):
    """The stored carry, checked against the fresh one leaf by leaf
    (count both ways, shapes), as tensors of the fresh carry's dtype on
    its device."""
    n_leaves = len(fresh)
    if any(f"leaf_{i}" not in z for i in range(n_leaves)):
        raise CheckpointMismatch(
            f"checkpoint {path} has fewer carry leaves than this problem "
            "(parameter structure changed); refusing to resume: delete "
            "the checkpoint to restart")
    if f"leaf_{n_leaves}" in z:
        raise CheckpointMismatch(
            f"checkpoint {path} has more carry leaves than this problem "
            "(parameter structure changed); refusing to resume: delete "
            "the checkpoint to restart")
    carry = []
    for i, leaf in enumerate(fresh):
        stored = z[f"leaf_{i}"]
        if tuple(stored.shape) != tuple(leaf.shape):
            raise CheckpointMismatch(
                f"checkpoint {path} leaf {i} has shape "
                f"{tuple(stored.shape)}, expected {tuple(leaf.shape)} "
                "(free-parameter set or epoch padding changed); refusing "
                "to resume: delete the checkpoint to restart")
        carry.append(torch.as_tensor(np.array(stored), dtype=leaf.dtype,
                                     device=leaf.device))
    return tuple(carry)


def load_checkpoint(path, fresh, n_iter, inputs_digest):
    """(carry, done, history) of the checkpoint at ``path``, checked
    against the fresh carry, the budget and the inputs' digest; any
    refusal, an unreadable file included, is :class:`CheckpointMismatch`."""
    try:
        with np.load(path, allow_pickle=False) as z:
            stored_n_iter = int(z["n_iter"])
            if stored_n_iter != n_iter:
                raise CheckpointMismatch(
                    f"checkpoint {path} was recorded for n_iter="
                    f"{stored_n_iter}, requested {n_iter}; refusing to "
                    "resume (the lr schedule would not match): delete the "
                    "checkpoint to restart")
            _check_ckpt_digest(
                path, z["inputs_digest"] if "inputs_digest" in z else None,
                inputs_digest)
            return (_load_ckpt_carry(z, fresh, path), int(z["done"]),
                    np.array(z["history"]))
    except CheckpointMismatch:
        raise
    except Exception as e:  # noqa: BLE001 -- a truncated or foreign file
        raise CheckpointMismatch(
            f"checkpoint {path} is unreadable ({type(e).__name__}: {e}); "
            "delete it to restart") from e


def save_checkpoint(path, carry, n_iter, done, history, inputs_digest=None):
    """Write a mid-fit checkpoint: the carry's leaves, ``n_iter``,
    ``done``, the history so far and the digest, as one ``.npz``
    replaced atomically. The one writer of the single and the batched
    fits."""
    payload = {f"leaf_{i}": leaf.detach().cpu().numpy()
               for i, leaf in enumerate(carry)}
    payload["n_iter"] = np.int64(n_iter)
    payload["done"] = np.int64(done)
    payload["history"] = history.detach().cpu().numpy()
    if inputs_digest is not None:
        payload["inputs_digest"] = np.str_(inputs_digest)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def _resume(path, carry, history, n_iter, inputs_digest, share):
    """``(carry, done, history)`` of the checkpoint at ``path``, or None
    without one. Under a ``share`` global rank 0 alone looks at the file
    and decides, after a barrier; the other ranks take its decision, its
    carry and its history from a broadcast and keep their share. A
    refusal raises :class:`CheckpointMismatch` on every rank, with the
    share as its ``share`` (``utilities/checkpoints``: rank 0 alone then
    deletes the file)."""
    if share is None:
        if not os.path.exists(path):
            return None
        stored_carry, done, stored = load_checkpoint(path, carry, n_iter,
                                                     inputs_digest)
        return stored_carry, done, torch.from_numpy(np.array(stored))
    share.barrier()
    full = tuple(share.full(x) for x in carry)
    full_history = share.full(history).clone()
    status, done, refusal = 0, 0, None  # status 0 no file, 1 resume, 2 refused
    if share.is_writer and os.path.exists(path):
        try:
            full, done, stored = load_checkpoint(path, full, n_iter,
                                                 inputs_digest)
            full_history[..., :done] = torch.from_numpy(
                np.array(stored[..., :done]))
            status = 1
        except CheckpointMismatch as e:
            status, refusal = 2, e
    status, done = share.broadcast(torch.tensor([status, done])).tolist()
    if status == 2:
        refusal = refusal or CheckpointMismatch(
            f"checkpoint {path} refused on rank 0; delete it to restart")
        refusal.share = share
        raise refusal
    if status == 0:
        return None
    return (tuple(share.local(share.broadcast(x)).to(c.device)
                  for x, c in zip(full, carry)), done,
            share.local(share.broadcast(full_history)))


def run_segments(steps, carry, history, n_iter, checkpoint_path,
                 checkpoint_every, inputs_digest, share=None):
    """Drive ``steps(carry, iterations) -> carry`` over ``range(n_iter)``:
    in one segment without a path; else resume from the checkpoint at
    ``checkpoint_path`` if there is one (its history goes to
    ``history[..., :done]``) and write one after every
    ``checkpoint_every`` iterations. ``share`` (a
    ``parallel.batch.CheckpointShare``) shares the file between ranks."""
    if checkpoint_path is None:
        return steps(carry, range(n_iter))
    every = int(checkpoint_every)
    if every <= 0:
        raise ValueError(
            f"checkpoint_every must be positive, got {checkpoint_every} "
            "(a non-positive segment length would loop forever)")

    def whole(x):
        return x if share is None else share.full(x)

    done = 0
    resumed = _resume(checkpoint_path, carry, history, n_iter, inputs_digest,
                      share)
    if resumed is not None:
        carry, done, stored = resumed
        history[..., :done] = stored[..., :done]
    while done < n_iter:
        stop = min(done + every, n_iter)
        carry = steps(carry, range(done, stop))
        done = stop
        written = tuple(whole(x) for x in carry)
        written_history = whole(history[..., :done])
        if share is None or share.is_writer:
            save_checkpoint(checkpoint_path, written, n_iter, done,
                            written_history, inputs_digest=inputs_digest)
        if share is not None:
            share.barrier()
    return carry


def _free_from(vec, spec, free0, batched=False):
    # top-level keys with no free leaves (kwargs_sersic) are kept as {};
    # ``batched``: ``vec`` holds one flat tree a row (the snapshot ring)
    out = (unflatten_batched if batched else unflatten)(
        vec.detach().clone(), spec)
    for k, v in free0.items():
        if isinstance(v, dict) and k not in out:
            out[k] = {}
    return out


LBFGS_METHODS = ("l-bfgs-b", "lbfgsb", "l-bfgs")
N_PARAM_SNAPSHOTS = 64


class Optimizer:
    """A Loss, a Params and a method: 'adabelief', or L-BFGS under any of
    the names :data:`LBFGS_METHODS`.

    ``minimize`` runs the fit from the Params' best values (or their start
    with ``restart_from_init``) and stores the best free tree back into
    it; ``loss_history`` holds the n_iter losses.
    """

    def __init__(self, loss, parameters, method="adabelief"):
        if method != "adabelief" and method not in LBFGS_METHODS:
            raise ValueError(f"unknown method {method!r}")
        self.loss = loss
        self.parameters = parameters
        self.method = method
        self.loss_history = None

    def minimize(self, maxiter=None, max_iterations=None,
                 min_iterations=None, init_learning_rate=1e-3,
                 schedule_learning_rate=True, restart_from_init=False,
                 stop_at_loss_increase=False, progress_bar=False,
                 return_param_history=False, checkpoint_path=None,
                 checkpoint_every=500, checkpoint_inputs_digest=None, *,
                 checkpoint_share=None):
        """Returns (best_kwargs, logL, extra, runtime_s), in the JAX
        package's call form.

        ``max_iterations`` (else ``maxiter``) is the budget. AdaBelief
        runs :func:`run_adabelief_extended` with ``checkpoint_path``,
        ``checkpoint_every``, ``checkpoint_inputs_digest`` and
        ``checkpoint_share`` (which L-BFGS ignores, as in JAX), and with
        ``stop_at_loss_increase``, ``min_iterations`` and
        ``return_param_history`` (``N_PARAM_SNAPSHOTS`` snapshots) as its
        optional steps; with either option ``extra`` holds
        ``stopped_at``, and with ``return_param_history`` also
        ``param_history`` (the free tree of numpy arrays with a leading
        snapshot axis) and ``param_history_iterations``. The options
        raise ``ValueError`` with L-BFGS or with a checkpoint.
        ``progress_bar`` is accepted and unused.
        """
        del progress_bar
        t0 = time.time()
        p = self.parameters
        free0 = p.free0 if restart_from_init \
            else p.best_fit_values(as_kwargs=False)
        n_iter = int(max_iterations if max_iterations is not None
                     else maxiter)
        extended = bool(stop_at_loss_increase) or bool(return_param_history)
        if self.method != "adabelief" and extended:
            raise ValueError(
                "stop_at_loss_increase / return_param_history are only "
                "implemented for method='adabelief'")
        extra = {}
        if self.method == "adabelief":
            best, _, hist, stopped_at, snaps, snap_iters = \
                run_adabelief_extended(
                    self.loss.loss_fn, free0, p.lower, p.upper, n_iter,
                    init_learning_rate, schedule_learning_rate,
                    bool(stop_at_loss_increase), int(min_iterations or 0),
                    N_PARAM_SNAPSHOTS if return_param_history else 0,
                    checkpoint_path=checkpoint_path,
                    checkpoint_every=checkpoint_every,
                    inputs_digest=checkpoint_inputs_digest,
                    checkpoint_share=checkpoint_share)
            if extended:
                extra["stopped_at"] = stopped_at
            if return_param_history:
                extra["param_history"] = kwargs_to_numpy(snaps)
                extra["param_history_iterations"] = snap_iters
        else:
            best, _, hist = run_lbfgsb(self.loss.loss_fn, free0, p.lower,
                                       p.upper, n_iter)
        self.loss_history = hist
        p.set_best(best)
        logL = float(np.nanmin(hist)) \
            if hist.size and np.isfinite(hist).any() else float("nan")
        return (p.best_fit_values(as_kwargs=True), logL,
                {"loss_history": hist, **extra}, time.time() - t0)


def relative_loss_differential(loss_history):
    """Loss change over the last 10 % of iterations over the change before."""
    lh = np.asarray(loss_history)
    idx = int(0.9 * lh.size)
    if idx == 0 or idx == lh.size:
        return 0.0
    initial = np.nanmax(lh[:idx]) - np.nanmin(lh[:idx])
    end = np.nanmax(lh[idx:]) - np.nanmin(lh[idx:])
    if initial == 0:
        return 0.0
    return float(end / initial)


def warn_if_unconverged(loss_history, logger, label, budget_key,
                        threshold=UNCONVERGED_RLD_THRESHOLD):
    """Log a warning when the budget ended mid-descent; return the metric."""
    rld = relative_loss_differential(loss_history)
    if rld > threshold:
        logger.warning(
            f"{label}: loss still descending when the iteration budget "
            f"ran out (relative_loss_differential {rld:.3f} > "
            f"{threshold}); consider raising '{budget_key}'")
    return rld
