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
Checkpointed segments and the extended path (stop at loss increase,
parameter history) are not ported.
"""

import time

import numpy as np
import torch

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


def run_adabelief(loss_fn, free0, lower, upper, n_iter,
                  init_learning_rate=1e-3, schedule_learning_rate=True):
    """Projected AdaBelief.

    Returns:
        (best_free, final_free, loss_history) with loss_history a numpy
        array of n_iter float32 values.
    """
    theta, spec = flatten(free0)
    theta = theta.detach().clone()
    lo, hi = flatten_like(lower, spec), flatten_like(upper, spec)
    mu = torch.zeros_like(theta)
    nu = torch.zeros_like(theta)
    best = theta.clone()
    best_loss = torch.tensor(float("inf"), device=theta.device)
    history = torch.empty(n_iter, device=theta.device)
    for it in range(n_iter):
        x = theta.requires_grad_(True)
        value = loss_fn(unflatten(x, spec))
        grad, = torch.autograd.grad(value, x)
        theta = theta.detach()
        value = value.detach()
        history[it] = value
        improved = value < best_loss
        best_loss = torch.where(improved, value, best_loss)
        best = torch.where(improved, theta, best)
        mu = (1 - B1) * grad + B1 * mu
        pred_err = grad - mu
        nu = (1 - B2) * pred_err**2 + B2 * nu + EPS_ROOT
        count = it + 1
        mu_hat = mu / np.float32(1 - B1**count)
        nu_hat = nu / np.float32(1 - B2**count)
        lr = init_learning_rate * 0.01 ** (it / max(n_iter, 1)) \
            if schedule_learning_rate else init_learning_rate
        step = np.float32(-lr) * (mu_hat / (torch.sqrt(nu_hat) + EPS))
        theta = torch.clamp(theta + step, lo, hi)
    return (_free_from(best, spec, free0), _free_from(theta, spec, free0),
            history.cpu().numpy())


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


def _free_from(vec, spec, free0):
    # top-level keys with no free leaves (kwargs_sersic) are kept as {}
    out = unflatten(vec.detach().clone(), spec)
    for k, v in free0.items():
        if isinstance(v, dict) and k not in out:
            out[k] = {}
    return out


class Optimizer:
    """A Loss, a Params and a method ('adabelief' or 'l-bfgs-b').

    ``minimize`` runs the fit from the Params' best values and stores the
    best free tree back into it; ``loss_history`` holds the n_iter losses.
    """

    def __init__(self, loss, parameters, method="adabelief"):
        if method not in ("adabelief", "l-bfgs-b"):
            raise ValueError(f"unknown method {method!r}")
        self.loss = loss
        self.parameters = parameters
        self.method = method
        self.loss_history = None

    def minimize(self, max_iterations, init_learning_rate=1e-3,
                 schedule_learning_rate=True):
        """Returns (best_kwargs, logL, {"loss_history": ...}, runtime_s)."""
        t0 = time.time()
        p = self.parameters
        free0 = p.best_fit_values(as_kwargs=False)
        n_iter = int(max_iterations)
        if self.method == "adabelief":
            best, _, hist = run_adabelief(
                self.loss.loss_fn, free0, p.lower, p.upper, n_iter,
                init_learning_rate=init_learning_rate,
                schedule_learning_rate=schedule_learning_rate)
        else:
            best, _, hist = run_lbfgsb(self.loss.loss_fn, free0, p.lower,
                                       p.upper, n_iter)
        self.loss_history = hist
        p.set_best(best)
        logL = float(np.nanmin(hist)) \
            if hist.size and np.isfinite(hist).any() else float("nan")
        return (p.best_fit_values(as_kwargs=True), logL,
                {"loss_history": hist}, time.time() - t0)


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
