"""Parameters as nested dicts of tensors, with fixing and box bounds.

Twin of ``lightcurver_tpu/core/params.py``: a parameter listed in
``kwargs_fixed`` is held at the value given there; every other one is free
and is optimized within ``kwargs_down`` .. ``kwargs_up``.

Also the carry-over between the two packages: :func:`kwargs_from_numpy`
and :func:`kwargs_to_numpy` turn nested dicts of numpy arrays (the JAX
package's kwargs, taken with ``np.asarray``) into float32 tensors on a
device and back.
"""

import numpy as np
import torch


def kwargs_from_numpy(kwargs, device):
    """Nested dict of array-likes (or Python floats) -> float32 tensors."""
    if isinstance(kwargs, dict):
        return {k: kwargs_from_numpy(v, device) for k, v in kwargs.items()}
    return torch.tensor(np.asarray(kwargs, dtype=np.float32), device=device)


def kwargs_to_numpy(kwargs):
    """Nested dict of tensors -> nested dict of numpy arrays (on the host)."""
    if isinstance(kwargs, dict):
        return {k: kwargs_to_numpy(v) for k, v in kwargs.items()}
    if isinstance(kwargs, torch.Tensor):
        return kwargs.detach().cpu().numpy()
    return np.asarray(kwargs)


def split_free(kwargs_init, kwargs_fixed):
    """Split kwargs into (free, fixed); a key in ``kwargs_fixed`` is fixed
    at the value given there. Leaves are tensors."""
    free, fixed = {}, {}
    for k, v in kwargs_init.items():
        if isinstance(v, dict):
            spec = kwargs_fixed.get(k, {}) if kwargs_fixed else {}
            free[k], fixed[k] = split_free(v, spec)
        elif kwargs_fixed is not None and k in kwargs_fixed:
            fixed[k] = kwargs_fixed[k]
        else:
            free[k] = v
    return free, fixed


def merge_free(free, fixed):
    """Merge a free and a fixed tree back into full kwargs."""
    out = {}
    for k in set(free) | set(fixed):
        fv, xv = free.get(k), fixed.get(k)
        if isinstance(fv, dict) or isinstance(xv, dict):
            out[k] = merge_free(fv or {}, xv or {})
        else:
            out[k] = fv if fv is not None else xv
    return out


def bounds_like_free(free, kwargs_bound, default):
    """A bounds tree shaped like ``free``; missing entries get ``default``."""
    out = {}
    for k, v in free.items():
        if isinstance(v, dict):
            sub = kwargs_bound.get(k, {}) if kwargs_bound else {}
            out[k] = bounds_like_free(v, sub, default)
        else:
            b = kwargs_bound[k] if kwargs_bound is not None \
                and k in kwargs_bound else default
            out[k] = torch.as_tensor(b, dtype=v.dtype, device=v.device) \
                .expand(v.shape).clone()
    return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


class Params:
    """kwargs_init / kwargs_fixed / kwargs_up / kwargs_down, split.

    Attributes:
        free0: initial free tree (tensors, copied: the caller's kwargs are
            never written to).
        fixed: fixed tree.
        lower, upper: bounds trees shaped like ``free0``.
    """

    def __init__(self, kwargs_init, kwargs_fixed=None, kwargs_up=None,
                 kwargs_down=None):
        free0, fixed = split_free(kwargs_init, kwargs_fixed or {})
        self.free0 = _clone(free0)
        self.fixed = _clone(fixed)
        self.upper = bounds_like_free(self.free0, kwargs_up, np.inf)
        self.lower = bounds_like_free(self.free0, kwargs_down, -np.inf)
        self._best_free = None

    def merge(self, free):
        """Full kwargs from a free tree."""
        return merge_free(free, self.fixed)

    def set_best(self, free):
        self._best_free = free

    def best_fit_values(self, as_kwargs=True):
        """Best free values found so far (full kwargs when ``as_kwargs``)."""
        best = self._best_free if self._best_free is not None else self.free0
        return self.merge(best) if as_kwargs else best
