"""Faults planted in the program, to show that the comparison catches
them. Used by ``benchmark/control.py`` and the tests, never by a run.

Each is a context manager that patches one function of the program and
restores it:

- ``noop``: every optimizer loop returns its state unchanged;
- ``half``: the ROI loss's chi2 leaves out the second half of the epochs
  and counts the first half twice (the mean taken over the rest); the PSF
  fit's losses leave out the second half of a bucket's frames and count
  the first half twice;
- ``answer``: the ROI fluxes are altered by 1e-3 where the GLS polish
  produces them, and the full PSFs where the PSF model renders them;
- ``exchange``: on several ranks, a sharded loss is this rank's own terms,
  with no all-reduce between the ranks (``sum_over_group`` returns the
  local sum, with its local gradient).
"""

import contextlib

import torch


@contextlib.contextmanager
def patched(owner, name, replacement):
    original = getattr(owner, name)
    setattr(owner, name, replacement(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def noop():
    from lightcurver_tpu_torch.core import optimize
    return patched(optimize.StepLoop, "run",
                   lambda original: lambda self, n: self.state)


def both(*managers):
    stack = contextlib.ExitStack()
    for manager in managers:
        stack.enter_context(manager)
    return stack


def half_weights(like):
    keep = torch.zeros_like(like)
    keep[:(len(keep) + 1) // 2] = 2.0
    return keep


def half():
    from lightcurver_tpu_torch.core.deconv import loss
    from lightcurver_tpu_torch.core.psf import batched

    def optimizer(original):
        def run(loss_fn, *args, **kwargs):
            def halved(free):
                value = loss_fn(free)
                return value * half_weights(value)
            return original(halved, *args, **kwargs)
        return run

    def replacement(original):
        def init(self, *args, **kwargs):
            original(self, *args, **kwargs)
            self.local_w = self.local_w * half_weights(self.local_w)
        return init
    return both(patched(loss.Loss, "__init__", replacement),
                patched(batched, "run_lbfgsb_batched", optimizer),
                patched(batched, "run_adabelief_batched", optimizer))


def answer():
    from lightcurver_tpu_torch.core.psf import model
    from lightcurver_tpu_torch.processes import roi_modelling

    def replacement(original):
        def solve(kwargs, *args, **kw):
            out = original(kwargs, *args, **kw)
            ka = out["kwargs_analytic"]
            return {**out, "kwargs_analytic": {**ka, "a": ka["a"] * 1.001}}
        return solve

    def full_psf(original):
        return lambda self, *args, **kw: original(self, *args, **kw) * 1.001
    return both(patched(roi_modelling, "linear_flux_solve", replacement),
                patched(model.PSFModel, "full_psf", full_psf))


def exchange():
    from lightcurver_tpu_torch.core.deconv import batched, loss

    def local(original):
        return lambda fn, tree, group: fn(tree)
    return both(patched(loss, "sum_over_group", local),
                patched(batched, "sum_over_group", local))


FAULTS = {"noop": noop, "half": half, "answer": answer,
          "exchange": exchange}
