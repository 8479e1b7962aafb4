"""Exact GLS flux solve and diagonal Fisher flux errors.

Twin of ``lightcurver_tpu/core/fisher.py``. The model is linear in the
fluxes ``a``, so at fixed positions and background the per-epoch fluxes
solve the M x M normal equations ``(B W B^T) a = B W r`` (B the unit-flux
source images, r the data minus the flux-independent channels), and the
diagonal Fisher information is ``sum_px B^2 / sigma^2``.
:class:`FisherCovariance` wraps the flux errors in the reference's
interface.
"""

import numpy as np
import torch


def _diag_fisher(basis, sigma_2):
    """1-sigma flux errors (N, M) from the unit-flux images ``basis``
    (N, M, n, n) and the variances ``sigma_2`` (N, n, n)."""
    info = torch.nansum(basis**2 / sigma_2[:, None, :, :], dim=(-2, -1))
    return 1.0 / torch.sqrt(info)


def linear_flux_solve(kwargs, data, sigma_2, model, consts=None,
                      fixed_h_render=None):
    """kwargs with ``a`` replaced by the per-epoch GLS solution.

    Pixels where the data or sigma_2 is not finite get zero weight.
    ``consts`` and ``fixed_h_render`` choose the render of the basis and
    of the baseline as for ``DeconvModel.point_source_basis`` and
    ``background_only`` (JAX passes both in its ``consts``).
    """
    basis = model.point_source_basis(kwargs, consts)        # (N, M, n, n)
    baseline = model.background_only(kwargs, fixed_h_render,
                                     consts)                 # (N, n, n)
    w = torch.where(torch.isfinite(sigma_2) & torch.isfinite(data),
                    1.0 / sigma_2, torch.zeros_like(sigma_2))
    r = torch.nan_to_num(data - baseline)
    bw = basis * w[:, None, :, :]
    gram = torch.einsum("nmyx,nkyx->nmk", bw, torch.nan_to_num(basis))
    rhs = torch.einsum("nmyx,nyx->nm", bw, r)
    # degenerate (fully masked) epochs stay solvable
    eye = torch.eye(gram.shape[-1], dtype=gram.dtype,
                    device=gram.device) * 1e-12
    a = torch.linalg.solve(gram + eye, rhs[..., None])[..., 0]
    return {
        **kwargs,
        "kwargs_analytic": {
            **kwargs["kwargs_analytic"],
            "a": a.reshape(kwargs["kwargs_analytic"]["a"].shape),
        },
    }


def get_flux_uncertainties(kwargs, kwargs_up, kwargs_down, data, noisemap,
                           model):
    """1-sigma errors of ``kwargs['kwargs_analytic']['a']``: a flat numpy
    array in ``a``'s layout (e * M + j), in the JAX package's (and the
    reference helper's) call form. ``kwargs_up``, ``kwargs_down`` and
    ``data`` are accepted and unused: the closed form needs the unit-flux
    images and the noise only."""
    del kwargs_up, kwargs_down, data
    noisemap = torch.as_tensor(noisemap, dtype=torch.float32,
                               device=model.device)
    with torch.no_grad():
        err = _diag_fisher(model.point_source_basis(kwargs), noisemap**2)
    return err.reshape(-1).cpu().numpy()


def _nan_like(tree):
    if isinstance(tree, dict):
        return {k: _nan_like(v) for k, v in tree.items()}
    return np.full(tuple(tree.shape), np.nan)


class FisherCovariance:
    """The reference's ``FisherCovariance(parameters, optim,
    diagonal_only=True)`` then ``get_kwargs_sigma()``: the flux block from
    the diagonal Fisher information (exact, the model being linear in the
    fluxes), NaN of its shape for every other leaf. Twin of the JAX
    package's class."""

    def __init__(self, parameters, optim, diagonal_only=True):
        del diagonal_only
        self.parameters = parameters
        self.loss = optim.loss
        self.model = optim.loss.model

    def get_kwargs_sigma(self):
        """The kwargs tree of 1-sigma errors, as numpy arrays."""
        kwargs = self.parameters.best_fit_values(as_kwargs=True)
        out = _nan_like(kwargs)
        out["kwargs_analytic"]["a"] = get_flux_uncertainties(
            kwargs=kwargs, kwargs_up=None, kwargs_down=None, data=None,
            noisemap=torch.sqrt(self.loss.sigma_2), model=self.model)
        return out
