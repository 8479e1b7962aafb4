"""Loss of the joint deconvolution (twin of ``lightcurver_tpu/core/deconv/loss.py``).

    total = 0.5 * chi2
          + starlet-l1 on the background h, weighted per coefficient by the
            noise weights W ('hf' strength on the finest scale, 'scales'
            on the others, none on the coarse residual)
          + positivity of h and of the fluxes
          + point-source proximity: |h| under Gaussian bumps at the
            initial source positions
          + flux uniformity: scatter of each source's flux across epochs
          + Gaussian priors on analytic parameters.

Two subgradients are chosen to match JAX at exact zeros, which is where
stage 2 starts (h = 0): ``|x|`` has slope +1 at 0 (``torch.abs`` has 0),
and ``max(-h, 0)`` splits the slope 0.5 / 0.5 at the tie, as
``torch.maximum`` does (``clamp`` and ``relu`` do not).
"""

import torch

from ..starlet import n_starlet_scales
from ..params import merge_free
from ..profiles import gaussian_r_kernel
from ...ops.starlet_op import starlet_transform


def _abs(x):
    """|x| with derivative +1 at 0, as ``jnp.abs``."""
    return torch.where(x >= 0, x, -x)


class Prior:
    """Gaussian priors on entries of kwargs_analytic.

    ``Prior(prior_analytic=[["c_x", mean, sigma], ...])``.
    """

    def __init__(self, prior_analytic=None):
        self.prior_analytic = prior_analytic or []


class Loss:
    """Data chi2 plus regularization, bound to a model and a Params."""

    def __init__(self, data, deconv_class, param_class, sigma_2,
                 regularization_terms=None,
                 regularization_strength_scales=1.0,
                 regularization_strength_hf=1.0,
                 regularization_strength_positivity=0.0,
                 regularization_strength_pts_source=0.0,
                 regularization_strength_flux_uniformity=0.0,
                 W=None, prior=None, epoch_weights=None):
        model = self.model = deconv_class
        self.params = param_class
        device, m = model.device, model.m

        def t(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        self.n_scales = n_starlet_scales(m)
        self.use_starlet = regularization_terms == "l1_starlet"
        self.lambda_scales = float(regularization_strength_scales)
        self.lambda_hf = float(regularization_strength_hf)
        self.lambda_pos = float(regularization_strength_positivity)
        self.lambda_pts = float(regularization_strength_pts_source)
        self.lambda_flux_uni = float(regularization_strength_flux_uniformity)
        self.data = t(data)
        self.sigma_2 = t(sigma_2)
        self.epoch_w = t(epoch_weights) if epoch_weights is not None \
            else torch.ones(model.n_epochs, device=device)
        self.W = t(W) if W is not None else torch.ones(
            self.n_scales + 1, m, m, device=device)
        self.priors = [(name, t(mean), t(sigma)) for name, mean, sigma
                       in (prior.prior_analytic if prior else [])]

        self.pts_weights = None
        if self.lambda_pts > 0:
            # Gaussian bumps at the initial positions, evaluated once
            with torch.no_grad():
                px, py = model.source_positions(
                    param_class.merge(param_class.free0))
                bump = torch.zeros(m, m, device=device)
                for j in range(model.n_sources):
                    g = gaussian_r_kernel(m, model.s, x0=px[0, j],
                                          y0=py[0, j], device=device)
                    bump = bump + g / g.max()
                self.pts_weights = torch.clamp(bump, max=1.0)

        # a FIXED background renders the same every iteration: do it once
        self.fixed_h_render = None
        fixed_bg = param_class.fixed.get("kwargs_background", {})
        if "h" in fixed_bg:
            with torch.no_grad():
                self.fixed_h_render = model._h_render(t(fixed_bg["h"]))

    def loss_fn(self, free):
        """Scalar loss at the free tree (fixed values from the Params)."""
        return self._total(merge_free(free, self.params.fixed),
                           self.fixed_h_render)

    def __call__(self, kwargs):
        """Loss at full kwargs, everything free (h rendered)."""
        return self._total(kwargs, None)

    def _total(self, kwargs, fixed_h_render):
        model, m = self.model, self.model.m
        w = self.epoch_w
        modelled = model.model(kwargs, fixed_h_render)
        res = (self.data - modelled) ** 2 / self.sigma_2
        total = 0.5 * torch.nansum(w[:, None, None] * res)

        h_flat = kwargs["kwargs_background"]["h"]
        a = kwargs["kwargs_analytic"]["a"].reshape(model.n_epochs,
                                                   model.n_sources)
        if self.use_starlet:
            coeffs = starlet_transform(h_flat.reshape(m, m), self.n_scales)
            wabs = self.W * _abs(coeffs)
            total = total + self.lambda_hf * wabs[0].sum() \
                + self.lambda_scales * wabs[1:-1].sum()
        if self.lambda_pos > 0:
            total = total + self.lambda_pos * (
                torch.sum(torch.maximum(-h_flat, torch.zeros_like(h_flat)))
                + torch.sum(w[:, None]
                            * torch.maximum(-a, torch.zeros_like(a))))
        if self.pts_weights is not None:
            total = total + self.lambda_pts * torch.sum(
                self.pts_weights * _abs(h_flat.reshape(m, m)))
        if self.lambda_flux_uni > 0:
            wsum = torch.sum(w)
            mean = torch.sum(w[:, None] * a, dim=0) / wsum
            var = torch.sum(w[:, None] * (a - mean) ** 2, dim=0) / wsum
            total = total + self.lambda_flux_uni * torch.sum(
                var / (mean**2 + 1e-12))
        for name, mean, sigma in self.priors:
            val = kwargs["kwargs_analytic"][name]
            total = total + 0.5 * torch.sum(((val - mean) / sigma) ** 2)
        return total
