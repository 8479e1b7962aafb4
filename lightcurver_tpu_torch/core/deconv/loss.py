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

``irfft_backend`` chooses the render, as ``Loss(irfft_backend=...)`` does
in JAX: "fft" (the default) renders through cuFFT; "matmul", the port's
name for JAX's "mxu", builds the pooled DFT matrices and the raw PSF
spectra (``DeconvModel.matmul_consts``) and renders every evaluation
through the all-real matmul-DFT path, whose kernel is K2.

Epoch sharding (``parallel/``): with ``epochs=(start, stop)`` and a
process ``group``, the loss of one rank is the chi2 of its own epochs,
rendered by the model's slice over them (so K2 renders only those), and
rank 0 of the group adds every other term once, on the full tree. The
parameters are replicated on every rank: :func:`sum_over_group`
all-reduces the value and the gradient in one flat collective, so every
rank steps identically. Without a group the sum keeps its unsharded order.

Two subgradients are chosen to match JAX at exact zeros, which is where
stage 2 starts (h = 0): ``|x|`` has slope +1 at 0 (``torch.abs`` has 0),
and ``max(-h, 0)`` splits the slope 0.5 / 0.5 at the tie, as
``torch.maximum`` does (``clamp`` and ``relu`` do not).
"""

import torch
import torch.distributed as dist

from ..starlet import n_starlet_scales
from ..params import merge_free
from ..profiles import gaussian_r_kernel
from ...ops import check_irfft_backend
from ...ops.starlet_op import starlet_transform
from ...parallel.deconv import shard_consts, shard_pytree


def _abs(x):
    """|x| with derivative +1 at 0, as ``jnp.abs``."""
    return torch.where(x >= 0, x, -x)


def _leaves(tree):
    return [x for v in tree.values()
            for x in (_leaves(v) if isinstance(v, dict) else [v])]


def _with_leaves(tree, leaves):
    """``tree`` with its leaves, in :func:`_leaves` order, replaced."""
    return {k: _with_leaves(v, leaves) if isinstance(v, dict)
            else next(leaves) for k, v in tree.items()}


class _SumOverGroup(torch.autograd.Function):
    """The sum over the ranks of ``group`` of ``fn(*leaves)``, with its
    gradient: each rank evaluates its own term and its gradient, and one
    flat ``all_reduce`` carries the values and the gradients, so every
    rank holds the same sum. A value with a leading problem axis (the
    per-star losses) must depend on each problem's slice of the leaves
    only: its gradient is then scaled per problem."""

    @staticmethod
    def forward(ctx, fn, group, *leaves):
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(True) for x in leaves]
            value = fn(*xs)
            grads = torch.autograd.grad(value.sum(), xs, allow_unused=True)
        parts = [value.detach()] + [
            torch.zeros_like(x) if g is None else g
            for x, g in zip(xs, grads)]
        flat = torch.cat([p.reshape(-1) for p in parts])
        dist.all_reduce(flat, group=group)
        value, *ctx.grads = [
            chunk.reshape(p.shape) for chunk, p in zip(
                flat.split([p.numel() for p in parts]), parts)]
        return value

    @staticmethod
    def backward(ctx, grad_value):
        if grad_value.dim() == 0:
            scaled = [grad_value * g for g in ctx.grads]
        else:
            scaled = [g * grad_value.reshape((-1,) + (1,) * (g.dim() - 1))
                      for g in ctx.grads]
        return (None, None, *scaled)


def sum_over_group(fn, tree, group):
    """``fn(tree)`` summed over the ranks of ``group``, differentiable in
    the tensors of ``tree`` (see :class:`_SumOverGroup`)."""
    leaves = _leaves(tree)
    return _SumOverGroup.apply(
        lambda *xs: fn(_with_leaves(tree, iter(xs))), group, *leaves)


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
                 W=None, prior=None, epoch_weights=None,
                 irfft_backend=None, starlet_backend=None, *, epochs=None,
                 group=None):
        """
        ``irfft_backend``: "fft" (None: the default) or "matmul".
        ``starlet_backend`` is accepted and unused: JAX's global switch
        between its Pallas and XLA starlets; here a CUDA tensor runs K1
        and a CPU one its plain twin. ``epochs``: ``(start, stop)``, the
        epochs whose chi2 this rank computes (default: all); ``group``:
        the process group over whose ranks the loss is summed (default:
        none, one process).
        """
        del starlet_backend
        irfft_backend = irfft_backend or "fft"
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
        self.epoch_w = t(epoch_weights) if epoch_weights is not None \
            else torch.ones(model.n_epochs, device=device)
        if (epochs is None) != (group is None):
            raise ValueError("Loss: an epoch range and a process group go "
                             "together (each rank sums its own epochs)")
        self.group = group
        self.epochs = (0, model.n_epochs) if epochs is None \
            else tuple(int(e) for e in epochs)
        self.whole = self.epochs == (0, model.n_epochs)
        # the chi2 of this rank's epochs, through the model's slice
        self.local_model = model if self.whole \
            else model.epoch_slice(*self.epochs)
        local = shard_consts({"data": t(data), "sigma_2": t(sigma_2),
                              "epoch_w": self.epoch_w}, self.epochs)
        self.data, self.sigma_2 = local["data"], local["sigma_2"]
        self.local_w = local["epoch_w"]
        # the terms other than the chi2, counted once: on rank 0
        self.first = group is None or dist.get_rank(group) == 0
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

        check_irfft_backend(irfft_backend)
        self.consts = self.local_model.matmul_consts() \
            if irfft_backend == "matmul" else None

        # a FIXED background renders the same every iteration: do it once
        self.fixed_h_render = None
        fixed_bg = param_class.fixed.get("kwargs_background", {})
        if "h" in fixed_bg:
            with torch.no_grad():
                self.fixed_h_render = self.local_model._h_render(
                    t(fixed_bg["h"]), self.consts)

    def loss_fn(self, free):
        """Scalar loss at the free tree (fixed values from the Params)."""
        fixed = self.params.fixed
        return self._summed(lambda f: self._total(merge_free(f, fixed),
                                                  self.fixed_h_render), free)

    def __call__(self, kwargs):
        """Loss at full kwargs, everything free (h rendered)."""
        return self._summed(lambda k: self._total(k, None), kwargs)

    def _summed(self, fn, tree):
        if self.group is None:
            return fn(tree)
        return sum_over_group(fn, tree, self.group)

    def _total(self, kwargs, fixed_h_render):
        """This rank's chi2 term, plus, on rank 0, every other term."""
        model = self.local_model
        local = kwargs if self.whole \
            else shard_pytree(kwargs, self.epochs, model.n_sources)
        modelled = model.model(local, fixed_h_render, self.consts)
        res = (self.data - modelled) ** 2 / self.sigma_2
        total = 0.5 * torch.nansum(self.local_w[:, None, None] * res)
        if self.first:
            total = self._regularization(total, kwargs)
        return total

    def _regularization(self, total, kwargs):
        """``total`` plus the terms of the full tree other than the chi2:
        starlet l1, positivity, point-source proximity, flux uniformity
        (each source's mean and scatter over all epochs) and priors."""
        model, m = self.model, self.model.m
        w = self.epoch_w
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
