"""The fused render of the deconvolution model, K2, and its gradient.

Twin of ``lightcurver_tpu/ops/experimental/fused_render.py``. Per epoch e,
with the operands of the TPU kernel ``_fwd_kernel``:

    spec   = sum_c u[c] (x) v[c]              2M stacked rank-1 terms
    X      = spec * (t_hat * r_hat)           PSF times target kernel
             [+ h_hat * (t_hat * (pc + i ps))]  the background channel
    A + iB = (Ayp + i Byp) @ X                pooled inverse DFT, stage 1
    out    = Re{(A + iB) @ (Cxp + i Sxp)}     stage 2, on the data grid

Shapes: u_re, u_im (N, 2M, L); v (N, 2M, Lh); t_re, t_im (N, L, Lh);
r_hat, pc, ps (L, Lh); h_re, h_im (L, Lh), or (G, L, Lh) with G dividing
N: one background per group of N / G consecutive epochs, the counterpart
of ``jax.vmap`` over the stars of the star photometry, whose S stars x N
epochs render as S N epochs with G = S; Ayp, Byp (n, L); Cxp, Sxp (Lh, n);
out (N, n, n); float32. This is ``_model_all_real`` of the JAX model
without the mean term. The JAX kernel is forward-only; here the gradient
with respect to u_re, u_im, v (per epoch) and h_re, h_im (summed over
the epochs of each plane) is written out in :func:`render_backward_plain`.
With G the (n, n) cotangent of an epoch, P = Ayp + i Byp and
Q = Cxp + i Sxp:

    dX_re = Re(P^T G Q^T),  dX_im = -Im(P^T G Q^T)

then through the conjugate of t_hat * r_hat to the spectrum, and through
the conjugate of t_hat * (pc + i ps) to h_hat.

:func:`fused_render` is the differentiable entry point. A CPU tensor runs
the plain twins below; a CUDA tensor runs the hand-written kernels of
``csrc/fused_render.cu`` through ``ops/fused_render_cuda.py`` (which
counts their launches), or raises. The PSF spectra, ``r_hat``, the centre
phase and the DFT matrices are constants: they may not require grad. In
a cost count each direction is one unit of ``fused_render_cuda.work``
(``ops/cost.py``).
"""

import torch

from . import cost, fused_render_cuda

# positions of the constant operands in _FusedRender.forward
_CONSTANTS = {3: "t_re", 4: "t_im", 5: "r_hat", 6: "pc", 7: "ps",
              10: "ayp", 11: "byp", 12: "cxp", 13: "sxp"}


def _h_factor(t_re, t_im, pc, ps):
    """(re, im) of t_hat * (pc + i ps), the kernel of the h channel."""
    return t_re * pc - t_im * ps, t_re * ps + t_im * pc


def _per_epoch(h, n_epochs):
    """An (L, Lh) plane as it is (it broadcasts), or (G, L, Lh) planes
    repeated to one per epoch, (N, L, Lh)."""
    if h.dim() == 2:
        return h
    return h.repeat_interleave(n_epochs // h.shape[0], dim=0)


def _group_sum(x, n_groups):
    """(N, L, Lh) summed over all epochs (``n_groups`` None), or over each
    group of N / G consecutive epochs, (G, L, Lh)."""
    if n_groups is None:
        return x.sum(dim=0)
    return x.unflatten(0, (n_groups, -1)).sum(dim=1)


def render_plain(u_re, u_im, v, t_re, t_im, r_hat, pc, ps, h_re, h_im,
                 ayp, byp, cxp, sxp, include_h=True):
    """The K2 forward in plain torch, (N, n, n); any float dtype."""
    spec_re = torch.einsum("eck,ecj->ekj", u_re, v)
    spec_im = torch.einsum("eck,ecj->ekj", u_im, v)
    p_re, p_im = t_re * r_hat, t_im * r_hat
    x_re = spec_re * p_re - spec_im * p_im
    x_im = spec_re * p_im + spec_im * p_re
    if include_h:
        g_re, g_im = _h_factor(t_re, t_im, pc, ps)
        N = u_re.shape[0]
        h_re, h_im = _per_epoch(h_re, N), _per_epoch(h_im, N)
        x_re = x_re + h_re * g_re - h_im * g_im
        x_im = x_im + h_re * g_im + h_im * g_re
    a = torch.matmul(ayp, x_re) - torch.matmul(byp, x_im)
    b = torch.matmul(ayp, x_im) + torch.matmul(byp, x_re)
    return torch.matmul(a, cxp) - torch.matmul(b, sxp)


def render_backward_plain(g, u_re, u_im, v, t_re, t_im, r_hat, pc, ps,
                          ayp, byp, cxp, sxp, include_h=True, n_groups=None):
    """Cotangents ``(du_re, du_im, dv, dh_re, dh_im)`` of
    :func:`render_plain` for the output cotangent ``g`` (N, n, n); the
    h terms are None without ``include_h``, else (L, Lh), or (G, L, Lh)
    with ``n_groups`` G."""
    da = torch.matmul(g, cxp.T)                           # (N, n, Lh)
    db = -torch.matmul(g, sxp.T)
    dx_re = torch.matmul(ayp.T, da) + torch.matmul(byp.T, db)
    dx_im = torch.matmul(ayp.T, db) - torch.matmul(byp.T, da)
    p_re, p_im = t_re * r_hat, t_im * r_hat
    ds_re = dx_re * p_re + dx_im * p_im
    ds_im = dx_im * p_re - dx_re * p_im
    du_re = torch.einsum("ekj,ecj->eck", ds_re, v)
    du_im = torch.einsum("ekj,ecj->eck", ds_im, v)
    dv = torch.einsum("ekj,eck->ecj", ds_re, u_re) \
        + torch.einsum("ekj,eck->ecj", ds_im, u_im)
    dh_re = dh_im = None
    if include_h:
        g_re, g_im = _h_factor(t_re, t_im, pc, ps)
        dh_re = _group_sum(dx_re * g_re + dx_im * g_im, n_groups)
        dh_im = _group_sum(dx_im * g_re - dx_re * g_im, n_groups)
    return du_re, du_im, dv, dh_re, dh_im


class _FusedRender(torch.autograd.Function):

    @staticmethod
    def forward(ctx, u_re, u_im, v, t_re, t_im, r_hat, pc, ps, h_re, h_im,
                ayp, byp, cxp, sxp, include_h):
        wants = [name for i, name in _CONSTANTS.items()
                 if ctx.needs_input_grad[i]]
        if wants:
            raise ValueError(f"fused_render: {', '.join(wants)} are "
                             "constants and may not require grad")
        ctx.include_h = include_h
        ctx.n_groups = fused_render_cuda.h_groups(h_re, u_re.shape[0]) \
            if include_h else None
        consts = (t_re, t_im, r_hat, pc, ps, ayp, byp, cxp, sxp)
        ctx.save_for_backward(u_re, u_im, v, *consts)
        args = (u_re, u_im, v, t_re, t_im, r_hat, pc, ps, h_re, h_im,
                ayp, byp, cxp, sxp, include_h)
        render = render_plain if u_re.device.type == "cpu" \
            else fused_render_cuda.forward
        return cost.charged(lambda: _work(u_re, v, ayp, False, ctx),
                            render, *args)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        render_backward = render_backward_plain if g.device.type == "cpu" \
            else fused_render_cuda.backward
        saved = ctx.saved_tensors
        du_re, du_im, dv, dh_re, dh_im = cost.charged(
            lambda: _work(saved[0], saved[2], saved[8], True, ctx),
            render_backward, g, *saved, ctx.include_h, ctx.n_groups)
        return (du_re, du_im, dv, None, None, None, None, None, dh_re,
                dh_im, None, None, None, None, None)


def _work(u_re, v, ayp, backward, ctx):
    """(bytes, FLOPs) of one K2 call (``fused_render_cuda.operand_work``)."""
    n_bytes, products, rest = fused_render_cuda.operand_work(
        u_re, v, ayp, backward, ctx.include_h, ctx.n_groups)
    return n_bytes, products + rest


def fused_render(u_re, u_im, v, t_re, t_im, r_hat, pc, ps, h_re, h_im,
                 ayp, byp, cxp, sxp, include_h=True):
    """Differentiable K2 render, (N, n, n); ``h_re``/``h_im`` (L, Lh) or
    (G, L, Lh), and None when ``include_h`` is False."""
    return _FusedRender.apply(u_re.contiguous(), u_im.contiguous(),
                              v.contiguous(), t_re, t_im, r_hat, pc, ps,
                              h_re.contiguous() if include_h else None,
                              h_im.contiguous() if include_h else None,
                              ayp, byp, cxp, sxp, bool(include_h))
