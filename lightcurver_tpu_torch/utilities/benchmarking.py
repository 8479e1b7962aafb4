"""Micro-benchmark helpers, twin of JAX's ``utilities/benchmarking.py``.

JAX times a loop as one compiled ``lax.scan`` and reads (bytes, FLOPs)
from XLA's cost analysis. Here the same five names do it by the card's
means:

- :func:`time_compiled_loop` and :func:`time_vg_loop` capture the whole
  loop in one CUDA graph and replay it, best of several, between two CUDA
  events: the time of the device work without the host's cost of issuing
  it. ``time_vg_loop(..., eager=True)`` times the same loop launched op
  by op from the host (host clock, result fetched), so the two together
  give the host share a graph removes. On a CPU tensor the loop runs
  eagerly. As in JAX the carry depends on each step's full output, so
  nothing can be pruned or hoisted.
- :func:`compiled_cost` counts one call in a ``TorchDispatchMode`` over
  the aten ops it dispatches, backward ops included: each op's operands
  read once and its results written once, FLOPs from the formulas of
  ``torch.utils.flop_counter`` for products, the FFT's 2.5 N log2 N a
  real transform, one a pointwise output and one a reduced input
  element. K1 and K2 are counted as units from their shapes
  (``starlet_cuda.work``, ``fused_render_cuda.work``; ``ops/cost.py``),
  so the card's kernels, which no dispatch sees, and their plain twins
  on the CPU give the same count. It is the count of the unfused eager
  program: its bytes are not XLA's fused bytes.
- :func:`psf_pixel_phase_cost` and :func:`star_fit_phase_cost` build the
  per-iteration value-and-grad of the PSF fit's pixel phase and of the
  batched star fit at JAX's inputs and count it.

Per-iteration times from these helpers in PERF.md were taken on an
NVIDIA H100 by ``chip_smoke.py`` phase 16 and carry the card's name and
power limit; no TPU figure applies here.
"""

import math
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.optimize import _launch_counts
from ..ops import cost

N_WARMUP = 3   # eager steps on a side stream before a capture


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts, tuples and lists;
    None stays None."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def _leaves(tree):
    found = []
    _tree_map(found.append, tree)
    return found


def launch_counts():
    """(K1 forward, K1 adjoint, K2 forward, K2 backward) launches counted
    so far by the kernels' wrappers."""
    return _launch_counts()[:4]


def _run(step, carry, n_rep):
    """``n_rep`` steps from ``carry``: (the last step's value, the first's)."""
    first = None
    for _ in range(n_rep):
        carry, value = step(carry)
        first = value if first is None else first
    return value, first


def _perturbed(start, rep):
    return _tree_map(lambda x: x * (1 + 1e-6 * rep), start)


def _timed_loop(step, start, n_rep, n_best_of, eager, record):
    """Best of ``n_best_of`` runs of ``n_rep`` steps ``carry, value =
    step(carry)``, run ``rep`` starting from ``start`` times
    (1 + 1e-6 rep), prepared outside the timed window: seconds an
    iteration. On the card, unless ``eager``, the steps are one CUDA graph
    (:func:`_graph_loop`)."""
    device = _leaves(start)[0].device
    if device.type == "cuda" and not eager:
        return _graph_loop(step, start, n_rep, n_best_of, record, device)
    sync = torch.cuda.synchronize if device.type == "cuda" \
        else (lambda: None)
    float(_run(step, start, n_rep)[0])     # the first run, untimed
    best = math.inf
    for rep in range(1, n_best_of + 1):
        carry = _perturbed(start, rep)
        sync()
        t0 = time.perf_counter()
        float(_run(step, carry, n_rep)[0])
        best = min(best, time.perf_counter() - t0)
    return best / n_rep


def _graph_loop(step, start, n_rep, n_best_of, record, device):
    """The loop of :func:`_timed_loop` as one CUDA graph. K1 and K2 set
    their kernels' attributes at their first launch, which a capture
    forbids, so a few eager steps run first, on a side stream. A step that
    cannot be captured raises; nothing falls back to an eager loop.

    ``record`` (a dict, optional) gets ``captured_launches``, the K1 and K2
    launches the capture recorded into the graph (counted once by the
    wrappers, then run by every replay), ``replays``, and
    ``first_value`` / ``eager_first_value``: the first step's value from
    the graph's first replay and from the same step run eagerly."""
    static = _tree_map(torch.clone, start)
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        _run(step, static, N_WARMUP)
    current.wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()
    with torch.cuda.graph(graph):
        _, first = _run(step, static, n_rep)
    captured = tuple(b - a for a, b in zip(before, launch_counts()))
    graph.replay()                          # the first run, untimed
    torch.cuda.synchronize(device)
    first_value = float(first)
    eager_first_value = float(step(static)[1])
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = math.inf
    for rep in range(1, n_best_of + 1):
        _tree_map(lambda s, x: s.copy_(x * (1 + 1e-6 * rep)), static, start)
        torch.cuda.synchronize(device)
        begin.record(current)
        graph.replay()
        end.record(current)
        end.synchronize()
        best = min(best, begin.elapsed_time(end) * 1e-3)
    if record is not None:
        record.update(captured_launches=captured, replays=1 + n_best_of,
                      first_value=first_value,
                      eager_first_value=eager_first_value)
    return best / n_rep


def time_compiled_loop(fn, img, n_rep, *, record=None):
    """Mean per-iteration time of ``fn`` in one captured loop, best of 3.

    ``fn(x) -> tensor``; the carry is ``x * (1 + 1e-12 * sum(fn(x)))``:
    the FULL sum, since keeping one element live would let a compiler
    prune the rest of ``fn``, and each input depends on the last output.
    ``record``: see :func:`_graph_loop`."""
    def step(x):
        total = fn(x).sum()
        return x * (1.0 + 1e-12 * total), total

    return _timed_loop(step, img, int(n_rep), 3, False, record)


def time_vg_loop(vg, free, consts, n_rep=200, n_best_of=3, *, eager=False,
                 record=None):
    """Best-of-``n_best_of`` per-iteration time of ``vg`` in one captured
    loop.

    ``vg(free, consts) -> (value, grad)`` with ``grad`` a tree like
    ``free``; the carry is a gradient-descent step ``free - 1e-9 grad``,
    a loop-carried dependence as in :func:`time_compiled_loop`. The
    restarts are perturbed (``free`` times 1 + 1e-6 rep): a step's value
    sums ``value``. ``eager=True`` times the same loop without the graph;
    ``record``: see :func:`_graph_loop`."""
    def step(f):
        value, grad = vg(f, consts)
        return _tree_map(lambda x, g: x - 1e-9 * g, f, grad), value.sum()

    return _timed_loop(step, free, int(n_rep), int(n_best_of), eager,
                       record)


# allocations: no element is read or written
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided"}


def _fft_flops(func, args, out):
    """2.5 N log2 N a real transform of N points, 5 N log2 N a complex one,
    N the points of the transformed dims, per batch of them."""
    name = func.overloadpacket.__name__
    if name not in ("_fft_r2c", "_fft_c2r", "_fft_c2c"):
        return None
    real = out if name == "_fft_c2r" else args[0]
    points = math.prod(real.shape[d] for d in args[1])
    if points < 2:
        return 0
    per_point = 5.0 if name == "_fft_c2c" else 2.5
    return per_point * real.numel() * math.log2(points)


class _CostCount(TorchDispatchMode):
    """Bytes and FLOPs of the aten ops dispatched under it, K1 and K2
    charged as units (:mod:`..ops.cost`)."""

    def __init__(self):
        super().__init__()
        # imported here: where triton is installed it imports triton
        from torch.utils.flop_counter import flop_registry

        self.formulas = flop_registry
        self.bytes = 0
        self.flops = 0
        self.muted = 0

    def charge(self, n_bytes, flops):
        self.bytes += n_bytes
        self.flops += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.muted and not func.is_view \
                and func.overloadpacket.__name__ not in _NO_DATA:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        ins = {id(t): t for t in _leaves((args, kwargs))
               if isinstance(t, torch.Tensor)}
        outs = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
        self.bytes += sum(t.numel() * t.element_size()
                          for t in (*ins.values(), *outs))
        formula = self.formulas.get(func.overloadpacket)
        fft = _fft_flops(func, args, out)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        elif fft is not None:
            self.flops += fft
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in outs)
        elif torch.Tag.reduction in func.tags:
            self.flops += max((t.numel() for t in ins.values()), default=0)

    def __enter__(self):
        cost.COUNTS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            cost.COUNTS.pop()


def compiled_cost(fn, *args):
    """(bytes, flops) of one call ``fn(*args)``, counted over the aten ops
    it dispatches, backward ops included, with K1 and K2 as units (module
    docstring). As with JAX's, pass the per-iteration function (a loss's
    value-and-grad), not a whole optimizer loop. The call runs once, on
    the device of its arguments."""
    with _CostCount() as count:
        fn(*args)
    return float(count.bytes), float(count.flops)


def _value_and_grad(loss):
    """``vg(free, consts) -> (loss, grad)`` of ``loss(free, consts)``, a
    vector of independent problems (frames, stars): the gradient of its
    sum is each problem's, as JAX's vmap of ``value_and_grad`` gives."""
    def vg(free, consts):
        leaves = _tree_map(lambda x: x.detach().requires_grad_(True), free)
        with torch.enable_grad():
            value = loss(leaves, consts)
            grads = torch.autograd.grad(value.sum(), _leaves(leaves))
        it = iter(grads)
        return value.detach(), _tree_map(lambda _: next(it), leaves)

    return vg


def psf_pixel_phase_cost(batch, n_stars, n_pix, s, dft_pad=16, *,
                         device="cuda", irfft_backend="fft"):
    """(bytes, flops) of one pixel-phase PSF value-and-grad over ``batch``
    frames.

    The per-iteration program of the PSF fit's dominant phase (AdaBelief
    over the pixel grid, ``core/psf/build.py::phase_losses``, its starlet
    l1 through K1) at JAX's inputs: unit fluxes, zero positions, grid and
    data, unit variances, masks and weights, a Moffat of FWHM 2.5 and beta
    2.5. ``dft_pad`` sets the matmul render's padding (as
    ``build_psf(dft_pad=...)``; None for L = 2m); cuFFT ignores it.

    Returns ``((bytes, flops), (vg, free, consts))``, ``vg(free, consts)
    -> (loss (batch,), grad)`` as :func:`time_vg_loop` takes it.
    """
    from ..core.psf.build import phase_losses, psf_dft_mats
    from ..core.starlet import n_starlet_scales

    m = n_pix * s

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=device)

    _, _, loss_pixels = phase_losses(n_stars, n_pix, s, False)
    free = {
        "kwargs_gaussian": {"a": full((batch, n_stars), 1.0),
                            "x0": full((batch, n_stars), 0.0),
                            "y0": full((batch, n_stars), 0.0)},
        "kwargs_background": {"background": full((batch, m * m), 0.0)},
    }
    stamps = (batch, n_stars, n_pix, n_pix)
    consts = {
        "data": full(stamps, 0.0),
        "sigma_2": full(stamps, 1.0),
        "masks": full(stamps, True, torch.bool),
        "stamp_coordinates": full((batch, n_stars, 2), 0.0),
        "W": full((batch, n_starlet_scales(m) + 1, m, m), 1.0),
        "lam": full((), 1.0),
        "fixed": {
            "kwargs_moffat": {k: full((batch,), 2.5)
                              for k in ("fwhm_x", "fwhm_y", "beta")},
            "kwargs_distortion": {k: full((batch, 5), 0.0) for k in
                                  ("dilation_x", "dilation_y", "shear")}},
        "dft_mats": psf_dft_mats(m, s, irfft_backend, dft_pad, device),
    }
    vg = _value_and_grad(loss_pixels)
    return compiled_cost(vg, free, consts), (vg, free, consts)


def star_fit_phase_cost(n_stars=8, n_epochs=50, n_pix=16, s=2, *,
                        device="cuda", irfft_backend="fft"):
    """(bytes, flops) of one batched star-photometry value-and-grad.

    The per-iteration program of ``fit_stars_batched`` at the shipped
    flags (h fixed at zero, no per-epoch background) on JAX's inputs:
    unit data, noise and PSFs, through ``core/deconv/batched.py``'s
    ``_prepare_stars`` and ``_star_losses``.

    Returns ``((bytes, flops), (vg, free, consts))``; ``vg(free, consts)
    -> (loss (n_stars,), grad)`` as :func:`time_vg_loop` takes it.
    ``consts`` are the port's (``_prepare_stars``); the model, which holds
    the PSF spectra, is bound into ``vg``.
    """
    from ..core.deconv.batched import _prepare_stars, _star_losses

    stamps = (n_stars, n_epochs, n_pix, n_pix)
    ones = torch.ones(stamps, dtype=torch.float32, device=device)
    psf = torch.ones(n_stars, n_epochs, n_pix * s, n_pix * s,
                     dtype=torch.float32, device=device)
    model, free, _, _, consts, _ = _prepare_stars(
        ones, ones.clone(), psf, s, False, False, irfft_backend, 0, None)
    vg = _value_and_grad(
        lambda f, c: _star_losses(model, c, n_stars)(f))
    return compiled_cost(vg, free, consts), (vg, free, consts)
