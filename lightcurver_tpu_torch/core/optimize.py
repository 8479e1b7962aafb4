"""Fixed-iteration optimizers with box projection and best-loss tracking,
each iteration one step function, replayed as a CUDA graph on the card.

Twin of ``lightcurver_tpu/core/optimize.py``:

- AdaBelief with optax's exact semantics (b1 0.9, b2 0.999, eps 1e-16,
  eps_root 1e-16 added to the second moment every step, bias correction)
  and optionally ``exponential_decay(lr, n_iter, 0.01)``; the rate and the
  bias corrections are computed as optax computes them, in float32 from
  the integer count, on the device;
- projected L-BFGS (JAX's ``lbfgsb_scan``): ``optax.scale_by_lbfgs`` with
  memory 10, optax's zoom line search from a unit step (at most 6 trial
  evaluations), then a projection onto the box. The single fit takes the
  value and gradient again at the projected point after a step that the
  projection clipped (JAX's ``exact_bounds=True``); the frame-batched fit
  carries the line search's pair (``exact_bounds=False``, as JAX's
  batched PSF caller).

Both run EXACTLY n_iter iterations and return exactly n_iter history
entries, each the loss BEFORE that iteration's update; the best parameters
are those of the lowest recorded loss. The free tree is flattened into one
float32 vector (a row per problem in the batched fits), so each step is a
handful of kernels whatever the number of leaves.

How a loop runs (JAX compiles the whole ``lax.scan``): each loop is a
step closure ``state -> state`` over a tuple of preallocated tensors, and
the step reads no Python iteration index. The iteration is a device
counter in the state, which the step advances; the learning rate, the
bias corrections, the history slot (written in place), the freeze test,
the snapshot slot and L-BFGS's first step all come from it, and L-BFGS's
memory is rolled, oldest pair first, so its two-loop order is fixed.
:class:`StepLoop` drives the step:

- on the CPU, or with the loops' keyword ``eager=True``, by calling it
  once an iteration;
- on a CUDA tensor, by calling it :data:`N_WARMUP` times on a side stream
  (iterations of the fit, not extra ones: K1 and K2 set their kernels'
  attributes at their first launch, which a capture refuses), capturing
  the next step into one ``torch.cuda.CUDAGraph`` and replaying it for the
  rest of the budget. A replay does not pass the kernels' wrappers, so
  the driver adds to their launch counts what the capture recorded, once
  for each replay after the first. A step that cannot be captured raises;
  nothing falls back to calling it eagerly.

A loop is built, warmed up and captured once a call, except for a
:class:`KeptLoss` (the batched PSF fit's plans, ``core/psf/batched.py``):
the batched optimizers keep its loop, and a later call of the same shapes
and constants rewinds it to the new start in place
(:meth:`StepLoop.rewind`) and replays the graph from its first step.

What breaks a capture is a host round trip inside the step's loss: a read
back (``.item()``, ``float(t)``, ``if t:``, ``.tolist()``, ``nonzero``, a
boolean mask index), a copy from the host (``torch.tensor`` of data, an
index made from a Python list), or a branch on a Python number that
changes between iterations. A fit under a mesh (``parallel/``) whose
loss all-reduces through ``sum_over_group`` is captured the same way when
its process group is NCCL: the all-reduce is one more kernel of the graph,
and the warm-up steps issue every collective of the step first, so each
communicator exists before the capture. Under gloo, which all-reduces
through the host, its steps are called eagerly. One rule decides,
``parallel.distributed.capturable``: its callers pass ``eager=not
capturable(group)``.

AdaBelief is one step for the single and the frame-batched fits:
:func:`run_adabelief_extended` (JAX's ``adabelief_scan_extended``), whose
``stop_at_loss_increase`` and ``n_param_snapshots`` add a freeze of the
parameters and the moments once the loss rises after ``min_iterations``,
and a ring of parameter snapshots; and :func:`run_adabelief_batched`.

Mid-fit checkpoints (JAX's ``run_adabelief_checkpointed``): AdaBelief runs
in segments of ``checkpoint_every`` iterations, and after each the carry
(the flat ``theta``, ``mu``, ``nu``, ``best``, ``best_loss``), the number
of iterations done and the history so far are read back between replays
and written to one ``.npz`` (leaves only, read back with
``allow_pickle=False``). A later call with the same path resumes after the
last completed segment, with the counter at the global iteration index,
so the learning-rate schedule spans the full run and a resumed fit takes
the uninterrupted fit's steps. A file recorded for another budget, other
inputs or another carry, or one that cannot be read, is refused with
:class:`CheckpointMismatch`. The files are the port's own; they need not
read the JAX package's. Under a mesh (``checkpoint_share``,
``parallel/batch.CheckpointShare``) the ranks share one file: global rank
0 writes the carry gathered along the batch axis, reads it, decides
whether to resume and broadcasts its decision and its carry (the ranks
never split, and need no shared disk), and a barrier before the read and
after each write keeps a rank's resume or deletion from racing another's
write.

Frame-batched twins (the JAX package's ``adabelief_scan`` and
``lbfgsb_scan`` under ``jax.vmap``): :func:`run_adabelief_batched` and
:func:`run_lbfgsb_batched` optimize F independent problems at once. The
free tree's leaves carry a leading frame axis, the loss returns the (F,)
vector of per-frame losses, and the gradient of its sum is the per-frame
gradient. Every decision (best loss, line-search acceptance) is a
per-frame mask, so a NaN in one frame changes no other frame.
"""

import hashlib
import os
import time

import numpy as np
import torch

from .params import kwargs_to_numpy
from ..ops import fused_render_cuda, starlet_cuda
from ..parallel.distributed import capturable
from ..utilities.tracing import span

UNCONVERGED_RLD_THRESHOLD = 0.02

# optax.adabelief defaults, as the JAX package uses them
B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-16, 1e-16
LBFGS_MEMORY = 10
N_WARMUP = 3    # steps called on a side stream before a capture
N_CARRY = 5     # the checkpointed leaves: theta, mu, nu, best, best_loss

# the kernels' launch counts a replay adds to
_COUNTED = ((starlet_cuda, ("forward", "adjoint")),
            (fused_render_cuda, ("forward", "backward", "forward_h",
                                 "backward_h")))


def _launch_counts():
    return tuple(getattr(module.launches, field)
                 for module, fields in _COUNTED for field in fields)


def _add_launches(counts, times):
    counts = iter(counts)
    for module, fields in _COUNTED:
        for field in fields:
            setattr(module.launches, field,
                    getattr(module.launches, field) + times * next(counts))


def _copy_into(static, out):
    """Copy the step's outputs into the state's tensors; an output that
    shares storage with a state tensor (the old ``x`` kept as L-BFGS's
    previous point) is cloned first, so no copy reads a tensor already
    overwritten."""
    ptrs = {s.untyped_storage().data_ptr() for s in static}
    out = [o if o is s else (o.clone() if o.untyped_storage().data_ptr()
                             in ptrs else o)
           for s, o in zip(static, out)]
    for s, o in zip(static, out):
        if o is not s:
            s.copy_(o)


class StepLoop:
    """Drives ``state = step(state)`` over a tuple of tensors (module
    docstring): calls on the CPU or with ``eager``, else warm-up calls, one
    capture and replays of a CUDA graph.

    ``eager`` is the keyword it was made with; ``replays`` counts the
    graph's replays (the capture's own run included) and ``recorded``
    holds the K1 and K2 launches the capture recorded (K1 forward,
    adjoint, K2 forward, backward, forward with h, backward with h), None
    before a capture.
    """

    def __init__(self, step, state, *, eager=False):
        self.step = step
        self.state = tuple(state)
        self.device = self.state[0].device
        self.eager = bool(eager)
        self.graphed = self.device.type == "cuda" and not eager
        self.warm = 0
        self.graph = None
        self.recorded = None
        self.replays = 0

    def _call(self, n):
        for _ in range(n):
            self.state = self.step(self.state)

    def run(self, n):
        """Advance the state by ``n`` steps; returns it."""
        n = int(n)
        if not self.graphed:
            self._call(n)
            return self.state
        if self.graph is None and n > 0 and self.warm < N_WARMUP:
            warm = min(n, N_WARMUP - self.warm)
            with span("optimizer.warmup", steps=warm):
                current = torch.cuda.current_stream(self.device)
                side = torch.cuda.Stream(self.device)
                side.wait_stream(current)
                with torch.cuda.stream(side):
                    self._call(warm)
                current.wait_stream(side)
            self.warm += warm
            n -= warm
        if self.graph is None and n > 0:
            self._capture()
            n -= 1
        for _ in range(n):
            self.graph.replay()
        if n > 0:
            self.replays += n
            _add_launches(self.recorded, n)
        return self.state

    def _capture(self):
        """Capture one step into a graph and run it once (its launches
        were counted by the wrappers as the capture recorded them).

        ``torch.cuda.graph`` synchronises the device when it is entered;
        the explicit synchronise before it waits for the same work, so
        the drain span holds the wait for work queued earlier (the
        previous loop, fit or bucket) and the capture span the capture."""
        with span("optimizer.drain"):
            torch.cuda.synchronize(self.device)
        with span("optimizer.capture") as attrs:
            graph = torch.cuda.CUDAGraph()
            before = _launch_counts()
            with torch.cuda.graph(graph):
                _copy_into(self.state, self.step(self.state))
            self.recorded = tuple(b - a for a, b in zip(before,
                                                        _launch_counts()))
            attrs["recorded"] = self.recorded
        self.graph = graph
        graph.replay()
        self.replays += 1

    def rewind(self, start):
        """Restart the loop from ``start``, one tensor a state tensor,
        copied into it in stream order: a captured graph reads and writes
        the state's tensors, so they are never rebound. The graph and the
        warm-up count are kept, so on the card every step of the next
        :meth:`run` after a capture replays the graph. Returns the state."""
        for static, value in zip(self.state, start, strict=True):
            static.copy_(value)
        return self.state


class KeptLoss:
    """A loss whose batched optimizer loop outlives the call.

    :func:`run_lbfgsb_batched` and :func:`run_adabelief_batched` keep the
    loop they build on a ``KeptLoss``. A later call with the same budget,
    step constants and parameter shapes builds none: it copies its bounds
    and its start into the kept loop's tensors (:meth:`StepLoop.rewind`)
    and runs it, so on the card every step replays the graph the first
    call captured. It returns the kept history tensor, which the next call
    overwrites. Whatever else the loss reads, the caller changes by
    writing into the tensors it closes over, never by rebinding them.
    """

    def __init__(self, fn):
        self.fn = fn
        self.kept = None    # (key, loop, value_and_grad, lo, hi, history)

    def __call__(self, free):
        return self.fn(free)


def _batched_loop(loss_fn, key, x, spec, lower, upper, n_iter, build, start):
    """``(loop, history)`` of one batched run from the flat start ``x``:
    the loop a :class:`KeptLoss` kept for ``key``, given this call's
    bounds and rewound to ``start(value_and_grad)``; else
    ``build(value_and_grad, lo, hi, history)``, kept on a KeptLoss."""
    lo, hi = flatten_like(lower, spec), flatten_like(upper, spec)
    kept = loss_fn.kept if isinstance(loss_fn, KeptLoss) else None
    if kept is not None and kept[0] == key:
        _, loop, value_and_grad, kept_lo, kept_hi, history = kept
        kept_lo.copy_(lo)
        kept_hi.copy_(hi)
        loop.rewind(start(value_and_grad))
        return loop, history
    value_and_grad = _value_and_grad_batched(loss_fn, spec)
    history = torch.empty(x.shape[0], n_iter, dtype=x.dtype, device=x.device)
    loop = build(value_and_grad, lo, hi, history)
    if isinstance(loss_fn, KeptLoss):
        loss_fn.kept = (key, loop, value_and_grad, lo, hi, history)
    return loop, history


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


def _adabelief_update(theta, grad, mu, nu, lo, hi, count, lr):
    """One projected AdaBelief step (optax's arithmetic): returns the new
    (theta, mu, nu). ``count`` is the 1-based step and ``lr`` the rate,
    float32 tensors. Elementwise, so it serves any leading frame axis."""
    mu = (1 - B1) * grad + B1 * mu
    pred_err = grad - mu
    nu = (1 - B2) * pred_err**2 + B2 * nu + EPS_ROOT
    mu_hat = mu / (1 - torch.pow(B1, count))
    nu_hat = nu / (1 - torch.pow(B2, count))
    step = -lr * (mu_hat / (torch.sqrt(nu_hat) + EPS))
    return torch.clamp(theta + step, lo, hi), mu, nu


def _adabelief_carry(theta, n_frames=None):
    """A fresh carry (theta, mu, nu, best, best_loss) from the flat start
    ``theta``; ``best_loss`` is one value, or one per frame."""
    shape = () if n_frames is None else (n_frames,)
    return (theta, torch.zeros_like(theta), torch.zeros_like(theta),
            theta.clone(),
            torch.full(shape, float("inf"), dtype=theta.dtype,
                       device=theta.device))


def _value_and_grad(loss_fn, spec):
    """``(value, grad)`` of the loss at the flat ``theta``, detached."""
    def value_and_grad(theta):
        x = theta.detach().requires_grad_(True)
        value = loss_fn(unflatten(x, spec))
        grad, = torch.autograd.grad(value, x)
        return value.detach(), grad
    return value_and_grad


def _adabelief_loop(value_and_grad, carry, lo, hi, history, n_iter,
                    init_learning_rate, schedule_learning_rate, *,
                    eager=False, stop_at_loss_increase=False,
                    min_iterations=0, ring=None, ring_it=None, every=1):
    """A :class:`StepLoop` of projected AdaBelief from ``carry``.

    The state is the carry (theta, mu, nu, best, best_loss), the counter
    and, with ``stop_at_loss_increase``, the previous loss, the stopped
    flag and ``stopped_at``. Each step writes its loss to ``history[...,
    it]`` and, with a ``ring``, the updated parameters to slot ``min(it //
    every, slots - 1)`` when ``it % every == 0`` (their iteration to
    ``ring_it``). The single fit's tensors have no frame axis, the batched
    fit's one leading axis."""
    theta = carry[0]
    dtype, device = theta.dtype, theta.device
    lr0 = torch.full((), float(init_learning_rate), dtype=dtype,
                     device=device)
    span = torch.full((), max(n_iter, 1), dtype=dtype, device=device)

    def step(state):
        theta, mu, nu, best, best_loss, it = state[:6]
        value, grad = value_and_grad(theta)
        history.index_copy_(-1, it.view(1), value[..., None])
        improved = value < best_loss
        best_loss = torch.where(improved, value, best_loss)
        best = torch.where(improved[..., None], theta, best)
        # optax's exponential_decay(lr, n_iter, 0.01) at the 0-based count
        lr = lr0 * torch.pow(0.01, it.to(dtype) / span) \
            if schedule_learning_rate else lr0
        new = _adabelief_update(theta, grad, mu, nu, lo, hi,
                                (it + 1).to(dtype), lr)
        extra = ()
        if stop_at_loss_increase:
            prev_loss, stopped, stopped_at = state[6:]
            rose = (value > prev_loss) & (it >= min_iterations)
            stopped_at = torch.where(rose & ~stopped, it, stopped_at)
            stopped = stopped | rose
            new = tuple(torch.where(stopped[..., None], old, upd)
                        for old, upd in zip((theta, mu, nu), new))
            extra = (value, stopped, stopped_at)
        theta, mu, nu = new
        if ring is not None:
            slot = torch.clamp(it // every, max=ring.shape[0] - 1).view(1)
            take = it % every == 0
            ring.index_copy_(0, slot, torch.where(
                take, theta, ring.index_select(0, slot)[0])[None])
            ring_it.index_copy_(0, slot, torch.where(
                take, it, ring_it.index_select(0, slot)[0])[None])
        return (theta, mu, nu, best, best_loss, it + 1) + extra

    counter = torch.zeros((), dtype=torch.int64, device=device)
    extra = ()
    if stop_at_loss_increase:
        extra = (torch.full_like(carry[4], float("inf")),
                 torch.zeros(carry[4].shape, dtype=torch.bool,
                             device=device),
                 torch.full(carry[4].shape, n_iter, dtype=torch.int64,
                            device=device))
    return StepLoop(step, tuple(carry) + (counter,) + extra, eager=eager)


def run_adabelief(loss_fn, free0, lower, upper, n_iter,
                  init_learning_rate=1e-3, schedule_learning_rate=True, *,
                  eager=False):
    """Projected AdaBelief. ``eager``: call the step on the card too,
    without a graph (a loss that all-reduces over gloo,
    ``parallel.distributed.capturable``).

    Returns:
        (best_free, final_free, loss_history) with loss_history a numpy
        array of n_iter float32 values.
    """
    return run_adabelief_checkpointed(
        loss_fn, free0, lower, upper, n_iter, None,
        init_learning_rate=init_learning_rate,
        schedule_learning_rate=schedule_learning_rate, eager=eager)


def run_adabelief_checkpointed(loss_fn, free0, lower, upper, n_iter,
                               checkpoint_path, init_learning_rate=1e-3,
                               schedule_learning_rate=True,
                               checkpoint_every=500, inputs_digest=None,
                               checkpoint_share=None, *, eager=False):
    """Projected AdaBelief in resumable segments with on-disk checkpoints.

    With ``checkpoint_path`` None it is one segment and writes nothing.
    Otherwise a checkpoint is written after every ``checkpoint_every``
    iterations, and a call that finds one resumes from it (see the module
    docstring); ``inputs_digest`` (:func:`arrays_digest` of the fit's
    inputs) is stored with it and must match on resume;
    ``checkpoint_share`` shares the file between the ranks of a mesh (see
    the module docstring); ``eager`` as :func:`run_adabelief`.

    Returns:
        (best_free, final_free, loss_history[n_iter]) as
        :func:`run_adabelief`.
    """
    return run_adabelief_extended(
        loss_fn, free0, lower, upper, n_iter, init_learning_rate,
        schedule_learning_rate, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, inputs_digest=inputs_digest,
        checkpoint_share=checkpoint_share, eager=eager)[:3]


def run_adabelief_extended(loss_fn, free0, lower, upper, n_iter,
                           init_learning_rate=1e-3,
                           schedule_learning_rate=True,
                           stop_at_loss_increase=False, min_iterations=0,
                           n_param_snapshots=0, checkpoint_path=None,
                           checkpoint_every=500, inputs_digest=None,
                           checkpoint_share=None, *, eager=False):
    """The one projected AdaBelief loop, with the reference's optional
    semantics (JAX's ``adabelief_scan_extended``) as parts of the step
    that are built only when asked for, so without them it is the plain
    loop.

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
    - ``eager`` as :func:`run_adabelief`.

    Returns:
        (best_free, final_free, loss_history[n_iter], stopped_at,
        snapshots, snapshot_iterations): ``stopped_at`` an int;
        ``snapshots`` the free tree with a leading slot axis and
        ``snapshot_iterations`` an int32 array, or both None without
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
    history = torch.empty(n_iter, dtype=theta.dtype, device=theta.device)
    n_snap = min(int(n_param_snapshots), n_iter)
    ring = ring_it = None
    if n_snap:
        ring = theta.new_zeros(n_snap, theta.numel())
        ring_it = torch.zeros(n_snap, dtype=torch.int64,
                              device=theta.device)
    loop = _adabelief_loop(
        _value_and_grad(loss_fn, spec), _adabelief_carry(theta), lo, hi,
        history, n_iter, init_learning_rate, schedule_learning_rate,
        eager=eager, stop_at_loss_increase=bool(stop_at_loss_increase),
        min_iterations=int(min_iterations), ring=ring, ring_it=ring_it,
        every=max(1, n_iter // max(int(n_param_snapshots), 1)))
    theta, _, _, best, _ = run_segments(
        loop, history, n_iter, checkpoint_path, checkpoint_every,
        inputs_digest, checkpoint_share)
    stopped_at = int(loop.state[8]) if stop_at_loss_increase else n_iter
    snapshots = snapshot_iterations = None
    if n_snap:
        snapshots = _free_from(ring, spec, free0, batched=True)
        snapshot_iterations = ring_it.cpu().numpy().astype(np.int32)
    return (_free_from(best, spec, free0), _free_from(theta, spec, free0),
            history.cpu().numpy(), stopped_at, snapshots,
            snapshot_iterations)


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
                          checkpoint_share=None, *, eager=False):
    """Projected AdaBelief over F independent problems.

    ``free0``: tree of (F, ...) tensors; ``lower``/``upper``: trees of the
    per-frame shapes (broadcast over frames); ``loss_fn(tree) -> (F,)``.
    The learning-rate schedule is shared; each frame keeps its moments
    and its best loss. ``checkpoint_path``, ``checkpoint_every`` and
    ``inputs_digest`` checkpoint the per-frame carry as
    :func:`run_adabelief_checkpointed` does (JAX's batched star fit,
    ``_fit_stars_checkpointed``); with no path nothing is written;
    ``checkpoint_share`` shares the file between the ranks of a mesh;
    ``eager`` as :func:`run_adabelief`. A :class:`KeptLoss` keeps its
    loop, and takes no checkpoint.

    Returns:
        (best_free, final_free, loss_history) with the history an (F,
        n_iter) tensor on the device of the parameters.
    """
    if isinstance(loss_fn, KeptLoss) and checkpoint_path is not None:
        # a resume rebinds the state's tensors, which a kept graph reads
        raise ValueError("a KeptLoss's loop is not checkpointed")
    n_iter = int(n_iter)
    theta, spec = flatten_batched(free0)
    theta = theta.detach().clone()
    n_frames = theta.shape[0]
    loop, history = _batched_loop(
        loss_fn, ("adabelief", n_iter, spec, theta.shape,
                  float(init_learning_rate), bool(schedule_learning_rate),
                  eager),
        theta, spec, lower, upper, n_iter,
        lambda value_and_grad, lo, hi, history: _adabelief_loop(
            value_and_grad, _adabelief_carry(theta, n_frames), lo, hi,
            history, n_iter, init_learning_rate, schedule_learning_rate,
            eager=eager),
        lambda value_and_grad: _adabelief_carry(theta, n_frames) + (
            torch.zeros((), dtype=torch.int64, device=theta.device),))
    theta, _, _, best, _ = run_segments(
        loop, history, n_iter, checkpoint_path, checkpoint_every,
        inputs_digest, checkpoint_share)
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


def _lbfgs_loop(value_and_grad, x, lo, hi, history, exact_bounds, eager):
    """A :class:`StepLoop` of projected L-BFGS over the rows of ``x`` (F,
    P), each row its own problem: ``optax.scale_by_lbfgs`` (memory
    :data:`LBFGS_MEMORY`, the initial inverse Hessian scaled by the last
    pair's curvature, or by the capped inverse gradient norm at the first
    step), optax's zoom line search from a unit step
    (:func:`_zoom_linesearch`, :data:`LBFGS_LINESEARCH_STEPS` trials, JAX's
    ``max_linesearch_steps``), then the projection onto the box.

    The state: x, the pair (value, grad) carried from the line search,
    the clipped flags, the previous point and gradient, the memory (rolled:
    the newest pair last, so the two-loop recursion runs oldest first, as
    optax's ring from ``count % memory``), the best point and loss, and the
    counter. With ``exact_bounds`` (JAX's ``lbfgsb_scan`` default) the step
    evaluates at x every iteration and takes that pair where the previous
    step was clipped or the carried value is not finite (optax's
    ``value_and_grad_from_state``; the first step's carried value is
    infinite): ``lax.cond`` as a select, as JAX's vmapped caller pays it,
    so an iteration costs 1 + :data:`LBFGS_LINESEARCH_STEPS` evaluations.
    Without it the pair at the unprojected step is carried, and an
    iteration costs the line search's evaluations (one more at the start).
    Each step writes its loss to ``history[:, it]``."""
    def step(state):
        (x, value, grad, clipped, prev_x, prev_g, dparams, dgrads, rhos,
         best, best_loss, it) = state
        if exact_bounds:
            fresh_value, fresh_grad = value_and_grad(x)
            redo = clipped | ~torch.isfinite(value)
            value = torch.where(redo, fresh_value, value)
            grad = torch.where(redo[:, None], fresh_grad, grad)
        history.index_copy_(1, it.view(1), value[:, None])
        improved = value < best_loss
        best_loss = torch.where(improved, value, best_loss)
        best = torch.where(improved[:, None], x, best)
        # the pair of the last step; none at the first (optax's count 0)
        later = it > 0
        dp = torch.where(later, x - prev_x, torch.zeros_like(x))
        dg = torch.where(later, grad - prev_g, torch.zeros_like(x))
        curv = (dg * dp).sum(-1)
        rho = torch.where(curv == 0.0, torch.zeros_like(curv), 1.0 / curv)
        norm2 = (dg * dg).sum(-1)
        gamma = torch.where(norm2 > 0.0, curv / norm2,
                            torch.ones_like(curv))
        gamma = torch.where(later, gamma,
                            torch.clamp(1.0 / grad.norm(dim=-1), max=1.0))
        dparams = torch.cat((dparams[:, 1:], dp[:, None]), dim=1)
        dgrads = torch.cat((dgrads[:, 1:], dg[:, None]), dim=1)
        rhos = torch.cat((rhos[:, 1:], rho[:, None]), dim=1)
        # two-loop recursion, oldest pair first
        q, alphas = grad, [None] * LBFGS_MEMORY
        for k in reversed(range(LBFGS_MEMORY)):
            alphas[k] = rhos[:, k] * (dparams[:, k] * q).sum(-1)
            q = q - alphas[k][:, None] * dgrads[:, k]
        q = gamma[:, None] * q
        for k in range(LBFGS_MEMORY):
            beta = rhos[:, k] * (dgrads[:, k] * q).sum(-1)
            q = q + (alphas[k] - beta)[:, None] * dparams[:, k]
        t, new_value, new_grad = _zoom_linesearch(
            value_and_grad, x, value, grad, -q, LBFGS_LINESEARCH_STEPS)
        raw = x - t[:, None] * q
        new_x = torch.clamp(raw, lo, hi)
        return (new_x, new_value, new_grad, (raw != new_x).any(-1), x, grad,
                dparams, dgrads, rhos, best, best_loss, it + 1)

    return StepLoop(step, _lbfgs_start(value_and_grad, x, exact_bounds),
                    eager=eager)


def _lbfgs_start(value_and_grad, x, exact_bounds):
    """The state of :func:`_lbfgs_loop` at its start ``x`` (F, P): without
    ``exact_bounds`` it holds the value and gradient at ``x``, else an
    infinite value, which the first step replaces."""
    n_frames, n_par = x.shape
    memory = x.new_zeros(n_frames, LBFGS_MEMORY, n_par)
    inf = torch.full((n_frames,), float("inf"), dtype=x.dtype,
                     device=x.device)
    if exact_bounds:
        value, grad = inf.clone(), torch.zeros_like(x)
    else:
        value, grad = value_and_grad(x)
    clipped = torch.zeros(n_frames, dtype=torch.bool, device=x.device)
    return (x, value, grad, clipped, torch.zeros_like(x),
            torch.zeros_like(x), memory, memory.clone(),
            x.new_zeros(n_frames, LBFGS_MEMORY), x.clone(), inf.clone(),
            torch.zeros((), dtype=torch.int64, device=x.device))


def run_lbfgsb(loss_fn, free0, lower, upper, n_iter, *, eager=False):
    """Projected L-BFGS, JAX's ``lbfgsb_scan`` with ``exact_bounds=True``:
    the step of :func:`run_lbfgsb_batched` on one problem, which after a
    clipped step takes the value and gradient again at the projected point
    (:func:`_lbfgs_loop`). ``eager`` as :func:`run_adabelief`.

    Returns:
        (best_free, final_free, loss_history[n_iter]), the history a numpy
        array.
    """
    n_iter = int(n_iter)
    theta, spec = flatten(free0)
    lo, hi = flatten_like(lower, spec), flatten_like(upper, spec)
    single = _value_and_grad(loss_fn, spec)

    def value_and_grad(vec):
        value, grad = single(vec[0])
        return value.reshape(1), grad[None]

    history = torch.empty(1, n_iter, dtype=theta.dtype, device=theta.device)
    loop = _lbfgs_loop(value_and_grad, theta.detach().clone()[None], lo, hi,
                       history, True, eager)
    loop.run(n_iter)
    x, best = loop.state[0], loop.state[9]
    return (_free_from(best[0], spec, free0), _free_from(x[0], spec, free0),
            history[0].cpu().numpy())


def run_lbfgsb_batched(loss_fn, free0, lower, upper, n_iter, *,
                       eager=False):
    """Projected L-BFGS over F independent problems, as ``lbfgsb_scan``
    behaves under ``jax.vmap`` with ``exact_bounds=False``: per frame,
    :func:`_lbfgs_loop`'s step, carrying the line search's value and
    gradient at the unprojected step into the next iteration. Arguments
    and returns as :func:`run_adabelief_batched`. Each iteration costs
    :data:`LBFGS_LINESEARCH_STEPS` evaluations of all frames (one more at
    the start). A :class:`KeptLoss` keeps its loop.
    """
    n_iter = int(n_iter)
    x, spec = flatten_batched(free0)
    x = x.detach().clone()
    loop, history = _batched_loop(
        loss_fn, ("lbfgsb", n_iter, spec, x.shape, eager), x, spec, lower,
        upper, n_iter,
        lambda value_and_grad, lo, hi, history: _lbfgs_loop(
            value_and_grad, x, lo, hi, history, False, eager),
        lambda value_and_grad: _lbfgs_start(value_and_grad, x, False))
    loop.run(n_iter)
    x, best = loop.state[0], loop.state[9]
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
    status, done = share.broadcast(
        torch.tensor([status, done], dtype=torch.int64)).tolist()
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


def run_segments(loop, history, n_iter, checkpoint_path, checkpoint_every,
                 inputs_digest, share=None):
    """Run ``loop`` (a :class:`StepLoop` whose state starts with the
    :data:`N_CARRY` carry leaves and the iteration counter) for ``n_iter``
    steps and return its carry: in one segment without a path; else
    resume from the checkpoint at ``checkpoint_path`` if there is one (its
    carry and counter go into the state, its history to ``history[...,
    :done]``) and write one after every ``checkpoint_every`` iterations,
    reading the carry back between replays. ``share`` (a
    ``parallel.batch.CheckpointShare``) shares the file between ranks."""
    if checkpoint_path is None:
        return loop.run(n_iter)[:N_CARRY]
    every = int(checkpoint_every)
    if every <= 0:
        raise ValueError(
            f"checkpoint_every must be positive, got {checkpoint_every} "
            "(a non-positive segment length would loop forever)")

    def whole(x):
        return x if share is None else share.full(x)

    done = 0
    resumed = _resume(checkpoint_path, loop.state[:N_CARRY], history, n_iter,
                      inputs_digest, share)
    if resumed is not None:
        carry, done, stored = resumed
        counter = torch.full((), done, dtype=torch.int64, device=loop.device)
        loop.state = tuple(carry) + (counter,) + loop.state[N_CARRY + 1:]
        history[..., :done] = stored[..., :done]
    while done < n_iter:
        stop = min(done + every, n_iter)
        loop.run(stop - done)
        done = stop
        written = tuple(whole(x) for x in loop.state[:N_CARRY])
        written_history = whole(history[..., :done])
        if share is None or share.is_writer:
            save_checkpoint(checkpoint_path, written, n_iter, done,
                            written_history, inputs_digest=inputs_digest)
        if share is not None:
            share.barrier()
    return loop.state[:N_CARRY]


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
        On the card the steps replay a CUDA graph, unless the loss
        all-reduces over a gloo group (``parallel.distributed.capturable``
        of the loss's ``group``): then they are called eagerly (``eager``
        of the loops). ``progress_bar`` is accepted and unused.
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
        eager = not capturable(getattr(self.loss, "group", None))
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
                    checkpoint_share=checkpoint_share, eager=eager)
            if extended:
                extra["stopped_at"] = stopped_at
            if return_param_history:
                extra["param_history"] = kwargs_to_numpy(snaps)
                extra["param_history_iterations"] = snap_iters
        else:
            best, _, hist = run_lbfgsb(self.loss.loss_fn, free0, p.lower,
                                       p.upper, n_iter, eager=eager)
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
