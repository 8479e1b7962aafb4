"""Build, bind and launch the CUDA K2 kernels (``csrc/fused_render.cu``).

Replaces the Pallas TPU kernel
``lightcurver_tpu/ops/experimental/fused_render.py`` (``_fwd_kernel``,
launched by ``_fused_render_fwd_impl``) and adds the backward that the
JAX package never built. The operands are those of the TPU kernel; see
``ops/fused_render.py`` for what is computed, and for the plain twins
that serve a CPU tensor.

The library is compiled by ``nvcc`` at first use through
``ops/cuda_build.py`` and loaded with ctypes. Nothing is compiled or
loaded when this module is imported. :func:`forward` and
:func:`backward` take CUDA tensors only: they check dtype, device,
contiguity and every shape against the contract, and raise on what the
kernels do not take, before anything is launched. The kernels take the
k axis (L) in steps of 8; where L is not a multiple of 8 (an odd stamp at
s = 2 gives L = 4 mod 8) the wrappers pad it with zeros (:func:`pad_k`)
and slice the gradients back. The backward splits the half axis into
slabs by :func:`backward_slabs`, a plain function of the shapes and the
card's shared memory. The background planes h_re, h_im are one (L, Lh)
plane for every epoch, or (G, L, Lh), one per group of N / G consecutive
epochs (the star photometry's per-star background); dh comes back in the
same layout, each plane summed over its group. The counts in
:data:`launches` grow by one per call that launches the kernels and
nowhere else.

Numbers: kernel times in PERF.md were taken on an NVIDIA H100 and carry
the card's name and power limit; no TPU figure applies here.
"""

import ctypes
import threading
from typing import NamedTuple

import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "fused_render.cu"
MAX_EPOCHS = 65535   # the epoch axis is the grid's y dimension
K_STEP = 8           # the kernels take the k axis in steps of 8
# the backward's geometry, as csrc/fused_render.cu has it
BWD_CHUNK = 32       # kBwdChunk: rows of k per chunk
MAX_SLAB = 160       # kMaxSlab: columns of a slab (its register tiles)
# the axis of each forward operand (in the forward's order) that runs
# over k, None for those without one
_K_AXIS = (-1, -1, None, -2, -2, -2, -2, -2, -2, -2, -1, -1, None, None)


class LaunchCounts:
    """Launches since the last :meth:`reset`: all of them, and those with
    the background channel (``include_h``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.forward = 0
        self.backward = 0
        self.forward_h = 0
        self.backward_h = 0


launches = LaunchCounts()

_lib = None
_smem_optin = {}
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(cuda_build.build(SOURCE)))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.k2_forward.argtypes = [ptr] * 15 + [i32] * 7 + [ptr]
            lib.k2_backward.argtypes = [ptr] * 18 + [i32] * 8 + [ptr]
            for fn in (lib.k2_forward, lib.k2_backward):
                fn.restype = i32
            for name, args in (("k2_smem_optin", [i32]),
                               ("k2_smem_bytes", [i32] * 6)):
                getattr(lib, name).argtypes = args
                getattr(lib, name).restype = i32
            lib.k2_error_string.argtypes = [i32]
            lib.k2_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _geometry(what, u_re, v, ayp):
    if u_re.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {u_re.device}")
    if u_re.dim() != 3 or v.dim() != 3 or ayp.dim() != 2:
        raise ValueError(f"{what}: u (N, 2M, L), v (N, 2M, Lh) and "
                         "Ayp (n, L) expected")
    N, C, L = u_re.shape
    Lh, n = v.shape[-1], ayp.shape[0]
    if Lh != L // 2 + 1 or n > L:
        raise ValueError(f"{what}: Lh={Lh} must be L//2+1 for L={L}, and "
                         f"n={n} at most L")
    return N, C, L, Lh, n


def _check(what, device, operands):
    for name, (x, shape) in operands.items():
        if x.device != device:
            raise ValueError(f"{what}: {name} on {x.device}, not {device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{what}: {name} float32 expected, got "
                            f"{x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{what}: {name} of shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name}: contiguous tensor expected")


def _shapes(N, C, L, Lh, n, n_groups=None):
    h = (L, Lh) if n_groups is None else (n_groups, L, Lh)
    return {"u_re": (N, C, L), "u_im": (N, C, L), "v": (N, C, Lh),
            "t_re": (N, L, Lh), "t_im": (N, L, Lh), "r_hat": (L, Lh),
            "pc": (L, Lh), "ps": (L, Lh), "h_re": h, "h_im": h,
            "ayp": (n, L), "byp": (n, L), "cxp": (Lh, n), "sxp": (Lh, n),
            "g": (N, n, n)}


def work(N, C, L, Lh, n, backward, include_h, n_groups=None):
    """``(bytes, products, rest)`` of one call on N epochs (2M = C, k axis
    L, half axis Lh, stamps n): bytes with each operand read once and
    each result written once; FLOPs split into the products the tensor
    cores can take (the two DFT stages) and the rest (the rank-1
    spectrum and the elementwise terms). With ``include_h`` the
    background is ``n_groups`` planes (one shared plane for None), read
    by the forward and written as dh by the backward. The count of
    ``utilities/benchmarking.compiled_cost`` and the bounds of
    ``chip_smoke.py``."""
    plane = L * Lh
    G = n_groups or 1
    consts = (3 + 2 * G * (not backward)) if include_h else 1
    floats = (2 * N * C * L + N * C * Lh + 2 * N * plane + consts * plane
              + 2 * n * L + 2 * Lh * n + N * n * n)
    if backward:   # du, dv and dh out
        floats += 2 * N * C * L + N * C * Lh + 2 * G * plane * include_h
    products = 2 * N * (4 * n * plane + 2 * n * n * Lh)
    rank1 = (2 if backward else 1) * 2 * N * 2 * C * plane
    rest = rank1 + N * plane * (8 + 14 * include_h)
    return 4 * floats, products, rest


def operand_work(u_re, v, ayp, backward, include_h, n_groups):
    """:func:`work` at the shapes of K2's operands u_re (N, 2M, L),
    v (N, 2M, Lh) and ayp (n, L), with ``n_groups`` as :func:`h_groups`
    gives it for the forward's h."""
    return work(*u_re.shape, v.shape[-1], ayp.shape[0], backward,
                include_h, n_groups)


def h_groups(h_re, n_epochs):
    """G of a background plane stack: None for one (L, Lh) plane shared
    by every epoch, else the leading extent of (G, L, Lh), which must
    divide ``n_epochs``."""
    if h_re is None or h_re.dim() == 2:
        return None
    G = h_re.shape[0]
    if h_re.dim() != 3 or G < 1 or n_epochs % G:
        raise ValueError(f"fused_render: h of shape {tuple(h_re.shape)}: "
                         f"(L, Lh) or (G, L, Lh) with G dividing the "
                         f"{n_epochs} epochs expected")
    return G


def pad_k(ops):
    """The forward's 14 operands with the k axis padded with zeros to a
    multiple of :data:`K_STEP`: zero columns of u_re, u_im, Ayp, Byp and
    zero rows of the (L, Lh) planes and of t_re, t_im. The render and the
    gradients of the first L rows of k are the same sums. Operands that
    are None stay None; nothing is copied where L is a multiple already."""
    pad = -ops[0].shape[-1] % K_STEP
    if not pad:
        return tuple(ops)
    return tuple(
        x if x is None or axis is None else torch.nn.functional.pad(
            x, (0, pad) if axis == -1 else (0, 0, 0, pad))
        for x, axis in zip(ops, _K_AXIS))


def slab_width(Lh, n_slabs):
    """Columns of the widest of ``n_slabs`` slabs over the half axis Lh
    padded to a multiple of 8 (runs of 8 columns shared out evenly)."""
    units = -(-Lh // 8)
    return 8 * -(-units // n_slabs)


def backward_smem_bytes(C, n, width):
    """Shared memory of one backward block whose slabs are at most
    ``width`` columns wide, in bytes (``bwd_geom`` in the source): v and
    dv's running sums (width, C rounded up to 4) and dA, dB (n rounded up
    to 16, a stride of 8 mod 16), then the larger of phase A (G and the
    slab's rows of Cxp, Sxp) and phase B (a chunk's columns of Ayp, Byp
    and u, and its dX)."""
    ny, c4 = -(-n // 16) * 16, -(-C // 4) * 4
    gs, ds = ny + 4, width if width % 16 == 8 else width + 8
    phase_a = ny * gs + 2 * width * gs
    kc = BWD_CHUNK
    phase_b = 2 * ny * (kc + 8) + 2 * kc * c4 + 2 * kc * ds
    return 4 * (2 * width * c4 + 2 * ny * ds + max(phase_a, phase_b))


def backward_slabs(C, Lh, n, smem_limit):
    """Slabs of the half axis for the backward: the fewest whose widest
    fits ``smem_limit`` bytes of shared memory and the register tiles
    (:data:`MAX_SLAB` columns), so one slab where the whole padded half
    axis fits (ROI-100, the production stamp); None where even slabs of 8
    columns do not fit."""
    units = -(-Lh // 8)
    for n_slabs in range(1, units + 1):
        width = slab_width(Lh, n_slabs)
        if width <= MAX_SLAB and \
                backward_smem_bytes(C, n, width) <= smem_limit:
            return n_slabs
    return None


class BackwardPlan(NamedTuple):
    """How :func:`backward` runs at some shapes: its slabs, its kernel
    launches (the backward, then ``sum_middle`` for du with more than one
    slab and for dh with h) and the bytes of its scratch (du_part with
    more than one slab, dh_part with h)."""
    n_slabs: int
    launches: int
    scratch_bytes: int


def backward_plan(N, C, L, Lh, n, include_h, smem_limit):
    """:class:`BackwardPlan` at these shapes (L padded to a multiple of
    :data:`K_STEP`), or None where no slab fits ``smem_limit``."""
    n_slabs = backward_slabs(C, Lh, n, smem_limit)
    if n_slabs is None:
        return None
    du_part = 2 * N * n_slabs * C * L if n_slabs > 1 else 0
    dh_part = 2 * N * L * Lh if include_h else 0
    return BackwardPlan(n_slabs, 1 + (n_slabs > 1) + bool(include_h),
                        4 * (du_part + dh_part))


def smem_optin(device):
    """Shared memory a block may opt in to on ``device``, in bytes."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _smem_optin:
        _smem_optin[index] = _load().k2_smem_optin(index)
    return _smem_optin[index]


def _prepare(what, device, N):
    """The library and the card's shared-memory opt-in, after the epoch
    count is checked."""
    if not 0 < N <= MAX_EPOCHS:
        raise ValueError(f"{what}: {N} epochs, expected 1 to {MAX_EPOCHS}")
    return _load(), smem_optin(device)


def _ptr(x):
    return None if x is None else x.data_ptr()


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.k2_error_string(rc).decode()} ({rc})")


def forward(u_re, u_im, v, t_re, t_im, r_hat, pc, ps, h_re, h_im,
            ayp, byp, cxp, sxp, include_h=True):
    """K2 forward on the card: (N, n, n); h may be None without
    ``include_h``. One launch writes the output whole (3xTF32 products on
    the tensor cores, float32 accuracy), with no scratch and no atomics."""
    what = "fused_render forward"
    N, C, L, Lh, n = _geometry(what, u_re, v, ayp)
    n_groups = h_groups(h_re, N) if include_h else None
    shapes = _shapes(N, C, L, Lh, n, n_groups)
    named = dict(u_re=u_re, u_im=u_im, v=v, t_re=t_re, t_im=t_im,
                 r_hat=r_hat, pc=pc, ps=ps, ayp=ayp, byp=byp, cxp=cxp,
                 sxp=sxp)
    if include_h:
        named.update(h_re=h_re, h_im=h_im)
    _check(what, u_re.device, {k: (x, shapes[k]) for k, x in named.items()})
    ops = pad_k((u_re, u_im, v, t_re, t_im, r_hat, pc, ps,
                 h_re if include_h else None, h_im if include_h else None,
                 ayp, byp, cxp, sxp))
    L = ops[0].shape[-1]
    lib, optin = _prepare(what, u_re.device, N)
    need = lib.k2_smem_bytes(0, C, L, Lh, n, 0)
    if need < 0:
        raise ValueError(f"{what}: no kernel instance for L={L}: the half "
                         "axis is wider than the forward's register tiles")
    if need > optin:
        raise ValueError(f"{what}: 2M={C}, L={L}, n={n} need {need} bytes "
                         f"of shared memory, the card allows {optin}")
    out = torch.empty(N, n, n, device=u_re.device, dtype=torch.float32)
    with torch.cuda.device(u_re.device):
        stream = torch.cuda.current_stream(u_re.device).cuda_stream
        rc = lib.k2_forward(*(_ptr(x) for x in (*ops, out)),
                            N, C, L, Lh, n, int(bool(include_h)),
                            n_groups or 1, stream)
    _raise_on(lib, rc, what)
    launches.forward += 1
    launches.forward_h += int(bool(include_h))
    return out


def backward(g, u_re, u_im, v, t_re, t_im, r_hat, pc, ps, ayp, byp, cxp,
             sxp, include_h=True, n_groups=None):
    """K2 backward on the card: ``(du_re, du_im, dv, dh_re, dh_im)``, the
    h terms None without ``include_h``, else (L, Lh) each, or (G, L, Lh)
    with ``n_groups`` G (:func:`h_groups` of the forward's h). One launch
    of the slab kernel (3xTF32 products on the tensor cores), plus
    ``sum_middle`` for du where the half axis takes more than one slab
    and for dh with h (:func:`backward_plan`). Every sum, dh's over epochs
    included, is taken in a fixed order: no atomics."""
    what = "fused_render backward"
    N, C, L, Lh, n = _geometry(what, u_re, v, ayp)
    if n_groups is not None and (n_groups < 1 or N % n_groups):
        raise ValueError(f"{what}: n_groups={n_groups} does not divide the "
                         f"{N} epochs")
    shapes = _shapes(N, C, L, Lh, n)
    named = dict(g=g, u_re=u_re, u_im=u_im, v=v, t_re=t_re, t_im=t_im,
                 r_hat=r_hat, pc=pc, ps=ps, ayp=ayp, byp=byp, cxp=cxp,
                 sxp=sxp)
    _check(what, u_re.device, {k: (x, shapes[k]) for k, x in named.items()})
    L0 = L
    ops = pad_k((u_re, u_im, v, t_re, t_im, r_hat, pc, ps, None, None,
                 ayp, byp, cxp, sxp))
    ops = (*ops[:8], *ops[10:])   # all but h_re, h_im
    L = ops[0].shape[-1]
    lib, optin = _prepare(what, u_re.device, N)
    plan = backward_plan(N, C, L, Lh, n, include_h, optin)
    if plan is None:
        raise ValueError(f"{what}: 2M={C}, n={n} need more shared memory "
                         f"than the card allows ({optin} bytes) even in "
                         "slabs of 8 columns")
    n_slabs = plan.n_slabs
    dev = dict(device=u_re.device, dtype=torch.float32)
    du = torch.empty(2, N, C, L, **dev)
    dv = torch.empty(N, C, Lh, **dev)
    G = n_groups or 1
    dh = torch.empty(2, G, L, Lh, **dev) if include_h else None
    du_part = torch.empty(2, N, n_slabs, C, L, **dev) if n_slabs > 1 \
        else None
    dh_part = torch.empty(2, N, L, Lh, **dev) if include_h else None
    with torch.cuda.device(u_re.device):
        stream = torch.cuda.current_stream(u_re.device).cuda_stream
        rc = lib.k2_backward(
            *(_ptr(x) for x in (g, *ops, du_part, du, dv, dh_part, dh)),
            N, C, L, Lh, n, int(bool(include_h)), n_slabs, G, stream)
    _raise_on(lib, rc, what)
    launches.backward += 1
    launches.backward_h += int(bool(include_h))
    du = du[..., :L0]
    if not include_h:
        return du[0], du[1], dv, None, None
    dh = dh[:, :, :L0]
    if n_groups is None:
        dh = dh[:, 0]
    return du[0], du[1], dv, dh[0], dh[1]
