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
and slice the gradients back. The counts in :data:`launches` grow by one
per call that launches the kernels and nowhere else.

Numbers: kernel times in PERF.md were taken on an NVIDIA H100 and carry
the card's name and power limit; no TPU figure applies here.
"""

import ctypes
import threading

import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "fused_render.cu"
MAX_EPOCHS = 65535   # the epoch axis is the grid's y dimension
K_STEP = 8           # the kernels take the k axis in steps of 8
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
            lib.k2_forward.argtypes = [ptr] * 15 + [i32] * 6 + [ptr]
            lib.k2_backward.argtypes = [ptr] * 18 + [i32] * 6 + [ptr]
            for fn in (lib.k2_forward, lib.k2_backward):
                fn.restype = i32
            for name, args in (("k2_tile_width", []),
                               ("k2_smem_optin", [i32]),
                               ("k2_smem_bytes", [i32] * 5)):
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


def _shapes(N, C, L, Lh, n):
    return {"u_re": (N, C, L), "u_im": (N, C, L), "v": (N, C, Lh),
            "t_re": (N, L, Lh), "t_im": (N, L, Lh), "r_hat": (L, Lh),
            "pc": (L, Lh), "ps": (L, Lh), "h_re": (L, Lh), "h_im": (L, Lh),
            "ayp": (n, L), "byp": (n, L), "cxp": (Lh, n), "sxp": (Lh, n),
            "g": (N, n, n)}


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


def _prepare(what, backward, device, N, C, L, Lh, n):
    """The library, after the limits of the geometry are checked; L is
    the padded length, a multiple of :data:`K_STEP`."""
    if not 0 < N <= MAX_EPOCHS:
        raise ValueError(f"{what}: {N} epochs, expected 1 to {MAX_EPOCHS}")
    lib = _load()
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _smem_optin:
        _smem_optin[index] = lib.k2_smem_optin(index)
    need = lib.k2_smem_bytes(int(backward), C, L, Lh, n)
    if need < 0:
        raise ValueError(f"{what}: no kernel instance for L={L}: the half "
                         "axis is wider than the forward's register tiles")
    if need > _smem_optin[index]:
        raise ValueError(f"{what}: 2M={C}, L={L}, n={n} need {need} bytes "
                         f"of shared memory, the card allows "
                         f"{_smem_optin[index]}")
    return lib


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
    shapes = _shapes(N, C, L, Lh, n)
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
    lib = _prepare(what, False, u_re.device, N, C, L, Lh, n)
    out = torch.empty(N, n, n, device=u_re.device, dtype=torch.float32)
    with torch.cuda.device(u_re.device):
        stream = torch.cuda.current_stream(u_re.device).cuda_stream
        rc = lib.k2_forward(*(_ptr(x) for x in (*ops, out)),
                            N, C, L, Lh, n, int(bool(include_h)), stream)
    _raise_on(lib, rc, what)
    launches.forward += 1
    launches.forward_h += int(bool(include_h))
    return out


def backward(g, u_re, u_im, v, t_re, t_im, r_hat, pc, ps, ayp, byp, cxp,
             sxp, include_h=True):
    """K2 backward on the card: ``(du_re, du_im, dv, dh_re, dh_im)``, the
    h terms None without ``include_h``. Every sum, dh's over epochs
    included, is taken in a fixed order: no atomics."""
    what = "fused_render backward"
    N, C, L, Lh, n = _geometry(what, u_re, v, ayp)
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
    if ops[8].data_ptr() % 16 or ops[9].data_ptr() % 16:
        raise ValueError(f"{what}: Ayp and Byp must start 16-byte aligned "
                         "(the kernel reads them as float4)")
    lib = _prepare(what, True, u_re.device, N, C, L, Lh, n)
    dev = dict(device=u_re.device, dtype=torch.float32)
    du = torch.empty(2, N, C, L, **dev)
    dv = torch.empty(N, C, Lh, **dev)
    dh = torch.empty(2, L, Lh, **dev) if include_h else None
    n_tiles = -(-Lh // lib.k2_tile_width())
    du_part = torch.empty(2, N, n_tiles, C, L, **dev)
    dh_part = torch.empty(2, N, L, Lh, **dev) if include_h else None
    with torch.cuda.device(u_re.device):
        stream = torch.cuda.current_stream(u_re.device).cuda_stream
        rc = lib.k2_backward(
            *(_ptr(x) for x in (g, *ops, du_part, du, dv, dh_part, dh)),
            N, C, L, Lh, n, int(bool(include_h)), stream)
    _raise_on(lib, rc, what)
    launches.backward += 1
    launches.backward_h += int(bool(include_h))
    du = du[..., :L0]
    return du[0], du[1], dv, *((dh[0, :L0], dh[1, :L0]) if include_h
                               else (None, None))
