"""The work of the two hand-written kernels, and the card's peaks.

Frozen copies of the operation and byte counts of K1 (the starlet cascade)
and K2 (the fused render), taken from the shapes of a call. They belong to
the benchmark and not to the program, so a later implementation of either
kernel is measured against the same work:

- bytes: each operand read once and each result written once;
- K2's DFT products counted once, against the dense TF32 tensor peak: no
  float32-accurate implementation on this card does them faster (one pass
  of TF32 is not float32-accurate, three passes take three times as long);
- the remaining operations against the float32 peak outside the tensor
  cores.

The least time of a call is the largest of those three times.
"""

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12


def k2_work(N, C, L, Lh, n, backward, include_h, n_groups=None):
    """``(bytes, products, rest)`` of one K2 call on N epochs: C = 2M
    stacked source ramps, the k axis L, its half Lh = L // 2 + 1, stamps
    of n pixels; with ``include_h`` the background, ``n_groups`` planes
    (None: one shared plane), read by the forward and written back as its
    gradient by the backward."""
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


def k2_bound_s(N, C, L, Lh, n, backward, include_h, n_groups=None):
    """The least time of one K2 call, in seconds."""
    n_bytes, products, rest = k2_work(N, C, L, Lh, n, backward, include_h,
                                      n_groups)
    return max(n_bytes / HBM_BYTES_PER_S, products / TF32_FLOPS,
               rest / FP32_FLOPS)


def k1_work(m, batch, n_scales):
    """``(bytes, flops)`` of one K1 call, forward or adjoint, on ``batch``
    images of side ``m``: one plane in and n_scales + 1 out (or back);
    per level two 5-tap passes and a difference, 21 operations a pixel."""
    return (4 * batch * m * m * (n_scales + 2),
            21 * n_scales * batch * m * m)


def k1_bound_s(m, batch, n_scales):
    """The least time of one K1 call, in seconds."""
    n_bytes, flops = k1_work(m, batch, n_scales)
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
