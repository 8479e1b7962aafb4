"""K1 and K2 as units of work in a cost count.

``utilities/benchmarking.compiled_cost`` counts the bytes and FLOPs of a
call from the aten ops it dispatches. The card's kernels are ctypes
launches that no dispatch sees, and on the CPU their plain twins
dispatch many small ops. So the autograd functions of ``starlet_op`` and
``fused_render`` run each direction through :func:`charged`: inside a
count, the call is charged as one unit, its work from the kernel's
formula (``starlet_cuda.work``, ``fused_render_cuda.work``), and the
aten ops of its body are not counted. The card and the CPU then give the
same count. Outside a count, :func:`charged` is the plain call.
"""

# the open counts, innermost last (utilities/benchmarking._CostCount)
COUNTS = []


def charged(work, fn, *args):
    """``fn(*args)``; inside a count, charged as one unit of ``work()``,
    a pair (bytes, FLOPs), with the aten ops of the call left out."""
    if not COUNTS:
        return fn(*args)
    count = COUNTS[-1]
    count.charge(*work())
    count.muted += 1
    try:
        return fn(*args)
    finally:
        count.muted -= 1
