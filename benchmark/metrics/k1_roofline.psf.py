"""K1's share of its roofline over the traced buckets, in %: the least
time of every K1 launch in the trace (``benchmark/work.py``, at the
pixel phase's shape: a bucket's frames, the fine grid, its scales) over
the device time of K1's kernels, by name."""

from benchmark.work import k1_bound_s

KERNELS = ("starlet_bands",)


def read(summary, shapes):
    launches, seconds = summary.kernels(*KERNELS)
    if not launches or not seconds:
        return None
    return 100.0 * launches * k1_bound_s(**shapes["k1"]) / seconds
