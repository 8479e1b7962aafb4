"""K2's share of its roofline over the traced fits, in %: the least time of
every K2 launch (``benchmark/work.py``, at the rank's shapes; the launches
with and without the background told apart by the program's counters)
over the device time of K2's kernels, by name."""

from benchmark.work import k2_bound_s

KERNELS = ("k2_forward_rows", "k2_backward_slab", "sum_middle")


def read(summary, shapes):
    launches, seconds = summary.kernels(*KERNELS)
    c = summary.counters
    if not launches or not seconds or not c["k2_forward"]:
        return None
    k2 = shapes["k2"]
    bound = sum(count * k2_bound_s(**k2, backward=backward,
                                   include_h=include_h)
                for count, backward, include_h in (
                    (c["k2_forward"] - c["k2_forward_h"], False, False),
                    (c["k2_forward_h"], False, True),
                    (c["k2_backward"] - c["k2_backward_h"], True, False),
                    (c["k2_backward_h"], True, True)))
    return 100.0 * bound / seconds
