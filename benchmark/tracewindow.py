"""One ``torch.profiler`` window over the first units of a traced run, and
its reduction to what the per-layer metrics read.

The window starts before the first unit (a fit, or a bucket's dispatch)
and stops once unit ``k - 1`` has been collected on the host, after a
synchronise. The reduction keeps, per device operation name, its count
and its seconds; the device's busy time (the union of every operation's
interval on the card); the window's length (first to last event); the
longest idle gaps, each named by the innermost host operation under its
middle; and the program's launch counters over the same units.
"""

import time

import torch


def program_counts():
    """The program's K1 and K2 launch counters (graph replays included):
    ``launch_counts()`` and K2's launches with the background channel."""
    from lightcurver_tpu_torch.ops import fused_render_cuda
    from lightcurver_tpu_torch.utilities.benchmarking import launch_counts

    k1f, k1a, k2f, k2b = launch_counts()
    return {"k1_forward": k1f, "k1_adjoint": k1a, "k2_forward": k2f,
            "k2_backward": k2b,
            "k2_forward_h": fused_render_cuda.launches.forward_h,
            "k2_backward_h": fused_render_cuda.launches.backward_h}


class Summary:
    """What the metrics read from one traced window."""

    def __init__(self, ops, busy_s, window_s, gaps, counters, units):
        self.ops = ops              # name -> [count, seconds]
        self.busy_s = busy_s
        self.window_s = window_s
        self.gaps = gaps            # [[host op, seconds]], longest first
        self.counters = counters    # launch counters over the window
        self.units = units

    def kernels(self, *names):
        """(launches, seconds) of the device operations named any of
        ``names``, by :func:`function_name`."""
        n = t = 0
        for name, (count, seconds) in self.ops.items():
            if function_name(name) in names:
                n += count
                t += seconds
        return n, t


def function_name(signature):
    """A kernel's function name without its return type, namespaces,
    template arguments and parameters: ``void (anonymous
    namespace)::k2_backward_slab<32>(float const*, ...)`` gives
    ``k2_backward_slab``."""
    name = signature.removeprefix("void ").replace("(anonymous namespace)::",
                                                  "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def _events(prof):
    """(device intervals [(start, end, name)], host intervals) in ns."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.end_ns()
        if end <= start:
            continue
        kind = str(e.device_type())
        if kind.endswith("CUDA"):
            device.append((start, end, e.name()))
        elif kind.endswith("CPU"):
            host.append((start, end, e.name()))
    return device, host


def reduce(prof, counters, units, n_gaps=10):
    """A :class:`Summary` of a stopped profiler."""
    device, host = _events(prof)
    ops = {}
    for start, end, name in device:
        entry = ops.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (end - start) * 1e-9
    every = device + host
    lo = min((e[0] for e in every), default=0)
    hi = max((e[1] for e in every), default=0)
    busy, gaps, cursor = 0, [], lo
    for start, end, _ in sorted(device):
        if start > cursor:
            gaps.append((start - cursor, cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if hi > cursor:
        gaps.append((hi - cursor, cursor, hi))
    named = []
    for length, start, end in sorted(gaps, reverse=True)[:n_gaps]:
        mid = (start + end) // 2
        under = [h for h in host if h[0] <= mid < h[1]]
        name = min(under, key=lambda h: h[1] - h[0])[2] if under \
            else "(no host op)"
        named.append([name, length * 1e-9])
    return Summary(ops, busy * 1e-9, (hi - lo) * 1e-9, named, counters,
                   units)


class Tracer:
    """Profiles units ``0 .. n_units - 1`` of a window, and the program's
    launch counters over them."""

    def __init__(self, n_units, counts=program_counts):
        self.n_units = int(n_units)
        self.counts = counts
        self.prof = None
        self.summary = None
        self.reduce_s = None

    def begin(self, index):
        if index == 0:
            self.before = self.counts()
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()

    def end(self, index):
        if index == self.n_units - 1 and self.summary is None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.stop()
            after = self.counts()
            t0 = time.perf_counter()
            self.summary = reduce(
                self.prof, {k: after[k] - self.before[k] for k in after},
                self.n_units)
            self.reduce_s = time.perf_counter() - t0
            self.prof = None
