"""Spans: the port's stages as named intervals on the profiler's clock.

A span marks a layer boundary where the work happens:

=========================  ================================================
``roi.fit``                one ``fit_roi`` call, the root of its spans
``roi.stage1``             the L-BFGS stage with its history read-back
``roi.noise_weights``      the starlet weights W, as the host issues them
``roi.stage2``             the AdaBelief stage with its read-back
``roi.polish``             GLS polish, errors, chi2, the results' fetch
``optimizer.warmup``       a loop's eager steps before its capture
``optimizer.drain``        the host waiting for work queued before a capture
``optimizer.capture``      one loop's CUDA graph capture
``psf.dispatch``           one PSF bucket's dispatch, the root of its spans;
                           attr ``plan``: ``"hit"`` when the fit found its
                           bucket shape's plan, ``"miss"`` when it built it
``pipeline.wait_prepare``  the bucket pipeline waiting for a preparation
=========================  ================================================

Spans are recorded only while a ``torch.profiler`` runs on the calling
thread: with none, :func:`span` tests one flag and records nothing. Under
a profiler a span is a host range of the profiler's own trace, named
``name`` (a function-scope range: ``torch.profiler.record_function``'s
user annotations are also drawn on the device's timeline, as one interval
over every kernel they launched, which a reader of device intervals
would count as busy), and keeps a record (a dict):
``name``, ``id``, ``parent`` (the enclosing span of the same thread, or
None), ``root`` (the outermost one, which the spans of one fit or bucket
share), ``thread``, ``start_ns`` and ``end_ns`` (``time.time_ns()``: the
epoch clock of the profiler's events) and ``attrs``. A record is kept
when its span ends. The profiler follows the thread that started it (and
autograd's), so a span on a worker thread of the program records nothing.

To see where a fit's or a task's time goes, run it under the profiler and
read the stages in its trace or here::

    import torch
    from lightcurver_tpu_torch.utilities import tracing

    tracing.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fit_roi(...)
    for s in tracing.spans():
        print(s["name"], (s["end_ns"] - s["start_ns"]) * 1e-9, s["attrs"])
    prof.export_chrome_trace("fit.json")  # the spans are host ranges there
"""

import itertools
import threading
import time

import torch

_records = []
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The span of a call with no profiler running: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return {}

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("record", "_range", "_stack")

    def __init__(self, name, attrs):
        self.record = {"name": name, "attrs": attrs}

    def __enter__(self):
        stack = self._stack = _local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        record = self.record
        record["id"] = next(_ids)
        record["parent"] = parent["id"] if parent else None
        record["root"] = parent["root"] if parent else record["id"]
        record["thread"] = threading.get_ident()
        record["start_ns"] = time.time_ns()
        self._range = torch._C._profiler._RecordFunctionFast(record["name"])
        self._range.__enter__()
        stack.append(record)
        return record["attrs"]

    def __exit__(self, *exc):
        self._stack.pop()
        self._range.__exit__(*exc)
        self.record["end_ns"] = time.time_ns()
        _records.append(self.record)
        return False


def span(name, **attrs):
    """A context manager that records the span ``name`` with ``attrs``
    while a profiler runs on this thread; it yields the span's ``attrs``,
    which the body may add to (a plain dict when nothing is recorded)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, attrs)


def spans():
    """The finished spans, in the order they ended."""
    return list(_records)


def clear():
    """Forget the finished spans."""
    _records.clear()
