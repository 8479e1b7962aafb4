"""The program's spans over a traced window, as the span metrics read
them.

``lightcurver_tpu_torch.utilities.tracing`` records a span only while a
profiler runs, so after a traced run its ``spans()`` are those of the
window. A unit of work is a span of one name (``roi.fit``, one fit;
``psf.dispatch``, one bucket); a metric sums the spans inside the window's
units (a span is inside a unit when the unit is it or one of its
ancestors) and divides by their number. A span whose unit began before
the window has no recorded unit and is left out. A program without the
module has no spans, and every reader returns None.
"""


def program_spans():
    """The program's finished spans; [] when it records none."""
    try:
        from lightcurver_tpu_torch.utilities import tracing
    except ImportError:
        return []
    return tracing.spans()


def seconds(span):
    return (span["end_ns"] - span["start_ns"]) * 1e-9


def per_unit(spans, unit, names, value=seconds):
    """The sum of ``value`` over the spans named one of ``names`` inside a
    span named ``unit``, over the number of those units; None when the
    spans hold no unit."""
    by_id = {s["id"]: s for s in spans}
    units = {s["id"] for s in spans if s["name"] == unit}
    if not units:
        return None

    def inside(span):
        while span is not None:
            if span["id"] in units:
                return True
            span = by_id.get(span["parent"])
        return False

    return sum(value(s) for s in spans
               if s["name"] in names and inside(s)) / len(units)


def mean(spans, name):
    """The mean length of the spans named ``name``, in s; None without
    one."""
    found = [seconds(s) for s in spans if s["name"] == name]
    return sum(found) / len(found) if found else None
