"""Seconds per PSF bucket that the host is held before a graph capture by
device work queued earlier (``optimizer.drain`` spans inside the window's
``psf.dispatch`` spans, per dispatch): the overlap of the bucket pipeline
that the captures undo."""

from benchmark.spans import per_unit, program_spans


def read(summary, shapes):
    return per_unit(program_spans(), "psf.dispatch", {"optimizer.drain"})
