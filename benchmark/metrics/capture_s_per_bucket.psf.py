"""Seconds per PSF bucket that its optimizer loops spend in their eager
warm-up steps and their graph captures (``optimizer.warmup`` and
``optimizer.capture`` spans inside the window's ``psf.dispatch`` spans,
per dispatch)."""

from benchmark.spans import per_unit, program_spans


def read(summary, shapes):
    return per_unit(program_spans(), "psf.dispatch",
                    {"optimizer.warmup", "optimizer.capture"})
