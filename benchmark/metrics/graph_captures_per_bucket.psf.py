"""CUDA graphs captured per PSF bucket: the program's
``optimizer.capture`` spans inside the traced window's ``psf.dispatch``
spans, per dispatch (the window holds the next bucket's dispatch too)."""

from benchmark.spans import per_unit, program_spans


def read(summary, shapes):
    return per_unit(program_spans(), "psf.dispatch", {"optimizer.capture"},
                    value=lambda span: 1)
