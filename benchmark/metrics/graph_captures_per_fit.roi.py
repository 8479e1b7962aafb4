"""CUDA graphs captured per fit: the program's ``optimizer.capture`` spans
inside the traced window's ``roi.fit`` spans, per fit."""

from benchmark.spans import per_unit, program_spans


def read(summary, shapes):
    return per_unit(program_spans(), "roi.fit", {"optimizer.capture"},
                    value=lambda span: 1)
