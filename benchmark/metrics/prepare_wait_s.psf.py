"""Seconds the bucket pipeline's main thread waits for a bucket's
preparation on the worker thread: the mean ``pipeline.wait_prepare`` span
of the traced window."""

from benchmark.spans import mean, program_spans


def read(summary, shapes):
    return mean(program_spans(), "pipeline.wait_prepare")
