"""Seconds per fit outside its two optimizer stages: the ``roi.fit`` span
less its ``roi.stage1`` and ``roi.stage2`` spans (set-up, the noise
weights as the host issues them, the GLS polish, errors, chi2 and the
results' fetch)."""

from benchmark.spans import per_unit, program_spans


def read(summary, shapes):
    spans = program_spans()
    fit = per_unit(spans, "roi.fit", {"roi.fit"})
    if fit is None:
        return None
    return fit - per_unit(spans, "roi.fit", {"roi.stage1", "roi.stage2"})
