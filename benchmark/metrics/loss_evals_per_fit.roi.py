"""Loss evaluations per fit: K2 forward launches over the traced fits,
from the program's launch counters (graph replays included), per fit."""


def read(summary, shapes):
    evals = summary.counters["k2_forward"]
    return evals / summary.units if evals else None
