"""The share of the traced window in which no operation ran on the card
(rank 0's card on four), in %."""


def read(summary, shapes):
    if summary.window_s <= 0 or summary.busy_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
