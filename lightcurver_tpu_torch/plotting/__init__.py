"""Diagnostic plots and the HTML light curve: copies of
``lightcurver_tpu/plotting``.

The JAX package imports matplotlib and selects its Agg backend when this
package is imported. Here each function imports it when it plots
(:func:`pyplot`), so every module imports on a machine without
matplotlib, and the pipeline tasks that plot log a warning there instead.
"""


def pyplot():
    """``matplotlib.pyplot`` on the non-interactive Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
