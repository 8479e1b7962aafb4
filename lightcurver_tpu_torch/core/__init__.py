"""Numerical core of the port (twin of ``lightcurver_tpu/core``)."""
