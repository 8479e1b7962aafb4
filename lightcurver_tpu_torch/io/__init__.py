"""FITS and WCS (copies of ``lightcurver_tpu/io``)."""
