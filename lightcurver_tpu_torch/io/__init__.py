"""FITS and WCS (copies of what the ROI task calls from
``lightcurver_tpu/io``)."""
