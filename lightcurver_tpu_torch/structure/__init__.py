"""The pipeline's configuration and state store (copies of what the ROI
task calls from ``lightcurver_tpu/structure``)."""
