"""The pipeline's configuration and state store (copies of
``lightcurver_tpu/structure``)."""
