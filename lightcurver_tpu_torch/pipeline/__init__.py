"""The pipeline's task wrappers and post-task checks (copies of
``lightcurver_tpu/pipeline``)."""
