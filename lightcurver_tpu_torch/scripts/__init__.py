"""The port's command-line entry points: ``python -m
lightcurver_tpu_torch.scripts.run`` and ``python -m
lightcurver_tpu_torch.scripts.initialize``."""
