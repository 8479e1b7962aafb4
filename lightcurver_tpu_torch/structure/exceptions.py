"""Pipeline exceptions: a copy of
``lightcurver_tpu/structure/exceptions.py``."""


class NoConfigFilePathInEnvironment(Exception):
    """Raised when LIGHTCURVER_CONFIG is not set in the environment."""

    def __init__(self):
        super().__init__(
            "Please define the environment variable LIGHTCURVER_CONFIG: "
            "a path to your config.yaml file.")


class TaskWasNotSuccessful(Exception):
    """Raised when every job of a task failed, and by the post-task health
    checks (``pipeline/state_checkers.py``)."""
