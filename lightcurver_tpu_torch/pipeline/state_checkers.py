"""Post-task health checks: a copy of
``lightcurver_tpu/pipeline/state_checkers.py``."""

from ..structure.database import get_count_based_on_conditions
from ..structure.user_config import get_user_config


def check_plate_solving():
    """Plate-solve success fraction must reach the configured minimum.

    Returns:
        (success: bool, message: str)
    """
    user_config = get_user_config()
    attempted = get_count_based_on_conditions(
        "attempted_plate_solve = 1 AND eliminated = 0", table="frames")
    solved = get_count_based_on_conditions(
        "plate_solved = 1 AND eliminated = 0", table="frames")
    if attempted == 0:
        return True, "No plate solve attempted (already solved?)."
    fraction = solved / attempted
    minimum = user_config["plate_solving_min_success_fraction"]
    message = (f"Plate solve success fraction: {fraction:.2f} "
               f"(minimum: {minimum:.2f}).")
    return fraction >= minimum, message
