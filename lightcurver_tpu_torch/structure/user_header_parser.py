"""The user's FITS-header parser: a copy of
``lightcurver_tpu/structure/user_header_parser.py``.

The user supplies ``$workdir/header_parser/parse_header.py`` defining
``parse_header(header) -> dict`` with keys ``mjd``, ``gain`` and
``exptime``.
"""

import importlib.util

from .user_config import get_user_config


def load_custom_header_parser():
    """Return the user's ``parse_header`` function from the workdir plugin."""
    path = get_user_config()["workdir"] / "header_parser" / "parse_header.py"
    if not path.exists():
        raise FileNotFoundError(
            f"Header parser plugin not found at {path}. Create it with a "
            "parse_header(header) -> {'mjd','gain','exptime'} function.")
    spec = importlib.util.spec_from_file_location("user_header_parser", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not hasattr(module, "parse_header"):
        raise AttributeError(
            f"{path} must define a parse_header(header) function.")
    return module.parse_header
