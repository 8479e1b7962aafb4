"""Chi2 gating of the fitted PSFs and star fluxes: a copy of
``lightcurver_tpu/utilities/chi2_selector.py``.

Strategies, from the config's ``{psf,fluxes}_fit_exclude_strategy``:
    None                  -> (-inf, inf)
    {'sigma_clip': k}     -> median +/- k * std of the sigma-clipped chi2
    {'threshold': [a, b]} -> the bounds as given
"""

import numpy as np

from ..structure.database import execute_sqlite_query
from ..structure.user_config import get_user_config
from .stats import sigma_clipped_stats

_TABLES = {"psf": "PSFs", "fluxes": "star_flux_in_frame"}


def get_chi2_bounds(psf_or_fluxes):
    """(chi2_min, chi2_max) for selecting good fits downstream."""
    if psf_or_fluxes not in _TABLES:
        raise ValueError(
            f"get_chi2_bounds: not something I know of: {psf_or_fluxes}")
    conf = get_user_config()[f"{psf_or_fluxes}_fit_exclude_strategy"]
    if conf is None:
        return -np.inf, np.inf
    if not isinstance(conf, dict) or len(conf) != 1:
        raise RuntimeError(
            f"Unexpected {psf_or_fluxes}_fit_exclude_strategy: {conf}. "
            "valid: None, {'sigma_clip': k} or {'threshold': [lo, hi]}")
    (strategy, value), = conf.items()
    if strategy == "threshold":
        return tuple(value)
    if strategy == "sigma_clip":
        chi2 = execute_sqlite_query(
            f"SELECT chi2 FROM {_TABLES[psf_or_fluxes]}", use_pandas=True)
        _, median, std = sigma_clipped_stats(chi2["chi2"], sigma=value)
        return median - value * std, median + value * std
    raise RuntimeError(
        f"Unexpected {psf_or_fluxes}_fit_exclude_strategy: {strategy}. "
        "valid: None, 'sigma_clip' or 'threshold'")
