"""Relative zeropoints, one normalization coefficient per frame: the port
of the JAX pipeline task ``lightcurver_tpu/processes/
normalization_calculation.py::calculate_coefficient``.

Each star's light curve is divided by its median; per-star scale factors
(SLSQP, held to a mean of 1) minimise the weighted scatter among the stars
within each frame; a frame's coefficient is the inverse-variance mean of
its scaled normalised fluxes, its uncertainty their weighted std. The
fluxes are filtered to the current star selection (``select_stars``), as
the JAX task does (PARITY.md).

The diagnostic plot of the normalised curves goes to
``plots/normalization/<footprint hash>/normalization_fluxes_plot.pdf``, as
JAX's task writes it. pandas and matplotlib are imported by the functions
that use them.
"""

import logging

import numpy as np
from scipy.optimize import minimize

from ..structure.database import (execute_sqlite_query, executemany_sqlite,
                                  get_pandas, select_stars)
from ..structure.user_config import get_user_config
from ..utilities.chi2_selector import get_chi2_bounds
from ..utilities.footprint import get_combined_footprint_hash


def get_fluxes(combined_footprint_hash, photometry_chi2_min,
               photometry_chi2_max):
    """All star fluxes (chi2-gated) joined with frame mjd and star name."""
    import pandas as pd

    query = """
    SELECT s.name,
           f.id AS frame_id,
           f.mjd,
           sff.star_gaia_id,
           sff.combined_footprint_hash,
           sff.flux AS flux,
           sff.flux_uncertainty AS d_flux
    FROM frames f
    JOIN star_flux_in_frame sff ON f.id = sff.frame_id
    JOIN stars s ON sff.star_gaia_id = s.gaia_id
               AND sff.combined_footprint_hash = s.combined_footprint_hash
    JOIN stars_in_frames sif ON sif.star_gaia_id = s.gaia_id
               AND sif.frame_id = f.id
               AND sif.combined_footprint_hash = s.combined_footprint_hash
    WHERE sff.combined_footprint_hash = ?
      AND sff.chi2 BETWEEN ? AND ?
    ORDER BY s.name, f.id"""
    df = execute_sqlite_query(
        query, (combined_footprint_hash, photometry_chi2_min,
                photometry_chi2_max), use_pandas=True)
    # NULL fluxes come back as float NaN, never as objects pandas would
    # refuse to aggregate
    for col in ("flux", "d_flux"):
        df[col] = pd.to_numeric(df[col], errors="coerce")
    return df


def update_normalization_coefficients(norm_data):
    executemany_sqlite(
        """INSERT INTO normalization_coefficients (frame_id,
           combined_footprint_hash, coefficient, coefficient_uncertainty)
           VALUES (?, ?, ?, ?)
           ON CONFLICT(combined_footprint_hash, frame_id) DO UPDATE SET
           coefficient=excluded.coefficient,
           coefficient_uncertainty=excluded.coefficient_uncertainty""",
        norm_data)


def cost_function_scatter_in_frame(scaling_factors, normalized_flux_pivot,
                                   normalized_d_flux_pivot):
    """Total weighted per-frame variance among the scaled star curves."""
    scaled = normalized_flux_pivot.mul(scaling_factors, axis=0)
    weights = 1.0 / normalized_d_flux_pivot
    means = (scaled * weights).sum(axis=0) / weights.sum(axis=0)
    variance = (weights.mul((scaled.sub(means, axis="columns")) ** 2)
                ).sum(axis=0) / weights.sum(axis=0)
    return variance.sum()


def weighted_std(values, weights):
    """NaN-tolerant weighted standard deviation."""
    values = np.asarray(values, dtype=float)
    weights = np.asarray(weights, dtype=float)
    bad = np.isnan(values) | np.isnan(weights)
    values, weights = values[~bad], weights[~bad]
    if values.size == 0:
        return np.nan
    mean = np.average(values, weights=weights)
    return np.sqrt(np.average((values - mean) ** 2, weights=weights))


def calculate_coefficient():
    """Pipeline task: compute and upsert the per-frame coefficients."""
    import pandas as pd

    logger = logging.getLogger("lightcurver.normalization_coefficient")
    user_config = get_user_config()
    frames_ini = get_pandas(
        columns=["id"],
        conditions=["plate_solved = 1", "eliminated = 0",
                    "roi_in_footprint = 1"])
    footprint_hash = get_combined_footprint_hash(
        user_config, frames_ini["id"].to_list())

    chi2_min, chi2_max = get_chi2_bounds(psf_or_fluxes="fluxes")
    df = get_fluxes(footprint_hash, chi2_min, chi2_max)
    # only the current star selection, as the photometry task selects it:
    # a stale row of a star excluded since would bias every coefficient
    selected = select_stars(
        stars_to_use=user_config["stars_to_use_norm"],
        combined_footprint_hash=footprint_hash,
        stars_to_exclude=user_config["stars_to_exclude_norm"])
    df = df[df["star_gaia_id"].isin(selected["gaia_id"])]
    logger.info(f"Normalization from {len(df)} flux measurements.")

    # per-star median normalization
    medians = df.groupby("star_gaia_id")["flux"].median().rename(
        "median_flux")
    df = df.merge(medians, on="star_gaia_id")
    df["normalized_flux"] = df["flux"] / df["median_flux"]
    df["normalized_d_flux"] = df["d_flux"] / df["median_flux"]

    flux_pivot = df.pivot(index="star_gaia_id", columns="frame_id",
                          values="normalized_flux")
    d_flux_pivot = df.pivot(index="star_gaia_id", columns="frame_id",
                            values="normalized_d_flux")

    # align the per-star curves: scale factors minimising the per-frame
    # scatter, held to a mean of 1
    constraint = {"type": "eq",
                  "fun": lambda c: 1.0 - np.nanmean(c)}
    result = minimize(cost_function_scatter_in_frame,
                      np.ones(flux_pivot.shape[0]),
                      args=(flux_pivot, d_flux_pivot),
                      constraints=constraint, method="SLSQP")
    factors = result.x
    logger.info("Star curve fine-scaling factors: "
                f"{[round(float(e), 2) for e in factors]}.")

    scaled_fluxes = flux_pivot.mul(factors, axis=0)
    scaled_d_fluxes = d_flux_pivot.mul(factors, axis=0)
    weights = 1.0 / scaled_d_fluxes**2

    coeff = (scaled_fluxes * weights).sum(axis=0) / weights.sum(axis=0)
    err = pd.Series(
        [weighted_std(scaled_fluxes[fid], weights[fid])
         for fid in scaled_fluxes.columns],
        index=scaled_fluxes.columns)
    # one star: its weighted std is 0, so take 10 % of the coefficient
    err.loc[err == 0.0] = 0.1 * coeff.loc[err == 0.0]

    norm_data = [(int(fid), footprint_hash, float(coeff[fid]),
                  float(err[fid])) for fid in coeff.keys()]
    update_normalization_coefficients(norm_data)

    try:
        from ..plotting.normalization_plotting import \
            plot_normalized_star_curves

        plot_dir = (user_config["plots_dir"] / "normalization"
                    / str(footprint_hash))
        plot_dir.mkdir(exist_ok=True, parents=True)
        plot_file = plot_dir / "normalization_fluxes_plot.pdf"
        plot_normalized_star_curves(
            combined_footprint_hash=footprint_hash, save_path=plot_file)
        logger.info(f"Wrote diagnostic plot at {plot_file}.")
    except Exception as e:
        logger.warning(f"Normalization plot failed: {e}")
