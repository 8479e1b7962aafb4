"""Light-curve post-processing: a copy of ``group_observations`` and
``convert_flux_to_magnitude`` of
``lightcurver_tpu/utilities/lightcurves_postprocessing.py``: 2-sigma-clipped
inverse-variance nightly means, and asymmetric magnitude errors with NaN
on non-positive fluxes. pandas is imported where a DataFrame is built.
"""

import warnings
from copy import deepcopy

import numpy as np

from .stats import sigmaclip


def _point_source_names(columns, suffix="_flux"):
    # strip the exact suffix (a label may hold an underscore, "QSO_A"); a
    # candidate is dropped only when it is a derived column of another
    # present source ("a_d" with "a" present)
    names = {c[:-len(suffix)] for c in columns if c.endswith(suffix)}
    derived = {f"{m}_{kind}" for m in names
               for kind in ("d", "scatter", "count")}
    return names - derived


def group_observations(df, threshold=0.8):
    """Group epochs into nights: a gap > ``threshold`` days starts a group.

    Per group and per source: 2-sigma clip the fluxes, then
    inverse-variance weighted mean; uncertainty = sqrt(1 / sum(weights));
    scatter = weighted std.  Other columns are plain-averaged.
    """
    import pandas as pd

    # an epoch without an MJD cannot be put in a night
    df = df[np.isfinite(np.asarray(df["mjd"], dtype=float))]
    df_sorted = df.sort_values(by="mjd").reset_index(drop=True)
    sources = sorted(_point_source_names(df.columns))
    flux_cols = ([f"{ps}_flux" for ps in sources]
                 + [f"{ps}_d_flux" for ps in sources])

    mjd = df_sorted["mjd"].to_numpy()
    breaks = np.flatnonzero(np.diff(mjd) > threshold) + 1
    bounds = np.concatenate([[0], breaks, [len(df_sorted)]])

    rows = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        group = df_sorted.iloc[lo:hi]
        row = {
            "mjd": group["mjd"].mean(),
            "scatter_mjd": float(np.nan_to_num(group["mjd"].std())),
        }
        for col in group.columns:
            if col != "mjd" and col not in flux_cols:
                row[col] = group[col].mean()
        for ps in sources:
            fluxes = group[f"{ps}_flux"].to_numpy()
            variances = group[f"{ps}_d_flux"].to_numpy() ** 2
            # a NaN epoch or a zero-variance one must not lose the night:
            # clip and average over the usable epochs only
            finite = (np.isfinite(fluxes) & np.isfinite(variances)
                      & (variances > 0))
            fluxes, variances = fluxes[finite], variances[finite]
            kept, lo_lim, hi_lim = sigmaclip(fluxes, low=2, high=2)
            keep = (fluxes >= lo_lim) & (fluxes <= hi_lim)
            kept_var = variances[keep]
            if kept_var.size > 0 and np.all(kept_var > 0):
                w = 1.0 / kept_var
                mean = np.average(kept, weights=w)
                scatter = np.sqrt(np.average((kept - mean) ** 2, weights=w))
                err = np.sqrt(1.0 / w.sum())
                count = kept_var.size
            else:
                mean, scatter, err, count = np.nan, np.nan, np.inf, 0
            row[f"{ps}_flux"] = mean
            row[f"{ps}_d_flux"] = err
            row[f"{ps}_scatter_flux"] = scatter
            row[f"{ps}_count_flux"] = count
        rows.append(row)
    return pd.DataFrame(rows)


def convert_flux_to_magnitude(df):
    """Add magnitude columns with asymmetric errors.

    For each source {ps} with columns {ps}_flux and {ps}_d_flux (and
    optionally {ps}_scatter_flux):
        {ps}_mag             = -2.5 log10(flux) + zeropoint
        {ps}_d_mag_down/up   = asymmetric errors from flux +/- d_flux
                               (NaN branch when flux -/+ error <= 0)
        {ps}_d_mag           = linearized 2.5/ln10 * |dF/F|
    """
    df = deepcopy(df)
    if "zeropoint" not in df.columns:
        warnings.warn("Zeropoint column missing. Using a zeropoint of 0.",
                      RuntimeWarning)
        df["zeropoint_used_in_conversion"] = 0.0
        df["zeropoint"] = 0.0
    zp = np.asarray(df["zeropoint"], dtype=float)

    flux_cols = [f"{ps}_flux"
                 for ps in sorted(_point_source_names(df.columns))]

    with np.errstate(invalid="ignore", divide="ignore"):
        for flux_col in flux_cols:
            ps = flux_col[:-len("_flux")]
            flux = np.asarray(df[flux_col], dtype=float)
            mag = -2.5 * np.log10(flux) + zp
            df[f"{ps}_mag"] = mag
            for prefix in ("d", "scatter"):
                err_col = f"{ps}_{prefix}_flux"
                if err_col not in df.columns:
                    continue
                err = np.asarray(df[err_col], dtype=float)
                up, down = flux + err, flux - err
                mag_down = np.where(up > 0, -2.5 * np.log10(
                    np.where(up > 0, up, 1.0)) + zp, np.nan)
                mag_up = np.where(down > 0, -2.5 * np.log10(
                    np.where(down > 0, down, 1.0)) + zp, np.nan)
                df[f"{ps}_{prefix}_mag_down"] = mag - mag_down
                df[f"{ps}_{prefix}_mag_up"] = mag_up - mag
                df[f"{ps}_{prefix}_mag"] = 2.5 / np.log(10) * np.abs(
                    err / flux)
    return df
