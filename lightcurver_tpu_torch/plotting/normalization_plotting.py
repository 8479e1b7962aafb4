"""Normalization diagnostic: coefficient vs MJD + normalized star curves
(a copy of ``lightcurver_tpu/plotting/normalization_plotting.py``).
Queries the DB."""

import numpy as np

from . import pyplot
from ..structure.database import execute_sqlite_query


def plot_normalized_star_curves(combined_footprint_hash, save_path=None):
    plt = pyplot()
    coeffs = execute_sqlite_query(
        """SELECT nc.frame_id, f.mjd, nc.coefficient,
                  nc.coefficient_uncertainty
           FROM normalization_coefficients nc
           JOIN frames f ON f.id = nc.frame_id
           WHERE nc.combined_footprint_hash = ? ORDER BY f.mjd""",
        (combined_footprint_hash,), use_pandas=True)
    fluxes = execute_sqlite_query(
        """SELECT s.name, f.mjd, sff.flux, sff.flux_uncertainty,
                  nc.coefficient
           FROM star_flux_in_frame sff
           JOIN stars s ON s.gaia_id = sff.star_gaia_id
                AND s.combined_footprint_hash = sff.combined_footprint_hash
           JOIN frames f ON f.id = sff.frame_id
           JOIN normalization_coefficients nc ON nc.frame_id = sff.frame_id
                AND nc.combined_footprint_hash =
                    sff.combined_footprint_hash
           WHERE sff.combined_footprint_hash = ? ORDER BY f.mjd""",
        (combined_footprint_hash,), use_pandas=True)

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 7), sharex=True)
    ax1.errorbar(coeffs["mjd"], coeffs["coefficient"],
                 yerr=coeffs["coefficient_uncertainty"], fmt=".",
                 markersize=4, elinewidth=0.6)
    ax1.set_ylabel("normalization coefficient")

    if not fluxes.empty:
        fluxes = fluxes.copy()
        # a degenerate frame (coefficient 0 or NaN) would put inf/NaN
        # points on the axes and blow matplotlib's autoscale for the
        # whole panel — drop those rows, they carry no diagnostic value
        coeff = np.asarray(fluxes["coefficient"], dtype=float)
        flux = np.asarray(fluxes["flux"], dtype=float)
        fluxes = fluxes[np.isfinite(coeff) & (coeff != 0)
                        & np.isfinite(flux)]
        fluxes["normalized"] = (fluxes["flux"] / fluxes["coefficient"])
        for name, group in fluxes.groupby("name"):
            med = group["normalized"].median()
            if med == 0:
                continue
            ax2.plot(group["mjd"], group["normalized"] / med, ".",
                     markersize=3, label=str(name))
        ax2.legend(fontsize=7, ncol=6)
    ax2.set_xlabel("MJD")
    ax2.set_ylabel("normalized star flux / median")
    plt.tight_layout()
    if save_path is not None:
        plt.savefig(save_path)
        plt.close()
    return fig
