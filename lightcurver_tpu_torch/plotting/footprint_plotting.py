"""Frame polygons + common/largest footprint fills
(a copy of ``lightcurver_tpu/plotting/footprint_plotting.py``)."""

import numpy as np

from . import pyplot


def plot_footprints(footprint_arrays, common_footprint, largest_footprint,
                    save_path=None):
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 8))
    for poly in footprint_arrays:
        closed = np.vstack([poly, poly[:1]])
        ax.plot(closed[:, 0], closed[:, 1], color="gray", alpha=0.5,
                linewidth=0.8)
    if largest_footprint is not None:
        v = largest_footprint.vertices
        ax.fill(v[:, 0], v[:, 1], alpha=0.15, color="C0",
                label="largest (union)")
    if common_footprint is not None:
        v = common_footprint.vertices
        ax.fill(v[:, 0], v[:, 1], alpha=0.3, color="C2",
                label="common (intersection)")
    ax.set_xlabel("RA [deg]")
    ax.set_ylabel("Dec [deg]")
    ax.invert_xaxis()
    ax.legend()
    plt.tight_layout()
    if save_path is not None:
        plt.savefig(save_path, dpi=130)
        plt.close()
    return ax
