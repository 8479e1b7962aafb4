"""Diagnostic plots: extracted sources, Gaia-solve overlays, footprints
with stars (a copy of ``lightcurver_tpu/plotting/sources_plotting.py``)."""

import numpy as np

from . import pyplot
from .image_plotting import plot_image


def plot_sources(sources, image, save_path=None):
    """Image with detected source positions circled."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 8))
    plot_image(image, ax=ax)
    if len(sources):
        ax.scatter(sources["x"], sources["y"], s=60, facecolors="none",
                   edgecolors="red", linewidths=0.8)
    ax.set_title(f"{len(sources)} extracted sources")
    plt.tight_layout()
    if save_path is not None:
        plt.savefig(save_path, dpi=130)
        plt.close()
    return ax


def plot_coordinates_and_sources_on_image(image, sources, gaia_coords,
                                          wcs, save_path=None):
    """Gaia-solve diagnostic: detections + projected Gaia positions."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 8))
    plot_image(image, ax=ax)
    if sources is not None and len(sources):
        ax.scatter(sources["x"], sources["y"], s=50, facecolors="none",
                   edgecolors="red", linewidths=0.8, label="detections")
    ra, dec = gaia_coords
    gx, gy = wcs.world_to_pixel(np.asarray(ra), np.asarray(dec))
    ax.scatter(gx, gy, s=80, marker="+", color="cyan", label="gaia")
    ax.legend()
    plt.tight_layout()
    if save_path is not None:
        plt.savefig(save_path, dpi=130)
        plt.close()
    return ax


def plot_footprints_with_stars(footprint_arrays, stars, save_path=None):
    """Frame footprints + selected star positions with names."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 8))
    for poly in footprint_arrays:
        closed = np.vstack([poly, poly[:1]])
        ax.plot(closed[:, 0], closed[:, 1], color="gray", alpha=0.4,
                linewidth=0.8)
    for _, star in stars.iterrows():
        color = "red" if star["name"] == "roi" else "C0"
        ax.scatter(star["ra"], star["dec"], s=25, color=color)
        ax.annotate(star["name"], (star["ra"], star["dec"]),
                    textcoords="offset points", xytext=(4, 4), fontsize=8)
    ax.set_xlabel("RA [deg]")
    ax.set_ylabel("Dec [deg]")
    ax.invert_xaxis()
    plt.tight_layout()
    if save_path is not None:
        plt.savefig(save_path, dpi=130)
        plt.close()
    return ax
