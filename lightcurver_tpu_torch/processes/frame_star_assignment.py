"""Star-to-frame assignment, which stars land in which frame's footprint:
a copy of ``lightcurver_tpu/processes/frame_star_assignment.py``.

Each frame's footprint polygon is shrunk by a 4-arcsec margin (the
intersection of four margin-translated copies, the RA margin de-projected
by cos(dec)), and every star inside the shrunk polygon gets a
stars_in_frames row. Stars closer to the edge than half a stamp still
give partial cutouts, NaN-padded and masked downstream.
"""

import json
import sqlite3

import numpy as np

from ..structure.user_config import get_user_config
from ..utilities.geometry import SimplePolygon


def populate_stars_in_frames():
    """Fill the stars_in_frames join table (idempotent)."""
    user_config = get_user_config()
    # single connection: this loops over frames x stars
    conn = sqlite3.connect(user_config["database_path"])
    try:
        footprints = conn.execute(
            "SELECT frame_id, polygon FROM footprints").fetchall()
        stars = conn.execute(
            "SELECT gaia_id, ra, dec, combined_footprint_hash FROM stars"
        ).fetchall()

        from ..utilities.footprint import unwrap_ra

        margin_deg = 4.0 / 3600.0  # 4-arcsec margin (reference's value)
        for frame_id, footprint_str in footprints:
            vertices = np.asarray(json.loads(footprint_str), dtype=float)
            # flat-plane containment needs polygon AND stars in one
            # continuous RA window (fields straddling RA = 0); anchor
            # on a single vertex — a mean of wrapped RAs is corrupted
            # by the seam
            ra_center = float(vertices[0, 0])
            vertices[:, 0] = unwrap_ra(vertices[:, 0], ra_center)
            polygon = SimplePolygon(vertices)
            # mean dec over the CLOSED ring (first vertex repeated):
            # the reference averages shapely's exterior.xy, which
            # returns the closed ring, double-weighting vertex 0 —
            # match it exactly so the de-projected RA margin agrees
            # to the last bit, not just to ~1e-6 relative
            closed_dec = np.concatenate([polygon.vertices[:, 1],
                                         polygon.vertices[:1, 1]])
            mean_dec = float(np.nanmean(closed_dec))
            ra_margin = margin_deg / np.cos(np.radians(mean_dec))

            # shrink = intersection of the four margin-translated copies
            shrunk = polygon
            for dx, dy in ((ra_margin, 0), (-ra_margin, 0),
                           (0, margin_deg), (0, -margin_deg)):
                shrunk = shrunk.intersection(polygon.translated(dx, dy))
                if shrunk is None:
                    break
            if shrunk is None:
                continue

            for gaia_id, ra, dec, footprint_hash in stars:
                if shrunk.contains(float(unwrap_ra(ra, ra_center)), dec):
                    try:
                        conn.execute(
                            "INSERT INTO stars_in_frames (frame_id, "
                            "star_gaia_id, combined_footprint_hash) "
                            "VALUES (?, ?, ?)",
                            (frame_id, gaia_id, footprint_hash))
                    except sqlite3.IntegrityError:
                        continue  # pair already present
        conn.commit()
    finally:
        conn.close()
