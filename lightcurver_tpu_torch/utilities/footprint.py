"""Frame footprints, their hashes, union and intersection, storage and
sanity checks: a copy of ``lightcurver_tpu/utilities/footprint.py``.

The SQLite JSON formats are the JAX package's: a GeoJSON-style mapping for
the combined footprints, a plain vertex list for a frame's.
"""

import json

import numpy as np

from ..structure.database import execute_sqlite_query, get_pandas
from ..structure.user_config import get_user_config
from .geometry import SimplePolygon, polygon_union


def get_frames_hash(frames_ids):
    """Deterministic identity of a SET of frames (order-insensitive)."""
    if len(set(frames_ids)) != len(frames_ids):
        raise ValueError("Non-unique frame ids passed to this function")
    return hash(tuple(sorted(int(i) for i in frames_ids)))


def get_combined_footprint_hash(user_config, frames_id_list):
    """Footprint identity: the frame-set hash, or with the ROI_disk star
    selection the hash of its radius, so adding frames never renames the
    products."""
    if user_config["star_selection_strategy"] != "ROI_disk":
        return get_frames_hash(frames_id_list)
    return hash(user_config["ROI_disk_radius_arcseconds"])


def unwrap_ra(ra, center_ra):
    """Map RA (degrees) into the continuous window centered on center_ra.

    Flat-plane polygon math (intersections, centroids, containment)
    breaks when a field straddles RA = 0 and coordinates mix ~359.9
    with ~0.1; unwrapping every RA into (center - 180, center + 180]
    restores a consistent plane.  Works on scalars and arrays.
    """
    return center_ra + (np.asarray(ra) - center_ra + 180.0) % 360.0 - 180.0


def _unwrap_footprint(fp, center_ra):
    fp = np.asarray(fp, dtype=float).copy()
    fp[:, 0] = unwrap_ra(fp[:, 0], center_ra)
    return fp


def calc_common_and_total_footprint(list_of_footprints):
    """Intersection and union of frame corner polygons.

    Args:
        list_of_footprints: list of (4, 2) arrays of (ra, dec) corners.

    Returns:
        (common, largest): SimplePolygons; common is None when the frames
        share no area.
    """
    if not list_of_footprints:
        raise RuntimeError(
            "No frame footprints available — no frame is plate-solved "
            "with the ROI in its footprint yet; cannot combine.")
    # all frames unwrapped around ONE reference RA so cross-frame
    # intersections near RA = 0 stay in a single continuous plane.
    # The reference is a single VERTEX: a mean of wrapped RAs is itself
    # corrupted by the seam (mean of 359.95 and 0.15 is 180.05)
    ra0 = float(np.asarray(list_of_footprints[0])[0, 0])
    list_of_footprints = [_unwrap_footprint(fp, ra0)
                          for fp in list_of_footprints]
    polygons = [SimplePolygon(fp) for fp in list_of_footprints]
    common = polygons[0]
    for poly in polygons[1:]:
        common = common.intersection(poly)
        if common is None:
            break
    # EXACT n-way union (geometry.polygon_union), then the reference's
    # simplify(tolerance=0.001, preserve_topology=True) counterpart on
    # both results (reference utilities/footprint.py:50-58) — keeps the
    # stored / ADQL-emitted polygons small on heavily dithered stacks
    largest = polygon_union(polygons).simplify(0.001)
    if common is not None:
        common = common.simplify(0.001)
    return common, largest


def database_insert_single_footprint(frame_id, footprint_array):
    execute_sqlite_query(
        "INSERT OR REPLACE INTO footprints (frame_id, polygon) VALUES (?, ?)",
        params=(frame_id, json.dumps(np.asarray(footprint_array).tolist())),
        is_select=False)


def database_get_footprint(frame_id):
    result = execute_sqlite_query(
        "SELECT polygon FROM footprints WHERE frame_id = ?",
        params=(frame_id,))[0]
    return np.array(json.loads(result[0]))


def save_combined_footprints_to_db(frames_hash, common_footprint,
                                   largest_footprint):
    # an empty intersection (disjoint pointings) is stored as an empty
    # polygon rather than crashing: downstream ROI/star containment
    # checks then fail with informative "not in footprint" paths
    common = (common_footprint.mapping()
              if common_footprint is not None else [])
    execute_sqlite_query(
        "INSERT INTO combined_footprint (hash, largest, common) "
        "VALUES (?, ?, ?)",
        params=(frames_hash, json.dumps(largest_footprint.mapping()),
                json.dumps(common)),
        is_select=False)


def load_combined_footprint_from_db(frames_hash, missing_ok=True):
    """(largest, common) polygons for the hash, or None when absent.

    ``missing_ok=False`` raises an actionable error instead: callers
    that unpack the result directly (star querying) would otherwise
    surface 'cannot unpack non-iterable NoneType' with no hint that the
    footprint task must be (re-)run for the current frame set.
    """
    rows = execute_sqlite_query(
        "SELECT largest, common FROM combined_footprint WHERE hash = ?",
        params=(frames_hash,))
    if not rows:
        if missing_ok:
            return None
        raise RuntimeError(
            f"no combined footprint stored for frame-set hash "
            f"{frames_hash}: the frame set changed since the last "
            "footprint calculation — run the "
            "calculate_common_and_total_footprint task (do not --start "
            "the pipeline after it)")
    largest, common = rows[0]
    return json.loads(largest), json.loads(common)


def check_in_footprint_for_all_images():
    """Set frames.roi_in_footprint from each frame's own WCS."""
    from ..io.fits import read_fits
    from ..io.wcs import TanWCS

    frames = get_pandas(columns=["id", "image_relpath"],
                        conditions=["plate_solved = 1", "eliminated = 0"])
    user_config = get_user_config()
    for _, frame in frames.iterrows():
        path = user_config["workdir"] / frame["image_relpath"]
        # only the header is needed: skip loading (and BSCALE-converting)
        # the full wide-field pixel array per frame
        _, header = read_fits(path, header_only=True)
        wcs = TanWCS.from_header(header)
        shape = (int(header["NAXIS2"]), int(header["NAXIS1"]))
        inside = wcs.contains_world(user_config["ROI_ra_deg"],
                                    user_config["ROI_dec_deg"], shape)
        execute_sqlite_query(
            "UPDATE frames SET roi_in_footprint = ? WHERE id = ?",
            params=(int(inside), frame["id"]), is_select=False)


def identify_and_eliminate_bad_pointings():
    """Flag frames whose pointing deviates > mean + 5 std from the rest.

    (reference utilities/footprint.py:153-199)
    """
    rows = execute_sqlite_query(
        """SELECT frames.id, footprints.polygon
           FROM footprints
           JOIN frames ON footprints.frame_id = frames.id
           WHERE frames.eliminated != 1""",
        use_pandas=True)
    if len(rows) == 0:
        return
    ids = rows["id"].to_numpy()
    polys = [np.array(json.loads(poly)) for poly in rows["polygon"]]
    # one shared unwrap reference: pointings straddling RA = 0 must not
    # scatter centroids across the [0, 360) seam (a ~180-degree fake
    # deviation would either eliminate good frames or inflate the std
    # until real bad pointings pass).  A single vertex, not a mean —
    # a mean of wrapped RAs is itself corrupted by the seam
    ra0 = float(polys[0][0, 0])
    centers = np.array([_unwrap_footprint(p, ra0).mean(axis=0)
                        for p in polys])
    overall = centers.mean(axis=0)
    deviations = np.linalg.norm(centers - overall, axis=1)
    threshold = deviations.mean() + 5.0 * deviations.std()
    for frame_id in ids[deviations > threshold]:
        execute_sqlite_query(
            "UPDATE frames SET comment = 'bad_pointing', eliminated = 1 "
            "WHERE id = ?",
            params=(int(frame_id),), is_select=False)


def get_angle_wcs(wcs_object):
    """Angle to North ("North up, East left") in degrees.

    (reference utilities/footprint.py:202-224).  Delegates to the exact
    finite-difference TanWCS.north_angle_deg (SIP-aware, same convention
    — verified identical on pure-rotation CD matrices); the CD-only
    formula remains as a fallback for duck-typed WCS objects.
    """
    if hasattr(wcs_object, "north_angle_deg"):
        return float(wcs_object.north_angle_deg())
    # duck-typed fallback: CD preferred over PC, like the reference
    matrix = getattr(wcs_object, "cd", None)
    if matrix is None:
        matrix = getattr(wcs_object, "pc", None)
    if matrix is None:
        raise ValueError("Neither CD nor PC matrix found in WCS.")
    matrix = np.asarray(matrix, dtype=float)
    return float(np.arctan2(-matrix[0, 1], matrix[1, 1]) * 180.0 / np.pi)
