"""Plate solving, the frame selection, the astrometry.net wrappers and the
post-solve steps: a copy of ``lightcurver_tpu/processes/plate_solving.py``.

Frames are selected by the config's strategy and blind-solved with
astrometry.net's ``solve-field`` binary, or through the
nova.astrometry.net web API when an API key is set (``requests`` is
imported then). The post-solve steps store the footprint polygon, the ROI
containment, the pixel-anisotropy check, the north angle, the pixel scale
and the seeing in arcseconds. The two alternate solvers (Gaia match,
adapt a reference WCS) have their own modules.
"""

import logging
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ..structure.database import execute_sqlite_query, get_pandas
from ..utilities.footprint import (database_insert_single_footprint,
                                   get_angle_wcs)
from ..io.fits import read_fits, write_fits
from ..io.wcs import TanWCS


class CouldNotSolveError(RuntimeError):
    pass


def select_frames_needing_plate_solving(user_config, logger):
    """Frames to (re)solve per the plate_solve_frames strategy."""
    strategy = user_config["plate_solve_frames"]
    if strategy == "all_not_eliminated":
        conditions = ["eliminated = 0"]
    elif strategy == "all_never_attempted":
        conditions = ["eliminated = 0", "attempted_plate_solve = 0"]
    elif strategy == "all_not_plate_solved":
        conditions = ["eliminated = 0", "plate_solved = 0"]
    else:
        raise ValueError(
            f"Not an expected selection strategy: {strategy}")
    logger.info(f"Plate-solve frame selection: {strategy}.")
    return get_pandas(columns=["id", "image_relpath", "sources_relpath"],
                      conditions=conditions)


def solve_field_available():
    return shutil.which("solve-field") is not None


NOVA_API_URL = "https://nova.astrometry.net/api/"


def solve_via_nova_api(sources, nx, ny, user_config, api_url=None,
                       poll_interval=5.0, timeout=600.0):
    """Blind solution through the nova.astrometry.net web API.

    The reference supports this path when ``astrometry_net_api_key`` is
    set (reference processes/plate_solving.py:48-52, through the
    widefield_plate_solver package) — it serves users WITHOUT a local
    astrometry.net index installation.  The extracted source list is
    uploaded as the same FITS x,y table the local binary consumes,
    with the ROI position hint and plate-scale interval; the job is
    polled until the service returns a WCS header.

    Returns a TanWCS.  Raises CouldNotSolveError on login/upload/solve
    failure or timeout.  ``api_url`` is overridable for offline tests.
    """
    import json
    import time as _time

    import requests

    api_url = api_url or NOVA_API_URL
    scale_min, scale_max = user_config["plate_scale_interval"]
    http = requests.Session()

    def call(endpoint, payload, files=None):
        resp = http.post(api_url + endpoint,
                         data={"request-json": json.dumps(payload)},
                         files=files, timeout=60)
        out = resp.json()
        if out.get("status") not in (None, "success"):
            raise CouldNotSolveError(
                f"nova.astrometry.net {endpoint} failed: {out!r}")
        return out

    login = call("login",
                 {"apikey": user_config["astrometry_net_api_key"]})
    session = login["session"]

    with tempfile.TemporaryDirectory() as tmp:
        xyls = Path(tmp) / "sources.xyls"
        _write_xyls(xyls, sources, nx, ny)
        upload_args = {
            "session": session,
            "scale_units": "arcsecperpix",
            "scale_type": "ul",
            "scale_lower": float(scale_min),
            "scale_upper": float(scale_max),
            "center_ra": float(user_config["ROI_ra_deg"]),
            "center_dec": float(user_config["ROI_dec_deg"]),
            "radius": 2.0,
            "image_width": int(nx), "image_height": int(ny),
        }
        up = call("upload", upload_args,
                  files={"file": ("sources.xyls", xyls.read_bytes())})
    subid = up["subid"]

    deadline = _time.monotonic() + timeout
    job_id = None
    while _time.monotonic() < deadline:
        if job_id is None:
            sub = http.get(f"{api_url}submissions/{subid}",
                           timeout=60).json()
            jobs = [j for j in sub.get("jobs", []) if j]
            if jobs:
                job_id = jobs[0]
        else:
            job = http.get(f"{api_url}jobs/{job_id}", timeout=60).json()
            status = job.get("status")
            if status == "success":
                base = api_url[: -len("api/")] if api_url.endswith("api/") \
                    else api_url
                wcs_bytes = http.get(f"{base}wcs_file/{job_id}",
                                     timeout=60).content
                with tempfile.TemporaryDirectory() as tmp:
                    wcs_path = Path(tmp) / "solution.wcs"
                    wcs_path.write_bytes(wcs_bytes)
                    _, wcs_header = read_fits(wcs_path, header_only=True)
                return TanWCS.from_header(wcs_header)
            if status == "failure":
                raise CouldNotSolveError(
                    f"nova.astrometry.net job {job_id} failed")
        _time.sleep(poll_interval)
    raise CouldNotSolveError(
        f"nova.astrometry.net timed out after {timeout:.0f}s "
        f"(submission {subid}, job {job_id})")


def solve_one_image(image_path, sources_path, user_config):
    """Blind astrometric solution via astrometry.net.

    Local ``solve-field`` by default; the nova.astrometry.net web API
    when ``astrometry_net_api_key`` is set (the reference's dispatch,
    processes/plate_solving.py:48-52).  Feeds the extracted source
    list (x, y, flux; brightest first) with the ROI position hint and
    plate-scale interval, then writes the solved WCS into the frame
    header.

    Raises CouldNotSolveError when the solver is unavailable or fails.
    """
    from .star_extraction import read_sources

    sources = read_sources(sources_path)
    data, header = read_fits(image_path)
    ny, nx = data.shape

    if user_config.get("astrometry_net_api_key"):
        wcs = solve_via_nova_api(sources, nx, ny, user_config)
        from ..io.wcs import strip_wcs_cards

        strip_wcs_cards(header)
        header.update(wcs.to_header_cards())
        write_fits(image_path, data, header)
        return wcs

    if not solve_field_available():
        raise CouldNotSolveError(
            "astrometry.net's solve-field is not installed; set "
            "astrometry_net_api_key to use the nova.astrometry.net web "
            "API, use plate_solving_strategy 'alternate_gaia_solve' or "
            "'adapt_wcs_from_reference', or set already_plate_solved.")
    scale_min, scale_max = user_config["plate_scale_interval"]

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        xyls = tmp / "sources.xyls"
        _write_xyls(xyls, sources, nx, ny)
        cmd = [
            "solve-field", str(xyls),
            "--width", str(nx), "--height", str(ny),
            "--x-column", "X", "--y-column", "Y",
            "--sort-column", "FLUX",
            "--scale-units", "arcsecperpix",
            "--scale-low", str(scale_min), "--scale-high", str(scale_max),
            "--ra", str(user_config["ROI_ra_deg"]),
            "--dec", str(user_config["ROI_dec_deg"]),
            "--radius", "2",
            "--no-plots", "--overwrite", "--dir", str(tmp),
            "--odds-to-solve", "1e8",
        ]
        result = subprocess.run(cmd, capture_output=True, timeout=300)
        wcs_file = tmp / "sources.wcs"
        if result.returncode != 0 or not wcs_file.exists():
            raise CouldNotSolveError(
                f"solve-field failed: {result.stderr[-500:]!r}")
        _, wcs_header = read_fits(wcs_file, header_only=True)
        wcs = TanWCS.from_header(wcs_header)

    from ..io.wcs import strip_wcs_cards

    strip_wcs_cards(header)
    header.update(wcs.to_header_cards())
    write_fits(image_path, data, header)
    return wcs


def _write_xyls(path, sources, nx, ny):
    """Minimal FITS BINTABLE with X, Y, FLUX columns for solve-field."""
    import struct

    n = len(sources)
    rows = b"".join(
        struct.pack(">ddd", row.x + 1.0, row.y + 1.0, row.flux)
        for row in sources.itertuples())
    cards = [
        ("SIMPLE", "T"), ("BITPIX", "8"), ("NAXIS", "0"), ("EXTEND", "T"),
    ]
    primary = "".join(f"{k:<8}= {v:>20}".ljust(80) for k, v in cards)
    primary += "END".ljust(80)
    primary += " " * (-len(primary) % 2880)
    ext_cards = [
        ("XTENSION", "'BINTABLE'"), ("BITPIX", "8"), ("NAXIS", "2"),
        ("NAXIS1", str(24)), ("NAXIS2", str(n)), ("PCOUNT", "0"),
        ("GCOUNT", "1"), ("TFIELDS", "3"),
        ("TTYPE1", "'X       '"), ("TFORM1", "'D       '"),
        ("TTYPE2", "'Y       '"), ("TFORM2", "'D       '"),
        ("TTYPE3", "'FLUX    '"), ("TFORM3", "'D       '"),
        ("IMAGEW", str(nx)), ("IMAGEH", str(ny)),
    ]
    ext = "".join(f"{k:<8}= {v:>20}".ljust(80) for k, v in ext_cards)
    ext += "END".ljust(80)
    ext += " " * (-len(ext) % 2880)
    payload = rows + b"\0" * (-len(rows) % 2880)
    path.write_bytes(primary.encode() + ext.encode() + payload)


def post_plate_solve_steps(frame_path, user_config, frame_id):
    """Footprint insert, ROI containment, anisotropy check, scale/angle."""
    logger = logging.getLogger("lightcurver.plate_solving")
    data, header = read_fits(frame_path)
    try:
        wcs = TanWCS.from_header(header)
    except (KeyError, ValueError):
        logger.info(f"Frame {frame_id}: no valid WCS.")
        return
    shape = data.shape

    if wcs.contains_world(user_config["ROI_ra_deg"],
                          user_config["ROI_dec_deg"], shape):
        execute_sqlite_query(
            "UPDATE frames SET roi_in_footprint = 1 WHERE id = ?",
            params=(frame_id,), is_select=False)

    footprint = np.array(wcs.footprint_polygon(shape))
    database_insert_single_footprint(frame_id, footprint)

    anisotropy = wcs.pixel_anisotropy()  # |sx-sy|/(sx+sy)
    if anisotropy > float(user_config["max_pixel_anisotropy"]):
        logger.info(f"Frame {frame_id}: anisotropy {anisotropy:.1%} above "
                    "tolerance, eliminating.")
        execute_sqlite_query(
            "UPDATE frames SET eliminated = 1, "
            "comment='suspicious_plate_solved' WHERE id = ?",
            params=(frame_id,), is_select=False)

    pixel_scale = wcs.pixel_scale_arcsec()
    execute_sqlite_query(
        "UPDATE frames SET pixel_scale = ? WHERE id = ?",
        params=(pixel_scale, frame_id), is_select=False)
    execute_sqlite_query(
        "UPDATE frames SET seeing_arcseconds = pixel_scale * seeing_pixels, "
        "angle_to_north = ? WHERE id = ?",
        params=(get_angle_wcs(wcs), frame_id), is_select=False)
    logger.info(f"Frame {frame_id}: pixel scale {pixel_scale:.3f}\"/px.")


def solve_one_image_and_update_database(image_path, sources_path,
                                        user_config, frame_id):
    """Solve (unless already solved) + bookkeeping + status columns."""
    logger = logging.getLogger("lightcurver.plate_solving")
    if not user_config["already_plate_solved"]:
        try:
            solve_one_image(image_path, sources_path, user_config)
            success = True
        except (CouldNotSolveError, subprocess.TimeoutExpired) as e:
            logger.warning(f"Frame {frame_id}: plate solve failed: {e}")
            success = False
    else:
        success = True

    if success:
        post_plate_solve_steps(frame_path=image_path,
                               user_config=user_config, frame_id=frame_id)
    execute_sqlite_query(
        "UPDATE frames SET plate_solved = ?, attempted_plate_solve = 1 "
        "WHERE id = ?",
        params=(1 if success else 0, frame_id), is_select=False)
