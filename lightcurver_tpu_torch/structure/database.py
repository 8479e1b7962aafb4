"""SQLite state store: a copy of ``lightcurver_tpu/structure/database.py``.

The schema (``_FRAMES_COLUMNS``, ``_SCHEMA``) and ``initialize_database``,
which writes it with the same SQL text as the JAX package, so one
database serves either package's tasks; the query helpers
(``execute_sqlite_query``, ``executemany_sqlite``, ``get_pandas``,
``get_count_based_on_conditions``), the star selection (``select_stars``,
``select_stars_for_a_frame``) and the stars of a frame
(``query_all_stars_for_frame_and_footprint``). pandas is imported by the
queries that return a DataFrame, so the module imports without it.
"""

import sqlite3

import numpy as np

from .user_config import _as_name_list, get_user_config

_FRAMES_COLUMNS = [
    "id INTEGER PRIMARY KEY",
    "mjd REAL",
    "exptime REAL",
    "gain REAL",
    "original_image_path TEXT",
    "image_relpath TEXT UNIQUE",
    "sources_relpath TEXT",
    "telescope_latitude REAL",
    "telescope_longitude REAL",
    "telescope_elevation REAL",
    "telescope_name TEXT",
    "telescope_imager_name TEXT",
    "plate_solved INTEGER DEFAULT 0",
    "attempted_plate_solve INTEGER DEFAULT 0",
    "pixel_scale REAL DEFAULT NULL",
    "eliminated INTEGER DEFAULT 0",
    "airmass REAL DEFAULT NULL",
    "degrees_to_moon REAL DEFAULT NULL",
    "moon_phase REAL DEFAULT NULL",
    "sun_altitude REAL DEFAULT NULL",
    "seeing_pixels REAL DEFAULT NULL",
    "seeing_arcseconds REAL DEFAULT NULL",
    "sky_level_electron_per_second REAL DEFAULT NULL",
    "background_rms_electron_per_second REAL DEFAULT NULL",
    "ellipticity REAL DEFAULT NULL",
    "azimuth REAL DEFAULT NULL",
    "altitude REAL DEFAULT NULL",
    "comment TEXT DEFAULT NULL",
    "roi_in_footprint INTEGER DEFAULT 0",
    "angle_to_north REAL DEFAULT 0.0",
]

_SCHEMA = {
    "footprints": """(
        frame_id INTEGER PRIMARY KEY,
        polygon TEXT NOT NULL,
        FOREIGN KEY (frame_id) REFERENCES frames (id))""",
    "combined_footprint": """(
        id INTEGER PRIMARY KEY,
        hash INTEGER UNIQUE,
        largest TEXT,
        common TEXT)""",
    "stars": """(
        combined_footprint_hash INTEGER,
        name TEXT DEFAULT NULL,
        ra REAL,
        dec REAL,
        gmag REAL,
        rmag REAL,
        bmag REAL,
        pmra REAL,
        pmdec REAL,
        ref_epoch REAL,
        gaia_id TEXT,
        distance_to_roi_arcsec REAL,
        FOREIGN KEY (combined_footprint_hash)
            REFERENCES combined_footprint(hash),
        PRIMARY KEY (combined_footprint_hash, gaia_id))""",
    "catalog_star_photometry": """(
        star_gaia_id TEXT,
        catalog TEXT,
        band TEXT,
        mag REAL,
        mag_err REAL,
        original_catalog_id TEXT,
        FOREIGN KEY (star_gaia_id) REFERENCES stars(gaia_id),
        PRIMARY KEY (catalog, star_gaia_id))""",
    "stars_in_frames": """(
        frame_id INTEGER,
        star_gaia_id TEXT,
        combined_footprint_hash INTEGER,
        FOREIGN KEY (frame_id) REFERENCES frames(id),
        FOREIGN KEY (star_gaia_id) REFERENCES stars(gaia_id),
        FOREIGN KEY (combined_footprint_hash)
            REFERENCES combined_footprint(hash),
        PRIMARY KEY (combined_footprint_hash, frame_id, star_gaia_id))""",
    "PSFs": """(
        combined_footprint_hash INTEGER,
        frame_id INTEGER,
        chi2 REAL,
        psf_ref TEXT,
        subsampling_factor INTEGER,
        relative_loss_differential REAL,
        fwhm_moffat_arcseconds REAL DEFAULT NULL,
        FOREIGN KEY (frame_id) REFERENCES frames(id),
        FOREIGN KEY (combined_footprint_hash)
            REFERENCES combined_footprint(hash),
        PRIMARY KEY (combined_footprint_hash, frame_id, psf_ref))""",
    "star_flux_in_frame": """(
        frame_id INTEGER,
        star_gaia_id TEXT,
        combined_footprint_hash INTEGER,
        flux REAL,
        flux_uncertainty REAL,
        chi2 REAL,
        relative_loss_differential REAL,
        FOREIGN KEY (frame_id) REFERENCES frames(id),
        FOREIGN KEY (star_gaia_id) REFERENCES stars(gaia_id),
        FOREIGN KEY (combined_footprint_hash)
            REFERENCES combined_footprint(hash),
        PRIMARY KEY (combined_footprint_hash, frame_id, star_gaia_id))""",
    "normalization_coefficients": """(
        frame_id INTEGER,
        combined_footprint_hash INTEGER,
        coefficient REAL,
        coefficient_uncertainty REAL,
        FOREIGN KEY (frame_id) REFERENCES frames(id),
        FOREIGN KEY (combined_footprint_hash)
            REFERENCES combined_footprint(hash),
        PRIMARY KEY (combined_footprint_hash, frame_id))""",
    "absolute_zeropoints": """(
        frame_id INTEGER,
        combined_footprint_hash INTEGER,
        zeropoint REAL,
        zeropoint_uncertainty REAL,
        source_catalog TEXT,
        FOREIGN KEY (frame_id) REFERENCES frames(id),
        FOREIGN KEY (combined_footprint_hash)
            REFERENCES combined_footprint(hash),
        PRIMARY KEY (combined_footprint_hash, frame_id))""",
}


def _db_path(db_path=None):
    return db_path if db_path is not None else get_user_config()[
        "database_path"]


def _connect(db_path=None, timeout=15.0):
    conn = sqlite3.connect(_db_path(db_path), timeout=timeout)
    # WAL lets concurrent writers proceed without retry loops
    conn.execute("PRAGMA journal_mode=WAL")
    conn.execute("PRAGMA busy_timeout=15000")
    return conn


def initialize_database(db_path=None):
    """Create all tables (idempotent); add new frames columns on upgrade."""
    with _connect(db_path) as conn:
        conn.execute(
            f"CREATE TABLE IF NOT EXISTS frames ({', '.join(_FRAMES_COLUMNS)})")
        # forward-compatible: an older database gains the new columns
        for coldef in _FRAMES_COLUMNS:
            try:
                conn.execute(f"ALTER TABLE frames ADD COLUMN {coldef}")
            except sqlite3.OperationalError:
                pass
        for table, body in _SCHEMA.items():
            conn.execute(f"CREATE TABLE IF NOT EXISTS {table} {body}")
        conn.commit()


def _clean_params(params):
    """numpy scalars -> Python scalars before binding: sqlite3 binds numpy
    integers as BLOBs, which compare unequal to INTEGER columns."""
    return tuple(p.item() if isinstance(p, np.generic) else p
                 for p in params)


def execute_sqlite_query(query, params=(), is_select=True, timeout=15.0,
                         use_pandas=False):
    """Run one query: fetched rows (or a DataFrame when ``use_pandas``) for
    a select, the affected row count otherwise."""
    params = _clean_params(params)
    with _connect(timeout=timeout) as conn:
        if is_select:
            if use_pandas:
                import pandas as pd

                return pd.read_sql_query(sql=query, con=conn, params=params)
            return conn.execute(query, params).fetchall()
        cur = conn.execute(query, params)
        conn.commit()
        return cur.rowcount


def executemany_sqlite(query, rows, timeout=15.0):
    """Batched write (upserts); returns the affected row count."""
    rows = [_clean_params(r) for r in rows]
    with _connect(timeout=timeout) as conn:
        cur = conn.executemany(query, rows)
        conn.commit()
        return cur.rowcount


def get_pandas(conditions=None, columns=None, table="frames"):
    """SELECT {columns} FROM {table} [WHERE and-joined conditions] ->
    DataFrame."""
    cols = "*" if columns is None else ",".join(columns)
    query = f"SELECT {cols} FROM {table}"
    if conditions:
        query += " WHERE " + " AND ".join(conditions)
    return execute_sqlite_query(query, use_pandas=True)


def get_count_based_on_conditions(conditions, table="frames"):
    """COUNT(*) under a raw SQL condition string."""
    rows = execute_sqlite_query(
        f"SELECT COUNT(*) FROM {table} WHERE {conditions}")
    return rows[0][0]


def _apply_star_selection(base_query, base_params, stars_to_use,
                          stars_to_exclude, order_column="s"):
    """Shared star selection: the N closest to the ROI (None: 10), or a
    list of names; then the exclusions."""
    if stars_to_use is None:
        stars_to_use = 10
    if isinstance(stars_to_use, int):
        query = (base_query
                 + f" ORDER BY {order_column}.distance_to_roi_arcsec ASC"
                 + " LIMIT ?")
        params = (*base_params, stars_to_use)
    elif isinstance(stars_to_use, list):
        if not stars_to_use:
            # "IN ()" would be an SQLite syntax error deep inside a task
            raise ValueError(
                "stars_to_use is an empty list; give star names, an "
                "integer count, or null (top-10 closest)")
        marks = ",".join("?" * len(stars_to_use))
        query = base_query + f" AND {order_column}.name IN ({marks})"
        params = (*base_params, *stars_to_use)
    else:
        raise RuntimeError(
            f"stars_to_use: expected None, int or list, got "
            f"{type(stars_to_use)}")
    df = execute_sqlite_query(query, params, use_pandas=True)
    if stars_to_exclude:
        # comma-aware, as the config loader parses it
        stars_to_exclude = _as_name_list(stars_to_exclude)
        if not isinstance(stars_to_exclude, list):
            raise RuntimeError(
                f"stars_to_exclude: expected None, str or list, got "
                f"{type(stars_to_exclude)}")
        df = df[~df["name"].isin(stars_to_exclude)]
    return df


def select_stars(combined_footprint_hash, stars_to_use=None,
                 stars_to_exclude=None):
    """Stars of a footprint: the N closest to the ROI, or by name; the
    exclusions take precedence."""
    base = "SELECT * FROM stars s WHERE combined_footprint_hash = ?"
    return _apply_star_selection(base, (combined_footprint_hash,),
                                 stars_to_use, stars_to_exclude)


def select_stars_for_a_frame(frame_id, combined_footprint_hash,
                             stars_to_use=None, stars_to_exclude=None):
    """The stars of a frame (through ``stars_in_frames``), selected as by
    :func:`select_stars`."""
    base = """
        SELECT sif.frame_id, s.gaia_id, s.name, s.ra, s.dec,
               s.distance_to_roi_arcsec
        FROM stars_in_frames sif
        JOIN stars s ON sif.star_gaia_id = s.gaia_id
                    AND sif.combined_footprint_hash = s.combined_footprint_hash
        WHERE sif.frame_id = ? AND s.combined_footprint_hash = ?"""
    return _apply_star_selection(base, (frame_id, combined_footprint_hash),
                                 stars_to_use, stars_to_exclude)


def query_all_stars_for_frame_and_footprint(frame_id,
                                            combined_footprint_hash=None):
    """All stars linked to a frame, optionally filtered by footprint."""
    query = """
        SELECT stars.* FROM stars
        INNER JOIN stars_in_frames
            ON stars.gaia_id = stars_in_frames.star_gaia_id
           AND stars.combined_footprint_hash =
               stars_in_frames.combined_footprint_hash
        WHERE stars_in_frames.frame_id = ?"""
    params = [frame_id]
    if combined_footprint_hash is not None:
        query += " AND stars.combined_footprint_hash = ?"
        params.append(combined_footprint_hash)
    return execute_sqlite_query(query, params, use_pandas=True)
