"""SQLite state store: a copy of the query helpers of
``lightcurver_tpu/structure/database.py`` that the port's tasks call
(``execute_sqlite_query``, ``executemany_sqlite``, ``get_pandas``, and the
star selection ``select_stars`` / ``select_stars_for_a_frame``). The
schema, and writing it, stay with the JAX package's pipeline for now.
pandas is imported by the queries that return a DataFrame, so the module
imports without it.
"""

import sqlite3

import numpy as np

from .user_config import _as_name_list, get_user_config


def _db_path(db_path=None):
    return db_path if db_path is not None else get_user_config()[
        "database_path"]


def _connect(db_path=None, timeout=15.0):
    conn = sqlite3.connect(_db_path(db_path), timeout=timeout)
    # WAL lets concurrent writers proceed without retry loops
    conn.execute("PRAGMA journal_mode=WAL")
    conn.execute("PRAGMA busy_timeout=15000")
    return conn


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
