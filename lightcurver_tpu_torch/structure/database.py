"""SQLite state store: a copy of the query helpers of
``lightcurver_tpu/structure/database.py`` that the ROI task calls
(``execute_sqlite_query``, ``get_pandas``). The schema, and writing it,
stay with the JAX package's pipeline for now. pandas is imported by the
queries that return a DataFrame, so the module imports without it.
"""

import sqlite3

import numpy as np

from .user_config import get_user_config


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


def get_pandas(conditions=None, columns=None, table="frames"):
    """SELECT {columns} FROM {table} [WHERE and-joined conditions] ->
    DataFrame."""
    cols = "*" if columns is None else ",".join(columns)
    query = f"SELECT {cols} FROM {table}"
    if conditions:
        query += " WHERE " + " AND ".join(conditions)
    return execute_sqlite_query(query, use_pandas=True)
