"""SQL ingest — the result of a SELECT as a Frame.

Reference: h2o3_tpu/io/sql.py (water/jdbc/SQLManager.java:
``import_sql_select`` / ``import_sql_table``). A ``sqlite://`` URL
opens the standard library's sqlite3; any other database is reached
through a DB-API 2.0 connection the caller passes as ``conn=``. A
column whose values are all numbers (or NULL) is numeric, any other
column a categorical of its values' text; NULL is NA. The frame lands on
``device`` (the card unless the caller names another).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.parallel import device as dev_mod


def _connect(connection_url: str):
    """A DB-API connection for a ``sqlite://`` URL (``sqlite:////abs``
    is an absolute path); raises ``IOError`` for any other scheme."""
    if connection_url.startswith("sqlite://"):
        import sqlite3
        path = connection_url[len("sqlite://"):].lstrip("/")
        if connection_url.startswith("sqlite:////"):
            path = "/" + path
        return sqlite3.connect(path)
    raise IOError(
        f"no built-in driver for '{connection_url}' — pass a DB-API "
        "connection object to import_sql_select(conn=...) instead "
        "(the reference equally requires a JDBC driver jar)")


def import_sql_select(connection_url: Optional[str] = None,
                      select_query: str = "",
                      conn=None,
                      destination_frame: Optional[str] = None,
                      device: dev_mod.DeviceLike = None) -> Frame:
    """Run a SELECT and land its rows as a Frame on ``device``, stored
    in the DKV under ``destination_frame`` when one is given
    (SQLManager.importSqlSelect). A connection this call opens from
    ``connection_url`` it also closes; ``conn`` stays open."""
    device = dev_mod.resolve_device(device)
    own = False
    if conn is None:
        conn = _connect(connection_url)
        own = True
    try:
        cur = conn.cursor()
        cur.execute(select_query)
        names = [d[0] for d in cur.description]
        rows = cur.fetchall()
    finally:
        if own:
            conn.close()
    columns = list(zip(*rows)) if rows else [()] * len(names)
    cols = {}
    cats = []
    for name, vals in zip(names, columns):
        kinds = set(map(type, vals))
        if kinds <= {int, float, bool}:
            cols[name] = np.array(vals, dtype=np.float64)
        elif all(issubclass(k, (int, float)) or k is type(None)
                 for k in kinds):
            cols[name] = np.asarray(
                [np.nan if v is None else float(v) for v in vals],
                dtype=np.float64)
        else:
            cols[name] = np.asarray(
                vals if kinds <= {str} else
                [None if v is None else str(v) for v in vals], dtype=object)
            cats.append(name)
    return Frame.from_numpy(cols, categorical=cats, device=device,
                            key=destination_frame)


def import_sql_table(connection_url: Optional[str] = None, table: str = "",
                     columns: str = "*", conn=None,
                     destination_frame: Optional[str] = None,
                     device: dev_mod.DeviceLike = None) -> Frame:
    """``SELECT columns FROM table`` through ``import_sql_select``
    (SQLManager.importSqlTable)."""
    return import_sql_select(connection_url,
                             f"SELECT {columns} FROM {table}",  # noqa: S608
                             conn=conn, destination_frame=destination_frame,
                             device=device)
