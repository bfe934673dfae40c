"""DB compatibility shim: one qmark-style API over SQLite and Postgres.

Re-implements the reference's db_compat.py contract (connect_db :340,
qmark->%s translation :158, PRAGMA emulation :188, row adapter :255):
callers always write sqlite-style SQL (``?`` placeholders,
``PRAGMA table_info``); the Postgres wrapper rewrites on the fly.
Postgres needs psycopg installed — gated with a clear error since this
image ships SQLite only.
"""

from __future__ import annotations

import re
import sqlite3
import threading
from typing import Iterable


def is_postgres_url(target: str) -> bool:
    return target.startswith(("postgres://", "postgresql://"))


def connect_db(target: str, timeout: float = 30.0):
    """``target``: sqlite file path or postgres:// URL."""
    if is_postgres_url(target):
        return PostgresConnectionWrapper(target)
    conn = sqlite3.connect(target, timeout=timeout, check_same_thread=False)
    conn.row_factory = sqlite3.Row
    conn.execute("PRAGMA journal_mode=WAL")
    conn.execute("PRAGMA busy_timeout=30000")
    return conn


_QMARK_RE = re.compile(r"\?")


def _translate_qmark_placeholders(sql: str) -> str:
    """qmark -> %s outside of string literals."""
    out = []
    in_str = False
    for ch in sql:
        if ch == "'":
            in_str = not in_str
            out.append(ch)
        elif ch == "?" and not in_str:
            out.append("%s")
        else:
            out.append(ch)
    return "".join(out)


_DDL_REWRITES = (
    (re.compile(r"\bINTEGER PRIMARY KEY AUTOINCREMENT\b", re.I),
     "BIGSERIAL PRIMARY KEY"),
    (re.compile(r"\bDATETIME\b", re.I), "TIMESTAMPTZ"),
    (re.compile(r"\bBLOB\b", re.I), "BYTEA"),
)


def _rewrite_ddl(sql: str) -> str:
    for pat, repl in _DDL_REWRITES:
        sql = pat.sub(repl, sql)
    return sql


_PRAGMA_RE = re.compile(r"PRAGMA\s+table_info\(['\"]?(\w+)['\"]?\)", re.I)


class _PGCursorWrapper:
    def __init__(self, cur):
        self._cur = cur

    def execute(self, sql: str, params: Iterable = ()):  # noqa: A002
        m = _PRAGMA_RE.match(sql.strip())
        if m:
            # Emulate PRAGMA table_info via information_schema.
            self._cur.execute(
                "SELECT ordinal_position - 1 AS cid, column_name AS name, "
                "data_type AS type, "
                "CASE WHEN is_nullable = 'NO' THEN 1 ELSE 0 END AS notnull, "
                "column_default AS dflt_value, 0 AS pk "
                "FROM information_schema.columns WHERE table_name = %s "
                "ORDER BY ordinal_position",
                (m.group(1),),
            )
            return self
        sql = _translate_qmark_placeholders(_rewrite_ddl(sql))
        self._cur.execute(sql, tuple(params))
        return self

    def executemany(self, sql, seq):
        sql = _translate_qmark_placeholders(_rewrite_ddl(sql))
        self._cur.executemany(sql, [tuple(p) for p in seq])
        return self

    def fetchone(self):
        return self._cur.fetchone()

    def fetchall(self):
        return self._cur.fetchall()

    @property
    def lastrowid(self):
        return getattr(self._cur, "lastrowid", None)

    @property
    def rowcount(self):
        return self._cur.rowcount

    def close(self):
        self._cur.close()


class PostgresConnectionWrapper:
    """sqlite3-shaped facade over psycopg (dict rows, qmark SQL)."""

    def __init__(self, url: str):
        try:
            import psycopg
            from psycopg.rows import dict_row
        except ImportError as e:  # pragma: no cover - env without psycopg
            raise ImportError(
                "Postgres mode requires psycopg; this deployment has SQLite "
                "only — unset DATABASE_URL or install psycopg[binary]"
            ) from e
        self._conn = psycopg.connect(url, row_factory=dict_row, autocommit=False)

    def cursor(self):
        return _PGCursorWrapper(self._conn.cursor())

    def execute(self, sql, params=()):
        cur = self.cursor()
        cur.execute(sql, params)
        return cur

    def commit(self):
        self._conn.commit()

    def rollback(self):
        self._conn.rollback()

    def close(self):
        self._conn.close()


class ConnectionPool:
    """Tiny thread-local connection reuse for SQLite (one conn per thread
    per path — SQLite WAL handles multi-reader/single-writer)."""

    def __init__(self):
        self._local = threading.local()

    def get(self, target: str):
        cache = getattr(self._local, "conns", None)
        if cache is None:
            cache = self._local.conns = {}
        conn = cache.get(target)
        if conn is None:
            conn = cache[target] = connect_db(target)
        return conn


pool = ConnectionPool()
