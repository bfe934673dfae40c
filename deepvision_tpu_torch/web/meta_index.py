"""Meta-index database: list indexes, payload stores, caches, ops tables.

Re-implements the reference's 21-table meta-index schema
(``ensure_meta_index_schema`` web/server.py:7500-7838, connection factory
:7839).  SQLite single-node by default; a postgres:// DATABASE_URL routes
through the db shim for shared multi-worker deployments.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Optional

from deepvision_tpu_torch.web.db import connect_db, pool

SCHEMA = [
    # --- list indexes (hot query path; reference :7520-7614) ------------
    """CREATE TABLE IF NOT EXISTS session_index (
        session_id TEXT PRIMARY KEY,
        owner_user_id TEXT,
        instance_scope TEXT,
        topic TEXT,
        status TEXT,
        interview_mode TEXT,
        scenario_id TEXT,
        interview_count INTEGER DEFAULT 0,
        dimensions_json TEXT,
        current_report_name TEXT,
        last_report_name TEXT,
        file_signature TEXT,
        created_at TEXT,
        updated_at TEXT
    )""",
    """CREATE INDEX IF NOT EXISTS idx_session_owner_updated
        ON session_index(owner_user_id, instance_scope, updated_at DESC)""",
    """CREATE INDEX IF NOT EXISTS idx_session_owner_created
        ON session_index(owner_user_id, instance_scope, created_at DESC)""",
    """CREATE TABLE IF NOT EXISTS report_index (
        report_name TEXT PRIMARY KEY,
        owner_user_id TEXT,
        instance_scope TEXT,
        session_id TEXT,
        topic TEXT,
        report_profile TEXT,
        source_report_name TEXT,
        report_variant_label TEXT,
        deleted INTEGER DEFAULT 0,
        size_bytes INTEGER DEFAULT 0,
        created_at TEXT,
        updated_at TEXT
    )""",
    """CREATE INDEX IF NOT EXISTS idx_report_owner_created
        ON report_index(owner_user_id, instance_scope, deleted, created_at DESC)""",
    # --- full payload stores ("pure cloud" mode; reference :7615+) ------
    """CREATE TABLE IF NOT EXISTS session_store (
        session_id TEXT PRIMARY KEY,
        payload TEXT,
        updated_at TEXT
    )""",
    """CREATE TABLE IF NOT EXISTS report_store (
        report_name TEXT PRIMARY KEY,
        content TEXT,
        updated_at TEXT
    )""",
    # --- report meta maps ----------------------------------------------
    """CREATE TABLE IF NOT EXISTS report_meta_owners (
        report_name TEXT PRIMARY KEY, owner_user_id TEXT)""",
    """CREATE TABLE IF NOT EXISTS report_meta_scopes (
        report_name TEXT PRIMARY KEY, instance_scope TEXT)""",
    """CREATE TABLE IF NOT EXISTS report_meta_shares (
        share_token TEXT PRIMARY KEY,
        report_name TEXT,
        created_at TEXT,
        revoked INTEGER DEFAULT 0
    )""",
    """CREATE TABLE IF NOT EXISTS report_meta_deletions (
        report_name TEXT PRIMARY KEY, deleted_at TEXT)""",
    # --- scenarios ------------------------------------------------------
    """CREATE TABLE IF NOT EXISTS custom_scenarios (
        scenario_id TEXT PRIMARY KEY,
        owner_user_id TEXT,
        instance_scope TEXT,
        payload TEXT,
        created_at TEXT
    )""",
    # --- solution sidecars / caches ------------------------------------
    """CREATE TABLE IF NOT EXISTS solution_sidecar_store (
        report_name TEXT PRIMARY KEY, payload TEXT, updated_at TEXT)""",
    """CREATE TABLE IF NOT EXISTS solution_payload_cache (
        report_name TEXT PRIMARY KEY, payload TEXT, fingerprint TEXT,
        updated_at TEXT)""",
    # --- presentation map ----------------------------------------------
    """CREATE TABLE IF NOT EXISTS presentation_map_store (
        report_name TEXT PRIMARY KEY, payload TEXT, updated_at TEXT)""",
    # --- site config / runtime flags -----------------------------------
    """CREATE TABLE IF NOT EXISTS site_config_store (
        key TEXT PRIMARY KEY, value TEXT, updated_at TEXT)""",
    # --- metrics --------------------------------------------------------
    """CREATE TABLE IF NOT EXISTS runtime_metrics_store (
        id INTEGER PRIMARY KEY AUTOINCREMENT,
        kind TEXT, payload TEXT, created_at TEXT)""",
    # --- caches ---------------------------------------------------------
    """CREATE TABLE IF NOT EXISTS summary_cache_store (
        content_hash TEXT PRIMARY KEY, summary TEXT, doc_name TEXT,
        created_at TEXT)""",
    """CREATE TABLE IF NOT EXISTS converted_cache_store (
        content_sha256 TEXT PRIMARY KEY, markdown TEXT, source_name TEXT,
        created_at TEXT)""",
    # --- exports / ops --------------------------------------------------
    """CREATE TABLE IF NOT EXISTS export_asset_store (
        asset_id TEXT PRIMARY KEY,
        report_name TEXT,
        format TEXT,
        filename TEXT,
        content BLOB,
        created_at TEXT
    )""",
    """CREATE TABLE IF NOT EXISTS ops_archive_store (
        id INTEGER PRIMARY KEY AUTOINCREMENT,
        kind TEXT, ref TEXT, payload TEXT, created_at TEXT)""",
    """CREATE TABLE IF NOT EXISTS ownership_migration_log (
        id INTEGER PRIMARY KEY AUTOINCREMENT,
        action TEXT, payload TEXT, backup_path TEXT, created_at TEXT)""",
    """CREATE TABLE IF NOT EXISTS startup_snapshot_store (
        id INTEGER PRIMARY KEY AUTOINCREMENT, payload TEXT, created_at TEXT)""",
    """CREATE TABLE IF NOT EXISTS report_generation_status_store (
        session_id TEXT PRIMARY KEY, payload TEXT, updated_at TEXT)""",
]


def utc_now_iso() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


class MetaIndex:
    def __init__(self, target: str):
        self.target = target
        self._write_lock = threading.Lock()
        self.ensure_schema()

    def conn(self):
        return pool.get(self.target)

    def ensure_schema(self) -> None:
        conn = connect_db(self.target)
        for ddl in SCHEMA:
            conn.execute(ddl)
        conn.commit()
        conn.close()

    # -- generic helpers -------------------------------------------------
    def execute(self, sql: str, params: tuple = ()):  # write path
        with self._write_lock:
            conn = self.conn()
            cur = conn.execute(sql, params)
            conn.commit()
            return cur

    def query(self, sql: str, params: tuple = ()):  # read path
        return self.conn().execute(sql, params).fetchall()

    def query_one(self, sql: str, params: tuple = ()):
        return self.conn().execute(sql, params).fetchone()

    # -- kv-style accessors for the simple stores ------------------------
    def kv_set(self, table: str, key_col: str, key: str,
               value_col: str, value: str) -> None:
        self.execute(
            f"INSERT INTO {table} ({key_col}, {value_col}, updated_at) "
            f"VALUES (?, ?, ?) ON CONFLICT({key_col}) DO UPDATE SET "
            f"{value_col} = excluded.{value_col}, "
            f"updated_at = excluded.updated_at",
            (key, value, utc_now_iso()),
        )

    def kv_get(self, table: str, key_col: str, key: str,
               value_col: str) -> Optional[str]:
        row = self.query_one(
            f"SELECT {value_col} FROM {table} WHERE {key_col} = ?", (key,)
        )
        return row[value_col] if row else None

    def kv_delete(self, table: str, key_col: str, key: str) -> None:
        self.execute(f"DELETE FROM {table} WHERE {key_col} = ?", (key,))

    # -- site config (runtime-togglable flags; reference :9322-9650) -----
    def site_config_get(self, key: str, default: Any = None) -> Any:
        raw = self.kv_get("site_config_store", "key", key, "value")
        if raw is None:
            return default
        try:
            return json.loads(raw)
        except Exception:
            return raw

    def site_config_set(self, key: str, value: Any) -> None:
        self.kv_set(
            "site_config_store", "key", key, "value", json.dumps(value)
        )
