"""Session & report persistence: JSON/markdown files + meta-index mirror.

Re-implements the reference's storage layer: session files with
mtime/size signature caching (``safe_load_session`` web/server.py:5281,
``get_file_signature`` :5317), per-session write locks (:2443-2500),
report save+sync (``save_report_content_and_sync`` :7413), owner/scope/
deletion maps (:16722), session<->report binding (:17098), share tokens
(:16422-16693), and dv-timestamped ids (:16222-16225).
"""

from __future__ import annotations

import json
import os
import re
import secrets
import threading
import time
from typing import Dict, List, Optional, Tuple

from deepvision_tpu_torch.web.meta_index import MetaIndex, utc_now_iso


def new_session_id() -> str:
    ts = time.strftime("%Y%m%d%H%M%S", time.gmtime())
    return f"dv-{ts}-{secrets.token_hex(4)}"


_SAFE_ID_RE = re.compile(r"^[A-Za-z0-9._\-一-鿿]+$")


def is_safe_name(name: str) -> bool:
    return bool(name) and ".." not in name and _SAFE_ID_RE.match(name) is not None


class _NamedLocks:
    """Per-key RLocks (reference named_file_lock web/server.py:2462)."""

    def __init__(self):
        self._guard = threading.Lock()
        self._locks: Dict[str, threading.RLock] = {}

    def get(self, key: str) -> threading.RLock:
        with self._guard:
            lock = self._locks.get(key)
            if lock is None:
                lock = self._locks[key] = threading.RLock()
            return lock


class SessionStore:
    def __init__(self, data_dir: str, meta: MetaIndex, use_db_payload: bool = False):
        self.dir = os.path.join(data_dir, "sessions")
        self.backups_dir = os.path.join(data_dir, "session_backups")
        os.makedirs(self.dir, exist_ok=True)
        self.meta = meta
        self.use_db_payload = use_db_payload
        self.locks = _NamedLocks()
        # signature cache: session_id -> (signature, payload); bounded so a
        # long-lived process with many sessions doesn't hold them all.
        self._cache: Dict[str, Tuple[str, dict]] = {}
        self._cache_cap = 256
        self._cache_lock = threading.Lock()
        self.cache_hits = 0
        self.cache_misses = 0

    # -- paths / signatures ---------------------------------------------
    def path(self, session_id: str) -> str:
        return os.path.join(self.dir, f"{session_id}.json")

    def file_signature(self, session_id: str) -> Optional[str]:
        try:
            st = os.stat(self.path(session_id))
            return f"{st.st_mtime_ns}:{st.st_size}"
        except OSError:
            return None

    # -- CRUD ------------------------------------------------------------
    def save(self, session: dict) -> None:
        session_id = session["session_id"]
        session["updated_at"] = utc_now_iso()
        payload = json.dumps(session, ensure_ascii=False)
        with self.locks.get(session_id):
            tmp = self.path(session_id) + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(payload)
            os.replace(tmp, self.path(session_id))
            sig = self.file_signature(session_id)
            with self._cache_lock:
                self._cache[session_id] = (sig, session)
                self._evict_cache_locked()
            self._sync_index(session, sig)
            if self.use_db_payload:
                self.meta.kv_set(
                    "session_store", "session_id", session_id,
                    "payload", payload,
                )

    def load(self, session_id: str) -> Optional[dict]:
        if not is_safe_name(session_id):
            return None
        sig = self.file_signature(session_id)
        if sig is not None:
            with self._cache_lock:
                hit = self._cache.get(session_id)
            if hit and hit[0] == sig:
                self.cache_hits += 1
                return hit[1]
        self.cache_misses += 1
        data = None
        if sig is not None:
            try:
                with open(self.path(session_id), "r", encoding="utf-8") as fh:
                    data = json.load(fh)
            except (OSError, json.JSONDecodeError):
                data = None
        if data is None and self.use_db_payload:
            raw = self.meta.kv_get(
                "session_store", "session_id", session_id, "payload"
            )
            if raw:
                try:
                    data = json.loads(raw)
                except json.JSONDecodeError:
                    data = None
        if data is not None and sig is not None:
            with self._cache_lock:
                self._cache[session_id] = (sig, data)
                self._evict_cache_locked()
        return data

    def _evict_cache_locked(self) -> None:
        while len(self._cache) > self._cache_cap:
            self._cache.pop(next(iter(self._cache)))

    def delete(self, session_id: str) -> bool:
        with self.locks.get(session_id):
            existed = os.path.isfile(self.path(session_id))
            try:
                os.remove(self.path(session_id))
            except OSError:
                pass
            with self._cache_lock:
                self._cache.pop(session_id, None)
            self.meta.execute(
                "DELETE FROM session_index WHERE session_id = ?", (session_id,)
            )
            self.meta.kv_delete("session_store", "session_id", session_id)
        return existed

    def backup(self, session_id: str, label: str = "restart") -> Optional[str]:
        """Snapshot before destructive ops (reference restart-interview
        backups :31913)."""
        data = self.load(session_id)
        if data is None:
            return None
        os.makedirs(self.backups_dir, exist_ok=True)
        name = f"{session_id}.{label}.{int(time.time())}.json"
        path = os.path.join(self.backups_dir, name)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(data, fh, ensure_ascii=False)
        return path

    # -- index -----------------------------------------------------------
    def _sync_index(self, session: dict, sig: Optional[str]) -> None:
        self.meta.execute(
            """INSERT INTO session_index (session_id, owner_user_id,
                instance_scope, topic, status, interview_mode, scenario_id,
                interview_count, dimensions_json, current_report_name,
                last_report_name, file_signature, created_at, updated_at)
               VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)
               ON CONFLICT(session_id) DO UPDATE SET
                owner_user_id=excluded.owner_user_id,
                instance_scope=excluded.instance_scope,
                topic=excluded.topic, status=excluded.status,
                interview_mode=excluded.interview_mode,
                scenario_id=excluded.scenario_id,
                interview_count=excluded.interview_count,
                dimensions_json=excluded.dimensions_json,
                current_report_name=excluded.current_report_name,
                last_report_name=excluded.last_report_name,
                file_signature=excluded.file_signature,
                updated_at=excluded.updated_at""",
            (
                session.get("session_id"),
                session.get("owner_user_id"),
                session.get("instance_scope"),
                session.get("topic"),
                session.get("status"),
                session.get("interview_mode"),
                session.get("scenario_id"),
                len(session.get("interview_log", [])),
                json.dumps(session.get("dimensions", {}), ensure_ascii=False),
                session.get("current_report_name"),
                session.get("last_report_name"),
                sig,
                session.get("created_at"),
                session.get("updated_at"),
            ),
        )

    def list_index(
        self, owner_user_id: Optional[str], instance_scope: str,
        page: int = 1, page_size: int = 20, order_by: str = "updated_at",
        status: Optional[str] = None,
    ) -> Tuple[List[dict], int]:
        order_col = "created_at" if order_by == "created_at" else "updated_at"
        where = "WHERE instance_scope = ?"
        params: list = [instance_scope]
        if owner_user_id is not None:
            where += " AND owner_user_id = ?"
            params.append(owner_user_id)
        if status is not None:
            where += " AND status = ?"
            params.append(status)
        total = self.meta.query_one(
            f"SELECT COUNT(*) AS n FROM session_index {where}", tuple(params)
        )["n"]
        rows = self.meta.query(
            f"SELECT * FROM session_index {where} "
            f"ORDER BY {order_col} DESC LIMIT ? OFFSET ?",
            tuple(params + [page_size, (page - 1) * page_size]),
        )
        return [dict(r) for r in rows], total


def build_session_report_filename(topic: str, session_id: str,
                                  variant: str = "") -> str:
    """Filename embeds session_id to avoid same-day/topic collisions
    (reference build_session_report_filename web/server.py:17004)."""
    date = time.strftime("%Y%m%d", time.gmtime())
    safe_topic = re.sub(r"[^\w一-鿿-]+", "_", topic or "report")[:40]
    suffix = f"-{variant}" if variant else ""
    return f"{safe_topic}-{date}-{session_id}{suffix}.md"


class ReportStore:
    def __init__(self, data_dir: str, meta: MetaIndex, use_db_payload: bool = False):
        self.dir = os.path.join(data_dir, "reports")
        os.makedirs(self.dir, exist_ok=True)
        self.meta = meta
        self.use_db_payload = use_db_payload
        self.locks = _NamedLocks()

    def path(self, report_name: str) -> str:
        return os.path.join(self.dir, report_name)

    # -- content ---------------------------------------------------------
    def save(
        self, report_name: str, content: str, *, owner_user_id: Optional[str],
        instance_scope: str, session_id: Optional[str] = None,
        topic: str = "", report_profile: str = "",
        source_report_name: str = "", variant_label: str = "",
    ) -> None:
        if not is_safe_name(report_name):
            raise ValueError(f"unsafe report name: {report_name!r}")
        with self.locks.get(report_name):
            tmp = self.path(report_name) + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(content)
            os.replace(tmp, self.path(report_name))
            now = utc_now_iso()
            self.meta.execute(
                """INSERT INTO report_index (report_name, owner_user_id,
                    instance_scope, session_id, topic, report_profile,
                    source_report_name, report_variant_label, deleted,
                    size_bytes, created_at, updated_at)
                   VALUES (?, ?, ?, ?, ?, ?, ?, ?, 0, ?, ?, ?)
                   ON CONFLICT(report_name) DO UPDATE SET
                    owner_user_id=excluded.owner_user_id,
                    instance_scope=excluded.instance_scope,
                    session_id=excluded.session_id,
                    topic=excluded.topic,
                    report_profile=excluded.report_profile,
                    source_report_name=excluded.source_report_name,
                    report_variant_label=excluded.report_variant_label,
                    deleted=0,
                    size_bytes=excluded.size_bytes,
                    updated_at=excluded.updated_at""",
                (
                    report_name, owner_user_id, instance_scope, session_id,
                    topic, report_profile, source_report_name, variant_label,
                    len(content.encode("utf-8")), now, now,
                ),
            )
            # a fresh save RESURRECTS a previously-deleted name: clearing
            # report_index.deleted alone is not enough because is_deleted()
            # consults the tombstone map — without this, regenerating a
            # report after deleting it 404s forever
            # (tests/test_report_versioning_grid.py caught it)
            self.meta.execute(
                "DELETE FROM report_meta_deletions WHERE report_name = ?",
                (report_name,),
            )
            if owner_user_id is not None:
                self.meta.execute(
                    "INSERT INTO report_meta_owners (report_name, owner_user_id)"
                    " VALUES (?, ?) ON CONFLICT(report_name) DO UPDATE SET"
                    " owner_user_id = excluded.owner_user_id",
                    (report_name, owner_user_id),
                )
            self.meta.execute(
                "INSERT INTO report_meta_scopes (report_name, instance_scope)"
                " VALUES (?, ?) ON CONFLICT(report_name) DO UPDATE SET"
                " instance_scope = excluded.instance_scope",
                (report_name, instance_scope),
            )
            if self.use_db_payload:
                self.meta.kv_set(
                    "report_store", "report_name", report_name,
                    "content", content,
                )

    def load(self, report_name: str) -> Optional[str]:
        if not is_safe_name(report_name):
            return None
        if self.is_deleted(report_name):
            return None
        try:
            with open(self.path(report_name), "r", encoding="utf-8") as fh:
                return fh.read()
        except OSError:
            pass
        if self.use_db_payload:
            return self.meta.kv_get(
                "report_store", "report_name", report_name, "content"
            )
        return None

    def delete(self, report_name: str) -> bool:
        """Soft delete (reference report_meta_deletions map)."""
        row = self.meta.query_one(
            "SELECT 1 AS x FROM report_index WHERE report_name = ?",
            (report_name,),
        )
        if row is None:
            return False
        self.meta.execute(
            "UPDATE report_index SET deleted = 1 WHERE report_name = ?",
            (report_name,),
        )
        self.meta.execute(
            "INSERT INTO report_meta_deletions (report_name, deleted_at) "
            "VALUES (?, ?) ON CONFLICT(report_name) DO UPDATE SET "
            "deleted_at = excluded.deleted_at",
            (report_name, utc_now_iso()),
        )
        return True

    def is_deleted(self, report_name: str) -> bool:
        return (
            self.meta.query_one(
                "SELECT 1 AS x FROM report_meta_deletions WHERE report_name = ?",
                (report_name,),
            )
            is not None
        )

    def owner_of(self, report_name: str) -> Optional[str]:
        row = self.meta.query_one(
            "SELECT owner_user_id FROM report_meta_owners WHERE report_name = ?",
            (report_name,),
        )
        return row["owner_user_id"] if row else None

    def scope_of(self, report_name: str) -> Optional[str]:
        row = self.meta.query_one(
            "SELECT instance_scope FROM report_meta_scopes WHERE report_name = ?",
            (report_name,),
        )
        return row["instance_scope"] if row else None

    # -- session binding (reference is_report_bound_to_session :17098) ---
    def is_bound_to_session(self, report_name: str, session_id: str) -> bool:
        row = self.meta.query_one(
            "SELECT session_id FROM report_index WHERE report_name = ?",
            (report_name,),
        )
        if row and row["session_id"] == session_id:
            return True
        return session_id in report_name

    # -- share tokens ----------------------------------------------------
    def create_share(self, report_name: str) -> str:
        """Idempotent per report: re-sharing returns the existing live token
        (reference test_solution_share_creation_is_idempotent_for_same_owner)."""
        row = self.meta.query_one(
            "SELECT share_token FROM report_meta_shares "
            "WHERE report_name = ? AND revoked = 0",
            (report_name,),
        )
        if row:
            return row["share_token"]
        token = secrets.token_urlsafe(24)
        self.meta.execute(
            "INSERT INTO report_meta_shares (share_token, report_name, "
            "created_at, revoked) VALUES (?, ?, ?, 0)",
            (token, report_name, utc_now_iso()),
        )
        return token

    def resolve_share(self, token: str) -> Optional[str]:
        row = self.meta.query_one(
            "SELECT report_name FROM report_meta_shares "
            "WHERE share_token = ? AND revoked = 0",
            (token,),
        )
        return row["report_name"] if row else None

    # -- listing ---------------------------------------------------------
    def list_index(
        self, owner_user_id: Optional[str], instance_scope: str,
        page: int = 1, page_size: int = 20,
    ) -> Tuple[List[dict], int]:
        where = "WHERE instance_scope = ? AND deleted = 0"
        params: list = [instance_scope]
        if owner_user_id is not None:
            where += " AND owner_user_id = ?"
            params.append(owner_user_id)
        total = self.meta.query_one(
            f"SELECT COUNT(*) AS n FROM report_index {where}", tuple(params)
        )["n"]
        rows = self.meta.query(
            f"SELECT * FROM report_index {where} "
            "ORDER BY created_at DESC LIMIT ? OFFSET ?",
            tuple(params + [page_size, (page - 1) * page_size]),
        )
        return [dict(r) for r in rows], total
