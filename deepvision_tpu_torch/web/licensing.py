"""License system: signed codes, lifecycle, runtime-togglable enforcement.

Re-implements the reference license subsystem (HMAC-signed codes
``hash_license_code`` web/server.py:10059, batch generate/activate/revoke/
extend + event timeline :10493-11391, runtime enforcement gate :9322-9650,
first-admin bootstrap :10367).
"""

from __future__ import annotations

import hashlib
import hmac
import secrets
import threading
import time
from typing import List, Optional

from deepvision_tpu_torch.web.db import connect_db, pool
from deepvision_tpu_torch.web.meta_index import MetaIndex, utc_now_iso

LICENSE_SCHEMA = [
    """CREATE TABLE IF NOT EXISTS licenses (
        license_id INTEGER PRIMARY KEY AUTOINCREMENT,
        code_hash TEXT UNIQUE,
        code_hint TEXT,
        batch_id TEXT,
        level TEXT DEFAULT 'standard',
        status TEXT DEFAULT 'issued',
        user_id INTEGER,
        issued_at TEXT,
        activated_at TEXT,
        expires_at TEXT,
        revoked_at TEXT
    )""",
    """CREATE TABLE IF NOT EXISTS license_events (
        event_id INTEGER PRIMARY KEY AUTOINCREMENT,
        license_id INTEGER,
        action TEXT,
        detail TEXT,
        created_at TEXT
    )""",
    """CREATE TABLE IF NOT EXISTS license_meta (
        key TEXT PRIMARY KEY, value TEXT)""",
]


class LicenseError(Exception):
    """Activation/admin failure with the reference's HTTP semantics
    (web/server.py:10644-10672: 403 for revoked/replaced, 409 when the
    code is bound to another account)."""

    def __init__(self, message: str, *, status_code: int = 400,
                 error_code: str = "license_invalid"):
        super().__init__(message)
        self.status_code = status_code
        self.error_code = error_code


class LicenseService:
    def __init__(self, db_path: str, meta: MetaIndex, *,
                 signing_secret: str = "", enforcement_default: bool = False):
        self.db_path = db_path
        self.meta = meta
        self._lock = threading.Lock()
        conn = connect_db(db_path)
        for ddl in LICENSE_SCHEMA:
            conn.execute(ddl)
        conn.commit()
        conn.close()
        if signing_secret:
            self._set_meta("signing_secret", signing_secret)
        elif self._get_meta("signing_secret") is None:
            self._set_meta("signing_secret", secrets.token_hex(32))
        self.enforcement_default = enforcement_default

    def conn(self):
        return pool.get(self.db_path)

    def _get_meta(self, key: str) -> Optional[str]:
        row = self.conn().execute(
            "SELECT value FROM license_meta WHERE key = ?", (key,)
        ).fetchone()
        return row["value"] if row else None

    def _set_meta(self, key: str, value: str) -> None:
        conn = self.conn()
        conn.execute(
            "INSERT INTO license_meta (key, value) VALUES (?, ?) "
            "ON CONFLICT(key) DO UPDATE SET value = excluded.value",
            (key, value),
        )
        conn.commit()

    # -- code hashing ----------------------------------------------------
    def hash_license_code(self, code: str) -> str:
        secret = self._get_meta("signing_secret") or ""
        return hmac.new(
            secret.encode(), code.encode(), hashlib.sha256
        ).hexdigest()

    # -- enforcement gate (runtime togglable; reference :9322-9650) ------
    def enforcement_enabled(self) -> bool:
        v = self.meta.site_config_get("license_enforcement")
        if v is None:
            return self.enforcement_default
        return bool(v)

    def set_enforcement(self, enabled: Optional[bool]) -> None:
        """None resets to follow the config default."""
        if enabled is None:
            self.meta.kv_delete("site_config_store", "key",
                                "license_enforcement")
        else:
            self.meta.site_config_set("license_enforcement", bool(enabled))

    # -- lifecycle -------------------------------------------------------
    def batch_generate(self, count: int, *, level: str = "standard",
                       days_valid: int = 365, batch_id: str = "") -> List[str]:
        batch_id = batch_id or f"batch-{int(time.time())}"
        codes = []
        conn = self.conn()
        with self._lock:
            for _ in range(count):
                code = "-".join(
                    secrets.token_hex(2).upper() for _ in range(4)
                )
                conn.execute(
                    "INSERT INTO licenses (code_hash, code_hint, batch_id, "
                    "level, status, issued_at, expires_at) "
                    "VALUES (?, ?, ?, ?, 'issued', ?, ?)",
                    (
                        self.hash_license_code(code), code[:4] + "****",
                        batch_id, level, utc_now_iso(),
                        _iso_in_days(days_valid),
                    ),
                )
                lic_id = conn.execute(
                    "SELECT last_insert_rowid() AS id"
                ).fetchone()["id"]
                self._event(conn, lic_id, "issued", batch_id)
                codes.append(code)
            conn.commit()
        return codes

    def activate(self, code: str, user_id) -> dict:
        conn = self.conn()
        with self._lock:
            row = conn.execute(
                "SELECT * FROM licenses WHERE code_hash = ?",
                (self.hash_license_code(code),),
            ).fetchone()
            if row is None:
                raise LicenseError("无效的激活码")
            # terminal statuses refuse re-activation outright (reference
            # web/server.py:10644-10652 returns 403 for revoked AND
            # replaced — a replaced code must never rebind)
            if row["status"] == "revoked":
                raise LicenseError("激活码已被撤销", status_code=403,
                                   error_code="license_revoked")
            if row["status"] == "replaced":
                raise LicenseError("激活码已被新激活码替换，无法再次使用",
                                   status_code=403,
                                   error_code="license_replaced")
            # a code ever bound to a different account stays bound,
            # whatever its status (reference :10656-10672 returns 409)
            if row["user_id"] not in (None, user_id):
                raise LicenseError(
                    "激活码已被其他账号使用", status_code=409,
                    error_code="license_bound_to_other_user")
            if row["expires_at"] and row["expires_at"] < utc_now_iso():
                raise LicenseError("激活码已过期", status_code=403,
                                   error_code="license_expired")
            # a new activation replaces the user's previous license; the
            # old one is released as 'replaced' (reference
            # test_new_license_replaces_old_license_and_switches_level).
            # Re-activating the SAME code is a no-op on the binding
            # (…_reactivating_same_license_keeps_current_binding_stable).
            old = conn.execute(
                "SELECT license_id FROM licenses WHERE user_id = ? AND "
                "status = 'active' AND license_id != ?",
                (user_id, row["license_id"]),
            ).fetchall()
            for o in old:
                conn.execute(
                    "UPDATE licenses SET status = 'replaced' "
                    "WHERE license_id = ?", (o["license_id"],),
                )
                self._event(conn, o["license_id"], "replaced",
                            f"by:{row['license_id']}")
            already_bound = (
                row["status"] == "active" and row["user_id"] == user_id
            )
            conn.execute(
                "UPDATE licenses SET status = 'active', user_id = ?, "
                "activated_at = COALESCE(activated_at, ?) "
                "WHERE license_id = ?",
                (user_id, utc_now_iso(), row["license_id"]),
            )
            if not already_bound:
                self._event(conn, row["license_id"], "activated",
                            f"user:{user_id}")
            conn.commit()
        return self.get(row["license_id"])

    def current_for_user(self, user_id) -> Optional[dict]:
        row = self.conn().execute(
            "SELECT * FROM licenses WHERE user_id = ? AND status = 'active' "
            "ORDER BY activated_at DESC LIMIT 1",
            (user_id,),
        ).fetchone()
        if row is None:
            return None
        lic = dict(row)
        lic.pop("code_hash", None)
        if lic.get("expires_at") and lic["expires_at"] < utc_now_iso():
            lic["status"] = "expired"
        return lic

    def user_has_valid_license(self, user_id) -> bool:
        lic = self.current_for_user(user_id)
        return bool(lic and lic["status"] == "active")

    def revoke(self, license_id: int, reason: str = "") -> None:
        conn = self.conn()
        conn.execute(
            "UPDATE licenses SET status = 'revoked', revoked_at = ? "
            "WHERE license_id = ?",
            (utc_now_iso(), license_id),
        )
        self._event(conn, license_id, "revoked", reason)
        conn.commit()

    def extend(self, license_id: int, days: int) -> dict:
        conn = self.conn()
        row = conn.execute(
            "SELECT expires_at FROM licenses WHERE license_id = ?",
            (license_id,),
        ).fetchone()
        if row is None:
            raise LicenseError("license not found")
        base = row["expires_at"] or utc_now_iso()
        new_exp = _iso_add_days(base, days)
        conn.execute(
            "UPDATE licenses SET expires_at = ? WHERE license_id = ?",
            (new_exp, license_id),
        )
        self._event(conn, license_id, "extended", f"+{days}d")
        conn.commit()
        return self.get(license_id)

    def get(self, license_id: int) -> Optional[dict]:
        row = self.conn().execute(
            "SELECT * FROM licenses WHERE license_id = ?", (license_id,)
        ).fetchone()
        if row is None:
            return None
        lic = dict(row)
        lic.pop("code_hash", None)
        return lic

    def events(self, license_id: int) -> List[dict]:
        rows = self.conn().execute(
            "SELECT * FROM license_events WHERE license_id = ? "
            "ORDER BY event_id",
            (license_id,),
        ).fetchall()
        return [dict(r) for r in rows]

    def search(self, *, batch_id: str = "", status: str = "",
               user_id=None, code: str = "", limit: int = 50,
               offset: int = 0) -> List[dict]:
        where, params = ["1=1"], []
        if batch_id:
            where.append("batch_id = ?")
            params.append(batch_id)
        if status:
            where.append("status = ?")
            params.append(status)
        if user_id is not None:
            where.append("user_id = ?")
            params.append(user_id)
        if code:
            where.append("code_hash = ?")
            params.append(self.hash_license_code(code))
        rows = self.conn().execute(
            f"SELECT * FROM licenses WHERE {' AND '.join(where)} "
            "ORDER BY license_id DESC LIMIT ? OFFSET ?",
            tuple(params + [limit, offset]),
        ).fetchall()
        out = []
        for r in rows:
            lic = dict(r)
            lic.pop("code_hash", None)
            out.append(lic)
        return out

    def summary(self) -> dict:
        conn = self.conn()
        by_status = {
            r["status"]: r["n"]
            for r in conn.execute(
                "SELECT status, COUNT(*) AS n FROM licenses GROUP BY status"
            ).fetchall()
        }
        soon = conn.execute(
            "SELECT COUNT(*) AS n FROM licenses WHERE status = 'active' AND "
            "expires_at < ?",
            (_iso_in_days(30),),
        ).fetchone()["n"]
        recent = [
            dict(r)
            for r in conn.execute(
                "SELECT * FROM license_events ORDER BY event_id DESC LIMIT 10"
            ).fetchall()
        ]
        return {"by_status": by_status, "expiring_30d": soon,
                "recent_events": recent}

    # -- first-admin bootstrap (reference :10367) ------------------------
    def bootstrap_status(self) -> dict:
        return {"bootstrapped": self._get_meta("bootstrapped") == "1"}

    def bootstrap(self, user_id) -> dict:
        if self._get_meta("bootstrapped") == "1":
            raise LicenseError("already bootstrapped")
        self._set_meta("bootstrapped", "1")
        self._set_meta("bootstrap_admin", str(user_id))
        return {"ok": True, "admin_user_id": user_id}

    def _event(self, conn, license_id: int, action: str, detail: str = ""):
        conn.execute(
            "INSERT INTO license_events (license_id, action, detail, "
            "created_at) VALUES (?, ?, ?, ?)",
            (license_id, action, detail, utc_now_iso()),
        )


def _iso_in_days(days: int) -> str:
    return time.strftime(
        "%Y-%m-%dT%H:%M:%SZ", time.gmtime(time.time() + days * 86400)
    )


def _iso_add_days(iso: str, days: int) -> str:
    try:
        base = time.mktime(time.strptime(iso, "%Y-%m-%dT%H:%M:%SZ"))
    except ValueError:
        base = time.time()
    return time.strftime(
        "%Y-%m-%dT%H:%M:%SZ", time.gmtime(base + days * 86400)
    )
