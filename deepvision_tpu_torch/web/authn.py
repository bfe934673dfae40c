"""Auth: phone+SMS login, WeChat OAuth, account binding/merge.

Re-implements the reference auth subsystem (SMS dispatch
``dispatch_sms_code`` web/server.py:11505, hashed codes + caps
:11515-11695, WeChat OAuth :12161-12709, account merge :11838-12160,
session login :12749, tables :9692-9756).  Providers: ``mock`` logs the
code / honors SMS_TEST_CODE; real SMS providers plug in via
``register_sms_provider``.
"""

from __future__ import annotations

import hashlib
import json
import secrets
import threading
import time
from typing import Callable, Dict, Optional

from deepvision_tpu_torch.web.db import connect_db, pool
from deepvision_tpu_torch.web.meta_index import utc_now_iso

AUTH_SCHEMA = [
    """CREATE TABLE IF NOT EXISTS users (
        user_id INTEGER PRIMARY KEY AUTOINCREMENT,
        phone TEXT UNIQUE,
        nickname TEXT,
        level TEXT DEFAULT 'experience',
        is_admin INTEGER DEFAULT 0,
        created_at TEXT,
        last_login_at TEXT
    )""",
    """CREATE TABLE IF NOT EXISTS wechat_identities (
        openid TEXT PRIMARY KEY,
        user_id INTEGER,
        unionid TEXT,
        nickname TEXT,
        bound_at TEXT
    )""",
    """CREATE TABLE IF NOT EXISTS auth_sms_codes (
        phone TEXT,
        code_hash TEXT,
        purpose TEXT DEFAULT 'login',
        created_at REAL,
        expires_at REAL,
        used INTEGER DEFAULT 0,
        attempts INTEGER DEFAULT 0
    )""",
    """CREATE TABLE IF NOT EXISTS auth_meta (
        key TEXT PRIMARY KEY, value TEXT)""",
]


def hash_code(phone: str, code: str) -> str:
    return hashlib.sha256(f"{phone}:{code}".encode()).hexdigest()


class SmsRateLimited(Exception):
    pass


_sms_providers: Dict[str, Callable] = {}


def register_sms_provider(name: str, fn: Callable[[str, str], None]):
    _sms_providers[name] = fn


class AuthService:
    def __init__(self, db_path: str, *, provider: str = "mock",
                 test_code: str = "", code_ttl: int = 300,
                 send_cooldown: int = 60, daily_cap: int = 20,
                 admin_phones: Optional[list] = None,
                 admin_user_ids: Optional[list] = None,
                 max_verify_attempts: int = 5,
                 logger=None):
        self.db_path = db_path
        self.provider = provider
        self.test_code = test_code
        self.code_ttl = code_ttl
        self.send_cooldown = send_cooldown
        self.daily_cap = daily_cap
        self.admin_phones = set(admin_phones or [])
        self.admin_user_ids = set(str(u) for u in (admin_user_ids or []))
        self.max_verify_attempts = max_verify_attempts
        self.logger = logger
        self._lock = threading.Lock()
        self._init_db()

    def _init_db(self):
        conn = connect_db(self.db_path)
        for ddl in AUTH_SCHEMA:
            conn.execute(ddl)
        try:  # migrate pre-attempts databases in place
            conn.execute(
                "ALTER TABLE auth_sms_codes ADD COLUMN attempts "
                "INTEGER DEFAULT 0"
            )
        except Exception:
            pass
        conn.commit()
        conn.close()

    def conn(self):
        return pool.get(self.db_path)

    # -- SMS codes -------------------------------------------------------
    def issue_sms_code(self, phone: str, purpose: str = "login") -> str:
        now = time.time()
        with self._lock:
            conn = self.conn()
            recent = conn.execute(
                "SELECT MAX(created_at) AS t FROM auth_sms_codes "
                "WHERE phone = ? AND purpose = ?",
                (phone, purpose),
            ).fetchone()
            if recent and recent["t"] and now - recent["t"] < self.send_cooldown:
                raise SmsRateLimited("send too frequently")
            day_start = now - 86400
            count = conn.execute(
                "SELECT COUNT(*) AS n FROM auth_sms_codes "
                "WHERE phone = ? AND created_at > ?",
                (phone, day_start),
            ).fetchone()["n"]
            if count >= self.daily_cap:
                raise SmsRateLimited("daily cap reached")
            code = self.test_code or f"{secrets.randbelow(900000) + 100000}"
            conn.execute(
                "INSERT INTO auth_sms_codes (phone, code_hash, purpose, "
                "created_at, expires_at, used) VALUES (?, ?, ?, ?, ?, 0)",
                (phone, hash_code(phone, code), purpose, now,
                 now + self.code_ttl),
            )
            conn.commit()
        self._dispatch(phone, code)
        return code

    def _dispatch(self, phone: str, code: str) -> None:
        if self.provider == "mock":
            if self.logger:
                self.logger.info(f"[SMS mock] code for {phone}: {code}")
            return
        fn = _sms_providers.get(self.provider)
        if fn is None:
            raise RuntimeError(f"unknown SMS provider {self.provider!r}")
        fn(phone, code)

    def verify_sms_code(self, phone: str, code: str,
                        purpose: str = "login") -> bool:
        # SMS_TEST_CODE only fixes the *issued* code (see issue_sms_code);
        # verification always requires an issued, unconsumed, unexpired,
        # attempt-capped record — matching the reference's semantics
        # (web/server.py:11609-11689) and preventing login-as-anyone when
        # a test code is configured.
        now = time.time()
        with self._lock:
            conn = self.conn()
            row = conn.execute(
                "SELECT rowid, code_hash, expires_at, used, attempts "
                "FROM auth_sms_codes "
                "WHERE phone = ? AND purpose = ? ORDER BY created_at DESC "
                "LIMIT 1",
                (phone, purpose),
            ).fetchone()
            if not row or row["used"] or row["expires_at"] < now:
                return False
            if (row["attempts"] or 0) >= self.max_verify_attempts:
                return False
            if row["code_hash"] != hash_code(phone, code):
                conn.execute(
                    "UPDATE auth_sms_codes SET attempts = attempts + 1 "
                    "WHERE rowid = ?",
                    (row["rowid"],),
                )
                conn.commit()
                return False
            conn.execute(
                "UPDATE auth_sms_codes SET used = 1 WHERE rowid = ?",
                (row["rowid"],),
            )
            conn.commit()
        return True

    # -- users -----------------------------------------------------------
    def upsert_user_by_phone(self, phone: str) -> dict:
        with self._lock:
            conn = self.conn()
            row = conn.execute(
                "SELECT * FROM users WHERE phone = ?", (phone,)
            ).fetchone()
            now = utc_now_iso()
            if row is None:
                conn.execute(
                    "INSERT INTO users (phone, nickname, created_at, "
                    "last_login_at, is_admin) VALUES (?, ?, ?, ?, ?)",
                    (phone, f"用户{phone[-4:]}", now, now,
                     1 if phone in self.admin_phones else 0),
                )
                conn.commit()
                row = conn.execute(
                    "SELECT * FROM users WHERE phone = ?", (phone,)
                ).fetchone()
            else:
                conn.execute(
                    "UPDATE users SET last_login_at = ? WHERE user_id = ?",
                    (now, row["user_id"]),
                )
                conn.commit()
        return dict(row)

    def get_user(self, user_id) -> Optional[dict]:
        row = self.conn().execute(
            "SELECT * FROM users WHERE user_id = ?", (user_id,)
        ).fetchone()
        return dict(row) if row else None

    def list_users(self, limit: int = 200) -> list:
        """All accounts, oldest first (ops CLI account picker —
        reference admin_migrate_ownership.py list-users)."""
        rows = self.conn().execute(
            "SELECT user_id, phone, nickname, level, is_admin, created_at "
            "FROM users ORDER BY user_id LIMIT ?", (limit,),
        ).fetchall()
        return [dict(r) for r in rows]

    def find_users(self, query: str, limit: int = 20) -> list:
        rows = self.conn().execute(
            "SELECT user_id, phone, nickname, level, is_admin, created_at "
            "FROM users WHERE phone LIKE ? OR nickname LIKE ? "
            "OR CAST(user_id AS TEXT) = ? LIMIT ?",
            (f"%{query}%", f"%{query}%", query, limit),
        ).fetchall()
        return [dict(r) for r in rows]

    def set_user_level(self, user_id, level: str) -> None:
        self.conn().execute(
            "UPDATE users SET level = ? WHERE user_id = ?", (level, user_id)
        )
        self.conn().commit()

    def is_admin(self, user: Optional[dict]) -> bool:
        if not user:
            return False
        return bool(user.get("is_admin")) or (
            str(user.get("user_id")) in self.admin_user_ids
            or user.get("phone") in self.admin_phones
        )

    # -- WeChat (OAuth handshake is provider-pluggable; stores identity) -
    def bind_wechat(self, user_id, openid: str, nickname: str = "",
                    unionid: str = "") -> None:
        conn = self.conn()
        conn.execute(
            "INSERT INTO wechat_identities (openid, user_id, unionid, "
            "nickname, bound_at) VALUES (?, ?, ?, ?, ?) "
            "ON CONFLICT(openid) DO UPDATE SET user_id = excluded.user_id, "
            "nickname = excluded.nickname, bound_at = excluded.bound_at",
            (openid, user_id, unionid, nickname, utc_now_iso()),
        )
        conn.commit()

    def user_by_wechat(self, openid: str) -> Optional[dict]:
        row = self.conn().execute(
            "SELECT user_id FROM wechat_identities WHERE openid = ?",
            (openid,),
        ).fetchone()
        return self.get_user(row["user_id"]) if row else None

    def wechat_binding(self, user_id) -> Optional[dict]:
        row = self.conn().execute(
            "SELECT * FROM wechat_identities WHERE user_id = ?", (user_id,)
        ).fetchone()
        return dict(row) if row else None

    # -- account merge (reference :11838-12160) --------------------------
    # The merge source is NEVER taken from the request: a candidate is
    # recorded server-side only at the moment the current user *proves
    # control* of the conflicting identity (SMS code for a phone already
    # owned by another account; WeChat OAuth callback for an openid bound
    # to another account) — matching the reference flow where the merge
    # candidate is stored in the verified session (server.py:11838-12160).

    def set_merge_candidate(self, into_user_id, from_user_id,
                            via: str) -> None:
        conn = self.conn()
        conn.execute(
            "INSERT INTO auth_meta (key, value) VALUES (?, ?) "
            "ON CONFLICT(key) DO UPDATE SET value = excluded.value",
            (f"merge_candidate:{into_user_id}",
             json.dumps({"from": from_user_id, "via": via,
                         "ts": time.time()})),
        )
        conn.commit()

    def _get_merge_candidate(self, into_user_id) -> Optional[dict]:
        row = self.conn().execute(
            "SELECT value FROM auth_meta WHERE key = ?",
            (f"merge_candidate:{into_user_id}",),
        ).fetchone()
        if not row:
            return None
        info = json.loads(row["value"])
        if time.time() - info.get("ts", 0) > 600:
            return None
        return info

    @staticmethod
    def masked_summary(user: dict) -> dict:
        phone = user.get("phone") or ""
        return {
            "user_id": user["user_id"],
            "phone": (phone[:3] + "****" + phone[-4:]) if phone else None,
            "nickname": user.get("nickname"),
            "created_at": user.get("created_at"),
        }

    def merge_preview(self, into_user_id) -> dict:
        cand = self._get_merge_candidate(into_user_id)
        if cand is None:
            raise ValueError("没有待合并的账号（请先验证对方手机号或微信）")
        a = self.get_user(cand["from"])
        b = self.get_user(into_user_id)
        if not a or not b:
            raise ValueError("user not found")
        token = secrets.token_urlsafe(16)
        conn = self.conn()
        conn.execute(
            "INSERT INTO auth_meta (key, value) VALUES (?, ?) "
            "ON CONFLICT(key) DO UPDATE SET value = excluded.value",
            (f"merge_preview:{token}",
             json.dumps({"from": a["user_id"], "into": b["user_id"],
                         "via": cand.get("via"), "ts": time.time()})),
        )
        conn.commit()
        return {
            "preview_token": token,
            "verified_via": cand.get("via"),
            "from_user": self.masked_summary(a),
            "into_user": self.masked_summary(b),
        }

    def merge_apply(self, token: str, into_user_id) -> dict:
        conn = self.conn()
        row = conn.execute(
            "SELECT value FROM auth_meta WHERE key = ?",
            (f"merge_preview:{token}",),
        ).fetchone()
        if not row:
            raise ValueError("invalid preview token")
        info = json.loads(row["value"])
        if time.time() - info["ts"] > 600:
            raise ValueError("preview token expired")
        if str(info["into"]) != str(into_user_id):
            raise ValueError("preview token belongs to another account")
        conn.execute(
            "UPDATE wechat_identities SET user_id = ? WHERE user_id = ?",
            (info["into"], info["from"]),
        )
        conn.execute(
            "DELETE FROM auth_meta WHERE key = ?", (f"merge_preview:{token}",)
        )
        conn.execute(
            "DELETE FROM auth_meta WHERE key = ?",
            (f"merge_candidate:{info['into']}",),
        )
        conn.commit()
        return {"merged_from": info["from"], "into": info["into"]}
