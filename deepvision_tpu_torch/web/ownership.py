"""Admin ownership migration: audit / preview / apply / rollback.

Re-implements the reference flow (AdminOwnershipMigrationService
web/server_modules/ownership_admin_flow.py, scripts/admin_ownership_service.py,
routes web/server.py:44760-44874): dry-run preview returns hit samples, a
confirm word, and a preview token; apply requires both; every apply writes a
rollback backup under data/operations.
"""

from __future__ import annotations

import json
import os
import secrets
import time
from typing import Dict, List

from deepvision_tpu_torch.web.meta_index import utc_now_iso

CONFIRM_WORD = "确认迁移"
PREVIEW_TTL_S = 600


class OwnershipMigrationService:
    def __init__(self, state):
        self.state = state
        self._previews: Dict[str, dict] = {}
        self.backup_dir = os.path.join(state.data_dir, "operations")
        os.makedirs(self.backup_dir, exist_ok=True)

    # -- audit -----------------------------------------------------------
    def audit(self, user_id: str) -> dict:
        sessions, s_total = self.state.sessions.list_index(
            str(user_id), self.state.instance_scope, page=1, page_size=1000
        )
        reports, r_total = self.state.reports.list_index(
            str(user_id), self.state.instance_scope, page=1, page_size=1000
        )
        return {
            "user_id": user_id,
            "session_count": s_total,
            "report_count": r_total,
            "session_samples": [s["session_id"] for s in sessions[:10]],
            "report_samples": [r["report_name"] for r in reports[:10]],
        }

    # -- preview ---------------------------------------------------------
    def preview(self, from_user_id: str, to_user_id: str,
                kinds: tuple = ("sessions", "reports")) -> dict:
        audit = self.audit(from_user_id)
        token = secrets.token_urlsafe(16)
        self._previews[token] = {
            "from": str(from_user_id),
            "to": str(to_user_id),
            "kinds": tuple(kinds),
            "created": time.time(),
            "audit": audit,
        }
        return {
            "preview_token": token,
            "confirm_word": CONFIRM_WORD,
            "from_user_id": from_user_id,
            "to_user_id": to_user_id,
            "kinds": list(kinds),
            "hits": audit,
            "expires_in_seconds": PREVIEW_TTL_S,
        }

    # -- apply -----------------------------------------------------------
    def apply(self, token: str, confirm_word: str) -> dict:
        info = self._previews.get(token)
        if info is None or time.time() - info["created"] > PREVIEW_TTL_S:
            raise ValueError("preview token 无效或已过期")
        if confirm_word != CONFIRM_WORD:
            raise ValueError(f"确认词不正确，应输入：{CONFIRM_WORD}")
        self._previews.pop(token, None)
        from_id, to_id = info["from"], info["to"]
        kinds = info.get("kinds") or ("sessions", "reports")

        moved_sessions: List[str] = []
        sessions, _ = (self.state.sessions.list_index(
            from_id, self.state.instance_scope, page=1, page_size=10000
        ) if "sessions" in kinds else ([], 0))
        backup_entries = []
        for row in sessions:
            sid = row["session_id"]
            session = self.state.sessions.load(sid)
            if session is None:
                continue
            backup_entries.append(
                {"type": "session", "id": sid, "owner": from_id}
            )
            session["owner_user_id"] = to_id
            self.state.sessions.save(session)
            moved_sessions.append(sid)

        moved_reports: List[str] = []
        reports, _ = (self.state.reports.list_index(
            from_id, self.state.instance_scope, page=1, page_size=10000
        ) if "reports" in kinds else ([], 0))
        for row in reports:
            name = row["report_name"]
            backup_entries.append(
                {"type": "report", "id": name, "owner": from_id}
            )
            self.state.meta.execute(
                "UPDATE report_index SET owner_user_id = ? "
                "WHERE report_name = ?",
                (to_id, name),
            )
            self.state.meta.execute(
                "UPDATE report_meta_owners SET owner_user_id = ? "
                "WHERE report_name = ?",
                (to_id, name),
            )
            moved_reports.append(name)

        backup_name = f"ownership-{int(time.time())}-{secrets.token_hex(4)}.json"
        backup_path = os.path.join(self.backup_dir, backup_name)
        with open(backup_path, "w", encoding="utf-8") as fh:
            json.dump({
                "from": from_id, "to": to_id,
                "entries": backup_entries,
                "created_at": utc_now_iso(),
            }, fh, ensure_ascii=False)
        self.state.meta.execute(
            "INSERT INTO ownership_migration_log (action, payload, "
            "backup_path, created_at) VALUES (?, ?, ?, ?)",
            ("apply",
             json.dumps({"from": from_id, "to": to_id,
                         "sessions": len(moved_sessions),
                         "reports": len(moved_reports)},
                        ensure_ascii=False),
             backup_path, utc_now_iso()),
        )
        return {
            "ok": True,
            "moved_sessions": len(moved_sessions),
            "moved_reports": len(moved_reports),
            "backup": backup_name,
        }

    # -- history / rollback ----------------------------------------------
    def history(self) -> List[dict]:
        rows = self.state.meta.query(
            "SELECT * FROM ownership_migration_log ORDER BY id DESC LIMIT 50"
        )
        return [dict(r) for r in rows]

    def rollback(self, backup_name: str) -> dict:
        path = os.path.join(self.backup_dir, os.path.basename(backup_name))
        if not os.path.isfile(path):
            raise ValueError("备份不存在")
        with open(path, encoding="utf-8") as fh:
            backup = json.load(fh)
        restored = 0
        for entry in backup.get("entries", []):
            if entry["type"] == "session":
                session = self.state.sessions.load(entry["id"])
                if session is not None:
                    session["owner_user_id"] = entry["owner"]
                    self.state.sessions.save(session)
                    restored += 1
            else:
                self.state.meta.execute(
                    "UPDATE report_index SET owner_user_id = ? "
                    "WHERE report_name = ?",
                    (entry["owner"], entry["id"]),
                )
                self.state.meta.execute(
                    "UPDATE report_meta_owners SET owner_user_id = ? "
                    "WHERE report_name = ?",
                    (entry["owner"], entry["id"]),
                )
                restored += 1
        self.state.meta.execute(
            "INSERT INTO ownership_migration_log (action, payload, "
            "backup_path, created_at) VALUES (?, ?, ?, ?)",
            ("rollback", json.dumps({"restored": restored}), path,
             utc_now_iso()),
        )
        return {"ok": True, "restored": restored}
