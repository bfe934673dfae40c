"""Admin routes: licenses, users, usage, ownership migration, config center
(reference web/server.py:44375-44899)."""

from __future__ import annotations


from deepvision_tpu_torch.web.http import HTTPError, int_field, list_field, str_field
from deepvision_tpu_torch.web.licensing import LicenseError
from deepvision_tpu_torch.web.ownership import OwnershipMigrationService

# Config-center key directory: derived from the typed setting descriptors
# (reference _admin_setting descriptors web/server.py:2755-3289; depth now
# lives in deepvision_tpu_torch/web/config_center.py).
from deepvision_tpu_torch.web import config_center

CONFIG_GROUPS: dict = {}
for _desc in config_center.DESCRIPTORS:
    CONFIG_GROUPS.setdefault(_desc.group, []).append(_desc.key)


def register(app, state):
    from deepvision_tpu_torch.web.server import require_admin

    migrations = OwnershipMigrationService(state)

    # ------------------------------------------------------------------
    # License admin (reference :44375-44688)
    # ------------------------------------------------------------------

    @app.route("/api/admin/licenses/batch", methods=["POST"])
    def licenses_batch(req):
        require_admin(state, req)
        body = req.get_json()
        count = int_field(body, "count", 1, lo=1, hi=500)
        codes = state.licenses.batch_generate(
            count,
            level=body.get("level") or "standard",
            days_valid=int_field(body, "days_valid", 365, lo=1),
            batch_id=body.get("batch_id") or "",
        )
        return {"ok": True, "codes": codes, "count": len(codes)}, 201

    @app.route("/api/admin/licenses/bootstrap/status")
    def licenses_bootstrap_status(req):
        require_admin(state, req)
        return state.licenses.bootstrap_status()

    @app.route("/api/admin/licenses/bootstrap", methods=["POST"])
    def licenses_bootstrap(req):
        user = require_admin(state, req)
        try:
            return state.licenses.bootstrap(user["user_id"])
        except LicenseError as e:
            raise HTTPError(409, {"error": str(e)})

    @app.route("/api/admin/license-enforcement")
    def enforcement_get(req):
        require_admin(state, req)
        override = state.meta.site_config_get("license_enforcement")
        return {
            "enabled": state.licenses.enforcement_enabled(),
            "runtime_override": override is not None,
            "source": ("runtime" if override is not None
                       else state.resolver.source("LICENSE_ENFORCEMENT")),
        }

    @app.route("/api/admin/license-enforcement", methods=["POST"])
    def enforcement_set(req):
        require_admin(state, req)
        state.licenses.set_enforcement(bool(req.get_json().get("enabled")))
        return {"ok": True, "enabled": state.licenses.enforcement_enabled()}

    @app.route("/api/admin/license-enforcement/follow-default",
               methods=["POST"])
    def enforcement_follow_default(req):
        require_admin(state, req)
        state.licenses.set_enforcement(None)
        return {"ok": True, "enabled": state.licenses.enforcement_enabled()}

    @app.route("/api/admin/presentation-feature")
    def presentation_get(req):
        require_admin(state, req)
        flag = state.meta.site_config_get("presentation_feature")
        return {
            "enabled": bool(flag) if flag is not None
            else state.resolver.get_bool("PRESENTATION_FEATURE_ENABLED",
                                         False),
            "runtime_override": flag is not None,
            "source": ("runtime" if flag is not None else
                       state.resolver.source("PRESENTATION_FEATURE_ENABLED")),
        }

    @app.route("/api/admin/presentation-feature", methods=["POST"])
    def presentation_set(req):
        require_admin(state, req)
        state.meta.site_config_set(
            "presentation_feature", bool(req.get_json().get("enabled"))
        )
        return {"ok": True}

    @app.route("/api/admin/presentation-feature/follow-default",
               methods=["POST"])
    def presentation_follow_default(req):
        require_admin(state, req)
        state.meta.kv_delete("site_config_store", "key",
                             "presentation_feature")
        return {"ok": True}

    @app.route("/api/admin/licenses")
    def licenses_search(req):
        require_admin(state, req)
        return state.licenses.search(
            batch_id=req.args.get("batch_id", ""),
            status=req.args.get("status", ""),
            user_id=req.args.get("user_id") or None,
            code=req.args.get("code", ""),
            limit=min(200, int(req.args.get("limit", "50") or 50)),
            offset=int(req.args.get("offset", "0") or 0),
        )

    @app.route("/api/admin/licenses/summary")
    def licenses_summary(req):
        require_admin(state, req)
        return state.licenses.summary()

    @app.route("/api/admin/licenses/<int:license_id>")
    def license_get(req, license_id):
        require_admin(state, req)
        lic = state.licenses.get(int(license_id))
        if lic is None:
            raise HTTPError(404, {"error": "license not found"})
        return lic

    @app.route("/api/admin/licenses/<int:license_id>/events")
    def license_events(req, license_id):
        require_admin(state, req)
        return state.licenses.events(int(license_id))

    @app.route("/api/admin/licenses/bulk-revoke", methods=["POST"])
    def licenses_bulk_revoke(req):
        require_admin(state, req)
        ids = list_field(req.get_json(), "license_ids")
        done = 0
        for lid in ids[:500]:
            try:
                state.licenses.revoke(int(lid), "bulk")
            except (TypeError, ValueError):
                continue  # hostile item in an otherwise valid list
            done += 1
        return {"ok": True, "revoked": done}

    @app.route("/api/admin/licenses/bulk-extend", methods=["POST"])
    def licenses_bulk_extend(req):
        require_admin(state, req)
        body = req.get_json()
        ids = list_field(body, "license_ids")
        days = int_field(body, "days", 30)
        done = 0
        for lid in ids[:500]:
            try:
                state.licenses.extend(int(lid), days)
            except (TypeError, ValueError):
                continue
            done += 1
        return {"ok": True, "extended": done}

    @app.route("/api/admin/licenses/<int:license_id>/revoke",
               methods=["POST"])
    def license_revoke(req, license_id):
        require_admin(state, req)
        state.licenses.revoke(int(license_id),
                              req.get_json().get("reason") or "")
        return {"ok": True}

    @app.route("/api/admin/licenses/<int:license_id>/extend",
               methods=["POST"])
    def license_extend(req, license_id):
        require_admin(state, req)
        days = int_field(req.get_json(), "days", 30)
        try:
            return state.licenses.extend(int(license_id), days)
        except LicenseError as e:
            raise HTTPError(404, {"error": str(e)})

    # ------------------------------------------------------------------
    # Users / usage (reference :44689-44759)
    # ------------------------------------------------------------------

    @app.route("/api/admin/users")
    def admin_users(req):
        require_admin(state, req)
        query = req.args.get("q", "").strip()
        if not query:
            raise HTTPError(400, {"error": "缺少搜索关键字 q"})
        return state.auth.find_users(query)

    @app.route("/api/admin/users/<int:user_id>/level", methods=["PUT"])
    def admin_set_user_level(req, user_id):
        """Direct level assignment (reference user-level management,
        web/server.py:8949-8996; licenses remain the self-serve path)."""
        require_admin(state, req)
        from deepvision_tpu_torch.web.levels import LEVELS

        level = str_field(req.get_json(), "level")
        if level not in LEVELS:
            raise HTTPError(
                400, {"error": f"level 必须是 {'/'.join(LEVELS)} 之一"})
        state.auth.set_user_level(user_id, level)
        return {"ok": True, "user_id": user_id, "level": level}

    @app.route("/api/admin/usage/summary")
    def usage_summary(req):
        require_admin(state, req)
        s = state.meta.query_one(
            "SELECT COUNT(*) AS n FROM session_index WHERE instance_scope = ?",
            (state.instance_scope,),
        )["n"]
        r = state.meta.query_one(
            "SELECT COUNT(*) AS n FROM report_index WHERE instance_scope = ? "
            "AND deleted = 0",
            (state.instance_scope,),
        )["n"]
        users = state.auth.conn().execute(
            "SELECT COUNT(*) AS n FROM users"
        ).fetchone()["n"]
        return {
            "sessions": s, "reports": r, "users": users,
            "ai_calls": state.gateway.call_count,
            "report_queue": state.report_queue.queue_snapshot(),
        }

    @app.route("/api/admin/usage/users")
    def usage_users(req):
        require_admin(state, req)
        rows = state.meta.query(
            "SELECT owner_user_id, COUNT(*) AS sessions, "
            "MAX(updated_at) AS last_active FROM session_index "
            "WHERE instance_scope = ? GROUP BY owner_user_id "
            "ORDER BY sessions DESC LIMIT 100",
            (state.instance_scope,),
        )
        return [dict(r) for r in rows]

    @app.route("/api/admin/usage/users/<int:user_id>")
    def usage_user(req, user_id):
        require_admin(state, req)
        sessions, s_total = state.sessions.list_index(
            str(user_id), state.instance_scope, page=1, page_size=20
        )
        reports, r_total = state.reports.list_index(
            str(user_id), state.instance_scope, page=1, page_size=20
        )
        return {
            "user": state.auth.get_user(user_id),
            "session_count": s_total,
            "report_count": r_total,
            "recent_sessions": sessions,
            "recent_reports": reports,
        }

    # ------------------------------------------------------------------
    # Ownership migrations (reference :44760-44874)
    # ------------------------------------------------------------------

    @app.route("/api/admin/ownership-migrations/audit", methods=["POST"])
    def migration_audit(req):
        require_admin(state, req)
        user_id = req.get_json().get("user_id")
        if user_id is None:
            raise HTTPError(400, {"error": "缺少 user_id"})
        return migrations.audit(str(user_id))

    @app.route("/api/admin/ownership-migrations/preview", methods=["POST"])
    def migration_preview(req):
        require_admin(state, req)
        body = req.get_json()
        if not body.get("from_user_id") or not body.get("to_user_id"):
            raise HTTPError(400, {"error": "缺少 from_user_id / to_user_id"})
        return migrations.preview(
            str(body["from_user_id"]), str(body["to_user_id"])
        )

    @app.route("/api/admin/ownership-migrations/apply", methods=["POST"])
    def migration_apply(req):
        require_admin(state, req)
        body = req.get_json()
        try:
            return migrations.apply(
                body.get("preview_token", ""), body.get("confirm_word", "")
            )
        except ValueError as e:
            raise HTTPError(400, {"error": str(e)})

    @app.route("/api/admin/ownership-migrations")
    def migration_history(req):
        require_admin(state, req)
        return migrations.history()

    @app.route("/api/admin/ownership-migrations/rollback", methods=["POST"])
    def migration_rollback(req):
        require_admin(state, req)
        try:
            return migrations.rollback(req.get_json().get("backup") or "")
        except ValueError as e:
            raise HTTPError(400, {"error": str(e)})

    # ------------------------------------------------------------------
    # Config center (reference :44876-44899)
    # ------------------------------------------------------------------

    @app.route("/api/admin/config-center")
    def config_center_get(req):
        require_admin(state, req)
        runtime = state.resolver.runtime_snapshot()
        return {
            "groups": config_center.grouped_payload(state.resolver, runtime),
            "resolution_mode": state.resolver.mode,
            "env_files": state.resolver.loaded_files,
        }

    @app.route("/api/admin/config-center/save", methods=["POST"])
    def config_center_save(req):
        require_admin(state, req)
        body = req.get_json()
        updates = body.get("updates") or {}
        result = config_center.apply_updates(
            state.resolver, state.meta, updates
        )
        persisted = []
        if body.get("persist") == "env_file" and result["applied"]:
            # write the RAW validated values (masking is payload-only)
            raw = {}
            for key in result["applied"]:
                raw[key] = config_center.coerce(
                    config_center.BY_KEY[key], updates[key]
                )
            import os as _os

            env_path = state.resolver.loaded_files[0] if (
                state.resolver.loaded_files
            ) else _os.path.join(state.data_dir, ".env")
            persisted = config_center.write_env_file(env_path, raw)
        return {
            "ok": not result["errors"],
            "applied": result["applied"],
            "errors": result["errors"],
            "restart_required": result["restart_required"],
            "persisted_to_env": persisted,
            "note": "部分配置需要重启后完全生效",
        }

    @app.route("/api/admin/config-center/site-config", methods=["POST"])
    def config_center_site_config(req):
        """Regenerate the frontend's site-config.js from current values
        (reference site-config writer web/server.py:3741-3848)."""
        require_admin(state, req)
        import os as _os

        values = {
            d.key: state.resolver.get(d.key)
            for d in config_center.DESCRIPTORS
            if not d.sensitive
        }
        path = _os.path.join(state.data_dir, "site-config.js")
        config_center.write_site_config_js(path, values)
        return {"ok": True, "path": path, "keys": len(values)}
