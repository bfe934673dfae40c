"""Report, export, solution, share, presentation routes
(reference web/server.py:33999-34431, 43373-44222)."""

from __future__ import annotations

import secrets

from deepvision_tpu_torch.web.http import HTTPError, Response
from deepvision_tpu_torch.web.levels import level_allows
from deepvision_tpu_torch.web.meta_index import utc_now_iso
from deepvision_tpu_torch.web.pagination import list_response, paging_params
from deepvision_tpu_torch.web.runtime.exports import markdown_to_docx, markdown_to_pdf


def register(app, state):
    from deepvision_tpu_torch.web.server import require_user

    # ------------------------------------------------------------------
    # Listing / content / delete
    # ------------------------------------------------------------------

    @app.route("/api/reports")
    def list_reports(req):
        user = require_user(state, req)
        with state.list_gates["reports"]:
            page, size = paging_params(
                req,
                state.resolver.get_int("LIST_API_DEFAULT_PAGE_SIZE", 20),
                state.resolver.get_int("LIST_API_MAX_PAGE_SIZE", 100),
            )
            rows, total = state.reports.list_index(
                str(user["user_id"]), state.instance_scope,
                page=page, page_size=size,
            )
            return list_response(req, rows, total)

    @app.route("/api/reports/<path:filename>")
    def get_report(req, filename):
        user = require_user(state, req)
        content = _load_owned_report(state, filename, user)
        return Response(content, content_type="text/markdown; charset=utf-8")

    @app.route("/api/reports/<path:filename>", methods=["DELETE"])
    def delete_report(req, filename):
        user = require_user(state, req)
        _load_owned_report(state, filename, user)
        state.reports.delete(filename)
        return {"ok": True}

    @app.route("/api/reports/batch-delete", methods=["POST"])
    def batch_delete(req):
        user = require_user(state, req)
        names = req.get_json().get("report_names") or []
        deleted = []
        for name in names[:100]:
            try:
                _load_owned_report(state, name, user)
            except HTTPError:
                continue
            state.reports.delete(name)
            deleted.append(name)
        return {"ok": True, "deleted": deleted}

    # ------------------------------------------------------------------
    # Exports (reference :43496-43647; server-side docx/pdf are new
    # capabilities — the reference rendered these client-side)
    # ------------------------------------------------------------------

    @app.route("/api/reports/<path:filename>/exports")
    def list_exports(req, filename):
        user = require_user(state, req)
        _load_owned_report(state, filename, user)
        rows = state.meta.query(
            "SELECT asset_id, format, filename, created_at "
            "FROM export_asset_store WHERE report_name = ? "
            "ORDER BY created_at DESC",
            (filename,),
        )
        return [dict(r) for r in rows]

    @app.route("/api/reports/<path:filename>/exports", methods=["POST"])
    def create_export(req, filename):
        user = require_user(state, req)
        content = _load_owned_report(state, filename, user)
        body = req.get_json()
        fmt = body.get("format") or "markdown"
        level = user.get("level")
        fmt_capability = {"markdown": "markdown", "docx": "docx",
                          "pdf": "pdf", "appendix": "appendix"}
        if fmt not in fmt_capability and not body.get("content_base64"):
            raise HTTPError(400, {"error": f"不支持的导出格式 {fmt}"})
        if not level_allows(level, "exports", fmt_capability.get(fmt, fmt)):
            raise HTTPError(403, {"error": f"当前等级不支持导出 {fmt}"})
        if fmt == "docx":
            data = markdown_to_docx(content)
            out_name = filename.rsplit(".", 1)[0] + ".docx"
        elif fmt in ("pdf", "appendix"):
            data = markdown_to_pdf(content, title=filename)
            out_name = filename.rsplit(".", 1)[0] + ".pdf"
        elif fmt == "markdown":
            data = content.encode("utf-8")
            out_name = filename
        elif body.get("content_base64"):
            # client-rendered export archived back (reference flow)
            import base64

            data = base64.b64decode(body["content_base64"])
            out_name = body.get("filename") or filename
        else:
            raise HTTPError(400, {"error": f"不支持的导出格式 {fmt}"})
        asset_id = secrets.token_hex(8)
        state.meta.execute(
            "INSERT INTO export_asset_store (asset_id, report_name, format, "
            "filename, content, created_at) VALUES (?, ?, ?, ?, ?, ?)",
            (asset_id, filename, fmt, out_name, data, utc_now_iso()),
        )
        # archive to object storage (reference archives exports to S3,
        # web/server.py:43529-43600; local-FS backend when unconfigured)
        try:
            from deepvision_tpu_torch.web.object_storage import (
                ObjectStorageHistoryService,
            )

            ObjectStorageHistoryService(state).archive_export(
                filename, asset_id, out_name, data
            )
        except Exception:
            pass  # archive is best-effort; DB copy is authoritative
        return {"ok": True, "asset_id": asset_id, "filename": out_name,
                "size": len(data)}, 201

    @app.route("/api/reports/<path:filename>/exports/<asset_id>")
    def download_export(req, filename, asset_id):
        user = require_user(state, req)
        _load_owned_report(state, filename, user)
        row = state.meta.query_one(
            "SELECT * FROM export_asset_store WHERE asset_id = ? AND "
            "report_name = ?",
            (asset_id, filename),
        )
        if row is None:
            raise HTTPError(404, {"error": "导出产物不存在"})
        ctype = {
            "docx": "application/vnd.openxmlformats-officedocument"
                    ".wordprocessingml.document",
            "pdf": "application/pdf",
            "appendix": "application/pdf",
            "markdown": "text/markdown; charset=utf-8",
        }.get(row["format"], "application/octet-stream")
        return Response(
            row["content"], content_type=ctype,
            headers={"Content-Disposition":
                     f'attachment; filename="{row["filename"]}"'},
        )

    @app.route("/api/reports/<path:filename>/appendix/pdf")
    def appendix_pdf(req, filename):
        user = require_user(state, req)
        content = _load_owned_report(state, filename, user)
        if not level_allows(user.get("level"), "exports", "appendix"):
            raise HTTPError(403, {"error": "当前等级不支持附录导出"})
        data = markdown_to_pdf(content, title=filename)
        return Response(
            data, content_type="application/pdf",
            headers={"Content-Disposition":
                     f'attachment; filename="{filename}.pdf"'},
        )

    # ------------------------------------------------------------------
    # Solution page (reference :43648-43765)
    # ------------------------------------------------------------------

    @app.route("/api/reports/<path:filename>/solution")
    def solution(req, filename):
        user = require_user(state, req)
        _load_owned_report(state, filename, user)
        if not level_allows(user.get("level"), "solution_view"):
            raise HTTPError(403, {"error": "当前等级不支持方案页"})
        payload = state.solution.get_payload(filename)
        if payload is None:
            raise HTTPError(404, {"error": "报告不存在"})
        return payload

    @app.route("/api/reports/<path:filename>/solution/share",
               methods=["POST"])
    def share_solution(req, filename):
        user = require_user(state, req)
        _load_owned_report(state, filename, user)
        if not level_allows(user.get("level"), "solution_share"):
            raise HTTPError(403, {"error": "当前等级不支持方案分享"})
        token = state.reports.create_share(filename)
        return {"ok": True, "share_token": token,
                "share_url": f"/api/public/solutions/{token}"}

    @app.route("/api/public/solutions/<share_token>")
    def public_solution(req, share_token):
        report_name = state.reports.resolve_share(share_token)
        if report_name is None:
            raise HTTPError(404, {"error": "分享链接无效或已撤销"})
        payload = state.solution.get_payload(report_name)
        if payload is None:
            raise HTTPError(404, {"error": "报告已删除"})
        payload = dict(payload)
        payload["shared"] = True
        return payload

    # ------------------------------------------------------------------
    # Presentation / Refly (external workflow; feature-flagged)
    # ------------------------------------------------------------------

    def _presentation_enabled(user) -> bool:
        flag = state.meta.site_config_get("presentation_feature")
        if flag is None:
            flag = state.resolver.get_bool(
                "PRESENTATION_FEATURE_ENABLED", False)
        return bool(flag) and level_allows(user.get("level"), "presentation")

    from deepvision_tpu_torch.web.runtime.presentation import PresentationService

    presentations = PresentationService(state)
    # expose for lifecycle management: AppState.shutdown joins the
    # background deck-render/poll threads so teardown never races them
    state.presentations = presentations

    @app.route("/api/reports/<path:filename>/refly", methods=["POST"])
    def refly_start(req, filename):
        user = require_user(state, req)
        content = _load_owned_report(state, filename, user)
        if not _presentation_enabled(user):
            raise HTTPError(403, {"error": "演示稿功能未开放"})
        try:
            return presentations.start(filename, content), 202
        except RuntimeError as e:
            raise HTTPError(503, {"error": str(e)})

    @app.route("/api/reports/<path:filename>/refly/status")
    @app.route("/api/reports/<path:filename>/presentation/status")
    def refly_status(req, filename):
        user = require_user(state, req)
        _load_owned_report(state, filename, user)
        return presentations.status(filename)

    @app.route("/api/reports/<path:filename>/presentation")
    @app.route("/api/reports/<path:filename>/presentation/link")
    def presentation_get(req, filename):
        user = require_user(state, req)
        _load_owned_report(state, filename, user)
        st = presentations.status(filename)
        if st.get("state") != "completed":
            raise HTTPError(404, {"error": "暂无演示稿"})
        from deepvision_tpu_torch.web.object_storage import (
            ObjectStorageHistoryService,
        )

        storage = ObjectStorageHistoryService(state)
        try:
            data = storage.backend.get_object(st["storage_key"])
        except Exception:
            raise HTTPError(404, {"error": "演示稿文件缺失"})
        return Response(
            data, content_type="application/pdf",
            headers={"Content-Disposition":
                     f'attachment; filename="{filename}.presentation.pdf"'},
        )

    @app.route("/api/reports/<path:filename>/presentation/abort",
               methods=["POST"])
    def presentation_abort(req, filename):
        user = require_user(state, req)
        _load_owned_report(state, filename, user)
        return presentations.abort(filename)


def _load_owned_report(state, filename: str, user) -> str:
    # scope first: cross-tenant reports 404 (existence masked) BEFORE any
    # ownership signal leaks (reference visibility checks :16231-16287)
    scope = state.reports.scope_of(filename)
    if scope is not None and scope != state.instance_scope:
        raise HTTPError(404, {"error": "报告不存在"})
    owner = state.reports.owner_of(filename)
    if owner is not None and owner != str(user["user_id"]) and \
            not state.auth.is_admin(user):
        raise HTTPError(403, {"error": "无权访问该报告"})
    content = state.reports.load(filename)
    if content is None:
        raise HTTPError(404, {"error": "报告不存在"})
    return content
