"""Session + interview routes — the TTFT-critical path.

Re-implements reference routes web/server.py:28439-33092 (sessions CRUD,
next-question per SURVEY §3.2, submit-answer with evidence annotations,
undo/skip/complete, document upload per §3.4, report readiness + submit).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from deepvision_tpu_torch.web.http import HTTPError, int_field, str_field
from deepvision_tpu_torch.web.levels import clamp_interview_mode
from deepvision_tpu_torch.web.metrics import StageTimer
from deepvision_tpu_torch.web.pagination import (
    build_overload_response,
    list_response,
    paging_params,
)
from deepvision_tpu_torch.web.runtime.documents import (
    SUPPORTED_EXTENSIONS,
    ConversionError,
)
from deepvision_tpu_torch.web.runtime.followup import (
    build_capture_contract,
    build_evidence_ledger,
    classify_evidence,
    dimension_saturation,
    evaluate_answer_depth,
    next_probe_for_dimension,
    report_readiness,
    should_follow_up,
)
from deepvision_tpu_torch.web.runtime.interview import QuestionCache
from deepvision_tpu_torch.web.stores import new_session_id
from deepvision_tpu_torch.web.meta_index import utc_now_iso

_recent_submits = {}
_recent_lock = threading.Lock()


def register(app, state):
    from deepvision_tpu_torch.web.server import require_license, require_user

    # ------------------------------------------------------------------
    # Sessions CRUD
    # ------------------------------------------------------------------

    @app.route("/api/sessions")
    def list_sessions(req):
        user = require_user(state, req)
        with state.list_gates["sessions"]:
            page, size = paging_params(
                req,
                state.resolver.get_int("LIST_API_DEFAULT_PAGE_SIZE", 20),
                state.resolver.get_int("LIST_API_MAX_PAGE_SIZE", 100),
            )
            rows, total = state.sessions.list_index(
                str(user["user_id"]), state.instance_scope,
                page=page, page_size=size,
            )
            return list_response(req, rows, total)

    @app.route("/api/sessions", methods=["POST"])
    def create_session(req):
        user = require_user(state, req)
        require_license(state, req, user)
        body = req.get_json()
        topic = str_field(body, "topic")
        if not topic:
            raise HTTPError(400, {"error": "缺少访谈主题"})
        scenario_id = body.get("scenario_id") or "product-requirement"
        scenario = state.scenarios.get(scenario_id, state.instance_scope)
        if scenario is None:
            raise HTTPError(404, {"error": f"场景不存在: {scenario_id}"})
        # per-level cap on CONCURRENT in-progress sessions — an
        # intentional addition over the reference capability map
        # (web/server.py:8738-9019 has no session limit); counting only
        # in_progress sessions means completing/deleting interviews
        # frees quota rather than hard-blocking low tiers for life
        from deepvision_tpu_torch.web.levels import level_allows

        _, existing = state.sessions.list_index(
            str(user["user_id"]), state.instance_scope,
            page=1, page_size=1, status="in_progress",
        )
        if not level_allows(user.get("level"), "max_sessions", existing):
            raise HTTPError(403, {
                "error": "会话数量已达当前等级上限，请升级或删除旧会话",
                "session_limit_reached": True,
                "session_count": existing,
            })
        mode = clamp_interview_mode(
            user.get("level"), body.get("interview_mode") or "standard"
        )
        # session shape per reference :28638-28661 (Appendix A.1)
        session = {
            "session_id": new_session_id(),
            "owner_user_id": str(user["user_id"]),
            "instance_scope": state.instance_scope,
            "topic": topic,
            "description": str_field(body, "description"),
            "interview_mode": mode,
            "created_at": utc_now_iso(),
            "updated_at": utc_now_iso(),
            "status": "in_progress",
            "scenario_id": scenario_id,
            "scenario_config": scenario,
            "dimensions": {
                d["id"]: {"coverage": 0.0, "items": [], "score": 0.0,
                          "completed": False}
                for d in scenario.get("dimensions", [])
            },
            "reference_materials": [],
            "interview_log": [],
            "requirements": [],
            "summary": "",
            "depth_v2": {
                "enabled": True,
                "mode": mode,
                "skip_followup_confirm": False,
            },
        }
        state.sessions.save(session)
        return session, 201

    @app.route("/api/sessions/<session_id>")
    def get_session(req, session_id):
        user = require_user(state, req)
        return _load_owned(state, session_id, user)

    @app.route("/api/sessions/<session_id>", methods=["PUT"])
    def update_session(req, session_id):
        user = require_user(state, req)
        session = _load_owned(state, session_id, user)
        body = req.get_json()
        for key in ("topic", "description", "interview_mode", "status"):
            if key in body:
                session[key] = body[key]
        if "depth_v2" in body and isinstance(body["depth_v2"], dict):
            session.setdefault("depth_v2", {}).update(body["depth_v2"])
        state.sessions.save(session)
        return session

    @app.route("/api/sessions/<session_id>", methods=["DELETE"])
    def delete_session(req, session_id):
        user = require_user(state, req)
        _load_owned(state, session_id, user)
        state.sessions.delete(session_id)
        state.question_cache.invalidate_session(session_id)
        return {"ok": True}

    @app.route("/api/sessions/batch-delete", methods=["POST"])
    def batch_delete_sessions(req):
        """Batch delete; with delete_reports=true the session-bound reports
        go too — but only reports the caller owns in THIS instance scope
        (reference test_batch_delete_sessions_with_linked_reports /
        ..._does_not_delete_reports_from_other_scope)."""
        user = require_user(state, req)
        body = req.get_json()
        ids = body.get("session_ids") or []
        delete_reports = bool(body.get("delete_reports"))
        deleted, deleted_reports = [], []
        for sid in ids[:100]:
            try:
                session = _load_owned(state, sid, user)
            except HTTPError:
                continue
            if delete_reports:
                rows = state.meta.query(
                    "SELECT report_name FROM report_index WHERE "
                    "session_id = ? AND deleted = 0", (sid,),
                )
                names = {r["report_name"] for r in rows}
                for key in ("current_report_name", "last_report_name"):
                    if session.get(key):
                        names.add(session[key])
                for name in sorted(names):
                    scope = state.reports.scope_of(name)
                    if scope is not None and scope != state.instance_scope:
                        continue  # other tenant's report: never touched
                    owner = state.reports.owner_of(name)
                    if owner is not None and owner != str(user["user_id"]) \
                            and not state.auth.is_admin(user):
                        continue
                    if state.reports.delete(name):
                        deleted_reports.append(name)
            state.sessions.delete(sid)
            deleted.append(sid)
        return {"ok": True, "deleted": deleted,
                "deleted_sessions": deleted,
                "deleted_reports": deleted_reports}

    # ------------------------------------------------------------------
    # Next question (§3.2)
    # ------------------------------------------------------------------

    @app.route("/api/sessions/<session_id>/next-question", methods=["POST"])
    def next_question(req, session_id):
        timer = StageTimer()
        user = require_user(state, req)
        require_license(state, req, user)
        session = _load_owned(state, session_id, user)
        timer.mark("session_load")

        # resume question from readiness check (reference :29928)
        resume = session.pop("_resume_question", None)
        if resume:
            state.sessions.save(session)
            resume["resume"] = True
            return resume

        dimension, done_payload = _pick_dimension(state, session)
        if dimension is None:
            return done_payload

        signature = state.sessions.file_signature(session_id)
        cache_key = QuestionCache.key(session_id, dimension["id"], signature)
        cached = state.question_cache.get(cache_key)
        if cached:
            out = dict(cached)
            out["cached"] = True
            return out
        timer.mark("cache_check")

        with state.prefetch_lock:
            pf = state.prefetch.pop(session_id, None)
        if pf and pf.get("signature") == signature and \
                pf.get("dimension") == dimension["id"]:
            state.question_cache.put(cache_key, pf["result"])
            out = dict(pf["result"])
            out["cached"] = True
            out["prefetched"] = True
            return out
        timer.mark("prefetch_wait")

        # overload guard (reference :5751 -> 429 :30153)
        if not state.question_pending.acquire(blocking=False):
            raise build_overload_response(
                0, 0, state.question_retry_after
            )
        try:
            if not state.question_inflight.acquire(
                timeout=state.question_retry_after * 2
            ):
                raise build_overload_response(
                    1, 0, state.question_retry_after
                )
            try:
                timer.mark("queue_wait")
                result, meta = _generate_question(
                    state, session, dimension, timer
                )
            finally:
                state.question_inflight.release()
        finally:
            state.question_pending.release()

        payload = dict(result)
        payload.update(
            dimension=dimension["id"],
            ai_generated=meta.get("tier_used") != "fallback",
            decision_meta=_decision_meta(state, session, dimension, meta),
            question_generation_tier=meta.get("tier_used"),
            question_selected_lane=meta.get("selected_lane"),
            question_runtime_profile=session.get("interview_mode"),
            question_hedge_triggered=meta.get("hedge_triggered", False),
            question_fallback_triggered=meta.get(
                "fallback_triggered", False),
            question_attempts=meta.get("attempts", 1),
        )
        state.question_cache.put(cache_key, payload)
        state.metrics.record_stages("question", timer.stages)
        state.metrics.record_question_generation(
            mode=session.get("interview_mode") or "standard",
            tier=meta.get("tier_used") or "",
            lane=meta.get("selected_lane") or "",
            hedged=bool(meta.get("hedge_triggered")),
            fallback=bool(meta.get("fallback_triggered")),
        )
        _schedule_prefetch(state, session_id)
        return payload

    # ------------------------------------------------------------------
    # Submit answer
    # ------------------------------------------------------------------

    @app.route("/api/sessions/<session_id>/submit-answer", methods=["POST"])
    def submit_answer(req, session_id):
        user = require_user(state, req)
        require_license(state, req, user)
        session = _load_owned(state, session_id, user)
        body = req.get_json()
        question = str_field(body, "question")
        answer = str_field(body, "answer")
        if not question or not answer:
            raise HTTPError(400, {"error": "缺少问题或回答"})

        # idempotent submit dedupe (reference :2501-2610)
        dedupe_key = f"{session_id}:{hash(question)}:{hash(answer)}"
        now = time.time()
        with _recent_lock:
            last = _recent_submits.get(dedupe_key)
            if last and now - last < 5.0:
                return {"ok": True, "duplicate": True}
            _recent_submits[dedupe_key] = now
            if len(_recent_submits) > 500:
                cutoff = now - 30
                for k in [k for k, v in _recent_submits.items()
                          if v < cutoff]:
                    _recent_submits.pop(k, None)

        dimension_id = body.get("dimension") or _current_dimension_id(session)
        depth = evaluate_answer_depth(
            answer, body.get("rationale_text") or ""
        )
        entry = {
            "question": question,
            "answer": answer,
            "dimension": dimension_id,
            "is_follow_up": bool(body.get("is_follow_up")),
            "follow_up_round": int_field(body, "follow_up_round", 0),
            "options": body.get("options") or [],
            "multi_select": bool(body.get("multi_select")),
            "answer_mode": body.get("answer_mode") or "pick_with_reason",
            "requires_rationale": bool(body.get("requires_rationale")),
            "evidence_intent": body.get("evidence_intent") or "medium",
            "rationale_text": body.get("rationale_text") or "",
            "quality_score": depth["score"],
            "quality_signals": depth,
            "answered_at": utc_now_iso(),
        }
        entry["evidence_class"] = classify_evidence(entry)
        entry["follow_up_signals"] = {}
        entry["hard_triggered"] = False

        scenario_dims = {
            d["id"]: d
            for d in session.get("scenario_config", {}).get("dimensions", [])
        }
        dim_cfg = scenario_dims.get(dimension_id, {"id": dimension_id})
        decision = should_follow_up(
            session, dim_cfg, entry, session.get("interview_mode",
                                                 "standard"),
            gateway=state.gateway if state.gateway.mode != "off" else None,
        )
        entry["follow_up_signals"] = decision
        entry["hard_triggered"] = bool(decision.get("hard_triggered"))
        session.setdefault("interview_log", []).append(entry)

        if decision.get("follow_up"):
            session["_pending_follow_up"] = {
                "dimension": dimension_id,
                "round": decision.get("follow_up_round", 1),
                "context": decision.get("context", ""),
            }
        else:
            session.pop("_pending_follow_up", None)

        # update dimension coverage
        dim_state = session.setdefault("dimensions", {}).setdefault(
            dimension_id, {"coverage": 0.0, "items": [], "score": 0.0,
                           "completed": False},
        )
        sat = dimension_saturation(
            session, dim_cfg, session.get("interview_mode", "standard")
        )
        dim_state["coverage"] = round(
            min(1.0, sat["asked"] / max(1, sat["budget"])), 2
        )
        dim_state["score"] = sat["avg_quality"]
        if sat["saturated"] and not decision.get("follow_up"):
            dim_state["completed"] = True

        state.sessions.save(session)
        state.question_cache.invalidate_session(session_id)
        with state.prefetch_lock:
            state.prefetch.pop(session_id, None)
        _schedule_prefetch(state, session_id)
        _schedule_summary_update(state, session_id)
        return {
            "ok": True,
            "quality_score": depth["score"],
            "evidence_class": classify_evidence(entry),
            "follow_up": decision,
            "dimension_state": dim_state,
        }

    @app.route("/api/sessions/<session_id>/undo-answer", methods=["POST"])
    def undo_answer(req, session_id):
        user = require_user(state, req)
        session = _load_owned(state, session_id, user)
        log = session.get("interview_log", [])
        if not log:
            raise HTTPError(400, {"error": "没有可撤销的回答"})
        removed = log.pop()
        session.pop("_pending_follow_up", None)
        state.sessions.save(session)
        state.question_cache.invalidate_session(session_id)
        return {"ok": True, "removed_question": removed.get("question")}

    @app.route("/api/sessions/<session_id>/skip-follow-up", methods=["POST"])
    def skip_follow_up(req, session_id):
        user = require_user(state, req)
        session = _load_owned(state, session_id, user)
        session.pop("_pending_follow_up", None)
        if req.get_json().get("always"):
            session.setdefault("depth_v2", {})["skip_followup_confirm"] = True
        state.sessions.save(session)
        return {"ok": True}

    @app.route("/api/sessions/<session_id>/complete-dimension",
               methods=["POST"])
    def complete_dimension(req, session_id):
        user = require_user(state, req)
        session = _load_owned(state, session_id, user)
        dim_id = req.get_json().get("dimension")
        if not dim_id or dim_id not in session.get("dimensions", {}):
            raise HTTPError(400, {"error": "维度不存在"})
        session["dimensions"][dim_id]["completed"] = True
        session.pop("_pending_follow_up", None)
        state.sessions.save(session)
        state.question_cache.invalidate_session(session_id)
        return {"ok": True, "dimension": dim_id}

    @app.route("/api/sessions/<session_id>/restart-interview",
               methods=["POST"])
    def restart_interview(req, session_id):
        user = require_user(state, req)
        session = _load_owned(state, session_id, user)
        backup_path = state.sessions.backup(session_id, "restart")
        session["interview_log"] = []
        session["summary"] = ""
        session["status"] = "in_progress"
        session.pop("_pending_follow_up", None)
        for dim in session.get("dimensions", {}).values():
            dim.update(coverage=0.0, items=[], score=0.0, completed=False)
        state.sessions.save(session)
        state.question_cache.invalidate_session(session_id)
        return {"ok": True, "backup": bool(backup_path)}

    # ------------------------------------------------------------------
    # Documents (§3.4)
    # ------------------------------------------------------------------

    @app.route("/api/sessions/<session_id>/documents", methods=["POST"])
    def upload_document(req, session_id):
        user = require_user(state, req)
        require_license(state, req, user)
        session = _load_owned(state, session_id, user)
        f = req.files.get("file") or req.files.get("document")
        if f is None:
            raise HTTPError(400, {"error": "缺少文件"})
        max_bytes = state.resolver.get_int(
            "MAX_UPLOAD_BYTES", 10 * 1024 * 1024)
        if len(f.content) > max_bytes:
            raise HTTPError(413, {"error": "文件超过 10MB 限制"})
        name_lower = f.filename.lower()
        if name_lower.endswith((".png", ".jpg", ".jpeg", ".webp")):
            doc = _ingest_image(state, f)
        elif name_lower.endswith(SUPPORTED_EXTENSIONS):
            try:
                doc = state.docs.ingest(f.filename, f.content)
            except ConversionError as e:
                raise HTTPError(400, {"error": f"文档解析失败：{e}"})
        else:
            raise HTTPError(400, {"error": "不支持的文件类型"})
        docs = session.setdefault("reference_materials", [])
        docs[:] = [d for d in docs if d.get("name") != doc["name"]]
        docs.append(doc)
        state.sessions.save(session)
        state.question_cache.invalidate_session(session_id)
        return {
            "ok": True,
            "document": {k: v for k, v in doc.items() if k != "chunks"},
            "total_documents": len(docs),
        }

    @app.route("/api/sessions/<session_id>/documents/<path:doc_name>",
               methods=["DELETE"])
    def delete_document(req, session_id, doc_name):
        user = require_user(state, req)
        session = _load_owned(state, session_id, user)
        docs = session.get("reference_materials", [])
        before = len(docs)
        docs[:] = [d for d in docs if d.get("name") != doc_name]
        if len(docs) == before:
            raise HTTPError(404, {"error": "文档不存在"})
        state.sessions.save(session)
        return {"ok": True}

    # ------------------------------------------------------------------
    # Interview assistant chat (reference :30877)
    # ------------------------------------------------------------------

    @app.route("/api/sessions/<session_id>/interview-assistant-chat",
               methods=["POST"])
    def assistant_chat(req, session_id):
        user = require_user(state, req)
        session = _load_owned(state, session_id, user)
        body = req.get_json()
        message = str_field(body, "message")
        if not message:
            raise HTTPError(400, {"error": "缺少消息内容"})
        # accept both the nested shape and the frontend's flat fields
        current_q = body.get("current_question")
        if not current_q and body.get("question"):
            current_q = {
                "question": body.get("question"),
                "options": body.get("options") or [],
                "multi_select": bool(body.get("multi_select")),
                "answer_mode": body.get("answer_mode"),
            }
        out = state.assistant.chat(session, message, current_q)
        state.sessions.save(session)  # persist assistant chat memory
        return out

    # ------------------------------------------------------------------
    # Report readiness + generation submit (§3.3)
    # ------------------------------------------------------------------

    @app.route("/api/sessions/<session_id>/report-readiness",
               methods=["GET", "POST"])
    def readiness(req, session_id):
        user = require_user(state, req)
        session = _load_owned(state, session_id, user)
        payload = report_readiness(session)
        payload["evidence_ledger"] = build_evidence_ledger(session)
        return payload

    @app.route("/api/sessions/<session_id>/generate-report",
               methods=["POST"])
    def generate_report(req, session_id):
        user = require_user(state, req)
        require_license(state, req, user)
        session = _load_owned(state, session_id, user)
        body = req.get_json()
        if not body.get("force"):
            ready = report_readiness(session)
            if not ready["ready"]:
                return {
                    "accepted": False,
                    "readiness": ready,
                    "hint": "存在阻塞项，可携带 force=true 强制生成",
                }, 409
        from deepvision_tpu_torch.web.levels import clamp_report_profile

        requested = body.get("profile") or body.get("report_profile") \
            or "balanced"
        if requested not in ("balanced", "quality", "release-conservative"):
            raise HTTPError(400, {"error": f"未知的报告档位: {requested}"})
        profile = clamp_report_profile(user.get("level"), requested)
        if profile != requested:
            # explicit ask above the level's ceiling is a 403, not a silent
            # downgrade (reference level_capability_denied payload)
            from deepvision_tpu_torch.web.levels import CAPABILITIES

            required = next(
                (lv for lv in ("standard", "professional")
                 if requested in CAPABILITIES[lv]["report_profiles"]),
                "professional",
            )
            raise HTTPError(403, {
                "error": f"当前等级不支持 {requested} 档报告",
                "error_code": "level_capability_denied",
                "capability_key": f"report.profile.{requested}",
                "current_level": {"key": user.get("level") or "experience"},
                "required_level": {"key": required},
            })
        # retrigger while a job is live returns the active payload instead
        # of double-enqueueing (reference
        # test_generate_report_returns_existing_active_payload_when_retriggered)
        current = state.report_queue.status_payload(session_id)
        if current.get("active"):
            current["accepted"] = True
            current["already_active"] = True
            return current, 200
        accepted = state.report_queue.submit(
            session_id, profile=profile,
            owner_user_id=str(user["user_id"]),
            instance_scope=state.instance_scope,
            request_id=body.get("request_id") or "",
        )
        if not accepted:
            snap = state.report_queue.queue_snapshot()
            raise build_overload_response(
                snap["max_pending"], snap["running"], 5
            )
        return {"accepted": True, "session_id": session_id,
                "profile": profile}, 202


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _load_owned(state, session_id: str, user: dict) -> dict:
    session = state.sessions.load(session_id)
    if session is None:
        raise HTTPError(404, {"error": "会话不存在"})
    owner = session.get("owner_user_id")
    if owner is not None and owner != str(user["user_id"]) and \
            not state.auth.is_admin(user):
        raise HTTPError(403, {"error": "无权访问该会话"})
    if session.get("instance_scope") not in (None, state.instance_scope):
        raise HTTPError(404, {"error": "会话不存在"})
    return session


def _current_dimension_id(session: dict) -> Optional[str]:
    for d in session.get("scenario_config", {}).get("dimensions", []):
        dim_state = session.get("dimensions", {}).get(d["id"], {})
        if not dim_state.get("completed"):
            return d["id"]
    return None


def _pick_dimension(state, session):
    """Returns (dimension_cfg, None) or (None, done_payload)."""
    pending = session.get("_pending_follow_up")
    scenario_dims = session.get("scenario_config", {}).get("dimensions", [])
    by_id = {d["id"]: d for d in scenario_dims}
    if pending and pending.get("dimension") in by_id:
        return by_id[pending["dimension"]], None
    mode = session.get("interview_mode", "standard")
    for d in scenario_dims:
        dim_state = session.get("dimensions", {}).get(d["id"], {})
        if dim_state.get("completed"):
            continue
        sat = dimension_saturation(session, d, mode)
        if sat["saturated"]:
            dim_state["completed"] = True
            state.sessions.save(session)
            return None, {
                "dimension": d["id"],
                "completed": True,
                "completion_reason": "saturated",
                "quality_warning": sat["avg_quality"] < 0.4,
                "decision_meta": sat,
            }
        return d, None
    return None, {
        "completed": True,
        "all_dimensions_completed": True,
        "message": "所有维度访谈已完成，可以生成报告",
    }


def _generate_question(state, session, dimension, timer):
    session_id = session["session_id"]
    pending = session.get("_pending_follow_up")
    is_follow_up = bool(pending and pending.get("dimension") ==
                        dimension["id"])
    mode = session.get("interview_mode", "standard")
    n_in_dim = len([
        e for e in session.get("interview_log", [])
        if e.get("dimension") == dimension["id"]
    ])
    contract = build_capture_contract(dimension, n_in_dim + 1, mode)

    state.set_thinking(session_id, active=True, stage="搜索判定",
                       stage_index=1, message="正在判断是否需要联网检索")
    search_context = state.search.maybe_search_for_session(session)
    timer.mark("search")
    state.set_thinking(session_id, active=True, stage="生成问题",
                       stage_index=2, message="AI 正在生成下一个问题")
    # preflight planner: steer the next question at the biggest evidence
    # hole in this dimension (reference probe planner web/server.py:19738)
    probe = next_probe_for_dimension(session, dimension["id"])
    result, meta = state.question_gen.generate(
        session, dimension,
        is_follow_up=is_follow_up,
        follow_up_context=(pending or {}).get("context", ""),
        capture_contract=contract,
        search_context=search_context,
        focus_aspect=(probe or {}).get("aspect", ""),
    )
    if probe:
        meta["preflight_probe"] = probe
    timer.mark("ai_call")
    state.set_thinking(session_id, active=False, stage="完成",
                       stage_index=4)
    if is_follow_up:
        result["is_follow_up"] = True
    return result, meta


def _decision_meta(state, session, dimension, meta) -> dict:
    from deepvision_tpu_torch.web.runtime.interview import mode_config

    mode = session.get("interview_mode", "standard")
    cfg = mode_config(mode)
    pending = session.get("_pending_follow_up") or {}
    sat = dimension_saturation(session, dimension, mode)
    return {
        "mode": mode,
        "follow_up_round": pending.get("round", 0),
        "remaining_budget": max(0, sat["budget"] - sat["asked"]),
        "missing_aspects": dimension.get("key_aspects", [])[sat["asked"]:],
        "tier_used": meta.get("tier_used"),
        "selected_lane": meta.get("selected_lane"),
    }


def _schedule_prefetch(state, session_id: str) -> None:
    """Background prefetch of the next question (reference :13868-14404);
    low priority — skipped entirely when AI is off, and gated on engine
    idleness when PREFETCH_IDLE_ONLY (reference _wait_for_prefetch_idle
    web/server.py:4546: prefetch must never steal capacity from live
    requests)."""
    if state.gateway.mode == "off":
        return
    if state.resolver.get_bool("PREFETCH_IDLE_ONLY", True):
        for eng in state.gateway.engines.values():
            q = eng.scheduler.queue_depths()
            if q["active"] or q["high"] or q.get("prefilling"):
                return

    def run():
        try:
            session = state.sessions.load(session_id)
            if session is None or session.get("_pending_follow_up"):
                return
            dimension, _ = _pick_dimension(state, session)
            if dimension is None:
                return
            signature = state.sessions.file_signature(session_id)
            mode = session.get("interview_mode", "standard")
            n_in_dim = len([
                e for e in session.get("interview_log", [])
                if e.get("dimension") == dimension["id"]
            ])
            contract = build_capture_contract(dimension, n_in_dim + 1, mode)
            result, meta = state.question_gen.generate(
                session, dimension, capture_contract=contract,
            )
            # annotate with the SAME route-added fields as the live path
            # (A.2 contract: cache hits serve the full normalized payload,
            # reference :29948 caches post-annotation results)
            payload = dict(result)
            payload.update(
                dimension=dimension["id"],
                ai_generated=meta.get("tier_used") != "fallback",
                decision_meta=_decision_meta(state, session, dimension,
                                             meta),
                question_generation_tier=meta.get("tier_used"),
                question_selected_lane=meta.get("selected_lane"),
                question_runtime_profile=session.get("interview_mode"),
                question_hedge_triggered=meta.get("hedge_triggered",
                                                  False),
                question_fallback_triggered=meta.get(
                    "fallback_triggered", False),
                question_attempts=meta.get("attempts", 1),
            )
            with state.prefetch_lock:
                state.prefetch[session_id] = {
                    "result": payload,
                    "signature": signature,
                    "dimension": dimension["id"],
                }
        except Exception:
            pass

    threading.Thread(target=run, daemon=True,
                     name=f"dv-prefetch-{session_id[:12]}").start()


def _schedule_summary_update(state, session_id: str) -> None:
    """Async sliding-window history summary (reference
    update_context_summary web/server.py:18506, worker :4607-4651): when the
    log passes SUMMARY_THRESHOLD, compress entries older than the window
    into session['summary'] on the low-priority summary lane."""
    if state.gateway.mode == "off":
        return
    threshold = state.resolver.get_int("SUMMARY_THRESHOLD", 8)
    window = state.resolver.get_int("CONTEXT_WINDOW_SIZE", 5)

    def run():
        try:
            session = state.sessions.load(session_id)
            if session is None:
                return
            log = session.get("interview_log", [])
            summarized_upto = int(session.get("_summary_upto") or 0)
            if len(log) < threshold or len(log) - summarized_upto < 3:
                return
            older = log[: len(log) - window]
            history_text = "\n".join(
                f"问：{e.get('question')} 答：{e.get('answer')}"
                for e in older
            )
            prev = session.get("summary", "")
            text = state.gateway.call_model(
                "请把以下访谈历史压缩为 200 字以内的要点摘要（保留已确认的"
                f"结论与数据）：\n已有摘要：{prev}\n新增历史：\n"
                + history_text[-4000:],
                call_type="summary",
                context={"doc_name": "访谈历史"},
            )
            session = state.sessions.load(session_id)
            if session is None:
                return
            session["summary"] = text.strip()[:800]
            session["_summary_upto"] = len(older)
            state.sessions.save(session)
        except Exception:
            pass

    threading.Thread(target=run, daemon=True,
                     name=f"dv-summary-{session_id[:12]}").start()


def _ingest_image(state, f) -> dict:
    """Images go to the vision path (reference describe_image_with_vision
    web/server.py:26523).  With a vision-capable lane configured
    (VISION_DESCRIBE_ENABLED) the description comes from the model;
    otherwise it degrades to a structured caption — metadata, orientation
    class, EXIF hints — under an explicit degraded-caption contract so the
    doc still contributes signal to interview prompts."""
    desc = None
    meta_parts = []
    try:
        from PIL import Image
        import io as _io

        img = Image.open(_io.BytesIO(f.content))
        ratio = img.width / max(img.height, 1)
        shape = ("宽幅横图（可能为截图/流程图）" if ratio > 1.6
                 else "纵向长图（可能为文档照片/长截图）" if ratio < 0.625
                 else "常规比例图片")
        meta_parts.append(
            f"尺寸 {img.width}x{img.height}，格式 {img.format}，{shape}")
        try:
            exif = img.getexif()
            for tag in (270, 306, 272):  # description / datetime / model
                v = exif.get(tag)
                if v:
                    meta_parts.append(str(v)[:80])
        except Exception:
            pass
    except Exception:
        meta_parts.append("无法解析图片头")

    if state.resolver.get_bool("VISION_DESCRIBE_ENABLED", False):
        try:
            import base64

            desc = state.gateway.call_model(
                "请描述这张图片的内容要点（需求访谈参考资料场景）。\n"
                f"[image/{f.filename};base64:"
                f"{base64.b64encode(f.content[:64]).decode()}...]",
                call_type="vision",
                context={"filename": f.filename},
            )
        except Exception:
            desc = None  # fall through to the degraded caption contract
    if not desc:
        desc = (
            f"图片资料 {f.filename}：{'；'.join(meta_parts)}。"
            "（视觉模型未启用，此为降级描述；访谈时可请用户口述图片要点。）"
        )
    return {
        "name": f.filename,
        "content": desc,
        "chunks": [desc],
        "summary": None,
        "char_count": len(desc),
        "kind": "image",
        "vision_mode": "model" if state.resolver.get_bool(
            "VISION_DESCRIBE_ENABLED", False) else "degraded_caption",
    }
