"""Scenario + report-template routes (reference web/server.py:27058-27674)."""

from __future__ import annotations

from deepvision_tpu_torch.web.http import HTTPError
from deepvision_tpu_torch.web.levels import level_allows
from deepvision_tpu_torch.web.scenarios import generate_scenario_from_description


def register(app, state):
    from deepvision_tpu_torch.web.server import require_user

    @app.route("/api/scenarios")
    def list_scenarios(req):
        require_user(state, req)
        items = state.scenarios.list_all(state.instance_scope)
        return [
            {k: v for k, v in sc.items() if k != "report"} | {
                "dimension_count": len(sc.get("dimensions", []))
            }
            for sc in items
        ]

    @app.route("/api/scenarios/<scenario_id>")
    def get_scenario(req, scenario_id):
        require_user(state, req)
        sc = state.scenarios.get(scenario_id, state.instance_scope)
        if sc is None:
            raise HTTPError(404, {"error": "场景不存在"})
        return sc

    @app.route("/api/scenarios/generate", methods=["POST"])
    def generate_scenario(req):
        user = require_user(state, req)
        if not level_allows(user.get("level"), "custom_scenarios"):
            raise HTTPError(403, {"error": "当前等级不支持自定义场景"})
        desc = (req.get_json().get("description") or "").strip()
        if len(desc) < 4:
            raise HTTPError(400, {"error": "请至少输入 4 个字的业务描述"})
        if len(desc) > 4000:
            # abuse guard (round-4 hardening sweep): an unbounded
            # description goes straight into an AI prompt
            raise HTTPError(400, {"error": "业务描述过长（上限 4000 字）"})
        scenario = generate_scenario_from_description(state.gateway, desc)
        return {"ok": True, "scenario": scenario}

    @app.route("/api/scenarios/custom", methods=["POST"])
    def save_custom(req):
        user = require_user(state, req)
        if not level_allows(user.get("level"), "custom_scenarios"):
            raise HTTPError(403, {"error": "当前等级不支持自定义场景"})
        payload = req.get_json().get("scenario") or req.get_json()
        try:
            saved = state.scenarios.save_custom(
                payload, owner_user_id=str(user["user_id"]),
                instance_scope=state.instance_scope,
            )
        except ValueError as e:
            raise HTTPError(400, {"error": str(e)})
        return {"ok": True, "scenario": saved}, 201

    @app.route("/api/scenarios/custom/<scenario_id>", methods=["DELETE"])
    def delete_custom(req, scenario_id):
        user = require_user(state, req)
        row = state.meta.query_one(
            "SELECT owner_user_id FROM custom_scenarios WHERE scenario_id = ?",
            (scenario_id,),
        )
        if row is None:
            raise HTTPError(404, {"error": "场景不存在"})
        if row["owner_user_id"] not in (None, str(user["user_id"])) and \
                not state.auth.is_admin(user):
            raise HTTPError(403, {"error": "无权删除该场景"})
        state.scenarios.delete_custom(scenario_id)
        return {"ok": True}

    @app.route("/api/scenarios/recognize", methods=["POST"])
    def recognize(req):
        require_user(state, req)
        text = (req.get_json().get("text") or "").strip()
        if not text:
            raise HTTPError(400, {"error": "缺少描述文本"})
        return {"matches": state.scenarios.recognize(text)}

    # --- report templates (reference :27058-27259) ----------------------
    @app.route("/api/report-templates/validate", methods=["POST"])
    def validate_template(req):
        require_user(state, req)
        payload = req.get_json()
        sections = payload.get("sections")
        problems = []
        if not isinstance(sections, list) or not sections:
            problems.append("sections 必须是非空列表")
        else:
            for i, s in enumerate(sections):
                if isinstance(s, dict):
                    if not s.get("id") or not s.get("title"):
                        problems.append(f"sections[{i}] 缺少 id/title")
                elif not isinstance(s, str):
                    problems.append(f"sections[{i}] 类型不合法")
        return {"valid": not problems, "problems": problems}

    @app.route("/api/report-templates/preview", methods=["POST"])
    def preview_template(req):
        require_user(state, req)
        payload = req.get_json()
        sections = payload.get("sections") or []
        lines = [f"# {payload.get('title', '报告预览')}", ""]
        for s in sections:
            title = s.get("title") if isinstance(s, dict) else str(s)
            lines += [f"## {title}", "", "（示例内容）", ""]
        return {"markdown": "\n".join(lines)}
