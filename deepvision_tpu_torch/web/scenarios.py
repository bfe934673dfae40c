"""Scenario system: builtin + custom scenarios, AI generation, recognition.

Re-implements the reference ScenarioLoader (scripts/scenario_loader.py:28-792
— builtin dir + custom dir + DB-backed custom in shared mode), AI scenario
generation with text-fallback parsing (web/server.py:15778-16217), and
keyword recognition (:27574).
"""

from __future__ import annotations

import json
import os
import re
import secrets
from typing import Dict, List, Optional

from deepvision_tpu_torch.web.meta_index import MetaIndex, utc_now_iso

DEFAULT_BUILTIN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "resources", "scenarios", "builtin",
)

REQUIRED_SCENARIO_KEYS = ("id", "name", "description", "dimensions")
REQUIRED_DIMENSION_KEYS = ("id", "name")


def validate_scenario(payload: dict) -> List[str]:
    problems = []
    for key in REQUIRED_SCENARIO_KEYS:
        if not payload.get(key):
            problems.append(f"missing field: {key}")
    dims = payload.get("dimensions") or []
    if not isinstance(dims, list) or not dims:
        problems.append("dimensions must be a non-empty list")
    else:
        for i, d in enumerate(dims):
            for key in REQUIRED_DIMENSION_KEYS:
                if not isinstance(d, dict) or not d.get(key):
                    problems.append(f"dimension[{i}] missing {key}")
    return problems


class ScenarioLoader:
    def __init__(
        self,
        meta: MetaIndex,
        builtin_dir: Optional[str] = None,
        custom_dir: Optional[str] = None,
        use_db_custom: bool = True,
    ):
        self.meta = meta
        self.builtin_dir = builtin_dir or DEFAULT_BUILTIN_DIR
        self.custom_dir = custom_dir
        if custom_dir:
            os.makedirs(custom_dir, exist_ok=True)
        self.use_db_custom = use_db_custom
        self._builtin_cache: Optional[Dict[str, dict]] = None

    # -- builtin ---------------------------------------------------------
    def builtins(self) -> Dict[str, dict]:
        if self._builtin_cache is None:
            out = {}
            try:
                names = sorted(os.listdir(self.builtin_dir))
            except OSError:
                names = []
            for name in names:
                if not name.endswith(".json"):
                    continue
                try:
                    with open(
                        os.path.join(self.builtin_dir, name), encoding="utf-8"
                    ) as fh:
                        sc = json.load(fh)
                    out[sc["id"]] = sc
                except (OSError, json.JSONDecodeError, KeyError):
                    continue
            self._builtin_cache = out
        return self._builtin_cache

    # -- custom ----------------------------------------------------------
    def customs(self, instance_scope: str = "default") -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        if self.custom_dir:
            try:
                for name in sorted(os.listdir(self.custom_dir)):
                    if name.endswith(".json"):
                        try:
                            with open(
                                os.path.join(self.custom_dir, name),
                                encoding="utf-8",
                            ) as fh:
                                sc = json.load(fh)
                            out[sc["id"]] = sc
                        except Exception:
                            continue
            except OSError:
                pass
        if self.use_db_custom:
            rows = self.meta.query(
                "SELECT payload FROM custom_scenarios WHERE instance_scope = ?",
                (instance_scope,),
            )
            for row in rows:
                try:
                    sc = json.loads(row["payload"])
                    out[sc["id"]] = sc
                except Exception:
                    continue
        return out

    def save_custom(self, payload: dict, *, owner_user_id=None,
                    instance_scope: str = "default") -> dict:
        problems = validate_scenario(payload)
        if problems:
            raise ValueError("; ".join(problems))
        if not payload.get("id"):
            payload["id"] = f"custom-{secrets.token_hex(4)}"
        payload.setdefault("custom", True)
        self.meta.execute(
            "INSERT INTO custom_scenarios (scenario_id, owner_user_id, "
            "instance_scope, payload, created_at) VALUES (?, ?, ?, ?, ?) "
            "ON CONFLICT(scenario_id) DO UPDATE SET payload = excluded.payload",
            (payload["id"], owner_user_id, instance_scope,
             json.dumps(payload, ensure_ascii=False), utc_now_iso()),
        )
        return payload

    def delete_custom(self, scenario_id: str) -> bool:
        row = self.meta.query_one(
            "SELECT 1 AS x FROM custom_scenarios WHERE scenario_id = ?",
            (scenario_id,),
        )
        self.meta.kv_delete("custom_scenarios", "scenario_id", scenario_id)
        return row is not None

    # -- lookup ----------------------------------------------------------
    def get(self, scenario_id: str,
            instance_scope: str = "default") -> Optional[dict]:
        sc = self.builtins().get(scenario_id)
        if sc:
            return sc
        return self.customs(instance_scope).get(scenario_id)

    def list_all(self, instance_scope: str = "default") -> List[dict]:
        out = list(self.builtins().values())
        out.extend(self.customs(instance_scope).values())
        return out

    # -- keyword recognition (reference :27574) --------------------------
    def recognize(self, text: str) -> List[dict]:
        scores = []
        for sc in self.list_all():
            score = 0
            for kw in sc.get("keywords", []):
                if kw and kw in text:
                    score += 1
            if sc.get("name") and sc["name"] in text:
                score += 2
            if score:
                scores.append((score, sc))
        scores.sort(key=lambda t: -t[0])
        return [
            {"scenario_id": sc["id"], "name": sc["name"], "score": score}
            for score, sc in scores[:5]
        ]


# ---------------------------------------------------------------------------
# AI scenario generation (reference web/server.py:15778-16217)
# ---------------------------------------------------------------------------

def generate_scenario_from_description(gateway, description: str) -> dict:
    prompt = (
        "请基于以下业务描述设计一个结构化访谈场景，输出 JSON，字段："
        "name/description/icon/keywords/dimensions(每个含 id/name/description/"
        "key_aspects/min_questions/max_questions)/report。\n业务描述："
        + description
    )
    text = gateway.call_model(
        prompt, call_type="scenario", context={"description": description}
    )
    payload = _parse_scenario_response(text, description)
    problems = validate_scenario(payload)
    if problems:
        payload = _fallback_scenario(description)
    return payload


def _parse_scenario_response(text: str, description: str) -> dict:
    # strategy 1: direct / fenced JSON
    for candidate in _json_candidates(text):
        try:
            data = json.loads(candidate)
            if isinstance(data, dict) and data.get("dimensions"):
                data.setdefault("id", f"custom-{secrets.token_hex(4)}")
                return data
        except json.JSONDecodeError:
            continue
    # strategy 2: text-outline fallback parser (reference text fallback)
    dims = []
    for m in re.finditer(r"^[\-\*\d\.、]+\s*(.{2,24})[:：]?\s*$", text, re.M):
        name = m.group(1).strip()
        if 2 <= len(name) <= 24:
            dims.append({
                "id": f"dim_{len(dims) + 1}",
                "name": name,
                "description": name,
                "key_aspects": [name],
                "min_questions": 2,
                "max_questions": 4,
            })
        if len(dims) >= 6:
            break
    if dims:
        return {
            "id": f"custom-{secrets.token_hex(4)}",
            "name": f"定制场景：{description[:20]}",
            "description": description[:200],
            "keywords": [],
            "dimensions": dims,
            "report": {"type": "standard", "template": "default",
                       "sections": []},
        }
    return _fallback_scenario(description)


def _json_candidates(text: str) -> List[str]:
    out = [text.strip()]
    fence = re.search(r"```(?:json)?\s*(.+?)```", text, re.S)
    if fence:
        out.append(fence.group(1).strip())
    brace = re.search(r"\{.*\}", text, re.S)
    if brace:
        out.append(brace.group(0))
    return out


def _fallback_scenario(description: str) -> dict:
    return {
        "id": f"custom-{secrets.token_hex(4)}",
        "name": f"定制场景：{description[:20]}" if description else "定制访谈场景",
        "description": description[:200] or "基于描述生成的访谈场景",
        "icon": "sparkles",
        "keywords": [],
        "dimensions": [
            {"id": "dim_goal", "name": "目标与背景",
             "description": "业务目标与现状背景",
             "key_aspects": ["业务目标", "现状背景"],
             "min_questions": 2, "max_questions": 4},
            {"id": "dim_constraint", "name": "现状与约束",
             "description": "资源、时间与技术约束",
             "key_aspects": ["资源约束", "时间窗口"],
             "min_questions": 2, "max_questions": 4},
            {"id": "dim_expectation", "name": "方案期望",
             "description": "期望达成的效果与衡量标准",
             "key_aspects": ["期望效果", "衡量标准"],
             "min_questions": 2, "max_questions": 4},
        ],
        "report": {"type": "standard", "template": "default", "sections": []},
        "custom": True,
    }
