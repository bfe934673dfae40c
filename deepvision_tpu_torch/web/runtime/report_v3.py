"""Report V3 pipeline: evidence pack -> draft -> validate/repair -> review
-> quality gate -> markdown render, with a layered degrade chain.

Re-implements the reference pipeline (generate_report_v3_pipeline
report_generation_runtime.py:409-1208, evidence pack web/server.py:22002,
draft validation :22980, deterministic repairs :24675, review patch merge
:23423, quality gate :25086-25312, render :26152, structured-JSON
parse+repair :21685-21943, salvage :32445, simple template :33355).
"""

from __future__ import annotations

import json
import re
import time
from typing import Dict, List, Optional

from deepvision_tpu_torch.web.runtime import prompt_formats, report_quality
from deepvision_tpu_torch.web.runtime.followup import (
    build_evidence_ledger, classify_evidence,
)

REPORT_PROFILES = {
    "balanced": {
        "draft_retries": 2, "review_rounds": 1, "quality_floor": 0.55,
        "facts_limit": 40,
    },
    "quality": {
        "draft_retries": 3, "review_rounds": 2, "quality_floor": 0.7,
        "facts_limit": 60,
    },
    "release-conservative": {
        "draft_retries": 3, "review_rounds": 2, "quality_floor": 0.8,
        "facts_limit": 60,
    },
}

DRAFT_REQUIRED_KEYS = ("overview", "needs", "analysis")
DRAFT_ALL_KEYS = (
    "overview", "needs", "analysis", "visualizations", "solutions",
    "risks", "actions", "open_questions", "evidence_index",
)
ANALYSIS_KEYS = (
    "customer_needs", "business_flow", "tech_constraints",
    "project_constraints",
)


def profile_config(profile: str) -> dict:
    return REPORT_PROFILES.get(profile, REPORT_PROFILES["balanced"])


# ---------------------------------------------------------------------------
# Evidence pack (reference build_report_evidence_pack :22002)
# ---------------------------------------------------------------------------

def build_evidence_pack(session: dict, facts_limit: int = 40) -> dict:
    facts = []
    for i, entry in enumerate(session.get("interview_log", []), 1):
        q_id = f"Q{i}"
        facts.append({
            "q_id": q_id,
            "dimension": entry.get("dimension"),
            "question": entry.get("question"),
            "answer": entry.get("answer"),
            "rationale": entry.get("rationale_text") or "",
            "is_follow_up": bool(entry.get("is_follow_up")),
            "evidence_class": classify_evidence(entry),
            "quality_score": entry.get("quality_score"),
        })
    # fact slimming (reference select_slimmed_facts_for_prompt :22320):
    # keep strongest evidence first when over the limit.
    if len(facts) > facts_limit:
        rank = {"explicit": 0, "rich_option": 1, "weak_inferred": 2,
                "pending_follow_up": 3}
        facts = sorted(
            facts, key=lambda f: rank.get(f["evidence_class"], 9)
        )[:facts_limit]
        facts.sort(key=lambda f: int(f["q_id"][1:]))
    scenario = session.get("scenario_config") or {}
    # uncovered key aspects per dimension = the report's blindspots; the
    # repair catalog backfills them into open_questions/actions
    # (reference blindspot rules web/server.py:24845-24960)
    ledger = build_evidence_ledger(session)
    dim_names = {d.get("id"): d.get("name")
                 for d in scenario.get("dimensions", [])}
    blindspots = [
        {"dimension": dim_names.get(dim_id, dim_id), "aspect": aspect}
        for dim_id, entry in ledger.get("dimensions", {}).items()
        for aspect in entry.get("aspects_missing", [])
    ]
    return {
        # stable per-session key: the gateway derives the engine
        # prefix-cache key from it, so draft retries / review rounds /
        # regenerates reuse the evidence-pack head's KV pages instead of
        # re-prefilling from token zero (reference prompt cache
        # web/server.py:4920-5012; round-5 fix — report calls previously
        # passed no session_id, so prefix_cache_report was 0 by
        # construction)
        "session_id": session.get("session_id"),
        "topic": session.get("topic", ""),
        "description": session.get("description", ""),
        "scenario_id": session.get("scenario_id"),
        "interview_mode": session.get("interview_mode"),
        "report_type": (scenario.get("report") or {}).get(
            "type", "standard"),
        "dimensions": session.get("dimensions", {}),
        "dimension_names": {
            d.get("id"): d.get("name")
            for d in scenario.get("dimensions", [])
        },
        "facts": facts,
        "blindspots": blindspots,
        "q_ids": [f["q_id"] for f in facts],
        "documents": [
            {"name": d.get("name"), "summary": d.get("summary") or
             (d.get("content") or "")[:400]}
            for d in session.get("reference_materials", [])
        ],
    }


# ---------------------------------------------------------------------------
# Structured JSON parsing + repair (reference :21685-21943)
# ---------------------------------------------------------------------------

def parse_structured_json_response(text: str) -> Optional[dict]:
    if not text:
        return None
    candidates = [text.strip()]
    fence = re.search(r"```(?:json)?\s*(.+?)```", text, re.S)
    if fence:
        candidates.append(fence.group(1).strip())
    brace = re.search(r"\{.*\}", text, re.S)
    if brace:
        candidates.append(brace.group(0))
    for cand in list(candidates):
        candidates.append(repair_json_text(cand))
    for cand in candidates:
        try:
            data = json.loads(cand)
            if isinstance(data, dict):
                return data
        except json.JSONDecodeError:
            continue
    return None


def repair_json_text(text: str) -> str:
    """Deterministic JSON repairs: trailing commas, truncated tails,
    unbalanced brackets (reference JSON repair :21724).

    Round-4 rewrite after adversarial tests broke the regex version on
    nested truncation (``{"a": {"b": "v``) and mid-array cutoffs: a
    string-aware scan finds an unterminated string, truncates back to
    its opening quote (plus any dangling ``"key":`` prefix), then closes
    the still-open brackets in stack order — counting braces is wrong
    when braces appear inside string values."""

    def scan(s):
        """(bracket stack, unterminated-string start or -1)."""
        stack = []
        in_str, esc, start = False, False, -1
        for i, ch in enumerate(s):
            if in_str:
                if esc:
                    esc = False
                elif ch == "\\":
                    esc = True
                elif ch == '"':
                    in_str = False
                continue
            if ch == '"':
                in_str, start = True, i
            elif ch in "{[":
                stack.append(ch)
            elif ch == "}":
                if stack and stack[-1] == "{":
                    stack.pop()
            elif ch == "]":
                if stack and stack[-1] == "[":
                    stack.pop()
        return stack, (start if in_str else -1)

    def _strip_partial_bare_token(s: str) -> str:
        """Drop a trailing bare token cut mid-literal (``fal``, ``tr``,
        ``12.``).  A COMPLETE literal (``true``/``false``/``null`` or a
        valid JSON number) is a legal value and must be kept."""
        m = re.search(r"([\w.+-]+)\s*$", s)
        if not m:
            return s
        tok = m.group(1)
        if tok in ("true", "false", "null") or re.fullmatch(
                r"-?(?:0|[1-9]\d*)(?:\.\d+)?(?:[eE][+-]?\d+)?", tok):
            return s
        s = s[: m.start()]
        # the partial token orphaned its `"key":` (object) or `,` (array)
        s = re.sub(r"[,\s]*\"[^\"]*\"\s*:\s*$", "", s)
        s = re.sub(r",\s*$", "", s)
        return s

    s = text
    stack, dangling = scan(s)
    if dangling >= 0:
        s = s[:dangling]
        # a now-orphaned `"key":` (or partial bare token) before the cut
        s = re.sub(r"[,\s]*\"[^\"]*\"\s*:\s*$", "", s)
        s = re.sub(r"[,\s]*[\w.+-]*\s*$", "", s)
        stack, _ = scan(s)
    elif stack:
        # output cut mid bare-token (`{"b": fal`) — no dangling string,
        # but the tail literal can't parse; strip it with its key/comma
        s = _strip_partial_bare_token(s)
    closers = {"{": "}", "[": "]"}
    for opener in reversed(stack):
        s = re.sub(r",\s*$", "", s)
        # an object cut right after `"key":` (value never started)
        if opener == "{":
            s = re.sub(r"[,\s]*\"[^\"]*\"\s*:\s*$", "", s)
            s = re.sub(r",\s*$", "", s)
        s += closers[opener]
    # trailing commas before closers (also covers the untruncated case)
    s = re.sub(r",\s*([}\]])", r"\1", s)
    return s


# ---------------------------------------------------------------------------
# Draft validation + deterministic repairs (reference :22980, :24675)
# ---------------------------------------------------------------------------

_MERMAID_TYPES = (
    "flowchart", "graph", "sequenceDiagram", "quadrantChart", "pie",
    "gantt", "classDiagram", "stateDiagram", "erDiagram", "mindmap",
)

VALID_PRIORITIES = ("P0", "P1", "P2", "P3")
_PRIORITY_ALIASES = {
    "高": "P0", "最高": "P0", "high": "P0", "critical": "P0",
    "中": "P1", "medium": "P1", "较高": "P1",
    "低": "P2", "low": "P2", "一般": "P2",
}


def _mermaid_ok(block: str) -> bool:
    head = (block or "").strip().split("\n", 1)[0].strip()
    if not any(head.startswith(t) for t in _MERMAID_TYPES):
        return False
    return (block.count("[") >= block.count("]") - 1
            and block.count("(") >= block.count(")") - 1)


def validate_report_draft(draft: dict, q_ids: List[str],
                          facts: Optional[List[dict]] = None) -> List[dict]:
    """Draft validation at reference depth (validate_report_draft_v3
    web/server.py:22980-23048): required sections, shape checks, overview
    bounds, priority vocabulary, duplicate needs, mermaid sanity, invalid
    refs, and high-evidence coverage."""
    issues = []

    def issue(type_, severity, message, target):
        issues.append({"type": type_, "severity": severity,
                       "message": message, "target": target})

    for key in DRAFT_REQUIRED_KEYS:
        if not draft.get(key):
            issue("missing_section", "error", f"缺少必需章节 {key}", key)

    overview = draft.get("overview")
    if isinstance(overview, str) and overview:
        if len(overview) < 30:
            issue("overview_too_short", "warning",
                  f"概述仅 {len(overview)} 字，缺少信息量", "overview")
        elif len(overview) > 2000:
            issue("overview_too_long", "warning",
                  "概述超过 2000 字，应下沉到分析章节", "overview")
    elif overview is not None and not isinstance(overview, str):
        issue("wrong_type", "error", "overview 必须是字符串", "overview")

    analysis = draft.get("analysis") or {}
    if not isinstance(analysis, dict):
        issue("wrong_type", "error", "analysis 必须是对象", "analysis")
        analysis = {}
    for key in ANALYSIS_KEYS:
        val = analysis.get(key)
        if not val:
            issue("missing_analysis", "warning", f"分析缺少 {key}", key)
        elif isinstance(val, str) and len(val) < 10:
            issue("analysis_thin", "warning",
                  f"分析 {key} 过于简略（{len(val)} 字）", key)

    valid_ids = set(q_ids)
    seen_titles = set()
    for section in ("needs", "solutions", "risks", "actions",
                    "open_questions"):
        items = draft.get(section)
        if items is not None and not isinstance(items, list):
            issue("wrong_type", "error", f"{section} 必须是列表", section)
            continue
        for i, item in enumerate(items or []):
            if isinstance(item, dict):
                refs = item.get("refs")
                if refs:
                    bad = [r for r in refs if r not in valid_ids]
                    if bad:
                        issue("invalid_ref", "warning",
                              f"{section}[{i}] 引用了不存在的证据 {bad}",
                              f"{section}[{i}]")
                if section == "needs":
                    title = (item.get("title") or "").strip()
                    if title and title in seen_titles:
                        issue("duplicate_need", "warning",
                              f"需求标题重复：{title}", f"needs[{i}]")
                    seen_titles.add(title)
                    pr = item.get("priority")
                    if pr and pr not in VALID_PRIORITIES and \
                            pr not in _PRIORITY_ALIASES:
                        issue("invalid_priority", "warning",
                              f"优先级 {pr!r} 不在 P0-P3", f"needs[{i}]")
                    if not title and not item.get("description"):
                        issue("empty_item", "warning",
                              f"needs[{i}] 缺少标题与描述", f"needs[{i}]")

    for key, block in (draft.get("visualizations") or {}).items():
        if block and isinstance(block, str) and not _mermaid_ok(block):
            issue("bad_mermaid", "warning",
                  f"可视化 {key} 不是有效的 mermaid 图", key)

    # high-evidence coverage: every explicit-class fact should be cited
    # somewhere (reference evidence-pack cross-check :23024-23048)
    if facts:
        cited = set()
        for section in ("needs", "solutions", "risks", "actions"):
            for item in draft.get(section) or []:
                if isinstance(item, dict):
                    cited.update(item.get("refs") or [])
        strong_uncited = [
            f["q_id"] for f in facts
            if f.get("evidence_class") == "explicit"
            and f["q_id"] not in cited
        ]
        if strong_uncited and len(strong_uncited) > len(facts) * 0.5:
            issue("evidence_underused", "warning",
                  f"高价值证据未被引用：{strong_uncited[:5]}", "refs")

    # per-item issue taxonomy consumed by the deterministic repair
    # catalog (report_quality.apply_issue_repairs; reference issue types
    # no_evidence/not_actionable web/server.py:24704,24775)
    for section in ("needs", "solutions", "risks", "actions",
                    "evidence_index"):
        for i, item in enumerate(draft.get(section) or []):
            if not isinstance(item, dict):
                continue
            refs = [r for r in (item.get("refs") or []) if r in valid_ids]
            if not refs and not (
                    section == "evidence_index"
                    and item.get("q_id") in valid_ids):
                issue("no_evidence", "warning",
                      f"{section}[{i}] 没有任何可追溯证据引用",
                      f"{section}[{i}]")
    for i, item in enumerate(draft.get("actions") or []):
        if not isinstance(item, dict):
            continue
        missing = [k for k in ("owner", "timeline", "metric")
                   if not str(item.get(k) or "").strip()]
        if len(missing) >= 2:
            issue("not_actionable", "warning",
                  f"actions[{i}] 缺少 {'/'.join(missing)}，无法验收",
                  f"actions[{i}]")
    return issues


def apply_deterministic_repairs(draft: dict, q_ids: List[str],
                                facts: Optional[List[dict]] = None) -> dict:
    """Reference-depth deterministic repairs (web/server.py:24675):
    everything rules can fix without another model call — type coercion,
    ref pruning, priority normalization, title dedupe, field truncation,
    broken-mermaid removal, evidence_index normalization + summary
    backfill from the facts."""
    valid_ids = set(q_ids)
    fact_by_id = {f["q_id"]: f for f in (facts or [])}

    if not isinstance(draft.get("overview"), str):
        draft["overview"] = str(draft.get("overview") or "")
    draft["overview"] = draft["overview"][:2400]

    seen_titles = set()
    for section in ("needs", "solutions", "risks", "actions",
                    "open_questions"):
        items = draft.get(section)
        if not isinstance(items, list):
            draft[section] = []
            continue
        repaired = []
        for item in items:
            if isinstance(item, str):
                # coerce bare strings to the dict contract
                item = ({"question": item[:300]}
                        if section == "open_questions"
                        else {"title": item[:120], "description": ""})
            if not isinstance(item, dict):
                continue
            if item.get("refs"):
                item["refs"] = [r for r in item["refs"] if r in valid_ids]
            for field in ("title", "description"):
                if field in item and not isinstance(item[field], str):
                    item[field] = str(item[field])
                if isinstance(item.get(field), str):
                    item[field] = item[field][:600]
            if section == "needs":
                pr = item.get("priority")
                if pr in _PRIORITY_ALIASES:
                    item["priority"] = _PRIORITY_ALIASES[pr]
                elif pr and pr not in VALID_PRIORITIES:
                    item["priority"] = "P1"
                title = (item.get("title") or "").strip()
                if title and title in seen_titles:
                    continue  # dedupe repeated needs
                seen_titles.add(title)
            if section == "risks" and item.get("severity") not in (
                None, "low", "medium", "high"
            ):
                item["severity"] = "medium"
            repaired.append(item)
        draft[section] = repaired

    analysis = draft.get("analysis")
    if not isinstance(analysis, dict):
        draft["analysis"] = {k: "" for k in ANALYSIS_KEYS}
    else:
        for k in ANALYSIS_KEYS:
            val = analysis.get(k)
            if val is None or not isinstance(val, str):
                analysis[k] = str(val) if val else ""

    vis = draft.get("visualizations")
    if not isinstance(vis, dict):
        draft["visualizations"] = {}
    else:
        for key in list(vis.keys()):
            block = vis[key]
            if block and (not isinstance(block, str)
                          or not _mermaid_ok(block)):
                # a broken diagram renders worse than no diagram
                vis.pop(key)

    draft.setdefault("evidence_index", [
        {"q_id": q, "summary": ""} for q in q_ids[:10]
    ])
    # normalize bare q_id strings; backfill summaries from the facts
    norm_ev = []
    seen_q = set()
    for e in draft.get("evidence_index") or []:
        if isinstance(e, str):
            e = {"q_id": e, "summary": ""}
        if not isinstance(e, dict):
            continue
        qid = e.get("q_id")
        if qid in seen_q:
            continue
        seen_q.add(qid)
        if not e.get("summary") and qid in fact_by_id:
            f = fact_by_id[qid]
            e["summary"] = (f.get("answer") or f.get("question") or "")[:80]
        norm_ev.append(e)
    draft["evidence_index"] = norm_ev
    return draft


# ---------------------------------------------------------------------------
# Quality gate (reference :25086-25312)
# ---------------------------------------------------------------------------

def quality_gate(draft: dict, issues: List[dict], profile: str,
                 *, review_rounds_run: int = 0) -> dict:
    """Profile-adaptive quality gate (reference :25086-25312 + soft-pass
    rules :32110-32299) with structured reasons explaining each component
    of the score."""
    cfg = profile_config(profile)
    errors = sum(1 for i in issues if i["severity"] == "error")
    warnings = sum(1 for i in issues if i["severity"] == "warning")
    sections_present = sum(1 for k in DRAFT_ALL_KEYS if draft.get(k))
    refs_total = 0
    refs_items = 0
    for section in ("needs", "solutions", "risks", "actions"):
        for item in draft.get(section) or []:
            if isinstance(item, dict):
                refs_items += 1
                if item.get("refs"):
                    refs_total += 1
    ref_coverage = refs_total / refs_items if refs_items else 0.0
    analysis = draft.get("analysis") or {}
    analysis_depth = sum(
        1 for k in ANALYSIS_KEYS
        if isinstance(analysis.get(k), str) and len(analysis[k]) >= 20
    ) / len(ANALYSIS_KEYS)
    has_vis = bool(draft.get("visualizations"))
    body_chars = len(draft.get("overview") or "") + sum(
        len(analysis.get(k) or "") for k in ANALYSIS_KEYS)

    components = {
        "structure": 0.3 * (sections_present / len(DRAFT_ALL_KEYS)),
        "ref_coverage": 0.3 * ref_coverage,
        "analysis_depth": 0.2 * analysis_depth,
        "visualization": 0.05 * (1.0 if has_vis else 0.0),
        "issue_penalty": 0.15 * max(
            0.0, 1.0 - errors * 0.5 - warnings * 0.08),
    }
    score = sum(components.values())

    reasons = []
    if errors:
        reasons.append(f"{errors} 个结构性错误")
    if ref_coverage < 0.5 and refs_items:
        reasons.append(f"证据引用覆盖率仅 {ref_coverage:.0%}")
    if analysis_depth < 0.75:
        reasons.append("分析章节深度不足")
    if body_chars < 200:
        reasons.append("正文内容过短")
    if not has_vis:
        reasons.append("缺少可视化图表")

    passed = errors == 0 and score >= cfg["quality_floor"]
    if profile == "release-conservative":
        # conservative releases also require a completed review round and
        # zero invalid-ref warnings (reference profile-adaptive
        # thresholds :25086)
        has_bad_refs = any(i["type"] == "invalid_ref" for i in issues)
        passed = passed and review_rounds_run >= 1 and not has_bad_refs
        if not passed and review_rounds_run < 1:
            reasons.append("release-conservative 要求至少一轮评审")
    soft_pass = errors == 0 and not passed and score >= cfg[
        "quality_floor"] - 0.15
    return {
        "score": round(score, 3),
        "passed": passed,
        "soft_pass": soft_pass,
        "errors": errors,
        "warnings": warnings,
        "ref_coverage": round(ref_coverage, 3),
        "analysis_depth": round(analysis_depth, 3),
        "components": {k: round(v, 3) for k, v in components.items()},
        "reasons": reasons,
        "profile": profile,
    }


# ---------------------------------------------------------------------------
# Markdown render (reference render_report_from_draft_v3 :26152)
# ---------------------------------------------------------------------------

def render_report_markdown(draft: dict, pack: dict, quality: dict) -> str:
    out = [f"# {pack.get('topic') or '需求调研报告'}", ""]
    out.append(f"> 生成时间：{time.strftime('%Y-%m-%d %H:%M')}  "
               f"模式：{pack.get('interview_mode') or 'standard'}  "
               f"质量分：{quality.get('score')}")
    out += ["", "## 一、总体概述", "", draft.get("overview", "")]

    needs = draft.get("needs") or []
    if needs:
        out += ["", "## 二、需求清单", ""]
        for i, n in enumerate(needs, 1):
            refs = "、".join(n.get("refs") or [])
            pr = n.get("priority", "")
            out.append(
                f"{i}. **{n.get('title', '')}**"
                + (f"（{pr}）" if pr else "")
                + f" — {n.get('description', '')}"
                + (f" _(证据: {refs})_" if refs else "")
            )

    analysis = draft.get("analysis") or {}
    out += ["", "## 三、详细分析", ""]
    for key, label in (
        ("customer_needs", "客户需求"),
        ("business_flow", "业务流程"),
        ("tech_constraints", "技术约束"),
        ("project_constraints", "项目约束"),
    ):
        if analysis.get(key):
            out += [f"### {label}", "", analysis[key], ""]

    vis = draft.get("visualizations") or {}
    mermaid_blocks = [
        (vis.get("priority_quadrant_mermaid"), "需求优先级矩阵"),
        (vis.get("business_flow_mermaid"), "业务流程图"),
        (vis.get("demand_pie_mermaid"), "诉求分布"),
        (vis.get("architecture_mermaid"), "架构示意"),
    ]
    if any(b for b, _ in mermaid_blocks):
        out += ["## 四、可视化", ""]
        for block, label in mermaid_blocks:
            if block:
                out += [f"### {label}", "", "```mermaid", block, "```", ""]

    solutions = draft.get("solutions") or []
    if solutions:
        out += ["## 五、方案建议", ""]
        for s in solutions:
            out.append(f"- **{s.get('title', '')}**：{s.get('description', '')}")

    risks = draft.get("risks") or []
    if risks:
        out += ["", "## 六、风险提示", ""]
        for r in risks:
            sev = r.get("severity", "")
            out.append(
                f"- **{r.get('title', '')}**"
                + (f"（{sev}）" if sev else "")
                + f"：{r.get('description', '')}"
            )

    actions = draft.get("actions") or []
    if actions:
        out += ["", "## 七、下一步行动", ""]
        for a in actions:
            owner = a.get("owner", "")
            out.append(
                f"- [ ] {a.get('title', '')}"
                + (f"（负责人：{owner}）" if owner else "")
            )

    open_qs = draft.get("open_questions") or []
    if open_qs:
        out += ["", "## 八、待澄清问题", ""]
        for q in open_qs:
            text = q.get("question") if isinstance(q, dict) else str(q)
            out.append(f"- {text}")

    # Assessment-type scenarios (interview-assessment) append a per-
    # dimension scorecard from the answer quality signals (reference
    # interview-assessment report prompt web/server.py:21044).
    if pack.get("report_type") == "assessment":
        out += ["", "## 评估打分", ""]
        out.append("| 维度 | 答题数 | 平均得分 | 评级 |")
        out.append("|---|---|---|---|")
        by_dim: Dict[str, List[float]] = {}
        for f in pack.get("facts", []):
            if f.get("quality_score") is not None:
                by_dim.setdefault(f.get("dimension") or "其他", []).append(
                    float(f["quality_score"])
                )
        names = pack.get("dimension_names", {})
        total_scores = []
        for dim, scores in by_dim.items():
            avg = sum(scores) / len(scores)
            total_scores.extend(scores)
            grade = ("优秀" if avg >= 0.7 else
                     "良好" if avg >= 0.5 else
                     "待提升" if avg >= 0.3 else "不足")
            out.append(
                f"| {names.get(dim, dim)} | {len(scores)} "
                f"| {avg:.2f} | {grade} |"
            )
        if total_scores:
            overall = sum(total_scores) / len(total_scores)
            rec = ("推荐" if overall >= 0.6 else
                   "待定" if overall >= 0.4 else "不推荐")
            out += ["", f"**综合得分：{overall:.2f} — 结论：{rec}**"]

    ev = draft.get("evidence_index") or []
    if ev:
        out += ["", "## 附录：证据索引", ""]
        for e in ev:
            if isinstance(e, dict):
                out.append(f"- {e.get('q_id', '')}: {e.get('summary', '')}")
            else:
                out.append(f"- {e}")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Simple template last resort (reference :33355)
# ---------------------------------------------------------------------------

def render_simple_template(pack: dict) -> str:
    out = [f"# {pack.get('topic') or '需求调研报告'}（简版）", ""]
    out.append("> 自动降级生成：AI 报告管线不可用，以下为问答实录整理。")
    by_dim: Dict[str, List[dict]] = {}
    for f in pack.get("facts", []):
        by_dim.setdefault(f.get("dimension") or "其他", []).append(f)
    for dim, facts in by_dim.items():
        out += ["", f"## {dim}", ""]
        for f in facts:
            out.append(f"- **{f['question']}**")
            out.append(f"  - 回答：{f.get('answer') or '（未回答）'}")
            if f.get("rationale"):
                out.append(f"  - 补充：{f['rationale']}")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Pipeline driver
# ---------------------------------------------------------------------------

class ReportPipelineResult:
    def __init__(self):
        self.markdown: str = ""
        self.draft: Optional[dict] = None
        self.quality: dict = {}
        self.path: str = "v3"          # v3 | salvage | simple_template
        self.timings: Dict[str, float] = {}
        self.review_rounds_run = 0
        self.draft_attempts = 0
        self.issues: List[dict] = []
        self.repair_notes: List[str] = []


def generate_report_v3(
    gateway, session: dict, *, profile: str = "balanced",
    status_cb=None, metrics=None,
) -> ReportPipelineResult:
    cfg = profile_config(profile)
    res = ReportPipelineResult()
    t0 = time.monotonic()

    def mark(stage):
        res.timings[stage] = round((time.monotonic() - t0) * 1e3, 1)
        if status_cb:
            status_cb(stage)

    pack = build_evidence_pack(session, cfg["facts_limit"])
    mark("evidence_pack")

    # --- draft loop with degrading facts/tokens (reference :558-563) ----
    draft = None
    facts_limit = cfg["facts_limit"]
    for attempt in range(cfg["draft_retries"] + 1):
        res.draft_attempts += 1
        slim_pack = dict(pack)
        slim_pack["facts"] = pack["facts"][:facts_limit]
        prompt = _draft_prompt(slim_pack)
        try:
            text = gateway.call_model(
                prompt, call_type="report_draft",
                context={"topic": pack["topic"], "q_ids": pack["q_ids"],
                         "session_id": pack.get("session_id")},
            )
            draft = parse_structured_json_response(text)
            if draft and all(draft.get(k) for k in DRAFT_REQUIRED_KEYS):
                break
            draft = None
        except Exception:
            draft = None
        facts_limit = max(10, int(facts_limit * 0.6))
    mark("draft")

    if draft is None:
        # salvage -> simple template (reference :32445, :33355)
        res.path = "simple_template"
        res.markdown = render_simple_template(pack)
        res.quality = {"score": 0.2, "passed": False, "soft_pass": True,
                       "profile": profile, "degraded": True}
        mark("render")
        return res

    draft = apply_deterministic_repairs(draft, pack["q_ids"], pack["facts"])
    issues = validate_report_draft(draft, pack["q_ids"], pack["facts"])
    # issue-driven repair catalog (reference :24675): weak binding,
    # demotion, blindspot/unknown backfill, dedup — no model calls
    repair = report_quality.apply_issue_repairs(draft, pack, issues,
                                                profile)
    if repair["changed"]:
        draft = repair["draft"]
        issues = validate_report_draft(draft, pack["q_ids"],
                                       pack["facts"])
    res.repair_notes = repair["notes"]
    mark("validate")

    # --- review rounds (reference review prompt :23243, merge :23423;
    # repair-reprompt on unpatched issues :23307) -------------------------
    for round_no in range(cfg["review_rounds"]):
        try:
            review_text = gateway.call_model(
                _review_prompt(draft, issues), call_type="report_review",
                context={"topic": pack["topic"],
                         "session_id": pack.get("session_id")},
            )
            review = parse_structured_json_response(review_text) or {}
        except Exception:
            break
        res.review_rounds_run += 1
        patch = review.get("patch") or {}
        if isinstance(patch, dict) and patch:
            draft = _merge_patch(draft, patch)
        elif review.get("issues") and not review.get("pass", True):
            # the reviewer flagged problems but sent no patch: repair-
            # reprompt the DRAFT lane with the named issues (ref :23307)
            try:
                fix_text = gateway.call_model(
                    _repair_reprompt(draft, review["issues"]),
                    call_type="report_draft",
                    context={"topic": pack["topic"],
                             "session_id": pack.get("session_id")},
                )
                fixed = parse_structured_json_response(fix_text)
                if fixed and all(fixed.get(k) for k in DRAFT_REQUIRED_KEYS):
                    draft = fixed
            except Exception:
                pass
        draft = apply_deterministic_repairs(draft, pack["q_ids"],
                                            pack["facts"])
        issues = validate_report_draft(draft, pack["q_ids"], pack["facts"])
        if review.get("pass", True):
            break
    if res.review_rounds_run:
        # repairs again over post-review drafts (review patches can
        # reintroduce refless or duplicate items)
        repair = report_quality.apply_issue_repairs(draft, pack, issues,
                                                    profile)
        if repair["changed"]:
            draft = repair["draft"]
            issues = validate_report_draft(draft, pack["q_ids"],
                                           pack["facts"])
            res.repair_notes = res.repair_notes + repair["notes"]
    mark("review")

    def _gate(d, iss):
        quality = quality_gate(d, iss, profile,
                               review_rounds_run=res.review_rounds_run)
        meta = report_quality.compute_quality_meta(
            d, pack, profile, review_issue_count=len(iss))
        gate_issues = report_quality.build_quality_gate_issues(meta)
        soft = report_quality.resolve_soft_pass(gate_issues, meta, profile)
        quality["quality_meta"] = meta
        quality["gate_issues"] = gate_issues
        hard_fail = any(i["severity"] == "high" for i in gate_issues)
        if soft:
            quality["soft_pass"] = True
            quality["soft_pass_kind"] = soft["kind"]
            quality["soft_pass_variant"] = soft["variant"]
        elif hard_fail:
            quality["passed"] = False
        return quality

    res.issues = issues
    res.quality = _gate(draft, issues)
    mark("quality_gate")

    if not (res.quality["passed"] or res.quality["soft_pass"]):
        # real salvage (reference :32445): rebuild the failing sections
        # from the evidence pack, keep whatever passed validation
        res.path = "salvage"
        draft = salvage_draft(draft, pack)
        issues = validate_report_draft(draft, pack["q_ids"], pack["facts"])
        repair = report_quality.apply_issue_repairs(draft, pack, issues,
                                                    profile)
        if repair["changed"]:
            draft = repair["draft"]
            issues = validate_report_draft(draft, pack["q_ids"],
                                           pack["facts"])
        res.issues = issues
        res.quality = _gate(draft, issues)
        res.quality["salvaged"] = True

    res.draft = draft
    res.markdown = render_report_markdown(draft, pack, res.quality)
    mark("render")
    if metrics:
        metrics.record_stages("report_v3", res.timings)
    return res


def _draft_prompt(pack: dict) -> str:
    """Serving-side draft prompt — MUST stay in the training distribution,
    so it renders through the shared canonical builder (prompt_formats.py)
    that build_corpus.py also uses. Reference draft prompt :22430."""
    facts = [
        (f["q_id"], f["question"] or "",
         ((f.get("answer") or "") +
          (f" {f['rationale']}" if f.get("rationale") else "")))
        for f in pack["facts"]
    ]
    return prompt_formats.report_draft_prompt(
        pack["topic"], facts,
        description=pack.get("description", ""),
        documents=[(d["name"], d["summary"])
                   for d in pack.get("documents", []) if d.get("name")],
    )


def _review_prompt(draft: dict, issues: List[dict]) -> str:
    return prompt_formats.report_review_prompt(
        json.dumps(draft, ensure_ascii=False)
        [:prompt_formats.REVIEW_DRAFT_TRUNC], issues)


def _repair_reprompt(draft: dict, issues: list) -> str:
    """Issue-driven re-prompt (reference repair-reprompt :23307)."""
    return prompt_formats.report_repair_prompt(
        json.dumps(draft, ensure_ascii=False)
        [:prompt_formats.REVIEW_DRAFT_TRUNC], issues[:10])


def salvage_draft(draft: dict, pack: dict) -> dict:
    """Rebuild a minimally-valid draft from the failing draft + evidence
    pack (reference salvage :32445): valid parts survive; missing or
    broken sections are synthesized from the facts."""
    facts = pack.get("facts", [])
    out = dict(draft) if isinstance(draft, dict) else {}
    if not isinstance(out.get("overview"), str) or \
            len(out.get("overview") or "") < 30:
        strongest = [f for f in facts
                     if f.get("evidence_class") in ("explicit",
                                                    "rich_option")][:3]
        points = "；".join(
            (f.get("answer") or "")[:60] for f in strongest if f.get("answer")
        )
        out["overview"] = (
            f"本报告基于对「{pack.get('topic', '')}」的 {len(facts)} 轮访谈"
            f"整理（自动修复版）。核心信息：{points or '见需求清单'}。"
        )
    if not out.get("needs"):
        out["needs"] = [
            {"title": (f.get("question") or "")[:40],
             "description": (f.get("answer") or "")[:200],
             "priority": "P1", "refs": [f["q_id"]]}
            for f in facts[:6] if f.get("answer")
        ]
    analysis = out.get("analysis")
    if not isinstance(analysis, dict):
        analysis = out["analysis"] = {}
    by_dim: Dict[str, List[str]] = {}
    for f in facts:
        if f.get("answer"):
            by_dim.setdefault(f.get("dimension") or "其他", []).append(
                f["answer"][:100])
    dim_blob = "；".join(
        f"{dim}: {answers[0]}" for dim, answers in list(by_dim.items())[:4]
    )
    for key in ANALYSIS_KEYS:
        if not analysis.get(key):
            analysis[key] = f"（自动整理）{dim_blob[:300]}"
    return apply_deterministic_repairs(out, pack.get("q_ids", []), facts)


def _merge_patch(draft: dict, patch: dict) -> dict:
    """Shallow-merge review patches (reference patch merge :23423)."""
    for key, value in patch.items():
        if key in ("needs", "solutions", "risks", "actions",
                   "open_questions") and isinstance(value, list):
            draft[key] = value
        elif key == "analysis" and isinstance(value, dict):
            draft.setdefault("analysis", {}).update(value)
        elif key == "visualizations" and isinstance(value, dict):
            draft.setdefault("visualizations", {}).update(value)
        elif isinstance(value, str):
            draft[key] = value
    return draft
