"""Solution-page derivation: report snapshot -> structured solution payload.

Re-implements the reference's solution derivation (SURVEY.md §2.3 "Solution
page derivation", build_solution_payload_from_report web/server.py:43275,
payload shape :43078-43114 / Appendix A.5): sidecar snapshots, quality
signals, hero/sections/cards, decision brief, narrative outline, and the
degraded variant when quality signals flag problems.
"""

from __future__ import annotations

import hashlib
import json
import re
import time
from typing import List, Optional

SCHEMA_VERSION = "tpu-1.0"


def _fingerprint(content: str) -> str:
    return hashlib.md5(content.encode("utf-8")).hexdigest()[:16]


def _extract_sections(markdown: str) -> List[dict]:
    sections = []
    current = None
    for line in markdown.splitlines():
        m = re.match(r"^(#{1,3})\s+(.*)", line)
        if m:
            if current:
                sections.append(current)
            current = {
                "id": f"sec-{len(sections) + 1}",
                "level": len(m.group(1)),
                "title": m.group(2).strip(),
                "body_lines": [],
            }
        elif current is not None:
            current["body_lines"].append(line)
    if current:
        sections.append(current)
    out = []
    for s in sections:
        body = "\n".join(s.pop("body_lines")).strip()
        s["body"] = body
        s["render_mode"] = "mermaid" if "```mermaid" in body else "markdown"
        out.append(s)
    return out


def _quality_signals(markdown: str, quality_meta: Optional[dict]) -> dict:
    signals = {
        "length_ok": len(markdown) > 400,
        "has_structure": markdown.count("#") >= 3,
        "has_evidence": "证据" in markdown or "Q1" in markdown,
        "quality_score": (quality_meta or {}).get("score", 0.0),
        "degraded_source": bool((quality_meta or {}).get("degraded")),
    }
    signals["healthy"] = (
        signals["length_ok"] and signals["has_structure"]
        and not signals["degraded_source"]
    )
    return signals


def build_solution_payload(
    report_name: str,
    markdown: str,
    *,
    session: Optional[dict] = None,
    quality_meta: Optional[dict] = None,
) -> dict:
    sections = _extract_sections(markdown)
    title = sections[0]["title"] if sections else (
        session or {}).get("topic", "解决方案")
    signals = _quality_signals(markdown, quality_meta)

    overview = ""
    for s in sections:
        if "概述" in s["title"] or "overview" in s["title"].lower():
            overview = s["body"][:600]
            break
    if not overview and sections:
        overview = sections[0]["body"][:600]

    needs, risks, actions, solutions = [], [], [], []
    for s in sections:
        # only top-level list sections qualify: H3 prose like "客户需求"
        # or mermaid titles would otherwise shadow the real lists
        if s["level"] != 2 or s["render_mode"] != "markdown":
            continue
        items = _bullet_items(s["body"])
        if not items:
            continue
        if "需求" in s["title"] and not needs:
            needs = items
        elif "风险" in s["title"] and not risks:
            risks = items
        elif ("行动" in s["title"] or "下一步" in s["title"]) \
                and not actions:
            actions = items
        elif ("方案" in s["title"] or "建议" in s["title"]) \
                and not solutions:
            solutions = items

    highlights = [n[:60] for n in needs[:3]] or [title]
    metrics = [
        {"label": "访谈轮次", "value": len((session or {}).get(
            "interview_log", []))},
        {"label": "需求条目", "value": len(needs)},
        {"label": "风险条目", "value": len(risks)},
        {"label": "质量分", "value": signals["quality_score"]},
    ]

    headline_cards = [
        {"title": "核心结论", "body": overview[:200], "tone": "primary"},
    ]
    if risks:
        headline_cards.append(
            {"title": "首要风险", "body": risks[0][:160], "tone": "warning"}
        )
    if actions:
        headline_cards.append(
            {"title": "关键行动", "body": actions[0][:160], "tone": "success"}
        )

    nav_items = [
        {"id": s["id"], "title": s["title"]}
        for s in sections if s["level"] <= 2
    ]

    render_sections = [
        {
            "id": s["id"],
            "title": s["title"],
            "level": s["level"],
            "render_mode": s["render_mode"],
            "content": s["body"],
        }
        for s in sections
    ]

    decision_summary = {
        "conclusion": overview[:200],
        "top_needs": needs[:5],
        "top_risks": risks[:3],
        "next_actions": actions[:5],
    }

    payload = {
        "report_name": report_name,
        "title": title,
        "subtitle": (session or {}).get("description", "")[:120],
        "overview": overview,
        "source_mode": "report_snapshot",
        "report_template": "default",
        "report_type": "standard",
        "fingerprint": _fingerprint(markdown),
        "quality_signals": signals,
        "solution_schema_meta": {
            "version": SCHEMA_VERSION,
            "section_count": len(render_sections),
            "render_mode": "sections",
            "snapshot_origin": "derived",
        },
        "hero": {
            "eyebrow": "解决方案",
            "title": title,
            "subtitle": (session or {}).get("topic", ""),
            "summary": overview[:300],
            "highlights": highlights,
            "actions": [{"label": "查看完整报告", "href":
                         f"/api/reports/{report_name}"}],
            "metrics": metrics,
        },
        "headline_cards": headline_cards,
        "metrics": metrics,
        "decision_summary": decision_summary,
        "proposal_brief": {"overview": overview, "needs": needs[:8]},
        "chapter_copy": _derive_chapter_copy(
            title, overview, needs, solutions, actions),
        "proposal_page": _derive_proposal_page(title, overview, sections),
        "proposal_support": _derive_proposal_support(markdown, needs,
                                                     session=session),
        "decision_brief": _derive_decision_brief(
            title, overview, needs, risks, solutions, actions),
        "narrative_outline": _derive_narrative_outline(sections),
        "page_copy": _derive_page_copy(
            title, overview, actions,
            audience=_derive_audience_profile(session, markdown)),
        "proposal_content_model": _derive_content_model(sections),
        "content_priority_plan": _derive_priority_plan(
            needs, risks, actions),
        "closing_block": {
            "title": "下一步",
            "items": actions[:5] or ["确认报告内容", "安排方案评审"],
        },
        "summary_card": {"title": title, "summary": overview[:200]},
        "render_model": {"sections": render_sections},
        "render_model_legacy": None,
        "audience_profile": _derive_audience_profile(session, markdown),
        "comparison_matrix": _derive_comparison_matrix(solutions, risks),
        "value_board": _derive_value_board(needs, solutions),
        "quality_review": quality_meta or {},
        "nav_items": nav_items,
        "sections": render_sections,
        "generated_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    if not signals["healthy"]:
        # degraded variant (reference :43018)
        payload["source_mode"] = "degraded"
        payload["hero"]["eyebrow"] = "解决方案（简版）"
        payload["headline_cards"] = headline_cards[:1]
    return payload


# ---------------------------------------------------------------------------
# Derived proposal content (reference web/server.py:38825-40509 audience
# profile / decision brief / narrative, :42710-42945 schema-driven sections).
# Deterministic derivations from the report snapshot; the AI chapter-copy
# merge (merge_ai_copy) refines chapter_copy/quality_review on top.
# ---------------------------------------------------------------------------

def _first_sentence(text: str, limit: int = 120) -> str:
    for sep in ("。", "；", "\n"):
        idx = text.find(sep)
        if 0 < idx < limit:
            return text[: idx + (1 if sep != "\n" else 0)]
    return text[:limit]


def _derive_chapter_copy(title, overview, needs, solutions, actions) -> dict:
    value = _first_sentence(overview) or f"{title}的结构化解决方案。"
    if needs:
        value += f" 核心诉求：{needs[0][:60]}。"
    approach = (solutions[0][:140] if solutions
                else "分阶段实施：先解决最影响一线效率的环节，再逐步扩展。")
    commitment = ("；".join(a[:60] for a in actions[:2])
                  if actions else "两周内完成方案评审并冻结一期范围。")
    return {
        "value_statement": value[:500],
        "approach": approach[:500],
        "commitment": commitment[:500],
    }


def _derive_proposal_page(title, overview, sections) -> dict:
    chapters = [
        {
            "id": s["id"],
            "title": s["title"],
            "summary": _first_sentence(s["body"], 160),
        }
        for s in sections if s["level"] == 2
    ][:8]
    return {
        "title": f"{title} · 方案建议",
        "pitch": _first_sentence(overview, 160),
        "chapters": chapters,
    }


def _derive_page_copy(title, overview, actions, audience=None) -> dict:
    """Audience-aware page copy (reference audience profile + page copy
    composition web/server.py:38825-40509): decision-oriented readers
    get an approval CTA, implementation-leaning audiences get a
    kickoff CTA."""
    audience = audience or {}
    technical = "技术" in (audience.get("secondary") or "")
    quick = audience.get("reading_depth") == "速览"
    cta = "推进方案评审" if not technical else "安排技术对齐会"
    tagline = _first_sentence(overview, 80) or title
    if quick:
        tagline = f"速览：{tagline}"[:88]
    return {
        "hero_tagline": tagline,
        "cta_label": cta,
        "closing_note": (actions[0][:80] if actions
                         else "与业务方确认优先级后启动一期。"),
        "audience_tone": ("tech_alignment" if technical
                          else "decision_oriented"),
    }


_NARRATIVE_STAGES = (
    (("概述", "总体"), "开场", "用一段话交代结论与依据来源"),
    (("需求",), "诉求", "列出访谈确认的核心诉求与优先级"),
    (("分析",), "论证", "拆解现状、流程与约束，支撑后续方案"),
    (("可视化", "图"), "图景", "用图表呈现优先级与流程全貌"),
    (("方案", "建议"), "方案", "给出可比较、可落地的路径选项"),
    (("风险",), "风险", "暴露主要风险与缓解思路"),
    (("行动", "下一步"), "行动", "收敛为带负责人与时限的行动清单"),
    (("澄清", "问题"), "留白", "明确仍需补采确认的信息缺口"),
    (("附录", "证据"), "溯源", "每个结论都能回到原始问答"),
)


def _derive_narrative_outline(sections) -> list:
    """Narrative beats, not bare titles (reference narrative composition
    :39891-40509): each level-2 section gets its stage in the story arc,
    a reading hook, and a one-line summary from its own content."""
    outline = []
    for s in sections:
        if s["level"] != 2:
            continue
        stage, hook = "章节", ""
        for keywords, st, hk in _NARRATIVE_STAGES:
            if any(k in s["title"] for k in keywords):
                stage, hook = st, hk
                break
        body = s["body"]
        summary = _first_sentence(
            re.sub(r"^\s*(?:[-*]|\d+\.)\s*", "",
                   body.strip().split("\n")[0] if body.strip() else ""),
            90)
        summary = re.sub(r"\*\*([^*]+)\*\*", r"\1", summary)
        outline.append({
            "stage": stage,
            "title": s["title"],
            "hook": hook,
            "summary": summary,
            "anchor": s["id"],
        })
    return outline


def _derive_decision_brief(title, overview, needs, risks, solutions,
                           actions) -> dict:
    """SCQA decision brief (situation -> complication -> resolution ->
    asks) composed from the report's own sections — a one-screen pitch
    distinct from the raw decision_summary lists (reference decision
    brief/narrative v1 web/server.py:39891-40509)."""
    situation = _first_sentence(overview, 140) or \
        f"围绕「{title}」完成了结构化访谈与证据整理。"
    complication = (risks[0][:120] if risks else
                    (needs[0][:120] if needs else
                     "现状流程存在效率与协同缺口。"))
    resolution = (solutions[0][:140] if solutions else
                  "按价值优先级分阶段落地改造方案。")
    asks = [a[:90] for a in actions[:3]] or ["确认一期范围并安排方案评审"]
    return {
        "headline": f"{title}：从证据到行动的决策建议",
        "situation": situation,
        "complication": complication,
        "resolution": resolution,
        "asks": asks,
    }


def _derive_content_model(sections) -> dict:
    chapters = []
    for s in sections:
        if s["level"] > 2:
            continue
        blocks = []
        bullets = _bullet_items(s["body"])
        if bullets:
            blocks.append({"type": "bullets", "items": bullets[:8]})
        prose = "\n".join(
            ln for ln in s["body"].splitlines()
            if ln.strip() and not re.match(r"^\s*(?:[-*]|\d+\.|\|)", ln)
            and not ln.startswith("```")
        ).strip()
        if prose:
            blocks.append({"type": "text", "content": prose[:600]})
        if "```mermaid" in s["body"]:
            blocks.append({"type": "diagram", "format": "mermaid"})
        chapters.append({"id": s["id"], "title": s["title"],
                         "blocks": blocks})
    return {"version": SCHEMA_VERSION, "chapters": chapters}


def _derive_priority_plan(needs, risks, actions) -> dict:
    items = []
    for i, n in enumerate(needs[:8]):
        m = re.search(r"\b(P[0-3])\b", n)
        pr = m.group(1) if m else ("P0" if i == 0 else "P1" if i < 3 else "P2")
        items.append({"content": n[:160], "priority": pr,
                      "kind": "need"})
    for r in risks[:3]:
        items.append({"content": r[:160], "priority": "P1", "kind": "risk"})
    for a in actions[:3]:
        items.append({"content": a[:160], "priority": "P0", "kind": "action"})
    order = {"P0": 0, "P1": 1, "P2": 2, "P3": 3}
    items.sort(key=lambda x: order.get(x["priority"], 9))
    return {"strategy": "value_first", "items": items}


def _derive_proposal_support(markdown: str, needs,
                             session=None) -> dict:
    """Evidence claims + the drawer detail behind each Q-ref: the
    solution page opens an evidence drawer on a reference chip
    (reference solutionBindEvidenceDrawer, web/solution.js), so every
    cited q_id carries its question/answer snippet."""
    q_ids = sorted(set(re.findall(r"\bQ\d{1,3}\b", markdown)),
                   key=lambda q: int(q[1:]))
    evidence = []
    for i, n in enumerate(needs[:6]):
        refs = re.findall(r"\bQ\d{1,3}\b", n) or (
            [q_ids[i % len(q_ids)]] if q_ids else [])
        evidence.append({"claim": re.sub(r"\bQ\d{1,3}\b", "", n)[:140].strip(),
                         "refs": refs})
    detail = {}
    log = (session or {}).get("interview_log") or []
    for i, entry in enumerate(log, 1):
        qid = f"Q{i}"
        if qid not in q_ids:
            continue
        detail[qid] = {
            "question": (entry.get("question") or "")[:160],
            "answer": (entry.get("answer") or "")[:240],
            "rationale": (entry.get("rationale_text") or "")[:160],
            "dimension": entry.get("dimension") or "",
        }
    return {"evidence": evidence, "q_ids": q_ids,
            "evidence_detail": detail}


def _derive_audience_profile(session, markdown: str) -> dict:
    mode = (session or {}).get("interview_mode", "standard")
    tech = any(k in markdown for k in ("架构", "技术栈", "接口", "系统集成"))
    return {
        "primary": "业务决策者",
        "secondary": "技术实施团队" if tech else "实施团队",
        "reading_depth": {"quick": "速览", "deep": "深读"}.get(mode, "标准"),
        "tone": "decision_oriented",
    }


def _derive_comparison_matrix(solutions, risks) -> Optional[dict]:
    options = [{
        "name": "维持现状",
        "scores": {"实施难度": "低", "业务价值": "低",
                   "风险敞口": "持续累积"},
    }]
    if solutions:
        options.append({
            "name": "推荐方案",
            "summary": solutions[0][:120],
            "scores": {"实施难度": "中", "业务价值": "高",
                       "风险敞口": "可控" if risks else "低"},
        })
    if len(solutions) > 1:
        options.append({
            "name": "备选方案",
            "summary": solutions[1][:120],
            "scores": {"实施难度": "高", "业务价值": "中",
                       "风险敞口": "中"},
        })
    return {"criteria": ["实施难度", "业务价值", "风险敞口"],
            "options": options}


_VALUE_BUCKETS = (
    ("效率提升", ("效率", "自动", "时长", "周期", "手工", "提速")),
    ("成本与风险", ("成本", "预算", "风险", "资损", "合规", "库存")),
    ("体验与质量", ("体验", "质量", "稳定", "客户", "满意", "用户")),
)


def _derive_value_board(needs, solutions) -> Optional[dict]:
    columns = [{"title": t, "items": []} for t, _ in _VALUE_BUCKETS]
    pool = (needs or []) + (solutions or [])
    for item in pool[:12]:
        placed = False
        for col, (_, kws) in zip(columns, _VALUE_BUCKETS):
            if any(k in item for k in kws):
                col["items"].append(item[:100])
                placed = True
                break
        if not placed:
            columns[0]["items"].append(item[:100])
    columns = [c for c in columns if c["items"]]
    return {"columns": columns} if columns else None


def _bullet_items(body: str) -> List[str]:
    items = []
    for line in body.splitlines():
        m = re.match(r"^\s*(?:[-*]|\d+\.)\s*(?:\[ \]\s*)?(.+)", line)
        if m:
            text = re.sub(r"\*\*([^*]+)\*\*", r"\1", m.group(1)).strip()
            # inline evidence markers belong to the report view, not the
            # solution page's derived copy
            text = re.sub(r"\s*_\(证据: [^)]*\)_\s*$", "", text)
            if text:
                items.append(text)
    return items


_COPY_SCHEMA_KEYS = {
    "chapter_copy": ("value_statement", "approach", "commitment"),
    "quality_review": ("score", "verdict"),
}


def merge_ai_copy(payload: dict, ai_response: str) -> dict:
    """Schema-validated merge of AI chapter copy + quality review into the
    solution payload (reference schema-validated merge web/server.py:41210):
    malformed or partial AI output never corrupts the payload."""
    import json as _json
    import re as _re

    try:
        m = _re.search(r"\{.*\}", ai_response, _re.S)
        data = _json.loads(m.group(0) if m else ai_response)
    except (ValueError, AttributeError):
        return payload
    if not isinstance(data, dict):
        return payload
    copy = data.get("chapter_copy")
    if isinstance(copy, dict) and all(
        isinstance(copy.get(k), str) and copy.get(k)
        for k in _COPY_SCHEMA_KEYS["chapter_copy"]
    ):
        payload["chapter_copy"] = {
            k: copy[k][:500] for k in _COPY_SCHEMA_KEYS["chapter_copy"]
        }
    review = data.get("quality_review")
    if isinstance(review, dict) and all(
        k in review for k in _COPY_SCHEMA_KEYS["quality_review"]
    ):
        try:
            score = float(review["score"])
        except (TypeError, ValueError):
            return payload
        payload["quality_review"] = {
            "score": max(0.0, min(1.0, score)),
            "verdict": str(review["verdict"])[:40],
            "strengths": [str(s)[:120] for s in
                          (review.get("strengths") or [])[:5]],
            "concerns": [str(s)[:120] for s in
                         (review.get("concerns") or [])[:5]],
        }
    return payload


class SolutionService:
    """Sidecar snapshots + payload cache (reference :35405-36253,
    :35523-35605); optional AI chapter copy + quality review when a
    gateway is provided (reference :41442/:41488)."""

    def __init__(self, meta, reports, sessions, gateway=None):
        self.meta = meta
        self.reports = reports
        self.sessions = sessions
        self.gateway = gateway

    def get_payload(self, report_name: str) -> Optional[dict]:
        content = self.reports.load(report_name)
        if content is None:
            return None
        fp = _fingerprint(content)
        cached_raw = self.meta.kv_get(
            "solution_payload_cache", "report_name", report_name, "payload"
        )
        if cached_raw:
            try:
                cached = json.loads(cached_raw)
                if cached.get("fingerprint") == fp:
                    return cached
            except json.JSONDecodeError:
                pass
        session = None
        row = self.meta.query_one(
            "SELECT session_id FROM report_index WHERE report_name = ?",
            (report_name,),
        )
        if row and row["session_id"]:
            session = self.sessions.load(row["session_id"])
        quality_meta = (session or {}).get("last_report_quality_meta")
        payload = build_solution_payload(
            report_name, content, session=session, quality_meta=quality_meta
        )
        if self.gateway is not None and getattr(
            self.gateway, "mode", "off"
        ) != "off":
            try:
                ai_text = self.gateway.call_model(
                    "请为以下方案页撰写章节文案并做质量评审，输出 JSON："
                    '{"chapter_copy": {"value_statement", "approach", '
                    '"commitment"}, "quality_review": {"score": 0-1, '
                    '"verdict", "strengths": [], "concerns": []}}。\n\n'
                    f"方案概述：{payload.get('overview', '')[:1500]}",
                    call_type="solution_copy",
                    context={"title": payload.get("title", "")},
                )
                payload = merge_ai_copy(payload, ai_text)
            except Exception:
                pass  # AI copy is an enhancement; the payload stands alone
        self.meta.execute(
            "INSERT INTO solution_payload_cache (report_name, payload, "
            "fingerprint, updated_at) VALUES (?, ?, ?, ?) "
            "ON CONFLICT(report_name) DO UPDATE SET "
            "payload = excluded.payload, fingerprint = excluded.fingerprint, "
            "updated_at = excluded.updated_at",
            (report_name, json.dumps(payload, ensure_ascii=False), fp,
             time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())),
        )
        return payload

    def prewarm(self, report_name: str) -> None:
        try:
            self.get_payload(report_name)
        except Exception:
            pass
