"""Report V3 quality machinery: issue-driven deterministic repairs,
measured quality metrics, profile/evidence-adaptive gate thresholds, and
soft-pass resolution.

Re-implements, in this framework's draft schema (items carry `refs`,
`title`, `description`; actions optionally `owner`/`timeline`/`metric`),
the reference's quality subsystem:

- repair catalog `apply_deterministic_report_repairs_v3`
  (/root/reference/web/server.py:24675-25048): not_actionable
  owner/timeline/metric inference, no_evidence weak binding + demotion
  to open_questions, orphan evidence-index pruning, blindspot backfill
  into open_questions/actions/overview/analysis, unknown-ratio follow-up
  backfill, refs cleaning, per-section dedup;
- quality metrics + thresholds (:25050-25140): evidence_coverage,
  consistency, actionability, expression_structure, table_readiness,
  action_acceptance, milestone_coverage, weak-binding ratios;
- profile thresholds `_profile_quality_gate_thresholds_v3` (:25086) and
  evidence-adaptive relaxation `_adapt_quality_gate_thresholds_by_
  evidence_v3` (:25110-25180);
- per-field weak-binding limits `_get_weak_binding_field_limits_v3`
  (:25183);
- gate-issue builder `build_quality_gate_issues_v3` (:25207-25312);
- soft-pass rules `can_release_conservative_soft_pass_v3` /
  `can_balanced_low_evidence_soft_pass_v3` /
  `resolve_quality_gate_soft_pass_v3` (:32110-32299).

Everything here is deterministic rule logic — no model calls — so the
whole catalog is unit-testable one rule at a time
(tests/test_report_quality_rules.py).
"""

from __future__ import annotations

import copy
import re
from typing import Dict, List, Optional, Tuple

CLAIM_SECTIONS = ("needs", "solutions", "risks", "actions",
                  "open_questions", "evidence_index")
BIND_SECTIONS = ("needs", "solutions", "risks", "actions")

# Base thresholds = the strict (quality-profile) bar; balanced relaxes
# the expression/template family (reference REPORT_V3_QUALITY_THRESHOLDS
# :25086 + balanced relaxation :25102-25108).
QUALITY_THRESHOLDS = {
    "evidence_coverage": 0.90,
    "consistency": 0.80,
    "actionability": 0.80,
    "expression_structure": 0.82,
    "table_readiness": 0.78,
    "action_acceptance": 0.75,
    "milestone_coverage": 0.65,
    "max_weak_binding_ratio": 0.35,
}

# Minimum list sizes the style template expects (reference template
# minimums surfaced through style_template_violation :25290-25310).
TEMPLATE_MINIMUMS = {
    "needs": 3, "solutions": 2, "risks": 2, "actions": 2,
    "open_questions": 1,
}

WEAK_BINDING_FLOOR = 0.42          # reference REPORT_V3_WEAK_BINDING_MIN_SCORE
UNKNOWN_RATIO_TRIGGER = 0.45       # reference REPORT_V3_UNKNOWN_RATIO_TRIGGER
UNKNOWN_BACKFILL_MAX = 3           # reference ..._MAX_ITEMS

# Issue families a release-conservative build may soft-pass on: soft
# expression/template gaps only, never evidence/consistency hard gates
# (reference V3_RELEASE_CONSERVATIVE_SOFT_PASS_ISSUE_TYPES).
RELEASE_SOFT_ISSUE_TYPES = {
    "quality_gate_expression", "quality_gate_table",
    "quality_gate_acceptance", "quality_gate_milestone",
    "style_template_violation",
}
BALANCED_SOFT_ISSUE_TYPES = RELEASE_SOFT_ISSUE_TYPES | {
    "quality_gate_evidence",
}


def _safe_ratio(n: float, d: float) -> float:
    return (n / d) if d else 0.0


def _clamp01(x) -> float:
    try:
        return max(0.0, min(1.0, float(x)))
    except (TypeError, ValueError):
        return 0.0


# ---------------------------------------------------------------------------
# Weak evidence binding (reference infer_weak_evidence_refs_v3)
# ---------------------------------------------------------------------------

def _text_tokens(text: str) -> set:
    """Bigram tokens for CJK + word tokens for latin — cheap overlap
    fingerprint that works on mixed Chinese/English interview text."""
    text = (text or "").lower()
    toks = set(re.findall(r"[a-z0-9]{2,}", text))
    han = re.sub(r"[^一-鿿]", "", text)
    toks.update(han[i:i + 2] for i in range(len(han) - 1))
    return toks


def _item_text(item: dict) -> str:
    return " ".join(
        str(item.get(k) or "") for k in
        ("title", "description", "question", "reason", "impact",
         "owner", "metric", "summary", "claim")
    )


def infer_weak_refs(item: dict, facts: List[dict],
                    min_score: float = WEAK_BINDING_FLOOR) -> dict:
    """Best-overlap fact for an unreferenced item. Returns
    {"refs": [q_id], "score": s} or empty refs when nothing clears the
    floor (reference infer_weak_evidence_refs_v3)."""
    item_toks = _text_tokens(_item_text(item))
    if not item_toks:
        return {"refs": [], "score": 0.0}
    best_q, best_s = None, 0.0
    for f in facts or []:
        fact_toks = _text_tokens(
            f"{f.get('question') or ''} {f.get('answer') or ''} "
            f"{f.get('rationale') or ''}")
        if not fact_toks:
            continue
        inter = len(item_toks & fact_toks)
        score = inter / max(1, min(len(item_toks), len(fact_toks)))
        if score > best_s:
            best_q, best_s = f.get("q_id"), score
    if best_q is not None and best_s >= min_score:
        return {"refs": [best_q], "score": round(best_s, 3)}
    return {"refs": [], "score": round(best_s, 3)}


# ---------------------------------------------------------------------------
# Owner / timeline / metric inference (reference
# _infer_action_owner_timeline_metric_v3)
# ---------------------------------------------------------------------------

_ROLE_WORDS = ("负责人", "产品", "技术", "运营", "业务", "实施", "项目",
               "需求方", "供应商", "IT", "数据", "财务", "客服", "安全")
_TIME_RE = re.compile(
    r"(本周|下周|两周内?|本月|下月|月底|季度内?|[一二三四五六七八九十两]+个?"
    r"(?:周|月|季度)内?|年底|\d+\s*(?:天|周|个月)内?)")
_METRIC_RE = re.compile(
    r"([达提]升?[至到]?\s*\d+(?:\.\d+)?\s*(?:%|％)?|"
    r"[\d一二三四五六七八九十两]+(?:\.\d+)?\s*(?:%|％|成|倍|分钟|小时|天)|"
    r"\d+(?:\.\d+)?\s*(?:%|％))")


def infer_owner_timeline_metric(item: dict, pack: dict,
                                dimension_hint: str = "") -> dict:
    """Conservative fills for an action/solution item: extract from the
    item's own text first, then from its cited evidence, then from the
    dimension name; never invent quantified claims — the fallback metric
    is an explicit review placeholder."""
    text = _item_text(item)
    fact_by_id = {f.get("q_id"): f for f in pack.get("facts", [])}
    ref_text = " ".join(
        f"{fact_by_id[r].get('answer') or ''}"
        for r in (item.get("refs") or []) if r in fact_by_id
    )
    blob = f"{text} {ref_text}"

    owner = next((w for w in _ROLE_WORDS if w in blob), "")
    if not owner and dimension_hint:
        owner = f"{dimension_hint}负责人"
    owner = owner or "需求方"

    m = _TIME_RE.search(blob)
    timeline = m.group(1) if m else "两周内"

    m = _METRIC_RE.search(blob)
    metric = (f"达成口径：{m.group(1)}" if m
              else "完成评审并确认验收口径")
    return {"owner": owner, "timeline": timeline, "metric": metric}


# ---------------------------------------------------------------------------
# Blindspot / unknown helpers
# ---------------------------------------------------------------------------

def _sections_corpus(draft: dict, sections: Tuple[str, ...]) -> str:
    parts = []
    for sec in sections:
        for item in draft.get(sec) or []:
            if isinstance(item, dict):
                parts.append(_item_text(item))
            else:
                parts.append(str(item))
    return " ".join(parts).lower()


def _blindspot_open_question(dimension: str, aspect: str) -> dict:
    return {
        "question": f"{dimension or '相关维度'}的「{aspect}」尚未在访谈中覆盖，"
                    f"是否需要补充确认？",
        "reason": f"证据盘点显示关键要点「{aspect}」缺少任何问答支撑",
        "impact": "结论可能遗漏该要点对应的约束或诉求",
        "refs": [],
        "evidence_binding": "pending_follow_up",
    }


def _blindspot_action(dimension: str, aspect: str, pack: dict) -> dict:
    strong = [f.get("q_id") for f in pack.get("facts", [])
              if f.get("evidence_class") in ("explicit", "rich_option")]
    return {
        "title": f"补采「{aspect}」相关事实",
        "description": f"围绕{dimension or '相关维度'}的「{aspect}」安排一次"
                       f"补充访谈，确认现状、约束与量化指标后回填报告。",
        "refs": strong[:2],
        "evidence_binding": "pending_follow_up",
    }


def _demote_to_open_question(section: str, item: dict) -> dict:
    label = {"needs": "需求", "solutions": "方案", "risks": "风险",
             "actions": "行动"}.get(section, section)
    head = (item.get("title") or item.get("question")
            or _item_text(item)[:40] or "该条目")
    return {
        "question": f"{label}「{head}」缺少访谈证据支撑，是否成立？",
        "reason": "草稿中的该结论没有任何可追溯的问答依据",
        "impact": "若直接保留会把未经验证的判断写入正式报告",
        "refs": [],
        "evidence_binding": "pending_follow_up",
    }


# ---------------------------------------------------------------------------
# Repair catalog (reference :24675-25048)
# ---------------------------------------------------------------------------

def apply_issue_repairs(draft: dict, pack: dict, issues: List[dict],
                        profile: str = "balanced") -> dict:
    """Issue-driven deterministic repairs. Returns
    {"draft", "changed", "notes"}; never calls a model. Rule order
    mirrors the reference: actionability fills -> evidence
    binding/demotion -> blindspot backfill -> unknown backfill -> refs
    cleaning -> dedup."""
    if not isinstance(draft, dict):
        return {"draft": {}, "changed": False, "notes": []}
    working = copy.deepcopy(draft)
    notes: List[str] = []
    changed = False
    weak_floor = WEAK_BINDING_FLOOR
    if profile == "quality":
        weak_floor = max(weak_floor, 0.48)   # reference :24700
    issues = [i for i in (issues or []) if isinstance(i, dict)]
    facts = pack.get("facts", [])
    valid_ids = {f.get("q_id") for f in facts}

    def _flag(note):
        nonlocal changed
        changed = True
        notes.append(note)

    # R1: not_actionable -> fill owner/timeline/metric on actions (and
    # solutions when targeted), then try weak binding if still refless.
    for issue in issues:
        if (issue.get("type") or "").lower() != "not_actionable":
            continue
        target = str(issue.get("target") or "")
        sec, idx = _parse_target(target)
        candidates = ([(sec, idx)] if sec in ("actions", "solutions")
                      and idx is not None else
                      [("actions", i)
                       for i in range(len(working.get("actions") or []))])
        for field, index in candidates:
            values = working.get(field)
            if not isinstance(values, list) or index >= len(values):
                continue
            item = values[index]
            if not isinstance(item, dict):
                continue
            missing = [k for k in ("owner", "timeline", "metric")
                       if not str(item.get(k) or "").strip()]
            if missing:
                inferred = infer_owner_timeline_metric(
                    item, pack,
                    dimension_hint=str(issue.get("dimension") or ""))
                for k in missing:
                    item[k] = inferred[k]
                _flag(f"{field}[{index}] 补齐 {'/'.join(missing)}")
            if not item.get("refs"):
                bind = infer_weak_refs(item, facts, min_score=weak_floor)
                if bind["refs"]:
                    item["refs"] = bind["refs"]
                    item["evidence_binding"] = "weak_inferred"
                    item["binding_score"] = bind["score"]
                    _flag(f"{field}[{index}] 弱绑定证据 "
                          f"{','.join(bind['refs'])}")

    # R2/R3: no_evidence -> weak-bind, demote, or prune (evidence_index).
    remove: Dict[str, set] = {s: set() for s in CLAIM_SECTIONS}
    for issue in issues:
        if (issue.get("type") or "").lower() != "no_evidence":
            continue
        sec, idx = _parse_target(str(issue.get("target") or ""))
        if sec not in CLAIM_SECTIONS or idx is None:
            continue
        values = working.get(sec)
        if not isinstance(values, list) or idx >= len(values):
            continue
        item = values[idx]
        if not isinstance(item, dict):
            continue
        refs = [r for r in (item.get("refs") or []) if r in valid_ids]
        if refs:
            continue
        if sec == "evidence_index":
            remove[sec].add(idx)
            _flag(f"移除无证据索引项 evidence_index[{idx}]")
            continue
        bind = infer_weak_refs(item, facts, min_score=weak_floor)
        if bind["refs"]:
            item["refs"] = bind["refs"]
            item["evidence_binding"] = "weak_inferred"
            item["binding_score"] = bind["score"]
            _flag(f"{sec}[{idx}] 弱绑定证据 {','.join(bind['refs'])}")
        elif sec in BIND_SECTIONS:
            oq = working.get("open_questions")
            if not isinstance(oq, list):
                oq = working["open_questions"] = []
            oq.append(_demote_to_open_question(sec, item))
            remove[sec].add(idx)
            _flag(f"{sec}[{idx}] 降级为 open_questions")

    # R4: orphan evidence_index entries — a claim whose q_id no section
    # cites and whose text matches nothing (reference
    # _is_evidence_index_claim_orphan_v3).
    cited = set()
    for sec in BIND_SECTIONS:
        for item in working.get(sec) or []:
            if isinstance(item, dict):
                cited.update(item.get("refs") or [])
    ev_list = working.get("evidence_index")
    if isinstance(ev_list, list):
        for i, entry in enumerate(ev_list):
            if not isinstance(entry, dict):
                continue
            qid = entry.get("q_id")
            if qid and qid not in valid_ids:
                remove["evidence_index"].add(i)
                _flag(f"移除孤立证据索引项 evidence_index[{i}]")

    # R5/R6/R7: blindspot backfill. Aspects come from the pack's
    # blindspots plus any blindspot issues.
    blindspots: List[Tuple[str, str]] = []
    seen_bs = set()
    for bs in pack.get("blindspots") or []:
        key = (str(bs.get("dimension") or ""), str(bs.get("aspect") or ""))
        if key[1] and key not in seen_bs:
            seen_bs.add(key)
            blindspots.append(key)
    for issue in issues:
        if (issue.get("type") or "").lower() != "blindspot":
            continue
        key = (str(issue.get("dimension") or ""),
               str(issue.get("aspect") or ""))
        if key[1] and key not in seen_bs:
            seen_bs.add(key)
            blindspots.append(key)

    bs_targets = {str(i.get("target") or "").lower()
                  for i in issues
                  if (i.get("type") or "").lower() == "blindspot"}
    want_overview_note = any(t.startswith("overview") for t in bs_targets)
    want_action = (profile == "quality") or any(
        "action" in t for t in bs_targets)

    if blindspots:
        oq = working.get("open_questions")
        if not isinstance(oq, list):
            oq = working["open_questions"] = []
        actions = working.get("actions")
        if not isinstance(actions, list):
            actions = working["actions"] = []
        for dimension, aspect in blindspots:
            aspect_l = aspect.lower()
            oq_corpus = _sections_corpus(working, ("open_questions",))
            if aspect_l not in oq_corpus:
                oq.append(_blindspot_open_question(dimension, aspect))
                _flag(f"盲区补齐 open_questions: {aspect}")
            if want_overview_note:
                overview = str(working.get("overview") or "")
                if aspect_l not in overview.lower():
                    working["overview"] = (
                        overview + ("\n\n" if overview else "")
                        + f"【盲区提示】{dimension or '相关维度'}的"
                          f"「{aspect}」未被访谈覆盖，相关结论待补采确认。")
                    _flag(f"overview 标注盲区状态: {aspect}")
            if want_action:
                act_corpus = _sections_corpus(working, ("actions",))
                if aspect_l not in act_corpus:
                    act = _blindspot_action(dimension, aspect, pack)
                    # balanced keeps the bar high: only add a pending
                    # action when it can cite >=2 strong facts and the
                    # session is not blindspot-dominated (reference
                    # refs>=2 && blindspots<=2 for non-quality :24940)
                    ok = (profile == "quality"
                          or (len(act["refs"]) >= 2
                              and len(blindspots) <= 2))
                    if ok:
                        inferred = infer_owner_timeline_metric(
                            act, pack, dimension_hint=dimension)
                        act.update(inferred)
                        actions.append(act)
                        _flag(f"盲区补齐 action: {aspect}")

    # R8: unknown-heavy sessions backfill pending open questions so the
    # information gap is explicit instead of silently concluded over.
    unknowns = [f for f in facts
                if f.get("evidence_class") in ("weak_inferred",
                                               "pending_follow_up")]
    unknown_ratio = _safe_ratio(len(unknowns), len(facts))
    if unknown_ratio >= UNKNOWN_RATIO_TRIGGER and unknowns:
        oq = working.get("open_questions")
        if not isinstance(oq, list):
            oq = working["open_questions"] = []
        oq_corpus = _sections_corpus(working, ("open_questions",))
        added = 0
        for f in unknowns:
            if added >= UNKNOWN_BACKFILL_MAX:
                break
            qid = str(f.get("q_id") or "")
            if not re.fullmatch(r"Q\d+", qid) or qid.lower() in oq_corpus:
                continue
            oq.append({
                "question": f"{f.get('dimension') or '相关维度'}在{qid}的回答"
                            f"信号不足，是否需要补采确认真实约束？",
                "reason": "回答缺少可量化细节，证据等级偏弱",
                "impact": "报告的优先级与行动口径可能偏离实际",
                "refs": [qid],
                "evidence_binding": "pending_follow_up",
            })
            added += 1
            _flag(f"unknown补采 open_questions: {qid}")

    # apply removals
    for sec, idx_set in remove.items():
        if not idx_set:
            continue
        values = working.get(sec)
        if isinstance(values, list):
            working[sec] = [v for i, v in enumerate(values)
                            if i not in idx_set]

    # R9: refs cleaning everywhere (dedupe + drop unknown q_ids)
    for sec in CLAIM_SECTIONS:
        for item in working.get(sec) or []:
            if not isinstance(item, dict):
                continue
            refs = item.get("refs")
            if not refs:
                continue
            cleaned = []
            for r in refs:
                if r in valid_ids and r not in cleaned:
                    cleaned.append(r)
            if cleaned != refs:
                item["refs"] = cleaned
                _flag(f"{sec} 清洗 refs")

    # R10: per-section dedup (reference dedup_rules :25029)
    dedup_keys = {
        "needs": ("title", "description"),
        "solutions": ("title", "description"),
        "risks": ("title", "description"),
        "actions": ("title", "timeline"),
        "open_questions": ("question", "reason"),
        "evidence_index": ("q_id", "claim"),
    }
    for sec, keys in dedup_keys.items():
        values = working.get(sec)
        if not isinstance(values, list):
            continue
        seen, out = set(), []
        for item in values:
            if isinstance(item, dict):
                sig = "|".join(
                    str(item.get(k) or "").strip().lower() for k in keys)
            else:
                sig = str(item).strip().lower()
            if sig and sig in seen:
                continue
            seen.add(sig)
            out.append(item)
        if len(out) != len(values):
            working[sec] = out
            _flag(f"{sec} 去重 {len(values) - len(out)} 项")

    return {"draft": working, "changed": changed, "notes": notes[:30]}


def _parse_target(target: str):
    """'actions[2]' -> ('actions', 2); 'overview' -> ('overview', None)."""
    m = re.fullmatch(r"(\w+)\[(\d+)\]", (target or "").strip())
    if m:
        return m.group(1), int(m.group(2))
    return (target or "").strip() or None, None


# ---------------------------------------------------------------------------
# Quality metrics (reference _collect_claim_entries_for_quality +
# quality scoring feeding the gate)
# ---------------------------------------------------------------------------

def collect_claim_entries(draft: dict) -> List[dict]:
    entries = []
    for sec in CLAIM_SECTIONS:
        for item in draft.get(sec) or []:
            if not isinstance(item, dict):
                continue
            binding = str(item.get("evidence_binding") or "").lower()
            if sec == "open_questions" and binding == "pending_follow_up":
                # pending gaps are not conclusions; they must not drag
                # hard evidence coverage down (reference :25062)
                continue
            refs = [r for r in (item.get("refs") or [])
                    if isinstance(r, str)]
            if sec == "evidence_index" and not refs and item.get("q_id"):
                refs = [str(item["q_id"])]   # index rows self-reference
            entries.append({
                "section": sec,
                "refs": refs,
                "binding": binding,
                "owner": str(item.get("owner") or "").strip(),
                "timeline": str(item.get("timeline") or "").strip(),
                "metric": str(item.get("metric") or "").strip(),
            })
    return entries


def evidence_context(pack: dict) -> dict:
    facts = pack.get("facts", [])
    unknowns = [f for f in facts
                if f.get("evidence_class") in ("weak_inferred",
                                               "pending_follow_up")]
    scores = [float(f["quality_score"]) for f in facts
              if f.get("quality_score") is not None]
    return {
        "facts_count": len(facts),
        "unknown_ratio": round(_safe_ratio(len(unknowns), len(facts)), 3),
        "average_quality_score": round(
            _safe_ratio(sum(scores), len(scores)), 3),
        "blindspots_count": len(pack.get("blindspots") or []),
    }


def compute_quality_meta(draft: dict, pack: dict, profile: str,
                         *, review_issue_count: int = 0) -> dict:
    """Measured quality dimensions over a (repaired) draft. All values
    in [0,1]; keys mirror the reference's quality_meta contract."""
    claims = collect_claim_entries(draft)
    claim_total = len(claims)
    with_refs = [c for c in claims if c["refs"]]
    weak = [c for c in claims if c["binding"] == "weak_inferred"]
    pending = sum(
        1 for item in draft.get("open_questions") or []
        if isinstance(item, dict)
        and str(item.get("evidence_binding") or "") == "pending_follow_up")

    by_field: Dict[str, float] = {}
    for sec in ("actions", "solutions", "risks"):
        sec_claims = [c for c in claims if c["section"] == sec]
        sec_weak = [c for c in sec_claims
                    if c["binding"] == "weak_inferred"]
        by_field[sec] = round(
            _safe_ratio(len(sec_weak), len(sec_claims)), 3)

    actions = [c for c in claims if c["section"] == "actions"]
    act_sol = [c for c in claims if c["section"] in ("actions",
                                                     "solutions")]
    # an action is executable when it cites evidence and carries at
    # least 2 of owner/timeline/metric; a solution when it cites
    # evidence and has a substantive body (the repair catalog fills the
    # action fields, so post-repair drafts clear this honestly)
    actionable_solutions = sum(
        1 for item in draft.get("solutions") or []
        if isinstance(item, dict) and item.get("refs")
        and len(str(item.get("description") or "")) >= 24
    )
    actionable = [
        c for c in actions
        if c["refs"] and sum(bool(c[k]) for k in
                             ("owner", "timeline", "metric")) >= 2
    ]
    actionable_total = len(actionable) + actionable_solutions

    # expression structure: required narrative present + analysis depth
    analysis = draft.get("analysis") if isinstance(
        draft.get("analysis"), dict) else {}
    analysis_keys = ("customer_needs", "business_flow",
                     "tech_constraints", "project_constraints")
    analysis_depth = _safe_ratio(
        sum(1 for k in analysis_keys
            if isinstance(analysis.get(k), str)
            and len(analysis[k]) >= 20),
        len(analysis_keys))
    overview = str(draft.get("overview") or "")
    overview_band = 1.0 if 30 <= len(overview) <= 2400 else (
        0.5 if overview else 0.0)
    sections_present = _safe_ratio(
        sum(1 for s in ("needs", "solutions", "risks", "actions")
            if draft.get(s)), 4)
    expression = (0.4 * overview_band + 0.35 * analysis_depth
                  + 0.25 * sections_present)

    # table readiness: list items carry both a head and a substantive
    # body; actions alternatively qualify by owner+timeline (those two
    # columns are what the action table renders)
    rows = 0
    ready = 0
    for sec in BIND_SECTIONS:
        for item in draft.get(sec) or []:
            if not isinstance(item, dict):
                continue
            rows += 1
            head = str(item.get("title") or item.get("question") or "")
            body = str(item.get("description") or "")
            ok = head.strip() and len(body.strip()) >= 16
            if not ok and sec == "actions":
                ok = bool(head.strip() and item.get("owner")
                          and item.get("timeline"))
            if ok:
                ready += 1

    # consistency: structural contradiction heuristics — duplicated
    # claims and conflicting priorities are what rules can see locally
    dup_penalty = 0.0
    seen_titles = set()
    for item in draft.get("needs") or []:
        t = str((item or {}).get("title") or "").strip() \
            if isinstance(item, dict) else str(item)
        if t and t in seen_titles:
            dup_penalty += 0.15
        seen_titles.add(t)
    consistency = max(0.0, 1.0 - dup_penalty
                      - 0.05 * min(4, review_issue_count))

    list_counts = {s: len(draft.get(s) or []) for s in TEMPLATE_MINIMUMS}

    meta = {
        "runtime_profile": profile,
        "claim_total": claim_total,
        "evidence_coverage": round(
            _safe_ratio(len(with_refs), claim_total), 3),
        "consistency": round(consistency, 3),
        "actionability": round(_safe_ratio(actionable_total,
                                           len(act_sol)), 3)
        if act_sol else 0.0,
        "expression_structure": round(expression, 3),
        "table_readiness": round(_safe_ratio(ready, rows), 3)
        if rows else 0.0,
        "action_acceptance": round(
            _safe_ratio(sum(1 for c in actions if c["metric"]),
                        len(actions)), 3) if actions else 0.0,
        "milestone_coverage": round(
            _safe_ratio(sum(1 for c in actions if c["timeline"]),
                        len(actions)), 3) if actions else 0.0,
        "weak_binding_ratio": round(
            _safe_ratio(len(weak), claim_total), 3),
        "weak_binding_ratio_by_field": by_field,
        "rich_option_count": sum(
            1 for f in pack.get("facts", [])
            if f.get("evidence_class") == "rich_option"),
        "pending_follow_up_count": pending,
        "review_issue_count": review_issue_count,
        "list_counts": list_counts,
        "template_minimums": dict(TEMPLATE_MINIMUMS),
        "evidence_context": evidence_context(pack),
    }
    meta["overall"] = round(
        0.30 * meta["evidence_coverage"] + 0.15 * meta["consistency"]
        + 0.20 * meta["actionability"] + 0.15 * meta["expression_structure"]
        + 0.10 * meta["table_readiness"]
        + 0.10 * meta["milestone_coverage"], 3)
    return meta


# ---------------------------------------------------------------------------
# Thresholds: profile base + evidence-adaptive relaxation
# ---------------------------------------------------------------------------

def profile_thresholds(profile: str) -> dict:
    limits = dict(QUALITY_THRESHOLDS)
    if profile in ("quality", "release-conservative"):
        return limits
    # balanced relaxes the expression/template family so small-sample
    # interviews aren't over-blocked (reference :25102-25108)
    limits["expression_structure"] = min(
        limits["expression_structure"], 0.72)
    limits["table_readiness"] = min(limits["table_readiness"], 0.68)
    limits["action_acceptance"] = min(limits["action_acceptance"], 0.65)
    limits["milestone_coverage"] = min(limits["milestone_coverage"], 0.45)
    limits["max_weak_binding_ratio"] = max(
        limits["max_weak_binding_ratio"], 0.45)
    return limits


def adapt_thresholds_by_evidence(limits: dict, meta: dict) -> dict:
    """Evidence-reliability feedback into the gate (reference
    :25110-25180): sparse/unknown-heavy evidence relaxes soft gates
    (consistency stays rigid); rich-option sessions relax balanced
    evidence_coverage; blindspot-dominated sessions become
    'pending-capture reports' with a much lower evidence bar."""
    adapted = dict(limits)
    ctx = meta.get("evidence_context") or {}
    facts_count = int(ctx.get("facts_count") or 0)
    if facts_count <= 0:
        return adapted
    unknown_ratio = _clamp01(ctx.get("unknown_ratio"))
    avg_quality = _clamp01(ctx.get("average_quality_score"))
    profile = str(meta.get("runtime_profile") or "balanced")
    claim_total = max(0, int(meta.get("claim_total") or 0))
    rich_ratio = _safe_ratio(
        int(meta.get("rich_option_count") or 0), facts_count)
    pending_ratio = _safe_ratio(
        int(meta.get("pending_follow_up_count") or 0), max(1, claim_total))
    weak_ratio = _clamp01(meta.get("weak_binding_ratio"))
    blindspots = int(ctx.get("blindspots_count") or 0)

    tension = 0.0
    if unknown_ratio > 0.60:
        tension += min(0.12, (unknown_ratio - 0.60) * 0.30)
    if avg_quality and avg_quality < 0.32:
        tension += min(0.08, (0.32 - avg_quality) * 0.45)
    tension = min(tension, 0.18)
    if tension > 0.0:
        adapted["evidence_coverage"] = max(
            0.82, adapted["evidence_coverage"] - min(0.06, tension * 0.7))
        for key in ("actionability", "expression_structure",
                    "table_readiness", "action_acceptance",
                    "milestone_coverage"):
            adapted[key] = max(0.45, adapted[key] - tension)
        adapted["max_weak_binding_ratio"] = min(
            0.60, max(adapted["max_weak_binding_ratio"], 0.35 + tension))

    if (profile == "balanced" and rich_ratio >= 0.5
            and weak_ratio <= 0.12 and avg_quality >= 0.5
            and unknown_ratio <= 0.25):
        adapted["evidence_coverage"] = min(
            adapted["evidence_coverage"], 0.78)
    if (profile == "balanced" and rich_ratio >= 0.75
            and weak_ratio <= 0.10 and avg_quality >= 0.55
            and unknown_ratio <= 0.12):
        adapted["evidence_coverage"] = min(
            adapted["evidence_coverage"], 0.73)

    if (profile == "balanced" and blindspots >= 10
            and pending_ratio >= 0.25 and unknown_ratio >= 0.30
            and avg_quality >= 0.40 and weak_ratio <= 0.12):
        adapted["evidence_coverage"] = min(
            adapted["evidence_coverage"], 0.52)
    return adapted


def weak_binding_field_limits(profile: str, meta: dict) -> dict:
    if profile in ("quality", "release-conservative"):
        limits = {"actions": 0.25, "solutions": 0.35, "risks": 0.55}
    else:
        limits = {"actions": 0.35, "solutions": 0.45, "risks": 0.70}
    ctx = meta.get("evidence_context") or {}
    unknown_ratio = _clamp01(ctx.get("unknown_ratio"))
    avg_quality = _clamp01(ctx.get("average_quality_score"))
    if unknown_ratio >= 0.65 or (avg_quality and avg_quality <= 0.32):
        limits["risks"] = min(0.80, limits["risks"] + 0.10)
        limits["solutions"] = min(0.60, limits["solutions"] + 0.05)
        limits["actions"] = min(0.45, limits["actions"] + 0.03)
    return limits


# ---------------------------------------------------------------------------
# Gate-issue builder (reference build_quality_gate_issues_v3 :25207)
# ---------------------------------------------------------------------------

_GATE_CHECKS = (
    ("evidence_coverage", "quality_gate_evidence", "证据覆盖率",
     "needs/solutions/actions/risks/evidence_index"),
    ("consistency", "quality_gate_consistency", "一致性",
     "risks/open_questions"),
    ("actionability", "quality_gate_actionability", "可执行建议占比",
     "solutions/actions"),
    ("expression_structure", "quality_gate_expression", "表达结构完整度",
     "overview/analysis"),
    ("table_readiness", "quality_gate_table", "表格化可读性",
     "needs/solutions/risks/actions"),
    ("action_acceptance", "quality_gate_acceptance", "行动验收口径完备度",
     "actions.metric"),
    ("milestone_coverage", "quality_gate_milestone", "行动里程碑覆盖度",
     "actions.timeline"),
)


def build_quality_gate_issues(meta: dict,
                              thresholds: Optional[dict] = None) -> list:
    if not isinstance(meta, dict):
        return [{"type": "quality_gate_missing", "severity": "high",
                 "message": "缺少质量评分结果，无法通过质量门禁",
                 "target": "quality_meta"}]
    profile = str(meta.get("runtime_profile") or "balanced")
    limits = thresholds or profile_thresholds(profile)
    limits = adapt_thresholds_by_evidence(limits, meta)

    issues = []
    for key, issue_type, label, target in _GATE_CHECKS:
        current = _clamp01(meta.get(key))
        required = _clamp01(limits.get(key))
        if current + 1e-9 < required:
            issues.append({
                "type": issue_type, "severity": "high",
                "message": f"{label}低于门槛（当前{current:.1%}，"
                           f"要求≥{required:.1%}）",
                "target": target,
            })

    # weak binding: per-field limits first, overall ratio as fallback
    field_limits = weak_binding_field_limits(profile, meta)
    by_field = meta.get("weak_binding_ratio_by_field") or {}
    field_names = {"actions": "行动项", "solutions": "方案建议",
                   "risks": "风险项"}
    field_issues = []
    for field, limit in field_limits.items():
        ratio = _clamp01(by_field.get(field))
        if ratio > limit + 1e-9:
            field_issues.append({
                "type": "quality_gate_weak_binding",
                "severity": "high" if profile != "balanced" else "medium",
                "message": f"{field_names.get(field, field)}弱证据绑定占比"
                           f"过高（当前{ratio:.1%}，允许≤{limit:.1%}）",
                "target": field,
            })
    if field_issues:
        issues.extend(field_issues)
    else:
        ratio = _clamp01(meta.get("weak_binding_ratio"))
        limit = _clamp01(limits.get("max_weak_binding_ratio", 0.35))
        if ratio > limit + 1e-9:
            issues.append({
                "type": "quality_gate_weak_binding",
                "severity": "high" if profile != "balanced" else "medium",
                "message": f"弱证据绑定占比过高（当前{ratio:.1%}，"
                           f"允许≤{limit:.1%}）",
                "target": "solutions/risks/actions",
            })

    # style-template minimums
    minimums = meta.get("template_minimums") or {}
    counts = meta.get("list_counts") or {}
    names = {"needs": "核心需求", "solutions": "方案建议", "risks": "风险项",
             "actions": "行动项", "open_questions": "未决问题"}
    deficits = []
    for key, label in names.items():
        required = int(minimums.get(key) or 0)
        current = int(counts.get(key) or 0)
        if required > 0 and current < required:
            deficits.append(f"{label}≥{required}（当前{current}）")
    if deficits:
        issues.append({
            "type": "style_template_violation",
            "severity": "high" if profile != "balanced" else "medium",
            "message": "风格模板未达标：" + "，".join(deficits),
            "target": "needs/solutions/risks/actions/open_questions",
        })
    return issues


# ---------------------------------------------------------------------------
# Soft-pass rules (reference :32110-32299)
# ---------------------------------------------------------------------------

def _issue_types(issues: list) -> List[str]:
    out = []
    for i in issues or []:
        t = str((i or {}).get("type") or "").strip()
        if t and t not in out:
            out.append(t)
    return out


def can_release_conservative_soft_pass(gate_issues: list,
                                       meta: dict) -> bool:
    """Release-conservative builds may ship past SOFT expression/template
    gaps only — never past evidence/consistency — and only with solid
    floors underneath (reference :32110-32131)."""
    types = _issue_types(gate_issues)
    if not types or len(types) > 4:
        return False
    if not all(t in RELEASE_SOFT_ISSUE_TYPES for t in types):
        return False
    if not isinstance(meta, dict):
        return False
    if _clamp01(meta.get("evidence_coverage")) < 0.45:
        return False
    if _clamp01(meta.get("actionability")) < 0.35:
        return False
    if _clamp01(meta.get("table_readiness")) < 0.40:
        return False
    return True


def can_balanced_low_evidence_soft_pass(gate_issues: list,
                                        meta: dict) -> bool:
    """balanced may conservatively ship low-evidence-but-fact-backed
    reports (reference :32136-32260). Three shapes qualify:
    multi-fact sparse, multi-fact with light weak binding, and
    single-fact high-signal."""
    if not isinstance(meta, dict):
        return False
    if str(meta.get("runtime_profile") or "") != "balanced":
        return False
    types = _issue_types(gate_issues)
    if not types or len(gate_issues or []) > 5:
        return False
    weak_present = "quality_gate_weak_binding" in types
    allowed = set(BALANCED_SOFT_ISSUE_TYPES)
    if weak_present:
        allowed.add("quality_gate_weak_binding")
    if not all(t in allowed for t in types):
        return False

    ctx = meta.get("evidence_context") or {}
    facts_count = int(ctx.get("facts_count") or 0)
    unknown_ratio = _clamp01(ctx.get("unknown_ratio"))
    avg_quality = _clamp01(ctx.get("average_quality_score"))
    blindspots = int(ctx.get("blindspots_count") or 0)
    by_field = meta.get("weak_binding_ratio_by_field") or {}
    review_issues = int(meta.get("review_issue_count") or 0)
    pending = int(meta.get("pending_follow_up_count") or 0)

    if _clamp01(meta.get("overall")) < 0.45:
        return False
    if _clamp01(meta.get("consistency")) < 0.95:
        return False
    if _clamp01(meta.get("actionability")) < 0.35:
        return False
    if _clamp01(meta.get("table_readiness")) < 0.40:
        return False
    if review_issues > 8:
        return False

    if facts_count >= 2:
        if weak_present:
            # the stricter multi-fact + weak-binding variant
            if "quality_gate_evidence" not in types:
                return False
            if facts_count < 3:
                return False
            if _clamp01(meta.get("evidence_coverage")) < 0.78:
                return False
            if _clamp01(meta.get("overall")) < 0.52:
                return False
            if _clamp01(meta.get("actionability")) < 0.45:
                return False
            if _clamp01(meta.get("table_readiness")) < 0.50:
                return False
            if _clamp01(meta.get("weak_binding_ratio")) > 0.22:
                return False
            if _clamp01(by_field.get("actions")) > 0.50:
                return False
            if _clamp01(by_field.get("solutions")) > 0.20:
                return False
            if _clamp01(by_field.get("risks")) > 0.30:
                return False
            if pending > 0:
                return False
            if blindspots < 8:
                return False
            if unknown_ratio > 0.10:
                return False
            if avg_quality < 0.60:
                return False
            if review_issues > 4:
                return False
        elif (blindspots < 8 and pending < 1
                and "quality_gate_evidence" not in types):
            # multi-fact sparse needs a genuine evidence gap to explain
            return False
        return True

    # single-fact high-signal: explicit evidence, near-zero unknowns
    if facts_count != 1:
        return False
    if "quality_gate_evidence" not in types:
        return False
    if _clamp01(meta.get("evidence_coverage")) < 0.75:
        return False
    if _clamp01(meta.get("weak_binding_ratio")) > 0.05:
        return False
    if pending > 0:
        return False
    if blindspots < 10:
        return False
    if unknown_ratio > 0.10:
        return False
    if avg_quality < 0.55:
        return False
    if review_issues > 6:
        return False
    return True


def resolve_soft_pass(gate_issues: list, meta: dict,
                      profile: str) -> Optional[dict]:
    """Unified soft-pass decision (reference
    resolve_quality_gate_soft_pass_v3 :32268-32299). Returns None, or
    {"kind", "variant", "issue_types"}."""
    if not isinstance(meta, dict):
        return None
    types = _issue_types(gate_issues)
    if (profile == "release-conservative"
            and can_release_conservative_soft_pass(gate_issues, meta)):
        return {"kind": "release_conservative_soft_pass",
                "variant": "soft_expression_only",
                "issue_types": types}
    if can_balanced_low_evidence_soft_pass(gate_issues, meta):
        facts_count = int(
            (meta.get("evidence_context") or {}).get("facts_count") or 0)
        if facts_count == 1:
            variant = "single_fact_high_signal"
        elif "quality_gate_weak_binding" in types:
            variant = "multi_fact_light_weak_binding"
        else:
            variant = "multi_fact_sparse"
        return {"kind": "balanced_low_evidence_soft_pass",
                "variant": variant, "issue_types": types}
    return None
