"""Follow-up / saturation / evidence engine + assessment scoring.

Re-implements the reference's follow-up decision stack
(should_follow_up_comprehensive web/server.py:20424, dimension saturation
:18973, user fatigue :19092, answer-depth eval :20655, forced follow-up
:19182, similarity dedupe :20059), the evidence/capture contract
(:19243-21986) and per-answer assessment scoring (score_assessment_answer
:20573).
"""

from __future__ import annotations

import json
import re
from typing import List

from deepvision_tpu_torch.web.runtime.interview import mode_config

# ---------------------------------------------------------------------------
# Answer-depth heuristics (rule layer of the reference's rule+AI decision)
# ---------------------------------------------------------------------------

_VAGUE_MARKERS = ("不知道", "不清楚", "没想好", "随便", "都行", "不确定", "看情况")
_RICH_MARKERS = ("因为", "例如", "比如", "具体来说", "首先", "其次", "目前", "我们")


def evaluate_answer_depth(answer: str, rationale: str = "") -> dict:
    """0-1 depth score from length + structure signals
    (reference answer-depth eval :20655)."""
    text = f"{answer} {rationale}".strip()
    length_score = min(1.0, len(text) / 120.0)
    rich = sum(1 for m in _RICH_MARKERS if m in text)
    vague = sum(1 for m in _VAGUE_MARKERS if m in text)
    structure_score = min(1.0, rich * 0.25)
    penalty = min(0.6, vague * 0.3)
    score = max(0.0, min(1.0, 0.3 * length_score + 0.6 * structure_score
                         + 0.25 - penalty + (0.15 if len(text) > 40 else 0)))
    return {
        "score": round(score, 3),
        "length": len(text),
        "vague_markers": vague,
        "rich_markers": rich,
    }


def classify_evidence(entry: dict) -> str:
    """Evidence-class classifier (reference :21986):
    explicit / rich_option / weak_inferred / pending_follow_up."""
    answer = (entry.get("answer") or "").strip()
    rationale = (entry.get("rationale_text") or "").strip()
    depth = evaluate_answer_depth(answer, rationale)["score"]
    if rationale and depth >= 0.5:
        return "explicit"
    if entry.get("options") and answer and depth >= 0.35:
        return "rich_option"
    if entry.get("is_follow_up") and depth < 0.3:
        return "pending_follow_up"
    return "weak_inferred" if answer else "pending_follow_up"


# ---------------------------------------------------------------------------
# Capture contract (reference :19243)
# ---------------------------------------------------------------------------

def build_capture_contract(dimension: dict, question_number: int,
                           mode: str) -> dict:
    cfg = mode_config(mode)
    # Early questions in a dimension gather breadth (pick_only OK); later
    # ones must capture reasons; deep mode always wants rationale.
    want_rationale = mode == "deep" or question_number >= 2
    intent = "high" if question_number >= cfg["questions_per_dimension"] else (
        "medium" if want_rationale else "low"
    )
    return {
        "answer_mode": "pick_with_reason" if want_rationale else "pick_only",
        "evidence_intent": intent,
    }


# ---------------------------------------------------------------------------
# Saturation / fatigue / follow-up decision
# ---------------------------------------------------------------------------

def dimension_entries(session: dict, dimension_id: str) -> List[dict]:
    return [
        e for e in session.get("interview_log", [])
        if e.get("dimension") == dimension_id
    ]


# ---------------------------------------------------------------------------
# Depth V2 quality tiers (reference INTERVIEW_MODES_V2 web/server.py:18628)
# ---------------------------------------------------------------------------

INTERVIEW_MODES_V2 = {
    # tier thresholds classify each answer high/medium/low; follow-up
    # budgets spend per-tier (weak answers earn more probes); dimensions
    # exit only with the required number of high-tier answers.
    "quick": {
        "tier_thresholds": {"high": 0.55, "medium": 0.3},
        "min_high_answers": 0,
        "follow_up_budget_by_tier": {"low": 1, "medium": 1, "high": 0},
    },
    "standard": {
        "tier_thresholds": {"high": 0.6, "medium": 0.4},
        "min_high_answers": 1,
        "follow_up_budget_by_tier": {"low": 2, "medium": 1, "high": 0},
    },
    "deep": {
        "tier_thresholds": {"high": 0.65, "medium": 0.45},
        "min_high_answers": 2,
        "follow_up_budget_by_tier": {"low": 3, "medium": 2, "high": 1},
    },
}


def v2_enabled(session: dict) -> bool:
    return bool((session.get("depth_v2") or {}).get("enabled"))


def v2_config(mode: str) -> dict:
    return INTERVIEW_MODES_V2.get(mode, INTERVIEW_MODES_V2["standard"])


def answer_quality_tier(score: float, mode: str) -> str:
    th = v2_config(mode)["tier_thresholds"]
    if score >= th["high"]:
        return "high"
    if score >= th["medium"]:
        return "medium"
    return "low"


def dimension_saturation(session: dict, dimension: dict, mode: str) -> dict:
    """Coverage + quality saturation (reference :18973)."""
    cfg = mode_config(mode)
    entries = dimension_entries(session, dimension["id"])
    main_qs = [e for e in entries if not e.get("is_follow_up")]
    scores = [
        e.get("quality_score")
        or evaluate_answer_depth(e.get("answer", ""),
                                 e.get("rationale_text", ""))["score"]
        for e in entries
    ]
    avg_quality = sum(scores) / len(scores) if scores else 0.0
    budget = max(
        dimension.get("min_questions", 2),
        min(dimension.get("max_questions", 4),
            cfg["questions_per_dimension"]),
    )
    saturated = (
        len(main_qs) >= budget
        or (len(main_qs) >= dimension.get("min_questions", 2)
            and avg_quality >= cfg["quality_threshold"] + 0.2)
    )
    out = {
        "asked": len(main_qs),
        "budget": budget,
        "avg_quality": round(avg_quality, 3),
        "saturated": saturated,
    }
    if v2_enabled(session):
        # V2 exit condition: the quality MIX matters, not just the mean
        # (reference V2 quality tiers :18628).  A dimension may exit at
        # the BASE threshold (not v1's +0.2) once its high-tier quota is
        # met; without the quota it keeps asking until the hard budget.
        tiers = [answer_quality_tier(s, mode) for s in scores]
        high_n = tiers.count("high")
        need_high = v2_config(mode)["min_high_answers"]
        out["tiers"] = {t: tiers.count(t)
                        for t in ("high", "medium", "low")}
        out["high_required"] = need_high
        early_ok = (
            len(main_qs) >= dimension.get("min_questions", 2)
            and avg_quality >= cfg["quality_threshold"]
            and high_n >= need_high
        )
        out["saturated"] = len(main_qs) >= budget or early_ok
        if not out["saturated"] and len(main_qs) >= dimension.get(
                "min_questions", 2) and high_n < need_high:
            out["held_for_quality"] = True
    return out


def user_fatigue(session: dict) -> float:
    """Recent-answer fatigue signal (reference :19092): shrinking answers
    and vague markers raise fatigue toward 1."""
    log = session.get("interview_log", [])
    recent = log[-4:]
    if len(recent) < 3:
        return 0.0
    lengths = [len(e.get("answer") or "") for e in recent]
    shrinking = sum(
        1 for a, b in zip(lengths, lengths[1:]) if b < a * 0.7
    )
    vague = sum(
        1 for e in recent
        if any(m in (e.get("answer") or "") for m in _VAGUE_MARKERS)
    )
    return min(1.0, shrinking * 0.25 + vague * 0.3)


def should_follow_up(
    session: dict, dimension: dict, last_entry: dict, mode: str,
    gateway=None,
) -> dict:
    """Combined rule + (optional) AI-scored follow-up decision
    (reference should_follow_up_comprehensive :20424).

    Returns {follow_up: bool, reason, follow_up_round, context}."""
    cfg = mode_config(mode)
    round_no = int(last_entry.get("follow_up_round") or 0)
    max_rounds = cfg["max_follow_up_rounds"]
    if v2_enabled(session):
        # V2: the follow-up budget is spent per answer-quality tier —
        # weak answers earn more probes, strong answers none
        depth0 = evaluate_answer_depth(
            last_entry.get("answer", ""),
            last_entry.get("rationale_text", ""))
        tier = answer_quality_tier(
            last_entry.get("quality_score") or depth0["score"], mode)
        max_rounds = v2_config(mode)["follow_up_budget_by_tier"].get(
            tier, max_rounds)
    if round_no >= max_rounds:
        return {"follow_up": False, "reason": "follow_up_budget_exhausted"}
    if session.get("depth_v2", {}).get("skip_followup_confirm"):
        return {"follow_up": False, "reason": "user_skipped"}
    fatigue = user_fatigue(session)
    if fatigue >= 0.7:
        return {"follow_up": False, "reason": "user_fatigue",
                "fatigue": fatigue}

    depth = evaluate_answer_depth(
        last_entry.get("answer", ""), last_entry.get("rationale_text", "")
    )
    quality = last_entry.get("quality_score") or depth["score"]

    # forced follow-up: explicit vagueness on a high-intent question
    # (reference forced follow-up :19182)
    hard = (
        last_entry.get("evidence_intent") == "high"
        and depth["vague_markers"] > 0
    )
    if hard:
        return {
            "follow_up": True, "reason": "hard_trigger_vague_high_intent",
            "follow_up_round": round_no + 1, "hard_triggered": True,
            "context": "上一个回答在关键问题上不够具体，请追问细节。",
        }
    if quality < cfg["quality_threshold"]:
        # optional AI scoring refinement (assessment lane)
        ai_score = None
        if gateway is not None:
            try:
                from deepvision_tpu_torch.web.runtime import prompt_formats

                text = gateway.call_model(
                    prompt_formats.assessment_prompt(
                        last_entry.get("question") or "",
                        last_entry.get("answer") or ""),
                    call_type="assessment",
                    context={"answer": last_entry.get("answer", "")},
                )
                ai_score = json.loads(text).get("score")
            except Exception:
                ai_score = None
        if ai_score is not None and ai_score >= cfg["quality_threshold"]:
            return {"follow_up": False, "reason": "ai_score_pass",
                    "ai_score": ai_score}
        return {
            "follow_up": True, "reason": "low_answer_quality",
            "follow_up_round": round_no + 1,
            "context": "回答信息量不足，请追问具体场景、数据或原因。",
            "quality": quality, "ai_score": ai_score,
        }
    return {"follow_up": False, "reason": "quality_ok", "quality": quality}


# ---------------------------------------------------------------------------
# Question similarity dedupe (reference :20059)
# ---------------------------------------------------------------------------

def _tokenize(text: str) -> set:
    return set(re.findall(r"[\w一-鿿]{2,}", text))


def question_too_similar(question: str, session: dict,
                         threshold: float = 0.75) -> bool:
    new_tokens = _tokenize(question)
    if not new_tokens:
        return False
    for entry in session.get("interview_log", []):
        old_tokens = _tokenize(entry.get("question") or "")
        if not old_tokens:
            continue
        overlap = len(new_tokens & old_tokens) / len(new_tokens | old_tokens)
        if overlap >= threshold:
            return True
    return False


# ---------------------------------------------------------------------------
# Report readiness (reference :32807-33029)
# ---------------------------------------------------------------------------

def report_readiness(session: dict) -> dict:
    """Pre-generation blockers: pending follow-ups + low-signal dimensions."""
    blockers = []
    log = session.get("interview_log", [])
    pending = [
        e for e in log
        if classify_evidence(e) == "pending_follow_up"
        and e.get("evidence_intent") == "high"
    ]
    if pending:
        blockers.append({
            "type": "pending_follow_ups",
            "count": len(pending),
            "detail": "存在未充分回答的关键问题",
        })
    dims = session.get("dimensions", {})
    low_signal = []
    for dim_id, state in dims.items():
        entries = dimension_entries(session, dim_id)
        if not entries:
            low_signal.append(dim_id)
    if low_signal and log:
        blockers.append({
            "type": "low_signal_dimensions",
            "dimensions": low_signal,
            "detail": "部分维度没有任何问答记录",
        })
    return {
        "ready": not blockers,
        "blockers": blockers,
        "total_answers": len(log),
    }


# ---------------------------------------------------------------------------
# Evidence ledger (reference session evidence ledger web/server.py:19481)
# ---------------------------------------------------------------------------

def build_evidence_ledger(session: dict) -> dict:
    """Per-dimension evidence accounting: class counts, aspect coverage,
    and an overall strength grade the preflight planner and report
    pipeline consume."""
    scenario = session.get("scenario_config") or {}
    dims = {d["id"]: d for d in scenario.get("dimensions", [])}
    ledger: dict = {"dimensions": {}, "totals": {
        "explicit": 0, "rich_option": 0, "weak_inferred": 0,
        "pending_follow_up": 0,
    }}
    for dim_id, dim in dims.items():
        entries = dimension_entries(session, dim_id)
        classes = {"explicit": 0, "rich_option": 0, "weak_inferred": 0,
                   "pending_follow_up": 0}
        text_blob = ""
        for e in entries:
            cls = e.get("evidence_class") or classify_evidence(e)
            classes[cls] = classes.get(cls, 0) + 1
            ledger["totals"][cls] = ledger["totals"].get(cls, 0) + 1
            text_blob += (e.get("question") or "") + (e.get("answer") or "")
        aspects = dim.get("key_aspects") or []
        covered = [a for a in aspects if a in text_blob]
        strong = classes["explicit"] + classes["rich_option"]
        grade = ("strong" if strong >= 2 and not classes["pending_follow_up"]
                 else "adequate" if strong >= 1
                 else "weak" if entries else "empty")
        ledger["dimensions"][dim_id] = {
            "classes": classes,
            "entries": len(entries),
            "aspects_total": len(aspects),
            "aspects_covered": covered,
            "aspects_missing": [a for a in aspects if a not in covered],
            "grade": grade,
        }
    graded = [d["grade"] for d in ledger["dimensions"].values()]
    ledger["overall"] = (
        "strong" if graded and all(g == "strong" for g in graded)
        else "weak" if any(g in ("weak", "empty") for g in graded)
        else "adequate"
    )
    return ledger


# ---------------------------------------------------------------------------
# Preflight planner (reference mid-interview probe planner :19738)
# ---------------------------------------------------------------------------

def plan_preflight_probes(session: dict, *, max_probes: int = 5) -> List[dict]:
    """Plan targeted probes from ledger gaps: uncovered key aspects and
    weak/pending dimensions, ranked so the question engine can steer the
    next questions at the biggest evidence holes."""
    ledger = build_evidence_ledger(session)
    probes: List[dict] = []
    for dim_id, d in ledger["dimensions"].items():
        if d["grade"] == "empty":
            for aspect in d["aspects_missing"][:2] or [""]:
                probes.append({
                    "dimension": dim_id, "aspect": aspect,
                    "reason": "dimension_unvisited", "priority": 0,
                })
        elif d["classes"]["pending_follow_up"]:
            probes.append({
                "dimension": dim_id, "aspect": "",
                "reason": "pending_follow_up", "priority": 1,
            })
        elif d["grade"] == "weak":
            aspect = d["aspects_missing"][0] if d["aspects_missing"] else ""
            probes.append({
                "dimension": dim_id, "aspect": aspect,
                "reason": "weak_evidence", "priority": 2,
            })
        elif d["aspects_missing"]:
            probes.append({
                "dimension": dim_id, "aspect": d["aspects_missing"][0],
                "reason": "aspect_uncovered", "priority": 3,
            })
    probes.sort(key=lambda p: p["priority"])
    return probes[:max_probes]


def next_probe_for_dimension(session: dict, dimension_id: str):
    for probe in plan_preflight_probes(session):
        if probe["dimension"] == dimension_id and probe["aspect"]:
            return probe
    return None


# ---------------------------------------------------------------------------
# Legacy backfill (reference legacy-log backfill :20903)
# ---------------------------------------------------------------------------

def backfill_evidence_annotations(session: dict) -> int:
    """Fill missing evidence annotations on legacy interview-log entries
    (quality_score / evidence_class / answer_mode defaults).  Returns the
    number of entries updated; mutates the session in place."""
    updated = 0
    for e in session.get("interview_log", []):
        changed = False
        if e.get("quality_score") is None:
            e["quality_score"] = evaluate_answer_depth(
                e.get("answer", ""), e.get("rationale_text", ""))["score"]
            changed = True
        if not e.get("evidence_class"):
            e["evidence_class"] = classify_evidence(e)
            changed = True
        if not e.get("answer_mode"):
            e["answer_mode"] = "pick_with_reason" if e.get(
                "rationale_text") else "pick_only"
            changed = True
        if not e.get("evidence_intent"):
            e["evidence_intent"] = "medium"
            changed = True
        if changed:
            updated += 1
    return updated
