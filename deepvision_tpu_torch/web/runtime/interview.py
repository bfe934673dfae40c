"""Interview runtime: modes, prompt building, tiered generation, parsing.

Re-implements the reference interview engine
(web/server_modules/interview_runtime.py + in-server logic):

* interview modes with question/follow-up budgets (INTERVIEW_MODES
  web/server.py:18597, V2 :18628)
* prompt builder with doc budget + sliding-window history
  (build_interview_prompt interview_runtime.py:38, window config
  web/config.py:71-83)
* tiered fast->full strategy (generate_question_with_tiered_strategy
  interview_runtime.py:1474); hedged duplicate lanes become engine
  scheduler priorities (SURVEY.md §5.8)
* 5-strategy JSON parsing + normalization (parse_question_response
  web/server.py:28831-29024, normalize :29110-29169)
* rule-based fallback question (:30582)
"""

from __future__ import annotations

import json
import re
import time
from typing import Dict, List, Optional, Tuple

INTERVIEW_MODES = {
    "quick": {
        "label": "快速模式",
        "questions_per_dimension": 2,
        "max_follow_up_rounds": 1,
        "quality_threshold": 0.35,
    },
    "standard": {
        "label": "标准模式",
        "questions_per_dimension": 3,
        "max_follow_up_rounds": 2,
        "quality_threshold": 0.5,
    },
    "deep": {
        "label": "深度模式",
        "questions_per_dimension": 4,
        "max_follow_up_rounds": 3,
        "quality_threshold": 0.65,
    },
}


def mode_config(mode: str) -> dict:
    return INTERVIEW_MODES.get(mode, INTERVIEW_MODES["standard"])


# ---------------------------------------------------------------------------
# Prompt building
# ---------------------------------------------------------------------------

def build_history_window(
    interview_log: List[dict], window: int = 5,
    summary: str = "", summary_threshold: int = 8,
) -> Tuple[str, bool]:
    """Sliding window of recent Q/A + flag whether a summary refresh is due
    (reference CONTEXT_WINDOW_SIZE / SUMMARY_THRESHOLD web/config.py:71,73)."""
    recent = interview_log[-window:]
    lines = []
    for i, entry in enumerate(recent):
        q = (entry.get("question") or "").strip()
        a = (entry.get("answer") or "").strip()
        lines.append(f"问：{q}\n答：{a}")
    needs_summary = len(interview_log) >= summary_threshold
    text = ""
    if summary:
        text += f"【历史摘要】{summary}\n"
    text += "\n".join(lines)
    return text, needs_summary


def build_doc_context(
    reference_materials: List[dict], *, max_doc_chars: int = 1800,
    max_total_chars: int = 5000,
) -> str:
    """Doc budget (reference MAX_DOC_LENGTH/MAX_TOTAL_DOCS
    web/config.py:75,77): prefer AI summaries, truncate to budgets."""
    parts = []
    total = 0
    for doc in reference_materials:
        body = (doc.get("summary") or doc.get("content") or "")[:max_doc_chars]
        if not body:
            continue
        chunk = f"【参考文档：{doc.get('name', '未命名')}】\n{body}"
        if total + len(chunk) > max_total_chars:
            chunk = chunk[: max(0, max_total_chars - total)]
        parts.append(chunk)
        total += len(chunk)
        if total >= max_total_chars:
            break
    return "\n\n".join(parts)


def build_interview_prompt(
    session: dict,
    dimension: dict,
    *,
    is_follow_up: bool = False,
    follow_up_context: str = "",
    search_context: str = "",
    capture_contract: Optional[dict] = None,
    fast_tier: bool = False,
    prompt_budget: int = 0,
    focus_aspect: str = "",
) -> str:
    topic = session.get("topic", "")
    desc = session.get("description", "")
    history, _ = build_history_window(
        session.get("interview_log", []),
        summary=session.get("summary", ""),
    )
    docs = "" if fast_tier else build_doc_context(
        session.get("reference_materials", [])
    )
    aspects = "、".join(dimension.get("key_aspects", []))
    contract = capture_contract or {}

    # Stable-first section order: [preamble, topic, desc, docs, dimension,
    # search, history, ...ask].  Everything that is constant for the life
    # of a session (and across a dimension's rounds) comes FIRST so
    # consecutive next-question prompts share a long page-aligned head and
    # the engine's radix prefix cache skips its KV recompute (round-3
    # measured the old history-before-docs order capping reuse at ~1 page;
    # reference prompt cache web/server.py:4920-5012 cached per-session
    # prompt TEXT — here the cached artifact is device KV, so section
    # stability directly buys prefill time).  Retraining note: the
    # from-scratch checkpoints are distribution-locked to this order; the
    # corpus builder renders through THIS function, so any reorder must
    # ship with a checkpoint retrain (round-4 did).
    parts = [
        "你是一名资深需求访谈顾问，正在进行结构化访谈。",
        f"访谈主题：{topic}",
    ]
    if desc and not fast_tier:
        parts.append(f"主题说明：{desc}")
    if docs:
        parts.append(docs)
    parts.append(
        f"当前维度：{dimension.get('name')}（关注要点：{aspects}）"
    )
    if search_context:
        parts.append(f"【联网检索结果】\n{search_context}")
    if history:
        parts.append(f"历史问答：\n{history}")
    if is_follow_up:
        parts.append(f"请针对上一个回答进行追问。追问背景：{follow_up_context}")
    if focus_aspect:
        # preflight planner steering: aim at the uncovered aspect
        parts.append(f"本轮请优先覆盖尚未谈到的要点：{focus_aspect}")
    if contract:
        # contract rides BEFORE the schema spec so the prompt always ends
        # with the output-format instruction (the strongest conditioning
        # position for the local model; training examples end the same way)
        parts.append(
            f"采集要求：answer_mode={contract.get('answer_mode')}, "
            f"evidence_intent={contract.get('evidence_intent')}"
        )
    parts.append(
        "请生成下一个访谈问题，输出 JSON："
        '{"question": "问题文本(≤240字)", "options": ["选项1", ...2-6项], '
        '"multi_select": bool, "is_follow_up": %s, '
        '"answer_mode": "pick_only|pick_with_reason", '
        '"requires_rationale": bool, "evidence_intent": "low|medium|high", '
        '"ai_recommendation": "推荐选项或null"}'
        % ("true" if is_follow_up else "false")
    )
    prompt = "\n\n".join(parts)
    if prompt_budget and len(prompt) > prompt_budget:
        # Fast tier clamps the prompt to its budget (reference
        # QUESTION_FAST_PROMPT_BUDGET web/config.py:109).
        prompt = prompt[:prompt_budget]
    return prompt


# ---------------------------------------------------------------------------
# Response parsing: 5 escalating strategies (reference :28831-29024)
# ---------------------------------------------------------------------------

def parse_question_response(text: str) -> Optional[dict]:
    if not text:
        return None
    candidates = []
    # 1. whole body
    candidates.append(text.strip())
    # 2. fenced block
    fence = re.search(r"```(?:json)?\s*(.+?)```", text, re.S)
    if fence:
        candidates.append(fence.group(1).strip())
    # 3. first {...} span
    brace = re.search(r"\{.*\}", text, re.S)
    if brace:
        candidates.append(brace.group(0))
    # 4. repaired: trailing commas, single quotes
    if brace:
        repaired = re.sub(r",\s*([}\]])", r"\1", brace.group(0))
        repaired = repaired.replace("'", '"')
        candidates.append(repaired)
    for cand in candidates:
        try:
            data = json.loads(cand)
            if isinstance(data, dict) and data.get("question"):
                return data
        except json.JSONDecodeError:
            continue
    # 5. plain-text fallback: first question-looking line becomes the
    #    question with generic options.
    for line in text.splitlines():
        line = line.strip().lstrip("-*0123456789.、 ")
        if len(line) >= 6 and ("？" in line or "?" in line):
            return {"question": line[:240], "options": []}
    return None


DEFAULT_OPTIONS = ["是，已有明确结论", "部分明确，仍在讨论", "尚未开始考虑", "其他（请说明）"]


def normalize_generated_question_result(
    data: dict, *, is_follow_up: bool = False,
) -> dict:
    """Normalize to the API contract (reference
    normalize_generated_question_result web/server.py:29110-29169)."""
    question = str(data.get("question", "")).strip()[:240]
    options = [
        str(o).strip()[:80] for o in (data.get("options") or []) if str(o).strip()
    ]
    if len(options) < 2:
        options = list(DEFAULT_OPTIONS)
    options = options[:6]
    answer_mode = data.get("answer_mode")
    if answer_mode not in ("pick_only", "pick_with_reason"):
        answer_mode = "pick_with_reason"
    evidence_intent = data.get("evidence_intent")
    if evidence_intent not in ("low", "medium", "high"):
        evidence_intent = "medium"
    multi = bool(data.get("multi_select"))
    rec = data.get("ai_recommendation")
    if rec is not None:
        rec = str(rec).strip()[:80] or None
        if rec not in options:
            rec = None
    return {
        "question": question,
        "options": options,
        "multi_select": multi,
        "question_multi_select": multi,
        "is_follow_up": bool(data.get("is_follow_up", is_follow_up)),
        "answer_mode": answer_mode,
        "requires_rationale": bool(
            data.get("requires_rationale", answer_mode == "pick_with_reason")
        ),
        "evidence_intent": evidence_intent,
        "ai_recommendation": rec,
    }


def is_question_acceptable(result: dict) -> bool:
    """Visible-question quality gate (reference :20297)."""
    q = result.get("question", "")
    if len(q) < 5:
        return False
    if len(result.get("options", [])) < 2:
        return False
    return True


# ---------------------------------------------------------------------------
# Fallback question (reference :30582)
# ---------------------------------------------------------------------------

def build_fallback_question(dimension: dict, round_no: int = 0) -> dict:
    aspects = dimension.get("key_aspects") or [dimension.get("name", "核心需求")]
    aspect = aspects[round_no % len(aspects)]
    return normalize_generated_question_result({
        "question": f"关于{dimension.get('name')}，请重点谈谈{aspect}方面的"
                    "现状与期望。",
        "options": DEFAULT_OPTIONS,
        "answer_mode": "pick_with_reason",
        "evidence_intent": "medium",
    })


# ---------------------------------------------------------------------------
# Tiered strategy (reference interview_runtime.py:1474)
# ---------------------------------------------------------------------------

class TieredQuestionGenerator:
    """fast tier (short prompt, tight budget) -> full tier -> fallback.

    The reference raced two remote lanes with a hedge delay
    (interview_runtime.py:1284); with a local engine the second "lane" is
    the full-tier retry on the same scheduler, so no duplicate compute."""

    def __init__(self, gateway, metrics=None, *, fast_timeout: float = 8.0,
                 fast_max_tokens: int = 900, fast_prompt_budget: int = 2200):
        self.gateway = gateway
        self.metrics = metrics
        self.fast_timeout = fast_timeout
        self.fast_max_tokens = fast_max_tokens
        self.fast_prompt_budget = fast_prompt_budget
        # adaptive fast-path gate (reference hit-rate gate :29388-29517)
        self._fast_attempts = 0
        self._fast_successes = 0
        # percentile-based deadline (reference adaptive hedge trigger
        # _resolve_question_hedge_trigger_delay interview_runtime.py:
        # 1049-1283 — there it delays a duplicate request; with a local
        # scheduler the same signal tightens the fast-tier deadline so a
        # struggling engine fails over to the full tier sooner)
        self._fast_latencies: List[float] = []

    def fast_path_enabled(self) -> bool:
        if self._fast_attempts < 8:
            return True
        return (self._fast_successes / self._fast_attempts) >= 0.4

    def effective_fast_timeout(self) -> float:
        """p90 of recent successful fast-tier latencies x 1.5, clamped to
        [2s, configured] — adaptive percentile-based deadline."""
        lats = self._fast_latencies[-50:]
        if len(lats) < 8:
            return self.fast_timeout
        p90 = sorted(lats)[int(0.9 * (len(lats) - 1))]
        return max(2.0, min(self.fast_timeout, p90 * 1.5))

    def _record_fast_latency(self, seconds: float) -> None:
        self._fast_latencies.append(seconds)
        if len(self._fast_latencies) > 200:
            del self._fast_latencies[:100]

    def generate(
        self, session: dict, dimension: dict, *, is_follow_up: bool = False,
        follow_up_context: str = "", capture_contract: Optional[dict] = None,
        search_context: str = "", focus_aspect: str = "",
    ) -> Tuple[dict, dict]:
        """Returns (normalized_question, meta)."""
        context = {
            "session_id": session.get("session_id"),
            "dimension": dimension.get("id"),
            "dimension_name": dimension.get("name"),
            "key_aspects": dimension.get("key_aspects", []),
            "question_number": len(session.get("interview_log", [])) + 1,
            "is_follow_up": is_follow_up,
            "topic": session.get("topic", ""),
        }
        attempts = 0
        meta: Dict = {"tier_used": None, "selected_lane": None,
                      "hedge_triggered": False, "fallback_triggered": False,
                      "dedupe_resampled": False}

        def _too_similar(result: dict) -> bool:
            """Serving-side similarity dedupe (reference question-similarity
            gate web/server.py:20059): reject a draw that token-overlaps
            ≥0.75 with any question already asked this session.  The caller
            resamples ONCE (stochastic decoding gives a fresh draw); a
            second similar draw is accepted — a near-duplicate beats the
            rule fallback."""
            from deepvision_tpu_torch.web.runtime.followup import (
                question_too_similar,
            )

            return question_too_similar(result.get("question") or "",
                                        session)

        # --- fast tier ---
        if self.fast_path_enabled() and not is_follow_up:
            attempts += 1
            self._fast_attempts += 1
            prompt = build_interview_prompt(
                session, dimension, is_follow_up=is_follow_up,
                capture_contract=capture_contract, fast_tier=True,
                prompt_budget=self.fast_prompt_budget,
                search_context=search_context,
                focus_aspect=focus_aspect,
            )
            try:
                import time as _time

                t0 = _time.monotonic()
                for draw in (0, 1):
                    text, call_meta = self.gateway.call_model(
                        prompt, call_type="question_fast",
                        timeout=self.effective_fast_timeout(),
                        max_tokens=self.fast_max_tokens,
                        context=context, return_meta=True,
                    )
                    parsed = parse_question_response(text)
                    if not parsed:
                        break
                    result = normalize_generated_question_result(
                        parsed, is_follow_up=is_follow_up
                    )
                    if not is_question_acceptable(result):
                        break
                    if draw == 0 and _too_similar(result):
                        meta["dedupe_resampled"] = True
                        continue
                    self._fast_successes += 1
                    self._record_fast_latency(_time.monotonic() - t0)
                    meta.update(
                        tier_used="fast",
                        selected_lane=call_meta.get("lane"),
                        attempts=attempts,
                    )
                    return result, meta
            except Exception:
                pass

        # --- full tier ---
        attempts += 1
        prompt = build_interview_prompt(
            session, dimension, is_follow_up=is_follow_up,
            follow_up_context=follow_up_context,
            capture_contract=capture_contract,
            search_context=search_context,
            focus_aspect=focus_aspect,
        )
        call_type = "question_deep" if is_follow_up else "question"
        try:
            for draw in (0, 1):
                text, call_meta = self.gateway.call_model(
                    prompt, call_type=call_type, context=context,
                    return_meta=True,
                )
                parsed = parse_question_response(text)
                if not parsed:
                    break
                result = normalize_generated_question_result(
                    parsed, is_follow_up=is_follow_up
                )
                if not is_question_acceptable(result):
                    break
                if draw == 0 and not is_follow_up and _too_similar(result):
                    # follow-ups legitimately overlap their parent
                    # question's wording — only first-pass questions
                    # dedupe against the session history
                    meta["dedupe_resampled"] = True
                    continue
                meta.update(
                    tier_used="full",
                    selected_lane=call_meta.get("lane"),
                    attempts=attempts,
                    # the full tier rescued a request the fast tier
                    # already burned an attempt on — the local
                    # analogue of the reference's hedge lane winning
                    # the race (interview_runtime.py:1284)
                    hedge_triggered=attempts > 1,
                )
                return result, meta
        except Exception:
            pass

        # --- rule-based fallback ---
        meta.update(
            tier_used="fallback", fallback_triggered=True, attempts=attempts + 1
        )
        round_no = len(session.get("interview_log", []))
        result = build_fallback_question(dimension, round_no)
        result["is_follow_up"] = is_follow_up
        return result, meta


# ---------------------------------------------------------------------------
# Question result cache (reference :4851-4919) + prefetch (:13868-14404)
# ---------------------------------------------------------------------------

class QuestionCache:
    def __init__(self, max_entries: int = 256):
        self._data: Dict[str, tuple] = {}
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(session_id: str, dimension_id: str, signature: Optional[str]):
        return f"{session_id}:{dimension_id}:{signature}"

    def get(self, key: str) -> Optional[dict]:
        entry = self._data.get(key)
        if entry:
            self.hits += 1
            return entry[1]
        self.misses += 1
        return None

    def put(self, key: str, value: dict) -> None:
        if len(self._data) >= self.max_entries:
            oldest = min(self._data.items(), key=lambda kv: kv[1][0])[0]
            self._data.pop(oldest, None)
        self._data[key] = (time.time(), value)

    def invalidate_session(self, session_id: str) -> None:
        for k in [k for k in self._data if k.startswith(session_id + ":")]:
            self._data.pop(k, None)
