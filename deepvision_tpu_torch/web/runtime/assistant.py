"""Interview assistant chat: in-interview helper with suggestion mapping.

Re-implements the reference assistant (interview_assistant_chat.py:588/236/
414): context assembly from recent Q/A + doc chunks, per-session chat
memory, intent classification (process questions answered from interview
state without burning a model call), suggested-answer extraction mapped
back onto the current question's options, and a drafted rationale for
pick_with_reason questions.
"""

from __future__ import annotations

import re
from typing import List, Optional

from deepvision_tpu_torch.web.runtime.documents import select_chunks_for_query
from deepvision_tpu_torch.web.runtime.followup import dimension_saturation

MAX_CHAT_LOG = 20


def build_chat_context(session: dict, user_message: str,
                       max_history: int = 5, embed_fn=None) -> str:
    parts = [f"访谈主题：{session.get('topic', '')}"]
    log = session.get("interview_log", [])
    if log:
        recent = log[-max_history:]
        parts.append("最近问答：")
        for e in recent:
            parts.append(f"问：{e.get('question')}\n答：{e.get('answer')}")
    chat_log = session.get("assistant_chat_log") or []
    if chat_log:
        parts.append("助手对话历史：")
        for turn in chat_log[-4:]:
            parts.append(f"用户：{turn.get('user')}\n助手：{turn.get('reply')}")
    chunks: List[str] = []
    for doc in session.get("reference_materials", []):
        chunks.extend(doc.get("chunks") or [])
    if chunks:
        relevant = select_chunks_for_query(chunks, user_message, top_k=2,
                                           embed_fn=embed_fn)
        if relevant:
            parts.append("相关文档片段：\n" + "\n---\n".join(relevant))
    return "\n\n".join(parts)


# ---------------------------------------------------------------------------
# Intent classification (reference intent branches :236)
# ---------------------------------------------------------------------------

_PROCESS_MARKERS = ("还要多久", "还有几个问题", "什么时候结束", "进度",
                    "还要答多少", "能跳过", "跳过吗")
_OPTION_MARKERS = ("选哪个", "怎么选", "哪个选项", "选项什么意思", "区别")
_CLARIFY_MARKERS = ("什么意思", "没看懂", "不明白", "怎么理解", "解释")


def classify_intent(message: str) -> str:
    if any(m in message for m in _PROCESS_MARKERS):
        return "process"
    if any(m in message for m in _OPTION_MARKERS):
        return "option_help"
    if any(m in message for m in _CLARIFY_MARKERS):
        return "clarify"
    return "general"


def answer_process_question(session: dict) -> str:
    """Progress questions answered from interview state — no model call
    (the reference short-circuits these the same way)."""
    scenario = session.get("scenario_config") or {}
    dims = scenario.get("dimensions", [])
    mode = session.get("interview_mode", "standard")
    done = 0
    remaining_est = 0
    for d in dims:
        sat = dimension_saturation(session, d, mode)
        if sat["saturated"]:
            done += 1
        else:
            remaining_est += max(0, sat["budget"] - sat["asked"])
    answered = len(session.get("interview_log", []))
    return (
        f"目前已回答 {answered} 题，完成了 {done}/{len(dims) or 1} 个维度，"
        f"预计还需约 {max(remaining_est, 1)} 个问题。"
        "如果时间紧张，可以在追问上点击「跳过追问」，"
        "或随时点「生成报告」查看当前条件下的报告。"
    )


# ---------------------------------------------------------------------------
# Suggestion extraction (reference :414)
# ---------------------------------------------------------------------------

def _token_overlap(a: str, b: str) -> float:
    sa = set(re.findall(r"[\w一-鿿]", a))
    sb = set(re.findall(r"[\w一-鿿]", b))
    if not sa or not sb:
        return 0.0
    return len(sa & sb) / min(len(sa), len(sb))


def extract_suggested_answer(reply: str, options: Optional[List[str]],
                             multi_select: bool = False) -> Optional[dict]:
    """Map the assistant's advice back onto the current question's options:
    exact mention first, then 选择 X patterns, then token-overlap ranking;
    multi-select questions may map several options."""
    if not options:
        return None
    mentioned = [opt for opt in options if opt and opt in reply]
    if mentioned:
        if multi_select and len(mentioned) > 1:
            return {"options": mentioned[:3], "source": "mentioned"}
        return {"option": mentioned[0], "source": "mentioned"}
    m = re.search(r"(?:选择|建议选|推荐)[\"“]?([^\"”，。;\n]+)", reply)
    if m:
        cand = m.group(1).strip()
        for opt in options:
            if cand in opt or opt in cand:
                return {"option": opt, "source": "inferred"}
    # overlap ranking as last resort: only when clearly dominant
    scored = sorted(
        ((opt, _token_overlap(reply, opt)) for opt in options),
        key=lambda x: -x[1],
    )
    if scored and scored[0][1] >= 0.6 and (
            len(scored) < 2 or scored[0][1] - scored[1][1] >= 0.2):
        return {"option": scored[0][0], "source": "overlap"}
    return None


def draft_rationale(reply: str) -> Optional[str]:
    """Pull a usable one-line rationale from the advice for
    pick_with_reason questions (reference suggestion payload)."""
    for sent in re.split(r"[。\n]", reply):
        sent = sent.strip()
        if len(sent) >= 12 and any(
            k in sent for k in ("因为", "由于", "考虑到", "结合", "基于")
        ):
            return sent[:120]
    return None


class AssistantChat:
    def __init__(self, gateway):
        self.gateway = gateway

    def chat(self, session: dict, user_message: str,
             current_question: Optional[dict] = None) -> dict:
        intent = classify_intent(user_message)
        if intent == "process":
            reply = answer_process_question(session)
            self._remember(session, user_message, reply)
            return {"reply": reply, "suggested_answer": None,
                    "intent": intent}

        context = build_chat_context(
            session, user_message,
            embed_fn=getattr(self.gateway, "embed_texts", None))
        prompt = (
            "你是访谈助手，帮助受访者理解并回答当前问题。结合上下文给出"
            "简明建议（不超过200字）。\n\n" + context
            + f"\n\n用户提问：{user_message}"
        )
        if current_question:
            prompt += f"\n当前问题：{current_question.get('question')}"
            if current_question.get("options"):
                prompt += f"\n选项：{'、'.join(current_question['options'])}"
            if intent == "option_help":
                prompt += "\n请逐个简析选项差异，并给出你建议选择的一项。"
            elif intent == "clarify":
                prompt += "\n请先用一句话解释这个问题在问什么，再给回答思路。"
        try:
            reply = self.gateway.call_model(
                prompt, call_type="chat",
                context={"topic": session.get("topic", "")},
            )
        except Exception:
            reply = ("建议结合实际业务场景回答：先说明现状，再描述期望的"
                     "改进方向。")
        suggestion = extract_suggested_answer(
            reply, (current_question or {}).get("options"),
            bool((current_question or {}).get("multi_select")),
        )
        out = {"reply": reply, "suggested_answer": suggestion,
               "intent": intent}
        if current_question and current_question.get(
                "answer_mode") == "pick_with_reason":
            rat = draft_rationale(reply)
            if rat:
                out["suggested_rationale"] = rat
        self._remember(session, user_message, reply)
        return out

    @staticmethod
    def _remember(session: dict, user_message: str, reply: str) -> None:
        log = session.setdefault("assistant_chat_log", [])
        log.append({"user": user_message[:300], "reply": reply[:300]})
        del log[:-MAX_CHAT_LOG]
