"""Frozen copies of the app's prompt builders and of the training batch.

``build_interview_prompt`` (with ``build_history_window`` and
``build_doc_context``) is ``deepvision_tpu_torch/web/runtime/interview.py``'s,
``report_draft_prompt`` is ``web/runtime/prompt_formats.py``'s and
``train_batch`` is ``chip_smoke.py``'s ``_train_batch``, over a copy of the
built-in scenarios (``scenarios/``).  They are copies so that a later change
to the app's prompts does not move the yardstick; ``tests/
test_bench_frozen.py`` holds them equal to the originals as they stand.
"""

from __future__ import annotations

import glob
import json
import os
import random

SCENARIO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "scenarios")
DRAFT_KEYS = ("overview, needs, analysis, visualizations, solutions, "
              "risks, actions, open_questions, evidence_index")


def scenarios() -> list:
    out = []
    for path in sorted(glob.glob(os.path.join(SCENARIO_DIR, "*.json"))):
        with open(path, encoding="utf-8") as fh:
            out.append(json.load(fh))
    if not out:
        raise FileNotFoundError(f"{SCENARIO_DIR}/*.json")
    return out


def build_history_window(interview_log, window=5, summary="",
                         summary_threshold=8):
    recent = interview_log[-window:]
    lines = []
    for entry in recent:
        q = (entry.get("question") or "").strip()
        a = (entry.get("answer") or "").strip()
        lines.append(f"问：{q}\n答：{a}")
    needs_summary = len(interview_log) >= summary_threshold
    text = ""
    if summary:
        text += f"【历史摘要】{summary}\n"
    text += "\n".join(lines)
    return text, needs_summary


def build_doc_context(reference_materials, *, max_doc_chars=1800,
                      max_total_chars=5000):
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


def build_interview_prompt(session, dimension, *, is_follow_up=False,
                           follow_up_context="", search_context="",
                           capture_contract=None, fast_tier=False,
                           prompt_budget=0, focus_aspect=""):
    topic = session.get("topic", "")
    desc = session.get("description", "")
    history, _ = build_history_window(
        session.get("interview_log", []),
        summary=session.get("summary", ""),
    )
    docs = "" if fast_tier else build_doc_context(
        session.get("reference_materials", []))
    aspects = "、".join(dimension.get("key_aspects", []))
    contract = capture_contract or {}
    parts = [
        "你是一名资深需求访谈顾问，正在进行结构化访谈。",
        f"访谈主题：{topic}",
    ]
    if desc and not fast_tier:
        parts.append(f"主题说明：{desc}")
    if docs:
        parts.append(docs)
    parts.append(f"当前维度：{dimension.get('name')}（关注要点：{aspects}）")
    if search_context:
        parts.append(f"【联网检索结果】\n{search_context}")
    if history:
        parts.append(f"历史问答：\n{history}")
    if is_follow_up:
        parts.append(f"请针对上一个回答进行追问。追问背景：{follow_up_context}")
    if focus_aspect:
        parts.append(f"本轮请优先覆盖尚未谈到的要点：{focus_aspect}")
    if contract:
        parts.append(
            f"采集要求：answer_mode={contract.get('answer_mode')}, "
            f"evidence_intent={contract.get('evidence_intent')}")
    parts.append(
        "请生成下一个访谈问题，输出 JSON："
        '{"question": "问题文本(≤240字)", "options": ["选项1", ...2-6项], '
        '"multi_select": bool, "is_follow_up": %s, '
        '"answer_mode": "pick_only|pick_with_reason", '
        '"requires_rationale": bool, "evidence_intent": "low|medium|high", '
        '"ai_recommendation": "推荐选项或null"}'
        % ("true" if is_follow_up else "false"))
    prompt = "\n\n".join(parts)
    if prompt_budget and len(prompt) > prompt_budget:
        prompt = prompt[:prompt_budget]
    return prompt


def report_draft_prompt(topic, facts, *, description="", documents=None):
    parts = [
        f"你是一名需求分析专家。请基于以下访谈证据，为主题「{topic}」"
        f"撰写结构化报告草稿，输出 JSON，键：{DRAFT_KEYS}。"
    ]
    if description:
        parts.append(f"主题说明：{description}")
    facts_lines = "\n".join(
        f"[{q_id}] 问：{question} 答：{answer}"
        for q_id, question, answer in facts)
    parts.append(f"访谈证据：\n{facts_lines}")
    if documents:
        parts.append("\n\n".join(
            f"【参考文档：{name}】\n{summary}" for name, summary in documents))
    return "\n".join(parts)


def train_batch(tokenizer, rows: int, row_len: int, seed: int):
    """``[rows, row_len]`` token ids (a list of lists) of seeded interview
    transcripts, tokenized and joined by the end-of-turn id."""
    rng = random.Random(seed)
    scs = scenarios()
    ids = []
    while len(ids) < rows * row_len:
        sc = rng.choice(scs)
        parts = [f"访谈主题：{sc['name']}\n{sc['description']}\n\n"]
        for turn in range(rng.randint(4, 10)):
            d = rng.choice(sc["dimensions"])
            aspects = rng.sample(d["key_aspects"],
                                 rng.randint(1, len(d["key_aspects"])))
            parts.append(
                f"问题{turn + 1}（{d['name']}）：请具体说明{d['description']}。"
                f"\n回答：关于{'、'.join(aspects)}，目前第{rng.randint(1, 30)}"
                f"轮访谈确认了现状与期望。\n")
        ids.extend(tokenizer.encode("".join(parts)))
        ids.append(tokenizer.eos_id)
    ids = ids[: rows * row_len]
    return [ids[r * row_len:(r + 1) * row_len] for r in range(rows)]
