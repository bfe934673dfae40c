"""Canonical prompt formats shared by serving and training.

The reference rents an instruction-following model over HTTPS, so its
prompts (web/server.py:22430/22584/23243) only need to be *descriptive*.
This framework trains its own checkpoints, which makes the prompt string
part of the model contract: a serving prompt the corpus never produced is
out-of-distribution and decodes degenerately on a from-scratch model.

This module is therefore the SINGLE source of truth for every prompt
format that both sides touch: `scripts/build_corpus.py` renders training
examples through these builders, and the runtime (report_v3.py,
followup.py) renders serving prompts through the same functions. Aligning
the two is what the reference achieves implicitly by using one vendor
model for both "training" (vendor-side) and serving.

Only call types whose corpus generator had drifted from the runtime are
routed through here (report_draft / report_review / report_repair /
assessment). The other lanes (question, summary, search_decision,
solution_copy, chat, scenario) were already written against their runtime
builders — see gen_question_example's docstring in build_corpus.py.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

DRAFT_KEYS = ("overview, needs, analysis, visualizations, solutions, "
              "risks, actions, open_questions, evidence_index")

# Single truncation budget for the draft JSON embedded in review/repair
# prompts, shared by serving (report_v3._review_prompt/_repair_reprompt)
# and corpus generation (build_corpus.gen_review/repair_example) so long
# served drafts stay inside the training length distribution.  4000 chars
# ≈ 1.1k BPE tokens, leaving room for issues + the patch target inside
# the 2048-token training window.
REVIEW_DRAFT_TRUNC = 4000


def report_draft_prompt(
    topic: str,
    facts: Sequence[Tuple[str, str, str]],
    *,
    description: str = "",
    documents: Optional[Sequence[Tuple[str, str]]] = None,
) -> str:
    """Report-draft prompt (serving: report_v3._draft_prompt; training:
    build_corpus.gen_report_example).

    `facts` are (q_id, question, answer) with the answer already merged
    with any rationale text. Optional sections reuse the phrasing the
    question lane trains on (主题说明 / 【参考文档：…】) so they stay
    in-distribution even when a checkpoint saw them only in question
    contexts.
    """
    parts = [
        f"你是一名需求分析专家。请基于以下访谈证据，为主题「{topic}」"
        f"撰写结构化报告草稿，输出 JSON，键：{DRAFT_KEYS}。"
    ]
    if description:
        parts.append(f"主题说明：{description}")
    facts_lines = "\n".join(
        f"[{q_id}] 问：{question} 答：{answer}"
        for q_id, question, answer in facts
    )
    parts.append(f"访谈证据：\n{facts_lines}")
    if documents:
        parts.append("\n\n".join(
            f"【参考文档：{name}】\n{summary}" for name, summary in documents
        ))
    return "\n".join(parts)


def report_review_prompt(draft_json: str, issues: List[dict]) -> str:
    """Model review of a draft (serving: report_v3._review_prompt;
    training: build_corpus.gen_review_example). The response contract
    carries quality_score and a mergeable patch (reference review-merge
    web/server.py:23243,23423)."""
    return (
        "你是一名报告评审专家。请审查以下报告草稿 JSON 的证据引用与一致性，"
        '输出 JSON：{"pass": bool, "quality_score": 0-1, "issues": '
        '[{"type", "severity", "message", "target"}], "patch": '
        "{可直接合并的修正字段}}。\n\n已知问题："
        + json.dumps(issues, ensure_ascii=False)
        + "\n\n草稿：" + draft_json
    )


def report_repair_prompt(draft_json: str, issues: List[dict]) -> str:
    """Issue-driven re-prompt (serving: report_v3._repair_reprompt;
    training: build_corpus.gen_repair_example; reference repair-reprompt
    web/server.py:23307)."""
    return (
        "以下报告草稿存在评审问题，请修复后输出完整修正版 JSON"
        "（保持字段结构不变，仅修正问题项）。\n\n问题列表："
        + json.dumps(issues, ensure_ascii=False)
        + "\n\n草稿：" + draft_json
    )


def assessment_prompt(question: str, answer: str) -> str:
    """Answer information-content scoring (serving: followup.py
    assessment lane; training: build_corpus.gen_assessment_example;
    reference answer-depth eval web/server.py:20655)."""
    return (
        "请为以下访谈回答的信息含量打分(0-1)，输出 JSON "
        '{"score": 数值, "reason": "简短理由"}：\n'
        f"问：{question}\n答：{answer}"
    )
