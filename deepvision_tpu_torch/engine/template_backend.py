"""Deterministic template backend — structured outputs without a model.

A copy of the JAX package's ``engine/template_backend.py`` (the port keeps
its own copies of what it needs; nothing here depends on either package).

Serves two jobs the reference split across ENABLE_AI=False fallbacks and
test monkeypatching (reference tests stub `_call_question_with_optional_hedge`
etc., tests/test_question_fast_strategy.py:208-223):

* the app's "mock AI" mode (tests, demos, CPU-only deploys) — every call
  type returns schema-valid JSON immediately;
* the degrade chain's last resort when the real engine is unhealthy
  (reference fallback question at web/server.py:30582, simple report
  template at :33355).

Outputs are deterministic functions of the provided context, so snapshots
are stable across runs.
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional


def _h(seed_text: str, n: int) -> int:
    digest = hashlib.md5(seed_text.encode("utf-8")).digest()
    return int.from_bytes(digest[:4], "big") % n


def generate(call_type: str, prompt: str, context: Optional[dict] = None) -> str:
    context = context or {}
    if call_type in ("question", "question_fast", "question_deep"):
        return _question(prompt, context)
    if call_type in ("report", "report_draft"):
        return _report_draft(prompt, context)
    if call_type == "report_review":
        return _report_review(prompt, context)
    if call_type in ("summary", "doc_summary"):
        return _summary(prompt, context)
    if call_type == "search_decision":
        return _search_decision(prompt, context)
    if call_type == "assessment":
        return _assessment(prompt, context)
    if call_type == "scenario":
        return _scenario(prompt, context)
    if call_type == "chat":
        return _chat(prompt, context)
    if call_type == "solution_copy":
        return _solution_copy(prompt, context)
    return _summary(prompt, context)


_QUESTION_STEMS = [
    "在{aspect}方面，您目前遇到的最大挑战是什么？",
    "关于{aspect}，您期望达到的理想状态是怎样的？",
    "请描述一下{aspect}相关的具体场景和参与角色。",
    "在{aspect}上，您已经尝试过哪些方案？效果如何？",
    "如果必须排序，{aspect}中哪些点对您最重要？",
]

_OPTION_SETS = [
    ["效率与自动化", "质量与稳定性", "成本控制", "用户体验", "其他（请说明）"],
    ["已有明确方案", "有初步想法", "还在调研", "完全未开始"],
    ["核心业务流程", "辅助支撑环节", "对外服务能力", "内部管理需求"],
    ["一个月内", "一个季度内", "半年以上", "时间不确定"],
]


def _question(prompt: str, ctx: dict) -> str:
    dimension = ctx.get("dimension_name") or ctx.get("dimension") or "核心需求"
    aspects = ctx.get("key_aspects") or [dimension]
    round_no = int(ctx.get("question_number", 1))
    aspect = aspects[round_no % len(aspects)]
    stem = _QUESTION_STEMS[_h(f"{dimension}:{round_no}", len(_QUESTION_STEMS))]
    options = _OPTION_SETS[_h(f"{dimension}:{round_no}:opt", len(_OPTION_SETS))]
    is_follow_up = bool(ctx.get("is_follow_up"))
    payload = {
        "question": ("追问：" if is_follow_up else "") + stem.format(aspect=aspect),
        "options": options,
        "multi_select": round_no % 3 == 0,
        "is_follow_up": is_follow_up,
        "answer_mode": "pick_with_reason" if round_no % 2 else "pick_only",
        "requires_rationale": bool(round_no % 2),
        "evidence_intent": ["low", "medium", "high"][round_no % 3],
        "ai_recommendation": options[0] if round_no % 4 == 0 else None,
    }
    return json.dumps(payload, ensure_ascii=False)


def _report_draft(prompt: str, ctx: dict) -> str:
    topic = ctx.get("topic", "需求调研")
    q_ids = ctx.get("q_ids") or ["Q1"]

    def refs(i):
        return [q_ids[i % len(q_ids)]]

    draft = {
        "overview": (
            f"本报告基于对「{topic}」的结构化访谈整理而成，"
            f"共覆盖 {len(q_ids)} 轮问答。访谈显示核心诉求集中在业务效率、"
            "方案可落地性与成本控制三个方面，以下章节逐项展开分析。"
        ),
        "needs": [
            {
                "title": "核心业务诉求",
                "description": f"围绕{topic}的主要目标与期望价值，"
                               "访谈中被反复强调为本期必须解决的问题。",
                "priority": "P0",
                "refs": refs(0),
            },
            {
                "title": "落地路径诉求",
                "description": "对实施节奏、资源投入与里程碑的期望，"
                               "要求分阶段交付并在每阶段有可验收产物。",
                "priority": "P1",
                "refs": refs(1),
            },
            {
                "title": "数据与协同诉求",
                "description": "希望打通现有系统间的数据口径，"
                               "减少跨部门人工对账与重复录入。",
                "priority": "P1",
                "refs": refs(2),
            },
        ],
        "analysis": {
            "customer_needs": f"访谈对象对{topic}的痛点与期望价值做了明确表述。",
            "business_flow": "现有业务流程存在可优化环节，需结合访谈证据细化。",
            "tech_constraints": "技术栈与数据现状构成主要约束条件。",
            "project_constraints": "时间窗口与预算范围限定了方案选择空间。",
        },
        "visualizations": {
            "priority_quadrant_mermaid": (
                "quadrantChart\n    title 需求优先级矩阵\n"
                "    x-axis 实施成本低 --> 实施成本高\n"
                "    y-axis 价值低 --> 价值高\n"
                "    核心业务诉求: [0.3, 0.8]\n    落地路径诉求: [0.6, 0.6]"
            ),
            "business_flow_mermaid": (
                "flowchart LR\n    A[需求澄清] --> B[方案设计]\n"
                "    B --> C[实施落地]\n    C --> D[验收复盘]"
            ),
            "demand_pie_mermaid": (
                "pie title 诉求分布\n    \"业务效率\" : 45\n"
                "    \"质量稳定\" : 30\n    \"成本控制\" : 25"
            ),
            "architecture_mermaid": (
                "flowchart TB\n    U[用户层] --> S[服务层]\n    S --> D[数据层]"
            ),
        },
        "solutions": [
            {
                "title": "分阶段实施方案",
                "description": "先落地高价值低成本项形成示范效应，"
                               "再按里程碑迭代扩展到全量场景，降低切换风险。",
                "refs": refs(0),
            },
            {
                "title": "数据底座先行方案",
                "description": "优先统一主数据与接口规范，"
                               "为后续流程改造提供一致的数据口径与集成基础。",
                "refs": refs(2),
            },
        ],
        "risks": [
            {
                "title": "需求范围蔓延",
                "description": "访谈中部分诉求边界未完全澄清，需在立项时锁定。",
                "severity": "medium",
                "refs": refs(1),
            },
            {
                "title": "里程碑排期依赖",
                "description": "关键节点依赖第三方接口与数据迁移进度，"
                               "任一延期都会联动压缩验收窗口。",
                "severity": "medium",
                "refs": refs(2),
            },
        ],
        "actions": [
            {"title": "确认优先级清单", "owner": "需求方",
             "description": "按访谈证据输出P0/P1需求清单并完成业务评审。",
             "timeline": "两周内", "metric": "清单评审通过并双方签字确认",
             "refs": refs(0)},
            {"title": "输出实施里程碑", "owner": "实施方",
             "description": "拆解阶段目标与交付物，明确每阶段验收口径。",
             "timeline": "本月", "metric": "里程碑计划获立项会议通过",
             "refs": refs(1)},
        ],
        "open_questions": [
            {"question": "预算上限与审批流程是否已明确？", "refs": refs(1)}
        ],
        "evidence_index": [
            {"q_id": q, "summary": f"第 {i + 1} 轮问答要点"}
            for i, q in enumerate(q_ids[:10])
        ],
    }
    return json.dumps(draft, ensure_ascii=False)


def _report_review(prompt: str, ctx: dict) -> str:
    return json.dumps(
        {
            "pass": True,
            "quality_score": 0.86,
            "issues": [],
            "patch": {},
            "summary": "结构完整、证据引用齐备，允许发布。",
        },
        ensure_ascii=False,
    )


def _summary(prompt: str, ctx: dict) -> str:
    name = ctx.get("doc_name", "该文档")
    body = ctx.get("content", prompt)
    head = body.strip().replace("\n", " ")[:120]
    return (
        f"{name}要点摘要：{head}…… 核心内容包括背景说明、关键数据与结论建议，"
        "建议结合访谈问题定位相关段落。"
    )


def _search_decision(prompt: str, ctx: dict) -> str:
    topic = ctx.get("topic", "")
    need = _h(f"search:{topic}", 4) == 0
    return json.dumps(
        {"need_search": need, "query": topic[:40], "reason": "模板决策"},
        ensure_ascii=False,
    )


def _assessment(prompt: str, ctx: dict) -> str:
    answer = ctx.get("answer", "")
    score = min(0.95, 0.35 + min(len(answer), 200) / 250.0)
    return json.dumps({"score": round(score, 2)}, ensure_ascii=False)


def _scenario(prompt: str, ctx: dict) -> str:
    desc = ctx.get("description", prompt)[:30]
    dims = []
    for i, name in enumerate(["目标与背景", "现状与约束", "方案期望", "落地计划"]):
        dims.append(
            {
                "id": f"dim_{i + 1}",
                "name": name,
                "description": f"{desc}相关的{name}",
                "key_aspects": [f"{name}要点A", f"{name}要点B"],
                "min_questions": 2,
                "max_questions": 4,
            }
        )
    return json.dumps(
        {
            "name": f"定制场景：{desc}",
            "description": f"基于描述自动生成的访谈场景：{desc}",
            "icon": "sparkles",
            "keywords": [desc[:8]] if desc else [],
            "dimensions": dims,
            "report": {
                "type": "standard",
                "template": "default",
                "sections": [
                    "overview", "requirements_summary", "detailed_analysis",
                    "visualizations", "recommendations", "risks",
                    "next_steps", "appendix",
                ],
            },
        },
        ensure_ascii=False,
    )


def _solution_copy(prompt: str, ctx: dict) -> str:
    title = ctx.get("title", "解决方案")
    return json.dumps(
        {
            "chapter_copy": {
                "value_statement": f"{title}：以最小实施成本覆盖核心诉求，"
                                   "并为后续扩展预留空间。",
                "approach": "按「先高价值低成本、后迭代扩展」的路线分阶段推进，"
                            "每阶段以可验证的业务指标收口。",
                "commitment": "交付物包含方案说明、里程碑计划与验收标准。",
            },
            "quality_review": {
                "score": 0.85,
                "strengths": ["证据引用完整", "结构覆盖齐全"],
                "concerns": [],
                "verdict": "pass",
            },
        },
        ensure_ascii=False,
    )


def _chat(prompt: str, ctx: dict) -> str:
    return (
        "根据当前访谈上下文，建议您从实际业务场景出发作答：先说明现状，再描述"
        "期望的改进方向；若问题提供了选项，可选择最接近的一项并补充原因。"
    )
