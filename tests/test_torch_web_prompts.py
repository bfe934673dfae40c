"""The three prompt builders the benchmark renders through, against the JAX
app's: ``build_interview_prompt`` (``web/runtime/interview.py``),
``report_draft_prompt`` (``web/runtime/prompt_formats.py``) and
``convert_to_markdown`` (``web/runtime/documents.py``).  The same inputs,
made from a seed, give the same strings from both packages."""

import numpy as np
import pytest

from deepvision_tpu.web.runtime import documents as jax_documents
from deepvision_tpu.web.runtime import exports as jax_exports
from deepvision_tpu.web.runtime import interview as jax_interview
from deepvision_tpu.web.runtime import prompt_formats as jax_formats
from deepvision_tpu_torch.web.runtime import documents, interview
from deepvision_tpu_torch.web.runtime import prompt_formats

ANSWERS = ["跨部门协作效率低，数据分散，报表手工汇总耗时。",
           "我们有三套系统，因为口径不一致，例如月末对账要两天。",
           "期望自动补货，预算在五十万以内，半年内上线。"]
DIMENSION = {"id": "customer_needs", "name": "客户需求",
             "key_aspects": ["核心痛点", "期望价值", "使用场景"]}


def _session(seed, rounds, with_docs):
    rng = np.random.default_rng(seed)
    log = [{"question": f"第{r + 1}个问题：现状如何？",
            "answer": ANSWERS[int(rng.integers(len(ANSWERS)))] * int(
                rng.integers(1, 4)),
            "dimension": "customer_needs"} for r in range(rounds)]
    docs = [{"name": "背景.md", "content": "三个区域仓与一个中心仓。" * 40,
             "summary": "仓储背景摘要", "chunks": ["三个区域仓"]}] \
        if with_docs else []
    return {"session_id": f"dv-s{seed}", "topic": f"客户关系管理系统调研{seed}",
            "description": "覆盖销售与服务流程" if seed % 2 else "",
            "summary": "前几轮已确认数据分散" if rounds > 6 else "",
            "interview_log": log, "reference_materials": docs}


@pytest.mark.parametrize("rounds", [0, 3, 9])
@pytest.mark.parametrize("kw", [
    {}, {"fast_tier": True, "prompt_budget": 2200},
    {"is_follow_up": True, "follow_up_context": "回答缺少具体数字"},
    {"search_context": "行业报告：零售补货", "focus_aspect": "期望价值"},
], ids=["full", "fast", "follow_up", "search"])
def test_interview_prompt_equals_the_jax_app(rounds, kw):
    for seed, with_docs in ((rounds, False), (rounds + 1, True)):
        session = _session(seed, rounds, with_docs)
        want = jax_interview.build_interview_prompt(session, DIMENSION, **kw)
        assert interview.build_interview_prompt(
            session, DIMENSION, **kw) == want
        assert want


@pytest.mark.parametrize("n_facts", [1, 8, 24])
def test_report_draft_prompt_equals_the_jax_app(n_facts):
    facts = [(f"Q{k}", f"关于维度{k}的现状与期望？", ANSWERS[k % 3])
             for k in range(1, 1 + n_facts)]
    for kw in ({}, {"description": "覆盖三个区域仓",
                    "documents": [("背景.md", "仓储背景摘要")]}):
        want = jax_formats.report_draft_prompt("企业客户关系管理系统", facts,
                                               **kw)
        assert prompt_formats.report_draft_prompt(
            "企业客户关系管理系统", facts, **kw) == want


MARKDOWN = ("# 标题\n\n这是正文段落，包含**加粗**与列表。\n\n- 列表项一\n- 列表项二\n\n"
            "| 列 | 值 |\n|---|---|\n| 预算 | 50 万 |\n")


@pytest.mark.parametrize("name,make", [
    ("需求.md", lambda: MARKDOWN.encode("utf-8")),
    ("说明.txt", lambda: "纯文本说明\n第二行".encode("utf-8")),
    ("需求.docx", lambda: jax_exports.markdown_to_docx(MARKDOWN)),
    ("需求.pdf", lambda: jax_exports.markdown_to_pdf(MARKDOWN)),
])
def test_convert_to_markdown_equals_the_jax_app(name, make):
    data = make()
    try:
        want = jax_documents.convert_to_markdown(name, data)
    except jax_documents.ConversionError as e:
        with pytest.raises(documents.ConversionError, match=str(e)):
            documents.convert_to_markdown(name, data)
        return
    assert documents.convert_to_markdown(name, data) == want
    assert want
