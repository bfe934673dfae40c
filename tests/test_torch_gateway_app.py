"""The port's gateway inside the JAX app's runtime objects.

``build_gateway`` (the port, CPU engines) and the JAX app's
``AppState._build_gateway`` (JAX engines, Pallas in interpret mode) are
built from the same settings and the same ``dv-tiny-test`` weights (carried
from JAX ``init_params`` through an ``.npz``).  Each gateway is handed to
the app's ``TieredQuestionGenerator`` (``web/runtime/interview.py``) for
one next-question call and to its ``ReportJobQueue``
(``web/runtime/report_queue.py``) for one report draft.  With every lane at
temperature 0 the two gateways see the same calls and return the same
text, and the app objects reach the same results.

No deadline may decide the comparison: a CPU run under load can take
longer than the fast tier's 8 s (the first call of either side compiles
or warms up), and a call that times out is retried with a shrunk prompt
or falls through to the next tier on that side alone.  So every lane and
the fast tier get a deadline a CPU run cannot reach, and a call that
still times out fails the test as such.  The report's minute stamp is
replaced by one placeholder on both sides before the reports are
compared.
"""

import json
import os
import re
import types

import pytest
import torch

from deepvision_tpu.engine.config import TINY_TEST
from deepvision_tpu.engine.weights import init_params, save_npz
from deepvision_tpu.web.env import ConfigResolver
from deepvision_tpu.web.meta_index import MetaIndex
from deepvision_tpu.web.runtime.interview import TieredQuestionGenerator
from deepvision_tpu.web.runtime.report_queue import ReportJobQueue
from deepvision_tpu.web.server import AppState
from deepvision_tpu.web.stores import ReportStore, SessionStore
from deepvision_tpu_torch.web.gateway import build_gateway

torch.set_num_threads(2)

DIM = {"id": "customer_needs", "name": "客户需求",
       "key_aspects": ["目标用户", "核心痛点", "使用场景"]}
MAX_TOKENS = 24
DEADLINE_S = 600.0  # no call of a CPU run comes near it
# render_report_markdown's "生成时间：YYYY-MM-DD HH:MM" (to the minute)
STAMP = re.compile(r"生成时间：\d{4}-\d{2}-\d{2} \d{2}:\d{2}")


def _session():
    return {
        "session_id": "dv-app-0001",
        "topic": "仓储管理系统选型",
        "description": "覆盖三个区域仓与一个中心仓的出入库流程",
        "interview_mode": "standard",
        "interview_log": [
            {"question": f"第{i}个问题？", "answer": f"第{i}个回答，包含具体内容",
             "dimension": "customer_needs"} for i in range(3)],
        "reference_materials": [],
        "summary": "",
        "scenario_config": {"dimensions": [DIM]},
    }


def _settings(ckpt):
    return {
        "AI_MODE": "engine", "QUESTION_MODEL_NAME": "dv-tiny-test",
        "REPORT_MODEL_NAME": "dv-tiny-test",
        "REPORT_DRAFT_MODEL_NAME": "dv-tiny-test",
        "REPORT_REVIEW_MODEL_NAME": "dv-tiny-test",
        "ENGINE_TOKENIZER": "byte", "ENGINE_CHECKPOINT_DIR": ckpt,
        "ENGINE_NUM_PAGES": 64, "ENGINE_PAGE_SIZE": 16,
        "ENGINE_MAX_PAGES_PER_SEQ": 16, "ENGINE_MAX_SLOTS": 2,
    }


def _jax_gateway(settings):
    state = AppState.__new__(AppState)
    state.resolver = ConfigResolver()
    for key, value in settings.items():
        state.resolver.set_runtime(key, value)
    state.metrics = types.SimpleNamespace(record_ai_call=None)
    return AppState._build_gateway(state)


def _drive(gw, data_dir):
    """Greedy lanes with a short budget and a deadline no call reaches,
    every call and its meta (or its error) recorded; one question through
    the tiered generator and one report through the queue."""
    gw.lanes = {k: v.replace(temperature=0.0, max_tokens=MAX_TOKENS,
                             timeout_s=DEADLINE_S)
                for k, v in gw.lanes.items()}
    calls, metas = [], []
    inner = gw.call_model

    def recording(prompt, call_type="question", *, return_meta=False, **kw):
        try:
            text, meta = inner(prompt, call_type, return_meta=True, **kw)
        except Exception as e:
            metas.append((call_type, {"failure_reason": str(e)}))
            raise
        calls.append((call_type, prompt, text))
        metas.append((call_type, meta))
        return (text, meta) if return_meta else text

    gw.call_model = recording
    session = _session()
    question, qmeta = TieredQuestionGenerator(
        gw, fast_max_tokens=MAX_TOKENS,
        fast_timeout=DEADLINE_S).generate(session, DIM)
    meta = MetaIndex(os.path.join(data_dir, "meta.sqlite3"))
    sessions = SessionStore(data_dir, meta)
    reports = ReportStore(data_dir, meta)
    sessions.save(session)
    queue = ReportJobQueue(gw, sessions, reports, meta, max_workers=1)
    try:
        assert queue.submit(session["session_id"])
        queue.drain(timeout=600)
        status = queue.status_payload(session["session_id"])
    finally:
        queue.shutdown()
    report = reports.load(status["report_name"]) if status.get(
        "report_name") else None
    return calls, metas, question, qmeta, status, report


def _timed_out(metas):
    """The calls that hit a deadline: retried with a shrunk prompt, or
    failed with a timeout."""
    return [(call_type, meta) for call_type, meta in metas
            if meta.get("prompt_shrunk")
            or "timeout" in str(meta.get("failure_reason") or "").lower()]


def _unstamped(report):
    return None if report is None else STAMP.sub("生成时间：<stamp>", report)


def test_port_gateway_in_the_jax_app_equals_the_jax_gateway(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("DV_DFA_CACHE_DIR", str(tmp_path / "dfa"))
    ckpt = str(tmp_path / "tiny.npz")
    save_npz(ckpt, init_params(TINY_TEST, seed=0))
    results = []
    for name, build in (("jax", _jax_gateway),
                        ("port", lambda s: build_gateway(s, device="cpu"))):
        gw = build(_settings(ckpt))
        data_dir = tmp_path / name
        data_dir.mkdir()
        try:
            results.append(_drive(gw, str(data_dir)))
        finally:
            for eng in gw.engines.values():
                eng.shutdown()
    (j_calls, j_metas, j_q, j_qmeta, j_status, j_report), \
        (t_calls, t_metas, t_q, t_qmeta, t_status, t_report) = results
    assert _timed_out(j_metas) == [] and _timed_out(t_metas) == []
    call_types = [c[0] for c in t_calls]
    assert "question_fast" in call_types and "report_draft" in call_types
    for call_type, _, text in t_calls:
        json.loads(text)                        # json_mode: every call parses
    assert t_calls == j_calls
    assert (t_q, t_qmeta) == (j_q, j_qmeta)
    assert t_status["state"] == j_status["state"] == "completed"
    for key in ("ai_generated", "report_quality_meta"):
        assert t_status.get(key) == j_status.get(key)
    # the minute stamp: as often in one report as in the other, then one
    # placeholder for both; every other byte is compared
    assert (len(STAMP.findall(t_report or ""))
            == len(STAMP.findall(j_report or "")))
    assert _unstamped(t_report) == _unstamped(j_report)


def test_port_gateway_retrieval_in_the_jax_app_equals_the_jax_gateway(
        tmp_path, monkeypatch):
    """The app's hybrid retrieval (``select_chunks_for_query``, keyword
    overlap blended with the gateway's ``embed_texts`` cosine) picks the
    same chunks through the port's engine-mode gateway as through the JAX
    one, and both gateways really embed (unit vectors, not the
    keyword-only fallback)."""
    from deepvision_tpu.web.runtime.documents import select_chunks_for_query

    monkeypatch.setenv("DV_DFA_CACHE_DIR", str(tmp_path / "dfa"))
    ckpt = str(tmp_path / "tiny.npz")
    save_npz(ckpt, init_params(TINY_TEST, seed=0))
    chunks = ["门店补货决策依赖人工经验", "完全无关的天气记录 foo",
              "仓储管理系统覆盖三个区域仓", "另一段无关的排班说明 bar",
              "中心仓的出入库流程需要扫码确认", "客户管理流程与数据报表"]
    queries = ["仓库进货怎样自动化", "出入库流程", "hello"]
    picks = []
    for build in (_jax_gateway,
                  lambda s: build_gateway(s, device="cpu")):
        gw = build(_settings(ckpt))
        try:
            embs = gw.embed_texts(chunks + queries)
            assert embs is not None and embs.shape == (9, TINY_TEST.d_model)
            assert abs(float((embs * embs).sum(-1).min()) - 1.0) < 1e-3
            picks.append([select_chunks_for_query(chunks, q, top_k=3,
                                                  embed_fn=gw.embed_texts)
                          for q in queries])
        finally:
            for eng in gw.engines.values():
                eng.shutdown()
    assert picks[1] == picks[0]
