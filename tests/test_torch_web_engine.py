"""The port's app in engine mode, against the JAX app, over HTTP.

Both apps boot with ``AI_MODE=engine`` on the same ``dv-tiny-test``
weights (JAX ``init_params`` carried through an ``.npz``), the JAX app on
its JAX engines (Pallas in interpret mode), the port's app on its CPU
engines (``device="cpu"``).  One session goes through both: login, a
session, ``next-question``, ``submit-answer``, ``generate-report`` and the
report.  With every lane at temperature 0 the two apps make the same model
calls with the same prompts, get the same text back and answer with the
same question and the same report.

No deadline may decide the comparison (a CPU run under load can take
longer than the fast tier's 8 s, and a call that times out is retried with
a shrunk prompt or falls through to the next tier on that side alone), so
``QUESTION_FAST_TIMEOUT`` and every lane's ``timeout_s`` are set to a
deadline no CPU call reaches, and a call that still times out or shrank
its prompt fails the test.  Background question prefetches run between
requests, and each request waits until they are done, so both apps see
the same order of calls.  The report's minute stamp is replaced by one
placeholder on both sides before the reports are compared.

The port's app also reads its engines' settings through the app's
``ConfigResolver``: one setting from an ``.env`` file and one saved in the
admin config centre reach the built ``EngineConfig``.  Without CUDA an
engine-mode app raises unless the caller asks for the CPU; a template-mode
app needs no device.
"""

import json
import re
import tempfile

import pytest
import torch

from deepvision_tpu.engine.config import TINY_TEST
from deepvision_tpu.engine.weights import init_params, save_npz
from deepvision_tpu.web.server import create_app as jax_create_app
from deepvision_tpu_torch.web.server import create_app as port_create_app
from test_torch_web_parity import normalise, settle

torch.set_num_threads(2)

MAX_TOKENS = 24
DEADLINE_S = 600.0  # no call of a CPU run comes near it
STAMP = re.compile(r"生成时间：\d{4}-\d{2}-\d{2} \d{2}:\d{2}")
PHONE = "13900000301"
ADMIN_PHONE = "13800000001"


def _settings(ckpt):
    return {
        "AI_MODE": "engine", "QUESTION_MODEL_NAME": "dv-tiny-test",
        "REPORT_MODEL_NAME": "dv-tiny-test",
        "REPORT_DRAFT_MODEL_NAME": "dv-tiny-test",
        "REPORT_REVIEW_MODEL_NAME": "dv-tiny-test",
        "ENGINE_TOKENIZER": "byte", "ENGINE_CHECKPOINT_DIR": ckpt,
        "ENGINE_NUM_PAGES": 64, "ENGINE_PAGE_SIZE": 16,
        "ENGINE_MAX_PAGES_PER_SEQ": 16, "ENGINE_MAX_SLOTS": 2,
        "QUESTION_FAST_TIMEOUT": DEADLINE_S,
        "QUESTION_FAST_MAX_TOKENS": MAX_TOKENS,
        "SMS_PROVIDER": "mock", "SMS_TEST_CODE": "666666",
        "ADMIN_PHONE_NUMBERS": ADMIN_PHONE,
        "SMS_SEND_COOLDOWN_SECONDS": 0,
    }


@pytest.fixture()
def tiny_npz(tmp_path, monkeypatch):
    monkeypatch.setenv("DV_DFA_CACHE_DIR", str(tmp_path / "dfa"))
    path = str(tmp_path / "tiny.npz")
    save_npz(path, init_params(TINY_TEST, seed=0))
    return path


def _login(c, phone):
    assert c.post("/api/auth/sms/send-code",
                  json_body={"phone": phone}).status_code == 200
    r = c.post("/api/auth/login/code",
               json_body={"phone": phone, "code": "666666"})
    assert r.status_code == 200, r.text


def _drive(app):
    """One session over HTTP; every model call and its meta recorded."""
    gw = app.state.gateway
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
    c = app.test_client()
    _login(c, PHONE)
    r = c.post("/api/sessions", json_body={
        "topic": "仓储管理系统选型", "scenario_id": "product-requirement",
        "interview_mode": "quick",
        "description": "覆盖三个区域仓与一个中心仓的出入库流程"})
    assert r.status_code == 201, r.text
    sid = r.get_json()["session_id"]
    r = c.post(f"/api/sessions/{sid}/next-question", json_body={})
    assert r.status_code == 200, r.text
    question = r.get_json()
    settle(DEADLINE_S)
    r = c.post(f"/api/sessions/{sid}/submit-answer", json_body={
        "question": question["question"],
        "answer": "我们有三套系统，因为数据分散，例如报表需要手工汇总",
        "dimension": question.get("dimension"),
        "options": question.get("options")})
    assert r.status_code == 200, r.text
    settle(DEADLINE_S)
    r = c.post(f"/api/sessions/{sid}/generate-report",
               json_body={"force": True})
    assert r.status_code == 202, r.text
    app.state.report_queue.drain(timeout=DEADLINE_S)
    status = c.get(f"/api/status/report-generation/{sid}").get_json()
    assert status["state"] == "completed", status
    r = c.get(f"/api/reports/{status['report_name']}")
    assert r.status_code == 200
    names = {sid: "<sid>", status["report_name"]: "<report>"}
    return (calls, metas, normalise(question, names),
            normalise(status, names), r.data.decode("utf-8"))


def _timed_out(metas):
    return [(call_type, meta) for call_type, meta in metas
            if meta.get("prompt_shrunk")
            or "timeout" in str(meta.get("failure_reason") or "").lower()]


def test_engine_mode_app_answers_as_the_jax_app(tiny_npz):
    results = []
    for create_app, kw in ((jax_create_app, {}),
                           (port_create_app, {"device": "cpu"})):
        with tempfile.TemporaryDirectory() as tmp:
            app = create_app(data_dir=tmp, overrides=_settings(tiny_npz),
                             **kw)
            try:
                assert app.state.gateway.mode == "engine"
                results.append(_drive(app))
            finally:
                settle(DEADLINE_S)
                app.state.shutdown()
    (j_calls, j_metas, j_q, j_status, j_report), \
        (t_calls, t_metas, t_q, t_status, t_report) = results
    assert _timed_out(j_metas) == [] and _timed_out(t_metas) == []
    call_types = [c[0] for c in t_calls]
    assert "question_fast" in call_types and "report_draft" in call_types
    for _, _, text in t_calls:
        json.loads(text)                        # json_mode: every call parses
    assert t_calls == j_calls
    assert t_q == j_q
    for key in ("state", "ai_generated", "report_quality_meta"):
        assert t_status.get(key) == j_status.get(key)
    # the minute stamp: as often in one report as in the other (random
    # tiny weights give drafts the quality gate refuses, and the degraded
    # report carries none), then one placeholder for both
    assert len(STAMP.findall(t_report)) == len(STAMP.findall(j_report))
    assert (STAMP.sub("生成时间：<stamp>", t_report)
            == STAMP.sub("生成时间：<stamp>", j_report))


def test_env_file_and_config_centre_reach_the_port_engines(tiny_npz, tmp_path,
                                                           monkeypatch):
    """``ENGINE_PREFILL_CHUNK_SIZE`` from an ``.env`` file and
    ``ENGINE_MAX_CHAINED_DECODES`` saved in the admin config centre (by a
    template-mode app on the same data dir, restored at the next boot)
    reach the engine-mode app's ``EngineConfig``."""
    env_file = tmp_path / "app.env"
    env_file.write_text("ENGINE_PREFILL_CHUNK_SIZE=32\n", encoding="utf-8")
    monkeypatch.setenv("DEEPVISION_ENV_FILE", str(env_file))
    data_dir = str(tmp_path / "data")
    template = {k: v for k, v in _settings(tiny_npz).items()
                if not k.startswith(("ENGINE_", "AI_MODE"))}
    app = port_create_app(data_dir=data_dir, overrides=template)
    try:
        c = app.test_client()
        _login(c, ADMIN_PHONE)
        r = c.post("/api/admin/config-center/save", json_body={
            "updates": {"ENGINE_MAX_CHAINED_DECODES": 3}})
        assert r.get_json()["applied"] == {"ENGINE_MAX_CHAINED_DECODES": 3}
    finally:
        app.state.shutdown()
    settings = _settings(tiny_npz)
    app = port_create_app(data_dir=data_dir, overrides=settings,
                          device="cpu")
    try:
        eng = app.state.gateway.engines["dv-tiny-test"]
        assert app.state.resolver.source("ENGINE_PREFILL_CHUNK_SIZE") \
            == "config"
        assert app.state.resolver.source("ENGINE_MAX_CHAINED_DECODES") \
            == "runtime"
        assert eng.cfg.prefill_chunk_size == 32
        assert eng.cfg.max_chained_decodes == 3
        assert eng.cfg.max_slots == 2 and eng.device.type == "cpu"
        # the app's metrics hook is the gateway's
        assert app.state.gateway.metrics_hook == app.state.metrics.record_ai_call
    finally:
        app.state.shutdown()


def test_engine_mode_needs_cuda_unless_asked_for_cpu(tiny_npz, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_create_app(data_dir=str(tmp_path / "engine"),
                        overrides=_settings(tiny_npz))
    # template mode builds no engine and runs without a card
    app = port_create_app(data_dir=str(tmp_path / "template"),
                          overrides={"AI_MODE": "template"})
    try:
        assert app.state.gateway.mode == "template"
        assert app.state.gateway.engines == {}
        status = app.test_client().get("/api/status").get_json()
        assert status["ai_mode"] == "template"
    finally:
        app.state.shutdown()
