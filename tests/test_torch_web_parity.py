"""The port's app against the JAX app, side by side, in template mode.

* **Differential lifecycle.**  One scripted request sequence (auth,
  sessions, next-question, submit-answer, undo, documents, generate-report
  and its status, the reports list, exports, solution and share, the admin
  config centre, metrics) goes through ``deepvision_tpu.web.server`` and
  ``deepvision_tpu_torch.web.server`` with the same settings; each request
  waits for the background question prefetches and summaries it started,
  so that the next one finds the same state in both apps.  Status codes
  compare equal, and JSON bodies compare equal once the values that
  differ between any two runs of one app are replaced by placeholders
  (:func:`normalise`): the data dir, session ids, report file names, share
  tokens, export asset ids and ISO or minute timestamps wherever they
  occur, and the values under the keys in ``VOLATILE_KEYS`` (latencies,
  latency percentiles, stage timings, durations, clock readings and file
  signatures, which hold a modification time).  Text bodies (the report's
  markdown) are compared whole with the same replacements; a docx export
  by its ``word/document.xml``.
* **Route table.**  Both apps register the same (method, rule) set.
* **Data-dir interchange.**  A session and a report that one app wrote are
  listed and read by the other over HTTP, both ways.
* **Static bytes.**  Both apps serve equal bytes for ``/``, ``js/app.js``
  and ``css/app.css``.
"""

import io
import json
import re
import tempfile
import threading
import zipfile

import pytest

from deepvision_tpu.web.server import create_app as jax_create_app
from deepvision_tpu_torch.web.server import create_app as port_create_app

ADMIN_PHONE = "13800000001"
USER_PHONE = "13900000201"
SETTINGS = {
    "AI_MODE": "template",
    "SMS_PROVIDER": "mock",
    "SMS_TEST_CODE": "666666",
    "DEBUG_MODE": True,
    "ADMIN_PHONE_NUMBERS": ADMIN_PHONE,
    "SMS_SEND_COOLDOWN_SECONDS": 0,
    "SMS_DAILY_CAP": 1000,
}
DOC = ("# 仓储系统背景\n\n三个区域仓与一个中心仓，出入库依赖纸质单据。\n\n"
       "## 痛点\n\n- 盘点差异大\n- 补货靠经验\n\n"
       + "门店补货决策依赖人工经验，数据分散在三套系统中。\n\n" * 40)

# keys whose values are clock readings, latencies or durations
VOLATILE_KEYS = {
    "created_at", "updated_at", "started_at", "finished_at", "completed_at",
    "queued_at", "expires_at", "activated_at", "generated_at", "timestamp",
    "last_login_at", "shared_at", "last_updated", "elapsed_ms",
    "latency_ms", "duration_ms", "elapsed_s", "duration_s", "ms", "avg_ms",
    "p50_ms", "p95_ms", "p99_ms", "max_ms", "min_ms", "total_ms",
    "mean_ms", "window_s", "uptime_s", "ewma_ms", "last_ms", "p50", "p95",
    "p99", "file_signature", "runtime_timings",
}
SID_RE = re.compile(r"dv-\d{14}-[0-9a-f]{8}")
ISO_RE = re.compile(r"\d{4}-\d{2}-\d{2}[T ]\d{2}:\d{2}(:\d{2}(\.\d+)?)?Z?")
COMPACT_TS_RE = re.compile(
    r"(?<!\d)20\d{12}(?!\d)|(?<!\d)20\d{6}(_\d{6})?(?!\d)")


def normalise(value, names):
    """``value`` with the run's own ids and clock readings replaced:
    every string in ``names`` (value -> placeholder) wherever it occurs,
    session ids, ISO and minute timestamps, compact dates and date-times
    (``20261017``, ``20261017123456``) and the
    values under :data:`VOLATILE_KEYS`."""
    if isinstance(value, dict):
        return {normalise(k, names): ("<volatile>" if k in VOLATILE_KEYS
                                      else normalise(v, names))
                for k, v in value.items()}
    if isinstance(value, list):
        return [normalise(v, names) for v in value]
    if isinstance(value, str):
        for real, placeholder in sorted(names.items(),
                                        key=lambda kv: -len(kv[0])):
            value = value.replace(real, placeholder)
        value = SID_RE.sub("<sid>", value)
        value = ISO_RE.sub("<ts>", value)
        return COMPACT_TS_RE.sub("<ts>", value)
    return value


def settle(timeout_s=120.0):
    """Wait for the app's background question prefetches and session
    summaries, so that the next request sees the same state in both
    apps."""
    for t in threading.enumerate():
        if t.name.startswith(("dv-prefetch-", "dv-summary-")):
            t.join(timeout_s)
            assert not t.is_alive(), t.name


def _login(c, phone):
    assert c.post("/api/auth/sms/send-code",
                  json_body={"phone": phone}).status_code == 200
    r = c.post("/api/auth/login/code",
               json_body={"phone": phone, "code": "666666"})
    assert r.status_code == 200, r.text
    return r.get_json()["user"]


def drive(create_app, data_dir, **kw):
    """The scripted sequence on a fresh app; one (step, status, body) per
    request, bodies normalised."""
    app = create_app(data_dir=data_dir, overrides=dict(SETTINGS), **kw)
    c = app.test_client()
    names = {data_dir: "<data_dir>"}
    out = []

    def step(name, method, path, **req):
        r = c.open(path, method, **req)
        settle()
        body = r.get_json()
        if body is None:
            ctype = r.headers.get("Content-Type", "")
            body = {"content_type": ctype, "bytes": len(r.data)}
            if ctype.startswith("text/"):
                body["text"] = r.data.decode("utf-8")
            if r.data[:2] == b"PK":      # docx: the document's text parts
                with zipfile.ZipFile(io.BytesIO(r.data)) as z:
                    body["document"] = z.read(
                        "word/document.xml").decode("utf-8")
        out.append((name, r.status_code, body))
        return r.status_code, body

    try:
        step("status", "GET", "/api/status")
        step("me_anonymous", "GET", "/api/auth/me")
        step("sessions_anonymous", "GET", "/api/sessions")
        user = _login(c, USER_PHONE)
        step("me", "GET", "/api/auth/me")
        # the admin raises the user to professional (exports, solution)
        c.post("/api/auth/logout")
        _login(c, ADMIN_PHONE)
        step("set_level", "PUT", f"/api/admin/users/{user['user_id']}/level",
             json_body={"level": "professional"})
        c.post("/api/auth/logout")
        _login(c, USER_PHONE)
        step("scenarios", "GET", "/api/scenarios")
        _, sess = step("create_session", "POST", "/api/sessions", json_body={
            "topic": "仓储管理系统选型", "scenario_id": "product-requirement",
            "interview_mode": "quick",
            "description": "覆盖三个区域仓与一个中心仓的出入库流程"})
        sid = SID_RE.search(json.dumps(sess)).group(0)
        names[sid] = "<sid>"
        step("upload_doc", "POST", f"/api/sessions/{sid}/documents",
             files={"file": ("背景说明.md", DOC.encode("utf-8"),
                             "text/markdown")})
        step("undo_empty", "POST", f"/api/sessions/{sid}/undo-answer",
             json_body={})
        for turn in range(3):
            _, q = step(f"next_question_{turn}", "POST",
                        f"/api/sessions/{sid}/next-question", json_body={})
            step(f"submit_answer_{turn}", "POST",
                 f"/api/sessions/{sid}/submit-answer", json_body={
                     "question": q["question"],
                     "answer": f"第{turn}轮：我们有三套系统，因为数据分散，"
                               "例如报表需要手工汇总",
                     "dimension": q.get("dimension"),
                     "options": q.get("options")})
            if turn == 1:
                step("undo", "POST", f"/api/sessions/{sid}/undo-answer",
                     json_body={})
        step("assistant_chat", "POST",
             f"/api/sessions/{sid}/interview-assistant-chat",
             json_body={"message": "这个问题我该怎么回答？"})
        step("session", "GET", f"/api/sessions/{sid}")
        step("sessions", "GET", "/api/sessions")
        step("readiness", "GET", f"/api/sessions/{sid}/report-readiness")
        step("thinking", "GET", f"/api/status/thinking/{sid}")
        step("generate_report", "POST", f"/api/sessions/{sid}/generate-report",
             json_body={"force": True})
        app.state.report_queue.drain()
        _, status = step("report_status", "GET",
                         f"/api/status/report-generation/{sid}")
        rep = status["report_name"]
        names[rep] = "<report>"
        step("reports", "GET", "/api/reports")
        step("report", "GET", f"/api/reports/{rep}")
        _, asset = step("export_docx", "POST", f"/api/reports/{rep}/exports",
                        json_body={"format": "docx"})
        names[asset["asset_id"]] = "<asset>"
        step("export_list", "GET", f"/api/reports/{rep}/exports")
        step("export_download", "GET",
             f"/api/reports/{rep}/exports/{asset['asset_id']}")
        step("export_bad_format", "POST", f"/api/reports/{rep}/exports",
             json_body={"format": "exe"})
        step("solution", "GET", f"/api/reports/{rep}/solution")
        _, share = step("share", "POST", f"/api/reports/{rep}/solution/share",
                        json_body={})
        names[share["share_token"]] = "<share>"
        step("share_again", "POST", f"/api/reports/{rep}/solution/share",
             json_body={})
        c.post("/api/auth/logout")
        step("public_solution", "GET",
             f"/api/public/solutions/{share['share_token']}")
        step("public_solution_missing", "GET",
             "/api/public/solutions/not-a-token")
        _login(c, ADMIN_PHONE)
        step("config_center", "GET", "/api/admin/config-center")
        step("config_save", "POST", "/api/admin/config-center/save",
             json_body={"updates": {"QUESTION_MAX_PENDING": 20,
                                    "NOT_ALLOWED_KEY": 1}})
        step("config_center_after", "GET", "/api/admin/config-center")
        step("metrics", "GET", "/api/metrics")
        step("summaries", "GET", "/api/summaries")
        c.post("/api/auth/logout")
        _login(c, USER_PHONE)
        step("delete_doc", "DELETE",
             f"/api/sessions/{sid}/documents/背景说明.md")
        step("delete_report", "DELETE", f"/api/reports/{rep}")
        step("delete_session", "DELETE", f"/api/sessions/{sid}")
        step("sessions_after", "GET", "/api/sessions")
    finally:
        app.state.shutdown()
    return [(name, status, normalise(body, names))
            for name, status, body in out]


def test_lifecycle_responses_equal_the_jax_app():
    runs = []
    for create_app, kw in ((jax_create_app, {}),
                           (port_create_app, {"device": "cpu"})):
        with tempfile.TemporaryDirectory() as tmp:
            runs.append(drive(create_app, tmp, **kw))
    jax_run, port_run = runs
    assert [s[:2] for s in port_run] == [s[:2] for s in jax_run]
    for got, want in zip(port_run, jax_run):
        assert got == want, got[0]
    statuses = dict(s[:2] for s in port_run)
    assert statuses["generate_report"] == 202
    assert statuses["export_docx"] == 201
    assert port_run[[s[0] for s in port_run].index("report_status")][2][
        "state"] == "completed"


def _routes(app):
    return {(m, rule) for _, methods, _, rule in app._routes  # noqa: SLF001
            for m in methods}


def test_route_tables_equal():
    tables = []
    for create_app, kw in ((jax_create_app, {}),
                           (port_create_app, {"device": "cpu"})):
        with tempfile.TemporaryDirectory() as tmp:
            app = create_app(data_dir=tmp, overrides=dict(SETTINGS), **kw)
            tables.append(_routes(app))
            app.state.shutdown()
    assert tables[0] == tables[1]
    assert len(tables[1]) >= 98


def _write_session_and_report(create_app, data_dir, **kw):
    app = create_app(data_dir=data_dir, overrides=dict(SETTINGS), **kw)
    c = app.test_client()
    try:
        _login(c, USER_PHONE)
        r = c.post("/api/sessions", json_body={
            "topic": "互通测试", "scenario_id": "product-requirement",
            "interview_mode": "quick"})
        sid = r.get_json()["session_id"]
        q = c.post(f"/api/sessions/{sid}/next-question",
                   json_body={}).get_json()
        assert c.post(f"/api/sessions/{sid}/submit-answer", json_body={
            "question": q["question"], "answer": "我们有三套系统，因为数据分散",
            "dimension": q.get("dimension")}).status_code == 200
        settle()
        assert c.post(f"/api/sessions/{sid}/generate-report",
                      json_body={"force": True}).status_code == 202
        app.state.report_queue.drain()
        status = c.get(f"/api/status/report-generation/{sid}").get_json()
        assert status["state"] == "completed", status
        return (sid, status["report_name"],
                c.get(f"/api/sessions/{sid}").get_json(),
                c.get(f"/api/reports/{status['report_name']}").get_json())
    finally:
        app.state.shutdown()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_data_dir_written_by_one_app_opens_in_the_other(writer, reader):
    apps = {"jax": (jax_create_app, {}),
            "port": (port_create_app, {"device": "cpu"})}
    with tempfile.TemporaryDirectory() as tmp:
        create_app, kw = apps[writer]
        sid, rep, session, report = _write_session_and_report(
            create_app, tmp, **kw)
        create_app, kw = apps[reader]
        app = create_app(data_dir=tmp, overrides=dict(SETTINGS), **kw)
        c = app.test_client()
        try:
            _login(c, USER_PHONE)
            sessions = c.get("/api/sessions").get_json()
            assert sid in json.dumps(sessions)
            reports = c.get("/api/reports").get_json()
            assert rep in json.dumps(reports, ensure_ascii=False)
            assert c.get(f"/api/sessions/{sid}").get_json() == session
            assert c.get(f"/api/reports/{rep}").get_json() == report
        finally:
            app.state.shutdown()


@pytest.mark.parametrize("path", ["/", "/js/app.js", "/css/app.css"])
def test_static_bytes_equal(path):
    bodies = []
    for create_app, kw in ((jax_create_app, {}),
                           (port_create_app, {"device": "cpu"})):
        with tempfile.TemporaryDirectory() as tmp:
            app = create_app(data_dir=tmp, overrides=dict(SETTINGS), **kw)
            r = app.test_client().get(path)
            bodies.append((r.status_code, r.headers.get("Content-Type"),
                           r.data))
            app.state.shutdown()
    assert bodies[0] == bodies[1]
    assert bodies[1][0] == 200 and len(bodies[1][2]) > 1000
