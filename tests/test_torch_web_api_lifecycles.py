"""The JAX app's lifecycle tests (``tests/test_api_lifecycles.py``)
against the port's app.

Every test of that module is imported here and runs unchanged: its
fixtures and helpers (``client``, ``_mkapp``) build the app through the
module global ``test_api_lifecycles.create_app``, which the autouse
fixture below points at the port's ``create_app(..., device="cpu")`` for
the length of each test.  No test of that module calls the JAX package in
its own body.  One is left out because its result depends on the wall
clock: ``test_retrigger_returns_active_payload_not_duplicate`` holds the
first report job for 0.6 s and needs the second request inside that
window.  Its counterpart below holds the job until the second request has
been answered.
"""

import threading
import types

import pytest

import test_api_lifecycles
from test_api_lifecycles import *  # noqa: F401,F403
from test_api_lifecycles import answer_once, login, make_session

from deepvision_tpu_torch.web.runtime import report_queue
from deepvision_tpu_torch.web.server import create_app as port_create_app

del test_retrigger_returns_active_payload_not_duplicate  # noqa: F821

BUILT = []


def _port_create_app(*args, **kwargs):
    app = port_create_app(*args, device="cpu", **kwargs)
    BUILT.append(type(app.state).__module__)
    return app


@pytest.fixture(autouse=True)
def _port_app(monkeypatch):
    monkeypatch.setattr(test_api_lifecycles, "create_app", _port_create_app)
    BUILT.clear()
    yield
    assert set(BUILT) <= {"deepvision_tpu_torch.web.server"}, BUILT


def test_port_retrigger_returns_active_payload_not_duplicate(client,
                                                             monkeypatch):
    """A second generate-report while the first job runs answers with the
    active job's payload and submits nothing; the job is held (where the
    queue's test delay sleeps) until that answer is in."""
    login(client, "13900000066")
    sid = make_session(client)["session_id"]
    answer_once(client, sid)
    queue = client.app.state.report_queue
    release = threading.Event()
    monkeypatch.setattr(report_queue, "time", types.SimpleNamespace(
        sleep=lambda s: release.wait(60), time=report_queue.time.time,
        monotonic=report_queue.time.monotonic))
    monkeypatch.setattr(queue, "test_delay_s", 1.0)
    try:
        r1 = client.post(f"/api/sessions/{sid}/generate-report",
                         json_body={"force": True})
        assert r1.status_code == 202
        submitted_before = queue.submitted
        r2 = client.post(f"/api/sessions/{sid}/generate-report",
                         json_body={"force": True})
        assert r2.status_code == 200, r2.text
        body = r2.get_json()
        assert body["already_active"] is True
        assert body["state"] in ("queued", "building_prompt", "generating")
        assert queue.submitted == submitted_before  # no second job
    finally:
        release.set()
    queue.drain()
    assert queue.status_payload(sid)["state"] == "completed"
