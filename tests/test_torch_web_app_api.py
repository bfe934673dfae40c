"""The JAX app's HTTP tests (``tests/test_app_api.py``) against the port's
app.

Every test of that module is imported here and runs unchanged: its
``client`` fixture builds the app through the module global
``test_app_api.create_app``, which the autouse fixture below points at the
port's ``create_app(..., device="cpu")`` for the length of each test.
Three tests call the JAX package in their own bodies and are left out;
their counterparts below call the port's modules instead.
"""

import io

import pytest

import test_app_api
from test_app_api import *  # noqa: F401,F403
from test_app_api import login, make_session

from deepvision_tpu_torch.web.server import create_app as port_create_app

del pytestmark  # noqa: F821 — the smoke tier stays the JAX app's
# their bodies import deepvision_tpu.web.runtime.*; counterparts below
del test_docx_upload_roundtrip  # noqa: F821
del test_image_upload_degraded_caption  # noqa: F821
del test_evidence_ledger_and_preflight  # noqa: F821

BUILT = []


def _port_create_app(*args, **kwargs):
    app = port_create_app(*args, device="cpu", **kwargs)
    BUILT.append(type(app.state).__module__)
    return app


@pytest.fixture(autouse=True)
def _port_app(monkeypatch):
    monkeypatch.setattr(test_app_api, "create_app", _port_create_app)
    BUILT.clear()
    yield
    assert set(BUILT) <= {"deepvision_tpu_torch.web.server"}, BUILT


def test_port_docx_upload_roundtrip(client):
    from deepvision_tpu_torch.web.runtime.exports import markdown_to_docx

    login(client)
    sid = make_session(client)["session_id"]
    docx_bytes = markdown_to_docx("# 标题\n\n这是正文段落。\n\n- 列表项一")
    r = client.post(
        f"/api/sessions/{sid}/documents",
        files={"file": ("需求文档.docx", docx_bytes,
                        "application/vnd.openxmlformats-officedocument"
                        ".wordprocessingml.document")},
    )
    assert r.status_code == 200, r.text
    assert "正文段落" in r.get_json()["document"]["content"]
    assert BUILT == ["deepvision_tpu_torch.web.server"]


def test_port_image_upload_degraded_caption(client):
    from PIL import Image

    from deepvision_tpu_torch.web.runtime.interview import build_doc_context

    login(client)
    sid = make_session(client)["session_id"]
    buf = io.BytesIO()
    Image.new("RGB", (1920, 600), (40, 90, 200)).save(buf, format="PNG")
    r = client.open(f"/api/sessions/{sid}/documents", method="POST",
                    files={"file": ("flow.png", buf.getvalue(), "image/png")})
    assert r.status_code == 200, r.text
    doc = r.get_json()["document"]
    assert doc["kind"] == "image"
    assert doc["vision_mode"] == "degraded_caption"
    assert "1920x600" in doc["content"] and "宽幅" in doc["content"]
    sess = client.get(f"/api/sessions/{sid}").get_json()
    assert any(d.get("kind") == "image"
               for d in sess["reference_materials"])
    assert "flow.png" in build_doc_context(sess["reference_materials"])


def test_port_evidence_ledger_and_preflight(client):
    from deepvision_tpu_torch.web.runtime.followup import (
        backfill_evidence_annotations,
        build_evidence_ledger,
        plan_preflight_probes,
    )

    login(client)
    sid = make_session(client)["session_id"]
    q = client.post(f"/api/sessions/{sid}/next-question",
                    json_body={}).get_json()
    client.post(f"/api/sessions/{sid}/submit-answer", json_body={
        "question": q["question"], "answer": "具体来说我们有三个系统，因为数据分散",
        "dimension": q.get("dimension"), "rationale_text": "例如报表手工汇总",
    })
    sess = client.get(f"/api/sessions/{sid}").get_json()
    assert sess["interview_log"][0].get("evidence_class")
    ledger = build_evidence_ledger(sess)
    assert ledger["overall"] in ("weak", "adequate", "strong")
    assert ledger["dimensions"]
    probes = plan_preflight_probes(sess)
    assert probes and probes[0]["reason"] in (
        "dimension_unvisited", "weak_evidence", "aspect_uncovered",
        "pending_follow_up")
    r = client.get(f"/api/sessions/{sid}/report-readiness")
    assert "evidence_ledger" in r.get_json()
    for e in sess["interview_log"]:
        e.pop("quality_score", None)
        e.pop("evidence_class", None)
    assert backfill_evidence_annotations(sess) == len(sess["interview_log"])
    assert all(e.get("evidence_class") for e in sess["interview_log"])
