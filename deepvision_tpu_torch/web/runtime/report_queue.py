"""Async report generation queue + status machine.

Re-implements the reference job queue (ThreadPoolExecutor workers=2,
pending slots=16, web/server.py:565-571/4276-4280, run_report_generation_job
report_generation_runtime.py:1262) and the status payload contract
(stages :4290-4298, detail states :4300-4315, poll payload :13549-13607).
"""

from __future__ import annotations

import json
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

from deepvision_tpu_torch.web.meta_index import MetaIndex, utc_now_iso
from deepvision_tpu_torch.web.runtime import report_v3
from deepvision_tpu_torch.web.stores import (
    ReportStore,
    SessionStore,
    build_session_report_filename,
)

STAGES = [
    "queued", "building_prompt", "generating", "fallback", "saving",
    "completed", "failed",
]
STAGE_LABELS = {
    "queued": "排队中",
    "building_prompt": "整理访谈证据",
    "generating": "AI 生成报告中",
    "fallback": "降级生成中",
    "saving": "保存报告",
    "completed": "已完成",
    "failed": "生成失败",
}
TOTAL_STAGES = 6


class ReportJobQueue:
    def __init__(
        self,
        gateway,
        sessions: SessionStore,
        reports: ReportStore,
        meta: MetaIndex,
        *,
        max_workers: int = 2,
        max_pending: int = 16,
        metrics=None,
        test_delay_s: float = 0.0,
    ):
        self.gateway = gateway
        self.sessions = sessions
        self.reports = reports
        self.meta = meta
        self.metrics = metrics
        self.test_delay_s = test_delay_s
        self.max_pending = max_pending
        self._executor = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="dv-report"
        )
        self._pending = threading.BoundedSemaphore(max_pending)
        self._lock = threading.Lock()
        self._status: Dict[str, dict] = {}
        self._futures: Dict[str, object] = {}
        self.running = 0
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0

    # -- status ----------------------------------------------------------
    def _set_status(self, session_id: str, **kw) -> None:
        with self._lock:
            st = self._status.setdefault(session_id, {})
            st.update(kw, updated_at=utc_now_iso())
            snapshot = dict(st)
        self.meta.kv_set(
            "report_generation_status_store", "session_id", session_id,
            "payload", json.dumps(snapshot, ensure_ascii=False),
        )

    def status_payload(self, session_id: str) -> dict:
        """Poll payload (reference build_report_generation_payload
        :13549-13607)."""
        with self._lock:
            st = dict(self._status.get(session_id) or {})
        if not st:
            raw = self.meta.kv_get(
                "report_generation_status_store", "session_id", session_id,
                "payload",
            )
            if raw:
                try:
                    st = json.loads(raw)
                except json.JSONDecodeError:
                    st = {}
        state = st.get("state", "idle")
        stage_index = STAGES.index(state) if state in STAGES else 0
        pending = self.max_pending - self._pending._value  # noqa: SLF001
        payload = {
            "active": state not in ("idle", "completed", "failed"),
            "processing": state in ("building_prompt", "generating",
                                    "fallback", "saving"),
            "state": state,
            "stage_index": min(stage_index, TOTAL_STAGES - 1),
            "total_stages": TOTAL_STAGES,
            "progress": round(
                min(1.0, stage_index / max(1, TOTAL_STAGES - 1)), 2
            ),
            "message": st.get("message", STAGE_LABELS.get(state, "")),
            "stage_label": STAGE_LABELS.get(state, state),
            "updated_at": st.get("updated_at"),
            "request_id": st.get("request_id"),
            "action": st.get("action", "generate"),
            "started_at": st.get("started_at"),
            "completed_at": st.get("completed_at"),
            "report_name": st.get("report_name"),
            "report_path": st.get("report_path"),
            "ai_generated": st.get("ai_generated", True),
            "v3_enabled": True,
            "report_profile": st.get("report_profile"),
            "source_report_name": st.get("source_report_name"),
            "report_variant_label": st.get("report_variant_label"),
            "error": st.get("error"),
            "queue_position": st.get("queue_position", 0),
            "queue_pending": max(0, pending),
            "queue_running": self.running,
            "estimated_wait_seconds": max(0, pending) * 20,
        }
        if st.get("report_quality_meta"):
            payload["report_quality_meta"] = st["report_quality_meta"]
        if st.get("runtime_timings"):
            payload["runtime_timings"] = st["runtime_timings"]
        return payload

    def queue_snapshot(self) -> dict:
        return {
            "pending_slots": self._pending._value,  # noqa: SLF001
            "max_pending": self.max_pending,
            "running": self.running,
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "rejected": self.rejected,
        }

    # -- submission ------------------------------------------------------
    def submit(self, session_id: str, *, profile: str = "balanced",
               owner_user_id=None, instance_scope: str = "default",
               request_id: str = "") -> bool:
        """False => queue full (caller maps to 429)."""
        if not self._pending.acquire(blocking=False):
            self.rejected += 1
            return False
        self.submitted += 1
        self._set_status(
            session_id, state="queued", request_id=request_id,
            started_at=utc_now_iso(), report_profile=profile, error=None,
            report_name=None, completed_at=None,
        )
        fut = self._executor.submit(
            self._run_job, session_id, profile, owner_user_id, instance_scope
        )
        with self._lock:
            self._futures[session_id] = fut
        return True

    # -- job -------------------------------------------------------------
    def _run_job(self, session_id: str, profile: str, owner_user_id,
                 instance_scope: str) -> None:
        self.running += 1
        try:
            if self.test_delay_s:
                time.sleep(self.test_delay_s)
            session = self.sessions.load(session_id)
            if session is None:
                self._set_status(session_id, state="failed",
                                 error="session not found")
                self.failed += 1
                return
            self._set_status(session_id, state="building_prompt")

            def status_cb(stage: str):
                if stage in ("draft", "review"):
                    self._set_status(session_id, state="generating",
                                     message=STAGE_LABELS["generating"])

            self._set_status(session_id, state="generating")
            result = report_v3.generate_report_v3(
                self.gateway, session, profile=profile,
                status_cb=status_cb, metrics=self.metrics,
            )
            if result.path != "v3":
                self._set_status(session_id, state="fallback")

            self._set_status(session_id, state="saving")
            report_name = build_session_report_filename(
                session.get("topic", ""), session_id,
                variant=profile if profile != "balanced" else "",
            )
            self.reports.save(
                report_name, result.markdown,
                owner_user_id=owner_user_id, instance_scope=instance_scope,
                session_id=session_id, topic=session.get("topic", ""),
                report_profile=profile,
            )
            # bind report to session (reference persist_report
            # report_generation_runtime.py:1385-1419)
            session["current_report_name"] = report_name
            session["last_report_name"] = report_name
            session["current_report_updated_at"] = utc_now_iso()
            session["last_report_quality_meta"] = result.quality
            session["status"] = "completed"
            self.sessions.save(session)

            self._set_status(
                session_id, state="completed", report_name=report_name,
                report_path=self.reports.path(report_name),
                completed_at=utc_now_iso(),
                report_quality_meta=result.quality,
                runtime_timings=result.timings,
                ai_generated=result.path == "v3",
            )
            self.completed += 1
        except Exception as e:  # noqa: BLE001
            self._set_status(
                session_id, state="failed",
                error=f"{type(e).__name__}: {e}",
            )
            self.failed += 1
            traceback.print_exc()
        finally:
            self.running -= 1
            self._pending.release()

    # -- test helper (reference _drain_report_generation_workers) --------
    def drain(self, timeout: float = 30.0) -> None:
        deadline = time.time() + timeout
        with self._lock:
            futures = list(self._futures.values())
        for fut in futures:
            fut.result(timeout=max(0.1, deadline - time.time()))

    def shutdown(self) -> None:
        self._executor.shutdown(wait=False)
