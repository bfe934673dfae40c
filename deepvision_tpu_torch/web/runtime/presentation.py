"""Presentation (Refly) workflow integration.

Re-implements the reference's external presentation pipeline
(web/server.py:33399-34152): upload the report to a Refly workflow, poll
execution, score/select the best candidate PDF, download + cache it, with
abort support.  Feature-flagged per user level and gated on REFLY_API_URL
(zero-egress deployments simply never enable it).  State persists in
``presentation_map_store`` so polling survives restarts.
"""

from __future__ import annotations

import json
import threading
import time

from deepvision_tpu_torch.web.meta_index import utc_now_iso


class PresentationService:
    def __init__(self, state):
        self.state = state
        self._threads = {}
        self._abort_flags = {}
        self._lock = threading.Lock()

    # -- persistence -----------------------------------------------------
    def _save(self, report_name: str, payload: dict) -> None:
        payload["updated_at"] = utc_now_iso()
        self.state.meta.kv_set(
            "presentation_map_store", "report_name", report_name,
            "payload", json.dumps(payload, ensure_ascii=False),
        )

    def status(self, report_name: str) -> dict:
        raw = self.state.meta.kv_get(
            "presentation_map_store", "report_name", report_name, "payload"
        )
        if raw is None:
            return {"active": False, "state": "idle"}
        try:
            return json.loads(raw)
        except json.JSONDecodeError:
            return {"active": False, "state": "idle"}

    # -- workflow --------------------------------------------------------
    def start(self, report_name: str, content: str) -> dict:
        cfg = self.state.resolver
        api_url = cfg.get_str("REFLY_API_URL")
        current = self.status(report_name)
        if current.get("active"):
            return current
        payload = {"active": True, "state": "submitting", "report_name":
                   report_name, "started_at": utc_now_iso(),
                   "mode": "refly" if api_url else "local"}
        self._save(report_name, payload)
        with self._lock:
            self._abort_flags[report_name] = threading.Event()
            t = threading.Thread(
                target=self._run if api_url else self._run_local,
                args=(report_name, content),
                daemon=True, name=f"dv-refly-{report_name[:16]}",
            )
            self._threads[report_name] = t
            t.start()
        return payload

    def _run_local(self, report_name: str, content: str) -> None:
        """Local presentation: no external workflow needed (the reference
        is dead without Refly; zero-egress deployments get a slide-deck
        PDF rendered in-process from the report's own structure)."""
        try:
            self._save(report_name, {"active": True, "state": "running",
                                     "mode": "local"})
            pdf = build_presentation_pdf(content, title=report_name)
            from deepvision_tpu_torch.web.object_storage import (
                ObjectStorageHistoryService,
            )

            storage = ObjectStorageHistoryService(self.state)
            key = storage.archive_export(
                report_name, f"local-{int(time.time())}",
                f"{report_name}.presentation.pdf", pdf,
            )
            self._save(report_name, {
                "active": False, "state": "completed", "mode": "local",
                "storage_key": key,
                "candidate": {"score": 1.0, "pages": content.count("## ")
                              + 2, "source": "local"},
            })
        except Exception as e:  # noqa: BLE001
            try:
                self._save(report_name, {
                    "active": False, "state": "failed", "mode": "local",
                    "error": f"{type(e).__name__}: {e}",
                })
            except Exception:  # noqa: BLE001
                # app torn down mid-run (tests, shutdown): the store is
                # gone — nothing left to record the failure into
                pass
        finally:
            with self._lock:
                self._threads.pop(report_name, None)
                self._abort_flags.pop(report_name, None)

    def abort(self, report_name: str) -> dict:
        with self._lock:
            flag = self._abort_flags.get(report_name)
        if flag is not None:
            flag.set()
            self._save(report_name, {"active": False, "state": "aborted"})
            return {"ok": True, "aborted": True}
        return {"ok": True, "aborted": False}

    def _run(self, report_name: str, content: str) -> None:
        import requests

        cfg = self.state.resolver
        api_url = cfg.get_str("REFLY_API_URL").rstrip("/")
        headers = {}
        if cfg.get_str("REFLY_API_KEY"):
            headers["Authorization"] = f"Bearer {cfg.get_str('REFLY_API_KEY')}"
        flag = self._abort_flags[report_name]
        try:
            # 1. run workflow (reference run_refly_workflow :33497)
            resp = requests.post(
                f"{api_url}/workflows/run",
                json={"input": {"markdown": content,
                                "title": report_name}},
                headers=headers, timeout=30,
            )
            resp.raise_for_status()
            execution_id = resp.json().get("execution_id")
            self._save(report_name, {
                "active": True, "state": "running",
                "execution_id": execution_id,
            })
            # 2. poll execution (reference poll_refly_execution :33516)
            deadline = time.time() + 600
            result = None
            while time.time() < deadline and not flag.is_set():
                time.sleep(5)
                poll = requests.get(
                    f"{api_url}/executions/{execution_id}",
                    headers=headers, timeout=15,
                )
                poll.raise_for_status()
                data = poll.json()
                if data.get("status") in ("succeeded", "failed"):
                    result = data
                    break
            if flag.is_set():
                return
            if not result or result.get("status") != "succeeded":
                self._save(report_name, {
                    "active": False, "state": "failed",
                    "error": (result or {}).get("error", "timeout"),
                })
                return
            # 3. select best candidate (reference
            #    select_best_refly_candidate :33835): prefer highest score,
            #    break ties by page count.
            candidates = result.get("outputs", [])
            best = None
            for c in candidates:
                score = (c.get("score") or 0, c.get("pages") or 0)
                if best is None or score > (
                    best.get("score") or 0, best.get("pages") or 0
                ):
                    best = c
            if not best or not best.get("url"):
                self._save(report_name, {
                    "active": False, "state": "failed",
                    "error": "no usable candidate",
                })
                return
            # 4. download + archive
            pdf = requests.get(best["url"], headers=headers, timeout=60)
            pdf.raise_for_status()
            from deepvision_tpu_torch.web.object_storage import (
                ObjectStorageHistoryService,
            )

            storage = ObjectStorageHistoryService(self.state)
            key = storage.archive_export(
                report_name, f"refly-{int(time.time())}",
                f"{report_name}.presentation.pdf", pdf.content,
            )
            self._save(report_name, {
                "active": False, "state": "completed",
                "storage_key": key,
                "candidate": {k: best.get(k) for k in
                              ("score", "pages", "url")},
            })
        except Exception as e:  # noqa: BLE001
            try:
                self._save(report_name, {
                    "active": False, "state": "failed",
                    "error": f"{type(e).__name__}: {e}",
                })
            except Exception:  # noqa: BLE001
                pass  # store already torn down (shutdown mid-poll)
        finally:
            with self._lock:
                self._threads.pop(report_name, None)
                self._abort_flags.pop(report_name, None)


def build_presentation_pdf(markdown: str, title: str = "") -> bytes:
    """Slide-structured PDF from a report: cover + one slide per H2
    section (title + first bullets/sentences), closing slide.  Reuses the
    from-scratch CJK PDF writer in runtime/exports.py."""
    import re as _re

    from deepvision_tpu_torch.web.runtime.exports import markdown_to_pdf

    sections = []
    current = None
    for line in markdown.splitlines():
        m = _re.match(r"^##\s+(.*)", line)
        if m:
            if current:
                sections.append(current)
            current = {"title": m.group(1).strip(), "lines": []}
        elif current is not None and line.strip() and \
                not line.startswith("#") and not line.startswith("```"):
            if len(current["lines"]) < 6:
                current["lines"].append(line.strip()[:80])
    if current:
        sections.append(current)

    deck = [f"# {title or '方案演示'}", "", "---", ""]
    for s in sections:
        deck += [f"# {s['title']}", ""]
        for ln in s["lines"]:
            deck.append(f"- {ln}" if not ln.startswith("-") else ln)
        deck += ["", "---", ""]
    deck += ["# 谢谢", "", "- 由 DeepVision TPU 引擎本地生成"]
    return markdown_to_pdf("\n".join(deck), title=title or "presentation")
