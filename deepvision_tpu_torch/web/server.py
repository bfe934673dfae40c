"""Application factory: wires config, stores, engine gateway, runtimes,
and the full ``/api/**`` route surface (compatible with reference
web/server.py's 98 routes, list at SURVEY.md §2.3/§3).

Run: ``python -m deepvision_tpu_torch.web.server --port 8899`` (engine
mode on CUDA; ``--device cpu`` asks for the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import threading
from typing import Dict, Optional

from deepvision_tpu_torch.engine.client import ModelGateway, configure_gateway
from deepvision_tpu_torch.web.authn import AuthService
from deepvision_tpu_torch.web.env import ConfigResolver
from deepvision_tpu_torch.web.gateway import build_gateway
from deepvision_tpu_torch.web.http import App, HTTPError, Request, Response
from deepvision_tpu_torch.web.licensing import LicenseService
from deepvision_tpu_torch.web.meta_index import MetaIndex, utc_now_iso
from deepvision_tpu_torch.web.metrics import MetricsCollector
from deepvision_tpu_torch.web.pagination import EndpointGate
from deepvision_tpu_torch.web.runtime.assistant import AssistantChat
from deepvision_tpu_torch.web.runtime.documents import DocumentPipeline
from deepvision_tpu_torch.web.runtime.interview import (
    QuestionCache,
    TieredQuestionGenerator,
)
from deepvision_tpu_torch.web.runtime.report_queue import ReportJobQueue
from deepvision_tpu_torch.web.runtime.search import SearchService
from deepvision_tpu_torch.web.runtime.solution import SolutionService
from deepvision_tpu_torch.web.scenarios import ScenarioLoader
from deepvision_tpu_torch.web.stores import ReportStore, SessionStore
from deepvision_tpu_torch.version import __version__


class StartupError(RuntimeError):
    pass


class _PrintLogger:
    def info(self, msg):
        print(f"[INFO] {msg}", flush=True)

    def warning(self, msg):
        print(f"[WARN] {msg}", flush=True)

    def error(self, msg):
        print(f"[ERROR] {msg}", flush=True)


class AppState:
    """All services one process needs (the reference kept these as
    module globals in its 45k-line server.py; here they're one object)."""

    def __init__(self, data_dir: Optional[str] = None,
                 overrides: Optional[dict] = None, *, device: str = "cuda"):
        self.device = device
        self.resolver = ConfigResolver()
        self.resolver.load_env_files(os.getcwd())
        for key, value in (overrides or {}).items():
            self.resolver.set_runtime(key, value)
        cfg = self.resolver

        self.data_dir = (
            data_dir
            or os.environ.get("DEEPVISION_DATA_DIR")
            or cfg.get_str("DEEPVISION_DATA_DIR", "data")
        )
        os.makedirs(self.data_dir, exist_ok=True)
        os.makedirs(os.path.join(self.data_dir, "auth"), exist_ok=True)
        os.makedirs(os.path.join(self.data_dir, "operations"), exist_ok=True)

        self.instance_scope = cfg.get_str("INSTANCE_SCOPE_KEY", "default")
        self.debug_mode = cfg.get_bool("DEBUG_MODE", True)
        self.secret_key = cfg.get_str("SECRET_KEY", "dev-secret-change-me")

        self._validate_security_config()

        meta_path = cfg.get_str("META_INDEX_DB_PATH") or os.path.join(
            self.data_dir, "meta_index.sqlite3"
        )
        self.meta = MetaIndex(cfg.get_str("DATABASE_URL") or meta_path)
        # re-apply persisted admin config-center overrides (they must NOT
        # outrank explicit process overrides passed to this constructor)
        from deepvision_tpu_torch.web import config_center as _config_center

        _config_center.restore_runtime_overrides(
            self.resolver, self.meta,
            skip=set(overrides or ()) | set(self.resolver.runtime_snapshot()),
        )
        use_db_payload = bool(cfg.get_str("DATABASE_URL"))
        self.sessions = SessionStore(self.data_dir, self.meta,
                                     use_db_payload=use_db_payload)
        self.reports = ReportStore(self.data_dir, self.meta,
                                   use_db_payload=use_db_payload)

        self.auth = AuthService(
            cfg.get_str("AUTH_DB_PATH") or os.path.join(
                self.data_dir, "auth", "auth.sqlite3"),
            provider=cfg.get_str("SMS_PROVIDER", "mock"),
            test_code=cfg.get_str("SMS_TEST_CODE", ""),
            code_ttl=cfg.get_int("SMS_CODE_TTL_SECONDS", 300),
            send_cooldown=cfg.get_int("SMS_SEND_COOLDOWN_SECONDS", 60),
            daily_cap=cfg.get_int("SMS_DAILY_CAP", 20),
            admin_phones=cfg.get_list("ADMIN_PHONE_NUMBERS"),
            admin_user_ids=cfg.get_list("ADMIN_USER_IDS"),
            logger=_PrintLogger(),
        )
        self.licenses = LicenseService(
            cfg.get_str("LICENSE_DB_PATH") or os.path.join(
                self.data_dir, "auth", "license.sqlite3"),
            self.meta,
            signing_secret=cfg.get_str("LICENSE_CODE_SIGNING_SECRET", ""),
            enforcement_default=cfg.get_bool(
                "LICENSE_ENFORCEMENT_ENABLED", False),
        )

        self.metrics = MetricsCollector(self.meta)
        self.gateway = self._build_gateway()
        configure_gateway(self.gateway)

        self.scenarios = ScenarioLoader(
            self.meta,
            builtin_dir=cfg.get_str("BUILTIN_SCENARIOS_DIR") or None,
            custom_dir=cfg.get_str("CUSTOM_SCENARIOS_DIR")
            or os.path.join(self.data_dir, "custom_scenarios"),
        )
        self.docs = DocumentPipeline(
            self.meta, self.gateway,
            summary_min_chars=cfg.get_int("DOC_SUMMARY_MIN_CHARS", 1400),
            summary_target_chars=cfg.get_int("DOC_SUMMARY_TARGET_CHARS", 700),
            metrics=self.metrics,
        )
        self.search = SearchService(
            self.gateway,
            enabled=cfg.get_bool("WEB_SEARCH_ENABLED", False),
            mcp_url=cfg.get_str("WEB_SEARCH_MCP_URL", ""),
            mcp_key=cfg.get_str("WEB_SEARCH_MCP_KEY", ""),
            metrics=self.metrics,
        )
        self.assistant = AssistantChat(self.gateway)
        self.question_gen = TieredQuestionGenerator(
            self.gateway, self.metrics,
            fast_timeout=cfg.get_float("QUESTION_FAST_TIMEOUT", 8.0),
            fast_max_tokens=cfg.get_int("QUESTION_FAST_MAX_TOKENS", 900),
            fast_prompt_budget=cfg.get_int(
                "QUESTION_FAST_PROMPT_BUDGET", 2200),
        )
        self.question_cache = QuestionCache()
        self.report_queue = ReportJobQueue(
            self.gateway, self.sessions, self.reports, self.meta,
            max_workers=cfg.get_int("REPORT_GENERATION_MAX_WORKERS", 2),
            max_pending=cfg.get_int("REPORT_GENERATION_MAX_PENDING", 16),
            metrics=self.metrics,
            test_delay_s=float(os.environ.get(
                "DEEPVISION_TEST_REPORT_GENERATION_DELAY_SECONDS", "0") or 0),
        )
        self.solution = SolutionService(self.meta, self.reports,
                                        self.sessions,
                                        gateway=self.gateway)

        # question overload guards (reference web/server.py:548-558)
        self.question_inflight = threading.BoundedSemaphore(
            cfg.get_int("QUESTION_MAX_INFLIGHT", 2))
        self.question_pending = threading.BoundedSemaphore(
            cfg.get_int("QUESTION_MAX_PENDING", 10))
        self.question_retry_after = cfg.get_int(
            "QUESTION_RETRY_AFTER_SECONDS", 2)

        # list endpoint gates (reference :5418)
        self.list_gates: Dict[str, EndpointGate] = {
            "sessions": EndpointGate(8),
            "reports": EndpointGate(8),
        }

        # thinking status per session (reference :3940-4018)
        self.thinking: Dict[str, dict] = {}
        self.thinking_lock = threading.Lock()

        # prefetch cache: (session_id) -> {"result":..., "signature":...}
        self.prefetch: Dict[str, dict] = {}
        self.prefetch_lock = threading.Lock()

        self.started_at = utc_now_iso()
        self._persist_startup_snapshot()

    # ------------------------------------------------------------------
    def _validate_security_config(self) -> None:
        """Refuse unsafe prod config (reference
        validate_runtime_security_config web/server.py:2736)."""
        if self.debug_mode:
            return
        if self.secret_key in ("", "dev-secret-change-me"):
            raise StartupError(
                "production mode requires a real SECRET_KEY"
            )
        if self.resolver.get_str("SMS_PROVIDER", "mock") == "mock":
            raise StartupError(
                "production mode refuses SMS_PROVIDER=mock"
            )
        if self.resolver.get_str("SMS_TEST_CODE", ""):
            raise StartupError(
                "production mode refuses a fixed SMS_TEST_CODE"
            )

    def _build_gateway(self) -> ModelGateway:
        """The gateway from the app's resolver: in engine mode its engines
        run on ``self.device`` (``LLMEngine`` raises when CUDA is asked
        for and absent); template mode builds no engine."""
        return build_gateway(self.resolver, device=self.device,
                             metrics_hook=self.metrics.record_ai_call)

    def _persist_startup_snapshot(self) -> None:
        snapshot = {
            "version": __version__,
            "started_at": self.started_at,
            "data_dir": self.data_dir,
            "ai_mode": self.gateway.mode,
            "instance_scope": self.instance_scope,
            "debug_mode": self.debug_mode,
            "env_files": self.resolver.loaded_files,
        }
        self.meta.execute(
            "INSERT INTO startup_snapshot_store (payload, created_at) "
            "VALUES (?, ?)",
            (json.dumps(snapshot, ensure_ascii=False), utc_now_iso()),
        )
        path = os.path.join(self.data_dir, "startup_snapshot.json")
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(snapshot, fh, ensure_ascii=False, indent=1)

    # -- thinking status (reference :3940-4018) -------------------------
    def set_thinking(self, session_id: str, *, active: bool,
                     stage: str = "", stage_index: int = 0,
                     total_stages: int = 4, message: str = "") -> None:
        with self.thinking_lock:
            if len(self.thinking) > 512:  # bound per-session status map
                for key in list(self.thinking)[:128]:
                    self.thinking.pop(key, None)
            self.thinking[session_id] = {
                "active": active,
                "stage": stage,
                "stage_index": stage_index,
                "total_stages": total_stages,
                "message": message,
                "updated_at": utc_now_iso(),
            }

    def get_thinking(self, session_id: str) -> dict:
        with self.thinking_lock:
            return dict(self.thinking.get(session_id) or {
                "active": False, "stage": "", "stage_index": 0,
                "total_stages": 4, "message": "",
            })

    def shutdown(self) -> None:
        self.report_queue.shutdown()
        self.metrics.stop_flusher()
        # presentation render/poll threads write into the stores; join
        # them before the stores go away (bounded — they are daemons)
        pres = getattr(self, "presentations", None)
        if pres is not None:
            for t in list(getattr(pres, "_threads", {}).values()):
                t.join(timeout=15)
        for eng in self.gateway.engines.values():
            eng.shutdown()


# ---------------------------------------------------------------------------
# Auth helpers
# ---------------------------------------------------------------------------

def current_user(state: AppState, req: Request) -> Optional[dict]:
    user_id = req.session.get("user_id")
    if user_id is None:
        return None
    return state.auth.get_user(user_id)


def require_user(state: AppState, req: Request) -> dict:
    user = current_user(state, req)
    if user is None:
        raise HTTPError(401, {"error": "请先登录"})
    return user


def require_admin(state: AppState, req: Request) -> dict:
    user = require_user(state, req)
    if not state.auth.is_admin(user):
        raise HTTPError(403, {"error": "需要管理员权限"})
    return user


# Routes reachable WITHOUT a valid license even under enforcement
# (reference LICENSE_PUBLIC_API_EXACT_PATHS web/server.py:12831-12838 —
# health, the license status/activation pair, and admin bootstrap).
LICENSE_PUBLIC_API_EXACT_PATHS = {
    "/api/status",
    "/api/status/web-search",
    "/api/licenses/current",
    "/api/licenses/activate",
    "/api/admin/licenses/bootstrap/status",
    "/api/admin/licenses/bootstrap",
}


def license_gate_applies(path: str, method: str = "GET") -> bool:
    """Mirror of reference is_license_protected_route
    (web/server.py:12841-12851): default-protect the whole /api/
    surface, allowlist the public/auth/bootstrap exceptions."""
    if method == "OPTIONS":
        return False
    p = (path or "").strip()
    if not p.startswith("/api/"):
        return False
    if p in LICENSE_PUBLIC_API_EXACT_PATHS:
        return False
    if p.startswith("/api/public/") or p.startswith("/api/auth/"):
        return False
    return True


def require_license(state: AppState, req: Request, user: dict) -> None:
    """License gate for protected business routes (reference
    require_valid_license web/server.py:12798)."""
    if not state.licenses.enforcement_enabled():
        return
    if state.auth.is_admin(user):
        return
    if not state.licenses.user_has_valid_license(user["user_id"]):
        raise HTTPError(403, {
            "error": "当前账号未激活 License",
            "license_required": True,
        })


# ---------------------------------------------------------------------------
# App factory
# ---------------------------------------------------------------------------

def create_app(data_dir: Optional[str] = None,
               overrides: Optional[dict] = None, *,
               device: str = "cuda") -> App:
    state = AppState(data_dir=data_dir, overrides=overrides, device=device)
    app = App("deepvision-tpu", secret_key=state.secret_key)
    app.state = state  # type: ignore[attr-defined]
    app.session_cookie_secure = state.resolver.get_bool(
        "SESSION_COOKIE_SECURE", not state.debug_mode)
    app.max_content_length = state.resolver.get_int(
        "MAX_CONTENT_LENGTH", 32 * 1024 * 1024)

    @app.after_request
    def _metrics_hook(req: Request, resp: Response):
        if req.path.startswith("/api/"):
            state.metrics.incr(f"http_status.{resp.status // 100}xx")
        return resp

    @app.before_request
    def _license_gate_hook(req: Request):
        """Default-deny license gate over the whole /api/ surface
        (reference enforce_auth_for_protected_routes +
        is_license_protected_route, web/server.py:12841-12894): with
        enforcement ON, every business API route requires a valid
        license unless allowlisted — a new route is gated the day it
        ships instead of opting in.  Per-route ``require_license``
        calls remain for belt-and-suspenders on the core flow.
        Auth itself stays per-route (the guard matrix pins each
        route's 401/403 contract); this hook only answers the
        license question, and only for logged-in non-admins."""
        if not license_gate_applies(req.path, req.method):
            return None
        if not state.licenses.enforcement_enabled():
            return None
        user = current_user(state, req)
        if user is None:
            return None  # the route's own require_user answers 401
        if state.auth.is_admin(user):
            return None
        if not state.licenses.user_has_valid_license(user["user_id"]):
            return Response({
                "error": "当前账号未激活 License",
                "license_required": True,
            }, status=403)
        return None

    from deepvision_tpu_torch.web.routes import (
        routes_admin,
        routes_auth,
        routes_reports,
        routes_scenarios,
        routes_sessions,
        routes_static,
    )

    routes_auth.register(app, state)
    routes_scenarios.register(app, state)
    routes_sessions.register(app, state)
    routes_reports.register(app, state)
    routes_admin.register(app, state)

    # --- status endpoints (reference :44223-44374) ----------------------
    @app.route("/api/status")
    def api_status(req):
        return {
            "status": "ok",
            "version": __version__,
            "ai_mode": state.gateway.mode,
            "started_at": state.started_at,
            "instance_scope": state.instance_scope,
            "engine": {
                name: eng.stats()
                for name, eng in state.gateway.engines.items()
            },
            "gateway_circuit": state.gateway.circuit_snapshot(),
            "report_queue": state.report_queue.queue_snapshot(),
        }

    @app.route("/api/status/web-search")
    def api_status_search(req):
        return dict(state.search.status)

    @app.route("/api/status/thinking/<session_id>")
    def api_status_thinking(req, session_id):
        return state.get_thinking(session_id)

    @app.route("/api/status/report-generation/<session_id>")
    def api_status_report(req, session_id):
        return state.report_queue.status_payload(session_id)

    # --- metrics (reference :44901-44946; admin-gated like the
    # reference's @require_admin) ----------------------------------------
    @app.route("/api/metrics")
    def api_metrics(req):
        require_admin(state, req)
        last_n = None
        if req.args.get("last_n"):
            try:
                last_n = int(req.args["last_n"])
            except ValueError:
                last_n = None
        stats = state.metrics.statistics(last_n)
        stage_latency = stats.get("stage_latency", {})

        def _pipeline_stages(prefix: str) -> dict:
            return {
                key[len(prefix):]: profile
                for key, profile in stage_latency.items()
                if key.startswith(prefix)
            }

        qgen = state.metrics.question_generation_stats()
        stats["question_generation"] = qgen
        stats["question_generation_runtime"] = {
            "stages": _pipeline_stages("question."),
            "by_mode": qgen.get("by_mode", {}),
        }
        stats["search_decision"] = state.metrics.search_decision_stats()
        stats["report_generation_queue"] = state.report_queue.queue_snapshot()
        stats["report_generation_runtime"] = {
            "stages": _pipeline_stages("report_v3."),
        }
        stats["list_overload"] = {
            f"{name}_list_rejected": gate.rejections
            for name, gate in state.list_gates.items()
        }
        stats["session_cache"] = {
            "hits": state.sessions.cache_hits,
            "misses": state.sessions.cache_misses,
        }
        stats["question_cache"] = {
            "hits": state.question_cache.hits,
            "misses": state.question_cache.misses,
        }
        # engine slot/page stats + circuit snapshot
        stats["engine"] = {
            name: eng.stats() for name, eng in state.gateway.engines.items()
        }
        stats["gateway_circuit"] = state.gateway.circuit_snapshot()
        return stats

    @app.route("/api/metrics/reset", methods=["POST"])
    def api_metrics_reset(req):
        require_admin(state, req)
        state.metrics.reset()
        for gate in state.list_gates.values():
            gate.rejections = 0
        state.report_queue.rejected = 0
        return {"ok": True}

    # --- summaries (reference :44948-45010) -----------------------------
    @app.route("/api/summaries")
    def api_summaries(req):
        require_admin(state, req)
        return {
            **state.docs.summaries_stats(),
            "enabled": True,
        }

    @app.route("/api/summaries/clear", methods=["POST"])
    def api_summaries_clear(req):
        require_admin(state, req)
        cleared = state.docs.clear_summaries()
        return {"ok": True, "cleared": cleared}

    # catch-all static route registers LAST so /api/** wins route matching
    routes_static.register(app, state)

    return app


def main():
    parser = argparse.ArgumentParser(description="deepvision-tpu server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8899)
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--device", default="cuda",
                        help="where engine-mode models run (cuda | cpu)")
    args = parser.parse_args()
    app = create_app(data_dir=args.data_dir, device=args.device)
    state: AppState = app.state  # type: ignore[attr-defined]
    app.logger.info(
        f"deepvision-tpu v{__version__} | ai_mode={state.gateway.mode} "
        f"| data={state.data_dir} | scope={state.instance_scope}"
    )
    from deepvision_tpu_torch.web.http import run_server

    run_server(app, args.host, args.port)


if __name__ == "__main__":
    main()
