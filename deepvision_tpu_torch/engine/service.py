"""Remote engine service + client — scale-out across hosts for serving.

A copy of the JAX package's ``engine/service.py`` over the port's engines.

One process per host runs ``EngineService`` (an HTTP front over a local
LLMEngine); other hosts route to it through ``RemoteEngine``, which speaks
the same ``generate_text``/``stats`` surface as a local engine so it can
sit inside an :class:`deepvision_tpu_torch.engine.router.EngineRouter` unchanged.

This replaces the reference's remote Anthropic-compatible lanes
(SURVEY.md §5.8): requests cross hosts; each host's tensors stay on its
own devices.

Protocol (JSON over HTTP):
  POST /v1/generate {prompt, max_tokens, temperature, top_k, top_p,
                     priority, timeout, prefix_key, json_mode}
      -> 200 {text, meta} | 429 {error, retry_after} | 5xx {error}
  GET  /v1/stats      -> engine stats payload
  GET  /v1/health     -> {ok, model}
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from deepvision_tpu_torch.engine.scheduler import EngineOverloadedError


class EngineService:
    """Serve one local engine over HTTP (stdlib wsgiref + the repo's own
    threaded server from web/http.py — no framework dependency)."""

    def __init__(self, engine, host: str = "0.0.0.0", port: int = 8990):
        self.engine = engine
        self.host = host
        self.port = port
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    # -- WSGI app ----------------------------------------------------------
    def _app(self, environ, start_response):
        path = environ.get("PATH_INFO", "")
        method = environ.get("REQUEST_METHOD", "GET")

        def respond(status: str, payload: dict):
            body = json.dumps(payload, ensure_ascii=False).encode()
            start_response(status, [
                ("Content-Type", "application/json; charset=utf-8"),
                ("Content-Length", str(len(body))),
            ])
            return [body]

        if path == "/v1/health":
            return respond("200 OK", {
                "ok": True, "model": self.engine.model_cfg.name})
        if path == "/v1/stats":
            return respond("200 OK", self.engine.stats())
        if path == "/v1/generate" and method == "POST":
            try:
                length = int(environ.get("CONTENT_LENGTH") or 0)
                req = json.loads(
                    environ["wsgi.input"].read(length).decode("utf-8"))
                text, meta = self.engine.generate_text(
                    req["prompt"],
                    max_tokens=int(req.get("max_tokens", 256)),
                    temperature=float(req.get("temperature", 0.0)),
                    top_k=int(req.get("top_k", 0)),
                    top_p=float(req.get("top_p", 1.0)),
                    priority=int(req.get("priority", 0)),
                    timeout=float(req.get("timeout", 120.0)),
                    prefix_key=req.get("prefix_key"),
                    json_mode=bool(req.get("json_mode", False)),
                )
                return respond("200 OK", {"text": text, "meta": meta})
            except EngineOverloadedError as e:
                return respond("429 Too Many Requests", {
                    "error": str(e), "retry_after": e.retry_after_s})
            except TimeoutError as e:
                return respond("504 Gateway Timeout", {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                return respond("500 Internal Server Error", {
                    "error": f"{type(e).__name__}: {e}"})
        return respond("404 Not Found", {"error": "not found"})

    # -- lifecycle -----------------------------------------------------------
    def start(self, background: bool = True) -> int:
        from wsgiref.simple_server import WSGIServer, make_server
        from socketserver import ThreadingMixIn

        class _Threading(ThreadingMixIn, WSGIServer):
            daemon_threads = True

        self.engine.start()
        self._httpd = make_server(
            self.host, self.port, self._app, server_class=_Threading)
        self.port = self._httpd.server_port
        if background:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="dv-engine-service", daemon=True)
            self._thread.start()
        else:
            self._httpd.serve_forever()
        return self.port

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
        self.engine.shutdown()


class RemoteEngine:
    """Client half: a remote engine replica behind the same surface as a
    local LLMEngine (generate_text/stats/start/shutdown)."""

    def __init__(self, base_url: str, *, connect_timeout: float = 5.0):
        self.base_url = base_url.rstrip("/")
        self.connect_timeout = connect_timeout
        self.model_cfg = None
        self.json_dfa = None

    def _request(self, path: str, payload: Optional[dict] = None,
                 timeout: float = 120.0) -> dict:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self.base_url + path)
        if payload is not None:
            req.data = json.dumps(payload).encode()
            req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            body = {}
            try:
                body = json.loads(e.read().decode("utf-8"))
            except Exception:  # noqa: BLE001
                pass
            if e.code == 429:
                raise EngineOverloadedError(
                    body.get("error", "remote overloaded"),
                    float(body.get("retry_after", 2.0)))
            if e.code == 504:
                raise TimeoutError(body.get("error", "remote timeout"))
            raise RuntimeError(
                body.get("error", f"remote engine HTTP {e.code}"))

    def start(self) -> None:
        health = self._request("/v1/health", timeout=self.connect_timeout)
        if not health.get("ok"):
            raise RuntimeError(f"remote engine unhealthy: {health}")

    def shutdown(self) -> None:
        pass  # the remote host owns its engine lifecycle

    def generate_text(self, prompt: str, **kw):
        timeout = float(kw.get("timeout") or 120.0)
        out = self._request("/v1/generate", {
            "prompt": prompt,
            "max_tokens": kw.get("max_tokens", 256),
            "temperature": kw.get("temperature", 0.0),
            "top_k": kw.get("top_k", 0),
            "top_p": kw.get("top_p", 1.0),
            "priority": kw.get("priority", 0),
            "timeout": timeout,
            "prefix_key": kw.get("prefix_key"),
            "json_mode": kw.get("json_mode", False),
        }, timeout=timeout + 10.0)
        meta = out.get("meta", {})
        meta["remote"] = self.base_url
        return out.get("text", ""), meta

    def stats(self) -> dict:
        try:
            s = self._request("/v1/stats", timeout=self.connect_timeout)
        except Exception as e:  # noqa: BLE001
            return {"error": str(e), "remote": self.base_url}
        s["remote"] = self.base_url
        return s
