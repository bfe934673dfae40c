"""Static frontend + site-config.js (reference web/server.py:26935-26973)."""

from __future__ import annotations

import json
import os

from deepvision_tpu_torch.web.http import HTTPError, Response

# The one frontend of both apps, served from the JAX app's tree as data
# (read by path, never imported), as ``resources/`` is shared.
STATIC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "deepvision_tpu", "web", "static")

_CONTENT_TYPES = {
    ".html": "text/html; charset=utf-8",
    ".js": "application/javascript; charset=utf-8",
    ".css": "text/css; charset=utf-8",
    ".json": "application/json; charset=utf-8",
    ".svg": "image/svg+xml",
    ".png": "image/png",
    ".ico": "image/x-icon",
}


def register(app, state):
    @app.route("/")
    def index(req):
        path = os.path.join(STATIC_DIR, "index.html")
        if os.path.isfile(path):
            with open(path, "rb") as fh:
                return Response(fh.read(), content_type=_CONTENT_TYPES[".html"])
        return Response(
            "<h1>deepvision-tpu</h1><p>API at /api/status</p>",
        )

    @app.route("/site-config.js")
    def site_config(req):
        cfg = {
            "instanceScope": state.instance_scope,
            "aiMode": state.gateway.mode,
            "debugMode": state.debug_mode,
        }
        body = "window.SITE_CONFIG = " + json.dumps(cfg, ensure_ascii=False) + ";"
        return Response(body, content_type=_CONTENT_TYPES[".js"])

    @app.route("/<static:filename>")
    def static_file(req, filename):
        safe = os.path.normpath(filename)
        if safe.startswith("..") or os.path.isabs(safe):
            raise HTTPError(404)
        path = os.path.join(STATIC_DIR, safe)
        if not os.path.isfile(path):
            raise HTTPError(404)
        ext = os.path.splitext(path)[1]
        with open(path, "rb") as fh:
            return Response(
                fh.read(),
                content_type=_CONTENT_TYPES.get(
                    ext, "application/octet-stream"),
            )
