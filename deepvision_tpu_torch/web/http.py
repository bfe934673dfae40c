"""Minimal WSGI micro-framework (Flask-shaped, stdlib-only).

The reference runs Flask + Gunicorn (web/gunicorn.conf.py); neither is in
this image, so the framework layer is built from scratch: routing with path
parameters, JSON requests/responses, HMAC-signed cookie sessions (the role
itsdangerous plays for Flask), multipart uploads, before-request hooks, and
a threaded WSGI server for production serving.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import io
import json
import re
import traceback
from http.cookies import SimpleCookie
from socketserver import ThreadingMixIn
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, unquote
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer

HTTP_STATUS = {
    200: "OK", 201: "Created", 204: "No Content", 302: "Found",
    304: "Not Modified", 400: "Bad Request", 401: "Unauthorized",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
    409: "Conflict", 413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 503: "Service Unavailable",
}


# ---------------------------------------------------------------------------
# Request / Response
# ---------------------------------------------------------------------------

class UploadedFile:
    def __init__(self, filename: str, content: bytes, content_type: str = ""):
        self.filename = filename
        self.content = content
        self.content_type = content_type

    def __len__(self):
        return len(self.content)


class Request:
    def __init__(self, environ: dict):
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET").upper()
        path = environ.get("PATH_INFO", "/")
        # PEP 3333: PATH_INFO arrives latin-1-decoded; re-decode as UTF-8 so
        # CJK report filenames in URLs resolve (socket-only behavior — test
        # clients bypass the WSGI encoding dance).
        try:
            path = path.encode("latin-1").decode("utf-8")
        except (UnicodeEncodeError, UnicodeDecodeError):
            pass
        self.path = path
        self.query_string = environ.get("QUERY_STRING", "")
        self._args = None
        self._body = None
        self._json = None
        self._form = None
        self._files = None
        self.path_params: Dict[str, str] = {}
        self.session: "Session" = Session()

    # -- headers --------------------------------------------------------
    def header(self, name: str, default: str = "") -> str:
        key = "HTTP_" + name.upper().replace("-", "_")
        if key in self.environ:
            return self.environ[key]
        if name.lower() == "content-type":
            return self.environ.get("CONTENT_TYPE", default)
        if name.lower() == "content-length":
            return self.environ.get("CONTENT_LENGTH", default)
        return default

    @property
    def headers(self) -> Dict[str, str]:
        out = {}
        for k, v in self.environ.items():
            if k.startswith("HTTP_"):
                out[k[5:].replace("_", "-").title()] = v
        if self.environ.get("CONTENT_TYPE"):
            out["Content-Type"] = self.environ["CONTENT_TYPE"]
        return out

    @property
    def remote_addr(self) -> str:
        return self.environ.get("REMOTE_ADDR", "")

    # -- query args -----------------------------------------------------
    @property
    def args(self) -> Dict[str, str]:
        if self._args is None:
            parsed = parse_qs(self.query_string, keep_blank_values=True)
            self._args = {k: v[0] for k, v in parsed.items()}
        return self._args

    # -- body -----------------------------------------------------------
    @property
    def body(self) -> bytes:
        if self._body is None:
            try:
                length = int(self.environ.get("CONTENT_LENGTH") or 0)
            except ValueError:
                length = 0
            stream = self.environ.get("wsgi.input")
            self._body = stream.read(length) if (stream and length) else b""
        return self._body

    def get_json(self, silent: bool = True) -> Any:
        if self._json is None:
            try:
                parsed = json.loads(self.body.decode("utf-8"))
            except Exception:
                if not silent:
                    raise
                parsed = {}
            # every API body is a JSON object; a top-level null/list/
            # scalar reaching route `.get(...)` calls was a 500 (found by
            # the round-4 hardening sweep) — treat it as an empty body
            if not isinstance(parsed, dict):
                parsed = {}
            self._json = parsed
        return self._json

    @property
    def cookies(self) -> Dict[str, str]:
        jar = SimpleCookie()
        jar.load(self.environ.get("HTTP_COOKIE", ""))
        return {k: m.value for k, m in jar.items()}

    # -- multipart ------------------------------------------------------
    def _parse_multipart(self):
        self._form, self._files = {}, {}
        ctype = self.header("Content-Type")
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if not m:
            return
        boundary = b"--" + m.group(1).encode()
        for part in self.body.split(boundary):
            part = part.strip(b"\r\n")
            if not part or part == b"--":
                continue
            if b"\r\n\r\n" not in part:
                continue
            raw_headers, content = part.split(b"\r\n\r\n", 1)
            headers = {}
            for line in raw_headers.decode("utf-8", "replace").split("\r\n"):
                if ":" in line:
                    hk, hv = line.split(":", 1)
                    headers[hk.strip().lower()] = hv.strip()
            disp = headers.get("content-disposition", "")
            name_m = re.search(r'name="([^"]*)"', disp)
            file_m = re.search(r'filename="([^"]*)"', disp)
            if not name_m:
                continue
            field = name_m.group(1)
            if file_m:
                self._files[field] = UploadedFile(
                    file_m.group(1), content,
                    headers.get("content-type", ""),
                )
            else:
                self._form[field] = content.decode("utf-8", "replace")

    @property
    def form(self) -> Dict[str, str]:
        if self._form is None:
            ctype = self.header("Content-Type")
            if ctype.startswith("multipart/form-data"):
                self._parse_multipart()
            elif ctype.startswith("application/x-www-form-urlencoded"):
                parsed = parse_qs(self.body.decode("utf-8", "replace"))
                self._form = {k: v[0] for k, v in parsed.items()}
                self._files = {}
            else:
                self._form, self._files = {}, {}
        return self._form

    @property
    def files(self) -> Dict[str, UploadedFile]:
        if self._files is None:
            _ = self.form
        return self._files


class Response:
    def __init__(
        self,
        body: Any = b"",
        status: int = 200,
        headers: Optional[Dict[str, str]] = None,
        content_type: Optional[str] = None,
    ):
        self.status = status
        self.headers: Dict[str, str] = dict(headers or {})
        self._cookies: List[str] = []
        if isinstance(body, (dict, list)):
            self.body = json.dumps(body, ensure_ascii=False).encode("utf-8")
            self.headers.setdefault(
                "Content-Type", "application/json; charset=utf-8"
            )
        elif isinstance(body, str):
            self.body = body.encode("utf-8")
            self.headers.setdefault(
                "Content-Type", content_type or "text/html; charset=utf-8"
            )
        else:
            self.body = bytes(body)
            if content_type:
                self.headers.setdefault("Content-Type", content_type)
        if content_type:
            self.headers["Content-Type"] = content_type

    def set_cookie(
        self, name: str, value: str, *, max_age: Optional[int] = None,
        path: str = "/", http_only: bool = True, same_site: str = "Lax",
        secure: bool = False,
    ):
        parts = [f"{name}={value}", f"Path={path}", f"SameSite={same_site}"]
        if max_age is not None:
            parts.append(f"Max-Age={max_age}")
        if http_only:
            parts.append("HttpOnly")
        if secure:
            parts.append("Secure")
        self._cookies.append("; ".join(parts))

    def delete_cookie(self, name: str, path: str = "/"):
        self._cookies.append(f"{name}=; Path={path}; Max-Age=0")

    def wsgi(self) -> Tuple[str, List[Tuple[str, str]], List[bytes]]:
        status_line = f"{self.status} {HTTP_STATUS.get(self.status, 'Unknown')}"
        headers = list(self.headers.items())
        body = b"" if self.status in (204, 304) else self.body
        if self.status not in (204, 304):
            headers.append(("Content-Length", str(len(body))))
        for c in self._cookies:
            headers.append(("Set-Cookie", c))
        return status_line, headers, [body]


def jsonify(data: Any, status: int = 200, headers: Optional[dict] = None):
    return Response(data, status=status, headers=headers)


# ---------------------------------------------------------------------------
# Signed cookie session (HMAC-SHA256)
# ---------------------------------------------------------------------------

class Session(dict):
    modified = False

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self.modified = True

    def pop(self, *a):
        self.modified = True
        return super().pop(*a)

    def clear(self):
        self.modified = True
        super().clear()


def sign_session(data: dict, secret: str) -> str:
    payload = base64.urlsafe_b64encode(
        json.dumps(data, separators=(",", ":")).encode()
    ).rstrip(b"=")
    sig = hmac.new(secret.encode(), payload, hashlib.sha256).digest()
    return (payload + b"." + base64.urlsafe_b64encode(sig).rstrip(b"=")).decode()

def unsign_session(token: str, secret: str) -> Optional[dict]:
    try:
        payload_b, sig_b = token.encode().rsplit(b".", 1)
        pad = b"=" * (-len(sig_b) % 4)
        expect = hmac.new(secret.encode(), payload_b, hashlib.sha256).digest()
        if not hmac.compare_digest(
            base64.urlsafe_b64decode(sig_b + pad), expect
        ):
            return None
        pad2 = b"=" * (-len(payload_b) % 4)
        return json.loads(base64.urlsafe_b64decode(payload_b + pad2))
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Routing / App
# ---------------------------------------------------------------------------

_PARAM_RE = re.compile(r"<(?:(?P<conv>[a-z]+):)?(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)>")


def _compile_rule(rule: str):
    pattern = ""
    idx = 0
    for m in _PARAM_RE.finditer(rule):
        pattern += re.escape(rule[idx:m.start()])
        conv = m.group("conv") or "default"
        name = m.group("name")
        if conv == "path":
            pattern += f"(?P<{name}>.+)"
        elif conv == "static":
            # like path, but never matches under /api/: the static
            # catch-all must not swallow API paths, or a wrong-verb API
            # call gets the file-server's 404 instead of the router's
            # 405 + Allow (tests/test_method_matrix.py)
            pattern += f"(?!api/)(?P<{name}>.+)"
        elif conv == "int":
            pattern += f"(?P<{name}>\\d+)"
        else:
            pattern += f"(?P<{name}>[^/]+)"
        idx = m.end()
    pattern += re.escape(rule[idx:])
    return re.compile("^" + pattern + "$")


class HTTPError(Exception):
    def __init__(self, status: int, payload: Any = None, headers=None):
        super().__init__(f"HTTP {status}")
        self.status = status
        self.payload = payload if payload is not None else {
            "error": HTTP_STATUS.get(status, "error")
        }
        self.headers = headers or {}


def list_field(body: Any, key: str) -> list:
    """List field from an untrusted JSON body; non-lists become []
    (same hostile-body contract as str_field/int_field below —
    tests/test_mutation_input_grid.py sends every JSON type at every
    mutating route)."""
    if not isinstance(body, dict):
        return []
    v = body.get(key)
    return v if isinstance(v, list) else []


def str_field(body: Any, key: str, default: str = "") -> str:
    """Body field as a stripped string; non-string scalars coerce, and
    structured values (list/dict) answer 400 instead of an
    AttributeError-500 deep in a handler (hostile-body grid,
    tests/test_api_error_grid.py)."""
    val = (body or {}).get(key) if isinstance(body, dict) else None
    if val is None:
        return default
    if isinstance(val, str):
        return val.strip()
    if isinstance(val, (int, float, bool)):
        return str(val)
    raise HTTPError(400, {"error": f"字段 {key} 类型错误"})


def int_field(body: Any, key: str, default: int,
              lo: Optional[int] = None, hi: Optional[int] = None) -> int:
    """Body field as an int with bounds; un-coercible input answers 400."""
    val = (body or {}).get(key) if isinstance(body, dict) else None
    if val is None or val == "":
        out = default
    else:
        try:
            out = int(val)
        except (TypeError, ValueError):
            raise HTTPError(400, {"error": f"字段 {key} 需要整数"})
    if lo is not None:
        out = max(lo, out)
    if hi is not None:
        out = min(hi, out)
    return out


class App:
    """WSGI application with Flask-style decorators."""

    def __init__(self, name: str = "app", secret_key: str = "dev-secret"):
        self.name = name
        self.secret_key = secret_key
        self.session_cookie = "dv_session"
        self.session_cookie_secure = False
        # Framework-level body cap: reject oversized Content-Length before
        # wsgi.input is ever read (per-route checks run after buffering).
        self.max_content_length: Optional[int] = 32 * 1024 * 1024
        self._routes: List[tuple] = []  # (regex, methods, fn, rule)
        self._before: List[Callable] = []
        self._after: List[Callable] = []
        self._error_handlers: Dict[int, Callable] = {}
        self.config: Dict[str, Any] = {}
        self.logger = _Logger()

    # -- registration ---------------------------------------------------
    def route(self, rule: str, methods: Optional[List[str]] = None):
        methods = [m.upper() for m in (methods or ["GET"])]

        def deco(fn):
            self._routes.append((_compile_rule(rule), methods, fn, rule))
            return fn

        return deco

    def before_request(self, fn):
        self._before.append(fn)
        return fn

    def after_request(self, fn):
        self._after.append(fn)
        return fn

    def error_handler(self, status: int):
        def deco(fn):
            self._error_handlers[status] = fn
            return fn

        return deco

    # -- dispatch -------------------------------------------------------
    def _coerce(self, rv) -> Response:
        if isinstance(rv, Response):
            return rv
        if isinstance(rv, tuple):
            body, status = rv[0], rv[1]
            headers = rv[2] if len(rv) > 2 else None
            if isinstance(body, Response):
                body.status = status
                if headers:
                    body.headers.update(headers)
                return body
            return Response(body, status=status, headers=headers)
        if rv is None:
            return Response(b"", status=204)
        return Response(rv)

    def handle(self, req: Request) -> Response:
        if self.max_content_length is not None:
            try:
                length = int(req.environ.get("CONTENT_LENGTH") or 0)
            except ValueError:
                length = 0
            if length > self.max_content_length:
                return self._finalize(req, Response(
                    {"error": "request body too large"}, status=413))
        # session decode
        token = req.cookies.get(self.session_cookie)
        if token:
            data = unsign_session(token, self.secret_key)
            if data:
                req.session.update(data)
                req.session.modified = False

        try:
            for hook in self._before:
                rv = hook(req)
                if rv is not None:
                    resp = self._coerce(rv)
                    return self._finalize(req, resp)
            fn, params, allowed = self._match(req)
            req.path_params = params
            rv = fn(req, **params)
            resp = self._coerce(rv)
        except HTTPError as e:
            handler = self._error_handlers.get(e.status)
            if handler:
                resp = self._coerce(handler(req, e))
            else:
                resp = Response(e.payload, status=e.status, headers=e.headers)
        except Exception:
            self.logger.error(
                f"unhandled error on {req.method} {req.path}\n"
                + traceback.format_exc()
            )
            handler = self._error_handlers.get(500)
            if handler:
                resp = self._coerce(handler(req, None))
            else:
                resp = Response({"error": "internal server error"}, status=500)
        return self._finalize(req, resp)

    def _finalize(self, req: Request, resp: Response) -> Response:
        for hook in self._after:
            resp = hook(req, resp) or resp
        if req.session.modified:
            if req.session:
                resp.set_cookie(
                    self.session_cookie,
                    sign_session(dict(req.session), self.secret_key),
                    max_age=30 * 86400,
                    secure=self.session_cookie_secure,
                )
            else:
                resp.delete_cookie(self.session_cookie)
        if req.method == "HEAD":
            # HEAD = GET minus the body; Content-Length stays the GET
            # value per RFC 9110 (header logic already ran on the body)
            resp.body = b""
        return resp

    def _match(self, req: Request):
        """Most-specific match wins: among all matching rules, prefer the
        one with the most literal (non-parameter) characters, so
        ``/api/reports/<path:f>/solution`` beats ``/api/reports/<path:f>``."""
        allowed: List[str] = []
        best = None
        best_score = -1
        # HEAD routes like GET; _finalize strips the body (werkzeug
        # semantics the reference app gets from Flask for free)
        method = "GET" if req.method == "HEAD" else req.method
        for regex, methods, fn, rule in self._routes:
            m = regex.match(req.path)
            if not m:
                continue
            if method not in methods:
                allowed.extend(methods)
                continue
            score = len(_PARAM_RE.sub("", rule))
            if score > best_score:
                best_score = score
                best = (fn, m)
        if best is not None:
            fn, m = best
            params = {k: unquote(v) for k, v in m.groupdict().items()}
            return fn, params, None
        if allowed:
            raise HTTPError(405, headers={
                "Allow": ", ".join(sorted(set(allowed)))})
        raise HTTPError(404)

    # -- WSGI -----------------------------------------------------------
    def __call__(self, environ, start_response):
        req = Request(environ)
        resp = self.handle(req)
        status, headers, body = resp.wsgi()
        start_response(status, headers)
        return body

    # -- test client ----------------------------------------------------
    def test_client(self) -> "TestClient":
        return TestClient(self)


class _Logger:
    def _emit(self, level, msg):
        print(f"[{level}] {msg}", flush=True)

    def info(self, msg):
        self._emit("INFO", msg)

    def warning(self, msg):
        self._emit("WARN", msg)

    def error(self, msg):
        self._emit("ERROR", msg)


# ---------------------------------------------------------------------------
# Test client (requests-like, no sockets)
# ---------------------------------------------------------------------------

class TestResponse:
    def __init__(self, status: int, headers: Dict[str, str], body: bytes):
        self.status_code = status
        self.headers = headers
        self.data = body

    def get_json(self):
        try:
            return json.loads(self.data.decode("utf-8"))
        except Exception:
            return None

    @property
    def text(self):
        return self.data.decode("utf-8", "replace")


class TestClient:
    def __init__(self, app: App):
        self.app = app
        self._cookies: Dict[str, str] = {}

    def open(
        self, path: str, method: str = "GET", json_body: Any = None,
        data: Optional[bytes] = None, headers: Optional[dict] = None,
        files: Optional[dict] = None, form: Optional[dict] = None,
    ) -> TestResponse:
        query = ""
        if "?" in path:
            path, query = path.split("?", 1)
        body = b""
        ctype = ""
        if json_body is not None:
            body = json.dumps(json_body, ensure_ascii=False).encode("utf-8")
            ctype = "application/json"
        elif files or form:
            boundary = "dvtestboundary42"
            parts = []
            for k, v in (form or {}).items():
                parts.append(
                    f'--{boundary}\r\nContent-Disposition: form-data; '
                    f'name="{k}"\r\n\r\n{v}\r\n'.encode()
                )
            for k, f in (files or {}).items():
                fname, content = f[0], f[1]
                fct = f[2] if len(f) > 2 else "application/octet-stream"
                parts.append(
                    f'--{boundary}\r\nContent-Disposition: form-data; '
                    f'name="{k}"; filename="{fname}"\r\n'
                    f"Content-Type: {fct}\r\n\r\n".encode()
                    + (content if isinstance(content, bytes)
                       else content.encode())
                    + b"\r\n"
                )
            body = b"".join(parts) + f"--{boundary}--\r\n".encode()
            ctype = f"multipart/form-data; boundary={boundary}"
        elif data is not None:
            body = data

        environ = {
            "REQUEST_METHOD": method.upper(),
            "PATH_INFO": path,
            "QUERY_STRING": query,
            "CONTENT_TYPE": ctype,
            "CONTENT_LENGTH": str(len(body)),
            "wsgi.input": io.BytesIO(body),
            "REMOTE_ADDR": "127.0.0.1",
        }
        if self._cookies:
            environ["HTTP_COOKIE"] = "; ".join(
                f"{k}={v}" for k, v in self._cookies.items()
            )
        for k, v in (headers or {}).items():
            key = k.upper().replace("-", "_")
            if key in ("CONTENT_LENGTH", "CONTENT_TYPE"):
                environ[key] = v  # WSGI carries these without HTTP_ prefix
            else:
                environ["HTTP_" + key] = v

        resp = self.app.handle(Request(environ))
        status, header_list, chunks = resp.wsgi()
        headers_out: Dict[str, str] = {}
        for k, v in header_list:
            if k == "Set-Cookie":
                cookie = SimpleCookie()
                cookie.load(v)
                for name, morsel in cookie.items():
                    if morsel.value:
                        self._cookies[name] = morsel.value
                    else:
                        self._cookies.pop(name, None)
            headers_out[k] = v
        return TestResponse(int(status.split()[0]), headers_out, b"".join(chunks))

    def get(self, path, **kw):
        return self.open(path, "GET", **kw)

    def post(self, path, **kw):
        return self.open(path, "POST", **kw)

    def put(self, path, **kw):
        return self.open(path, "PUT", **kw)

    def delete(self, path, **kw):
        return self.open(path, "DELETE", **kw)


# ---------------------------------------------------------------------------
# Threaded WSGI server (the Gunicorn-stand-in for production)
# ---------------------------------------------------------------------------

class ThreadedWSGIServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True
    allow_reuse_address = True


class QuietHandler(WSGIRequestHandler):
    """Access-log filter: suppress status-poll noise (reference
    SelectiveAccessLogRequestHandler, web/server.py:45056)."""

    quiet_prefixes = (
        "/api/status/",
        "/api/metrics",
    )

    def log_message(self, fmt, *args):
        try:
            if any(self.path.startswith(p) for p in self.quiet_prefixes):
                return
        except Exception:
            pass
        super().log_message(fmt, *args)


def run_server(app: App, host: str = "0.0.0.0", port: int = 8899):
    server = ThreadedWSGIServer((host, port), QuietHandler)
    server.set_app(app)
    app.logger.info(f"serving on http://{host}:{port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
