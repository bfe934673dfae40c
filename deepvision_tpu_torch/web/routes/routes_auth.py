"""Auth + license-activation routes (reference web/server.py:27692-28438)."""

from __future__ import annotations

from deepvision_tpu_torch.web.authn import SmsRateLimited
from deepvision_tpu_torch.web.http import HTTPError, str_field
from deepvision_tpu_torch.web.levels import capabilities_for
from deepvision_tpu_torch.web.licensing import LicenseError


def register(app, state):
    from deepvision_tpu_torch.web.server import current_user, require_user

    @app.route("/api/auth/sms/send-code", methods=["POST"])
    def send_code(req):
        phone = str_field(req.get_json(), "phone")
        if not phone or not phone.replace("+", "").isdigit():
            raise HTTPError(400, {"error": "手机号格式不正确"})
        try:
            state.auth.issue_sms_code(phone)
        except SmsRateLimited as e:
            raise HTTPError(429, {"error": str(e)},
                            headers={"Retry-After": "60"})
        return {"ok": True, "provider": state.auth.provider}

    @app.route("/api/auth/login/code", methods=["POST"])
    @app.route("/api/auth/recover/login", methods=["POST"])
    def login_code(req):
        body = req.get_json()
        phone = str_field(body, "phone")
        code = str_field(body, "code")
        if not phone or not code:
            raise HTTPError(400, {"error": "缺少手机号或验证码"})
        if not state.auth.verify_sms_code(phone, code):
            raise HTTPError(401, {"error": "验证码错误或已过期"})
        user = state.auth.upsert_user_by_phone(phone)
        req.session["user_id"] = user["user_id"]
        return {"ok": True, "user": _public_user(state, user)}

    @app.route("/api/auth/recover/send-code", methods=["POST"])
    def recover_send(req):
        phone = str_field(req.get_json(), "phone")
        if not phone:
            raise HTTPError(400, {"error": "手机号格式不正确"})
        try:
            state.auth.issue_sms_code(phone, purpose="login")
        except SmsRateLimited as e:
            raise HTTPError(429, {"error": str(e)},
                            headers={"Retry-After": "60"})
        return {"ok": True}

    @app.route("/api/auth/register", methods=["POST"])
    @app.route("/api/auth/login", methods=["POST"])
    def legacy_password_auth(req):
        # The reference deprecated password auth in favor of SMS codes.
        raise HTTPError(400, {"error": "请使用短信验证码登录"})

    @app.route("/api/auth/logout", methods=["POST"])
    def logout(req):
        req.session.clear()
        return {"ok": True}

    @app.route("/api/auth/me")
    def me(req):
        user = current_user(state, req)
        if user is None:
            return {"authenticated": False, "user": None}
        return {"authenticated": True, "user": _public_user(state, user)}

    # --- WeChat OAuth (full QR-connect flow, gated on app credentials) --
    from deepvision_tpu_torch.web.wechat import WeChatOAuth

    wechat = WeChatOAuth(
        state.resolver.get_str("WECHAT_APP_ID"),
        state.resolver.get_str("WECHAT_APP_SECRET"),
        state.resolver.get_str("WECHAT_REDIRECT_URI"),
    )

    @app.route("/api/auth/wechat/start")
    def wechat_start(req):
        if not wechat.configured:
            raise HTTPError(503, {
                "error": "WeChat OAuth 未配置（需要 WECHAT_APP_ID/SECRET）",
                "configured": False,
            })
        return wechat.start_url("login")

    @app.route("/api/auth/bind/wechat/start")
    def wechat_bind_start(req):
        require_user(state, req)
        if not wechat.configured:
            raise HTTPError(503, {"error": "WeChat OAuth 未配置",
                                  "configured": False})
        return wechat.start_url("bind")

    @app.route("/api/auth/wechat/callback")
    def wechat_callback(req):
        if not wechat.configured:
            raise HTTPError(503, {"error": "WeChat OAuth 未配置"})
        code = req.args.get("code", "")
        state_token = req.args.get("state", "")
        purpose = wechat.consume_state(state_token)
        if not code or purpose is None:
            raise HTTPError(400, {"error": "无效的回调参数或 state 已过期"})
        try:
            identity = wechat.exchange_code(code)
        except Exception as e:  # noqa: BLE001
            raise HTTPError(502, {"error": f"微信授权失败：{e}"})
        if purpose == "bind":
            user = require_user(state, req)
            existing = state.auth.user_by_wechat(identity["openid"])
            if existing and existing["user_id"] != user["user_id"]:
                # OAuth just proved control of a WeChat identity bound to
                # another account — offer a merge instead of silently
                # stealing the binding.
                state.auth.set_merge_candidate(
                    user["user_id"], existing["user_id"], "wechat")
                return {
                    "ok": False,
                    "conflict": True,
                    "merge_available": True,
                    "detail": "该微信已绑定其他账号，可发起账号合并",
                }
            state.auth.bind_wechat(
                user["user_id"], identity["openid"],
                identity["nickname"], identity["unionid"],
            )
            return {"ok": True, "bound": True}
        user = state.auth.user_by_wechat(identity["openid"])
        if user is None:
            # first login creates a phone-less account bound to the openid
            conn = state.auth.conn()
            conn.execute(
                "INSERT INTO users (phone, nickname, created_at, "
                "last_login_at) VALUES (NULL, ?, datetime('now'), "
                "datetime('now'))",
                (identity["nickname"],),
            )
            conn.commit()
            user_id = conn.execute(
                "SELECT last_insert_rowid() AS id").fetchone()["id"]
            state.auth.bind_wechat(
                user_id, identity["openid"], identity["nickname"],
                identity["unionid"],
            )
            user = state.auth.get_user(user_id)
        req.session["user_id"] = user["user_id"]
        return {"ok": True, "user": _public_user(state, user)}

    @app.route("/api/auth/bind/status")
    def bind_status(req):
        user = require_user(state, req)
        binding = state.auth.wechat_binding(user["user_id"])
        return {
            "phone_bound": bool(user.get("phone")),
            "wechat_bound": binding is not None,
            "wechat_nickname": (binding or {}).get("nickname"),
        }

    @app.route("/api/auth/bind/phone", methods=["POST"])
    def bind_phone(req):
        user = require_user(state, req)
        body = req.get_json()
        phone = str_field(body, "phone")
        code = str_field(body, "code")
        if not state.auth.verify_sms_code(phone, code):
            raise HTTPError(401, {"error": "验证码错误或已过期"})
        conn = state.auth.conn()
        other = conn.execute(
            "SELECT user_id FROM users WHERE phone = ? AND user_id != ?",
            (phone, user["user_id"]),
        ).fetchone()
        if other:
            # The caller just proved control of a phone owned by another
            # account: record a server-side merge candidate instead of
            # rebinding (reference merge flow, server.py:11838-12160).
            state.auth.set_merge_candidate(
                user["user_id"], other["user_id"], "phone")
            return {
                "ok": False,
                "conflict": True,
                "merge_available": True,
                "detail": "该手机号已绑定其他账号，可发起账号合并",
            }
        conn.execute(
            "UPDATE users SET phone = ? WHERE user_id = ?",
            (phone, user["user_id"]),
        )
        conn.commit()
        return {"ok": True}

    @app.route("/api/auth/account-merge/preview", methods=["POST"])
    def merge_preview(req):
        # Merge source comes ONLY from the server-side verified candidate
        # (set when this user proved control of the conflicting phone or
        # WeChat identity); from_user_id in the body is ignored.
        user = require_user(state, req)
        try:
            return state.auth.merge_preview(user["user_id"])
        except ValueError as e:
            raise HTTPError(400, {"error": str(e)})

    @app.route("/api/auth/account-merge/apply", methods=["POST"])
    def merge_apply(req):
        user = require_user(state, req)
        try:
            return state.auth.merge_apply(
                req.get_json().get("preview_token", ""), user["user_id"]
            )
        except ValueError as e:
            raise HTTPError(400, {"error": str(e)})

    # --- licenses (user-facing; reference :28282-28438) -----------------
    @app.route("/api/licenses/current")
    def license_current(req):
        user = require_user(state, req)
        return {
            "license": state.licenses.current_for_user(user["user_id"]),
            "enforcement_enabled": state.licenses.enforcement_enabled(),
        }

    @app.route("/api/licenses/activate", methods=["POST"])
    def license_activate(req):
        user = require_user(state, req)
        code = str_field(req.get_json(), "code")
        if not code:
            raise HTTPError(400, {"error": "缺少激活码"})
        try:
            lic = state.licenses.activate(code, user["user_id"])
        except LicenseError as e:
            raise HTTPError(e.status_code, {
                "error": str(e), "error_code": e.error_code})
        if lic.get("level"):
            state.auth.set_user_level(user["user_id"], lic["level"])
        return {"ok": True, "license": lic}


def _public_user(state, user: dict) -> dict:
    return {
        "user_id": user["user_id"],
        "phone": (user.get("phone") or "")[:3] + "****" +
                 (user.get("phone") or "")[-4:],
        "nickname": user.get("nickname"),
        "level": user.get("level", "experience"),
        "is_admin": state.auth.is_admin(user),
        "capabilities": capabilities_for(user.get("level")),
    }
