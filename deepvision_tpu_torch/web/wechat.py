"""WeChat OAuth2 client (reference web/server.py:12161-12709).

Config-gated on WECHAT_APP_ID/SECRET; the QR-connect flow:
start -> open.weixin.qq.com authorize URL with CSRF state ->
callback(code) -> access-token exchange -> userinfo fetch (with the
reference's mojibake-safe nickname repair :11713) -> login or bind.
"""

from __future__ import annotations

import secrets
import threading
import time
from typing import Optional
from urllib.parse import quote

AUTHORIZE_URL = "https://open.weixin.qq.com/connect/qrconnect"
TOKEN_URL = "https://api.weixin.qq.com/sns/oauth2/access_token"
USERINFO_URL = "https://api.weixin.qq.com/sns/userinfo"


def repair_nickname(raw: Optional[str]) -> str:
    """WeChat nicknames arrive latin-1-mangled through some proxies
    (reference mojibake-safe nickname web/server.py:11713)."""
    if not raw:
        return "微信用户"
    try:
        repaired = raw.encode("latin-1").decode("utf-8")
        # Accept the repair only if it increased CJK content.
        def cjk(s):
            return sum(1 for ch in s if "一" <= ch <= "鿿")
        if cjk(repaired) > cjk(raw):
            return repaired
    except (UnicodeEncodeError, UnicodeDecodeError):
        pass
    return raw


class WeChatOAuth:
    def __init__(self, app_id: str, app_secret: str, redirect_uri: str):
        self.app_id = app_id
        self.app_secret = app_secret
        self.redirect_uri = redirect_uri
        self._states: dict = {}
        self._lock = threading.Lock()

    @property
    def configured(self) -> bool:
        return bool(self.app_id and self.app_secret and self.redirect_uri)

    def start_url(self, purpose: str = "login") -> dict:
        state = secrets.token_urlsafe(16)
        with self._lock:
            self._states[state] = {"purpose": purpose, "ts": time.time()}
            # GC old states
            cutoff = time.time() - 600
            for s in [s for s, v in self._states.items()
                      if v["ts"] < cutoff]:
                self._states.pop(s, None)
        url = (
            f"{AUTHORIZE_URL}?appid={self.app_id}"
            f"&redirect_uri={quote(self.redirect_uri)}"
            f"&response_type=code&scope=snsapi_login&state={state}"
            "#wechat_redirect"
        )
        return {"authorize_url": url, "state": state}

    def consume_state(self, state: str) -> Optional[str]:
        with self._lock:
            entry = self._states.pop(state, None)
        if entry is None or time.time() - entry["ts"] > 600:
            return None
        return entry["purpose"]

    def exchange_code(self, code: str) -> dict:
        """code -> {openid, unionid, nickname} (network)."""
        import requests

        resp = requests.get(TOKEN_URL, params={
            "appid": self.app_id, "secret": self.app_secret,
            "code": code, "grant_type": "authorization_code",
        }, timeout=15)
        resp.raise_for_status()
        token = resp.json()
        if "errcode" in token and token["errcode"]:
            raise RuntimeError(f"wechat token error: {token}")
        info = requests.get(USERINFO_URL, params={
            "access_token": token["access_token"],
            "openid": token["openid"],
        }, timeout=15)
        info.raise_for_status()
        profile = info.json()
        return {
            "openid": token["openid"],
            "unionid": token.get("unionid") or profile.get("unionid", ""),
            "nickname": repair_nickname(profile.get("nickname")),
        }
