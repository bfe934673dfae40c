"""Web search: rule+AI need decision, MCP JSON-RPC client, result cache.

Re-implements the reference search stack (MCPClient web/server.py:17349-17550
speaking MCP protocol 2024-11-05 over HTTP/SSE, web_search :17551, rule+AI
decision :17667-17959 with decision cache + inflight dedupe :4033-4850).
Disabled by default (zero-egress deployments); the decision layer still
runs so prompts record the decision meta.
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Dict

_TIME_SENSITIVE = ("最新", "今年", "2025", "2026", "行情", "价格", "政策",
                   "市场规模", "竞品", "趋势")
_LOCAL_ANSWERABLE = ("流程", "痛点", "期望", "团队", "预算", "内部")


class MCPClient:
    """Minimal MCP JSON-RPC-over-HTTP client (protocol 2024-11-05)."""

    def __init__(self, url: str, api_key: str = "", timeout: float = 15.0):
        self.url = url
        self.api_key = api_key
        self.timeout = timeout
        self._id = 0
        self._lock = threading.Lock()
        self._initialized = False

    def _call(self, method: str, params: dict) -> dict:
        import requests

        with self._lock:
            self._id += 1
            req_id = self._id
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        resp = requests.post(
            self.url,
            json={"jsonrpc": "2.0", "id": req_id, "method": method,
                  "params": params},
            headers=headers,
            timeout=self.timeout,
        )
        resp.raise_for_status()
        data = resp.json()
        if "error" in data:
            raise RuntimeError(f"MCP error: {data['error']}")
        return data.get("result", {})

    def ensure_initialized(self) -> None:
        if self._initialized:
            return
        self._call("initialize", {
            "protocolVersion": "2024-11-05",
            "capabilities": {},
            "clientInfo": {"name": "deepvision-tpu", "version": "0.1"},
        })
        self._initialized = True

    def search(self, query: str) -> str:
        self.ensure_initialized()
        result = self._call(
            "tools/call",
            {"name": "web_search", "arguments": {"query": query}},
        )
        parts = []
        for item in result.get("content", []):
            if item.get("type") == "text":
                parts.append(item.get("text", ""))
        return "\n".join(parts)


class SearchService:
    def __init__(self, gateway, *, enabled: bool = False,
                 mcp_url: str = "", mcp_key: str = "", metrics=None):
        self.gateway = gateway
        self.enabled = enabled and bool(mcp_url)
        self.client = MCPClient(mcp_url, mcp_key) if mcp_url else None
        self.metrics = metrics
        self._decision_cache: Dict[str, dict] = {}
        self._result_cache: Dict[str, tuple] = {}
        self._inflight: Dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        self.status = {"active": False, "query": "", "updated_at": None}

    # -- decision (rule layer then AI layer; reference :17667-17959) -----
    def smart_search_decision(self, topic: str, question_hint: str = "") -> dict:
        key = f"{topic}:{question_hint}"[:200]
        with self._lock:
            if key in self._decision_cache:
                return self._decision_cache[key]
        text = f"{topic} {question_hint}"
        decision = None
        if any(m in text for m in _TIME_SENSITIVE):
            decision = {"need_search": True, "query": topic[:60],
                        "reason": "rule:time_sensitive"}
        elif all(m not in text for m in _TIME_SENSITIVE) and any(
            m in text for m in _LOCAL_ANSWERABLE
        ):
            decision = {"need_search": False, "reason": "rule:local_topic"}
        if decision is None:
            try:
                raw = self.gateway.call_model(
                    f"判断以下访谈话题是否需要联网检索外部信息，输出 JSON "
                    f'{{"need_search": bool, "query": "检索词"}}：{text[:300]}',
                    call_type="search_decision",
                    context={"topic": topic},
                )
                decision = json.loads(re.search(r"\{.*\}", raw, re.S).group(0))
                decision["reason"] = "ai"
            except Exception:
                decision = {"need_search": False, "reason": "decision_failed"}
        with self._lock:
            self._decision_cache[key] = decision
        if self.metrics:
            self.metrics.incr(
                "search.decision."
                + ("yes" if decision.get("need_search") else "no")
            )
        return decision

    # -- search with cache + inflight dedupe (reference :4764-4850) ------
    def search(self, query: str, ttl: float = 600.0) -> str:
        if not self.enabled or not self.client:
            return ""
        with self._lock:
            hit = self._result_cache.get(query)
            if hit and time.time() - hit[0] < ttl:
                return hit[1]
            ev = self._inflight.get(query)
            if ev is None:
                ev = self._inflight[query] = threading.Event()
                owner = True
            else:
                owner = False
        if not owner:
            ev.wait(20)
            with self._lock:
                hit = self._result_cache.get(query)
            return hit[1] if hit else ""
        try:
            self.status.update(active=True, query=query,
                               updated_at=time.time())
            result = self.client.search(query)
            with self._lock:
                self._result_cache[query] = (time.time(), result)
            return result
        except Exception:
            return ""
        finally:
            self.status.update(active=False)
            with self._lock:
                self._inflight.pop(query, None)
            ev.set()

    def maybe_search_for_session(self, session: dict) -> str:
        if not self.enabled:
            return ""
        decision = self.smart_search_decision(
            session.get("topic", ""), session.get("description", "")
        )
        if not decision.get("need_search"):
            return ""
        return self.search(decision.get("query") or session.get("topic", ""))
