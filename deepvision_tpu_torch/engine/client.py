"""ModelGateway — ``call_model``: the app's single synchronous AI entry.

Parity target: the reference app's synchronous model-call contract
(its web/server.py:26860 → :26672): one synchronous call
that resolves a lane, respects per-lane circuit cooldowns, walks fallback
candidates, retries timeouts with a 70%-shrunk prompt, and returns
``text`` or ``(text, meta)`` with lane/model/queue_wait/failure_reason.

"Lanes" are local generation profiles (engine replicas + scheduler
priorities) instead of remote HTTP clients, the circuit breaker watches
local engine health instead of gateway 5xx, and hedged duplicate requests
are replaced by scheduler priority (SURVEY.md §5.8).

A copy of the JAX package's ``engine/client.py`` over the port's engines.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from deepvision_tpu_torch.engine import template_backend
from deepvision_tpu_torch.engine.lanes import (
    DEFAULT_LANES,
    LaneProfile,
    resolve_lanes,
)

# Call types whose responses the app json-parses — these get kernel-level
# grammar constraints (engine/constrained.py); free-text call types
# (summaries, chat) stay unconstrained.
JSON_CALL_TYPES = frozenset({
    "question", "question_fast", "question_deep",
    "report", "report_draft", "report_review",
    "search_decision", "assessment", "scenario", "solution_copy",
})


class GatewayError(RuntimeError):
    pass


class CircuitBreaker:
    """Per-lane failure window/threshold/cooldown (reference
    record_gateway_lane_failure web/server.py:15097, threshold 2 at :1003)."""

    def __init__(self, threshold: int = 2, window_s: float = 60.0,
                 cooldown_s: float = 30.0):
        self.threshold = threshold
        self.window_s = window_s
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self._failures: Dict[str, list] = {}
        self._open_until: Dict[str, float] = {}

    def record_failure(self, lane: str, kind: str = "error") -> None:
        now = time.monotonic()
        with self._lock:
            window = [
                t for t in self._failures.get(lane, [])
                if now - t < self.window_s
            ]
            window.append(now)
            self._failures[lane] = window
            if len(window) >= self.threshold:
                self._open_until[lane] = now + self.cooldown_s

    def record_success(self, lane: str) -> None:
        with self._lock:
            self._failures.pop(lane, None)
            self._open_until.pop(lane, None)

    def in_cooldown(self, lane: str) -> bool:
        with self._lock:
            until = self._open_until.get(lane)
            if until is None:
                return False
            if time.monotonic() >= until:
                del self._open_until[lane]
                return False
            return True

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            return {
                lane: {
                    "cooldown_remaining_s": round(max(0.0, until - now), 1),
                    "recent_failures": len(self._failures.get(lane, [])),
                }
                for lane, until in self._open_until.items()
            }


class ModelGateway:
    """Routes call types to lanes and lanes to backends.

    mode:
      * ``"template"`` — deterministic structured outputs (tests/mock/demo).
      * ``"engine"``   — local LLMEngine replicas from ``engines`` registry.
      * ``"off"``      — every call raises (app falls back to rule-based).
    """

    def __init__(
        self,
        mode: str = "template",
        engines: Optional[dict] = None,
        lanes: Optional[Dict[str, LaneProfile]] = None,
        breaker: Optional[CircuitBreaker] = None,
        metrics_hook=None,
    ):
        self.mode = mode
        self.engines = engines or {}
        self.lanes = dict(lanes or DEFAULT_LANES)
        self.breaker = breaker or CircuitBreaker()
        self.metrics_hook = metrics_hook
        self.call_count = 0
        self._lock = threading.Lock()
        # adaptive lane-order (reference promote-on-success-stats
        # web/server.py:4049-4249): per-lane success counts + latency EWMA;
        # after MIN_SAMPLES the candidate order prefers healthy-fast lanes.
        self._lane_stats: Dict[str, dict] = {}
        self.adaptive_lane_order = True
        self.ADAPTIVE_MIN_SAMPLES = 6
        # chunk-embedding LRU (embed_texts); mutated under self._lock —
        # concurrent assistant-chat requests share the gateway
        self._embed_cache: "OrderedDict[str, object]" = OrderedDict()

    def _record_lane_stat(self, lane: str, ok: bool, ms: float) -> None:
        with self._lock:
            s = self._lane_stats.setdefault(
                lane, {"calls": 0, "failures": 0, "ewma_ms": None})
            s["calls"] += 1
            if not ok:
                s["failures"] += 1
            elif ms is not None:
                prev = s["ewma_ms"]
                s["ewma_ms"] = ms if prev is None else 0.8 * prev + 0.2 * ms

    def _adaptive_order(self, candidates):
        """Reorder fallback candidates by observed health: lanes with a
        high recent failure rate demote below their fallback even before
        the circuit opens; among healthy lanes, faster EWMA wins.  The
        configured primary keeps a slight edge so ordering is sticky."""
        if not self.adaptive_lane_order or len(candidates) < 2:
            return candidates

        def score(idx_lane):
            idx, lane = idx_lane
            s = self._lane_stats.get(lane)
            if not s or s["calls"] < self.ADAPTIVE_MIN_SAMPLES:
                return (0.0, idx)
            fail_rate = s["failures"] / s["calls"]
            ewma = s["ewma_ms"] or 0.0
            return (fail_rate * 100 + ewma / 1000.0, idx)

        return [l for _, l in sorted(enumerate(candidates), key=score)]

    def lane_stats_snapshot(self) -> dict:
        with self._lock:
            return {k: dict(v) for k, v in self._lane_stats.items()}

    def embed_texts(self, texts):
        """Semantic embeddings from the first engine replica that exposes
        them (LLMEngine.embed_texts — the serving params double as the
        encoder).  Returns an [N, d] array or None when no engine can
        embed (template backend, or every engine failed): callers fall
        back to keyword-only retrieval.

        Chunk embeddings are immutable per text, and chat re-ranks the
        SAME session chunks every message — an LRU keyed by text caches
        them so a repeat call embeds only the novel texts (usually just
        the query)."""
        cache = self._embed_cache
        with self._lock:
            missing = [t for t in dict.fromkeys(texts) if t not in cache]
        if missing:
            # embedding runs OUTSIDE the lock (device work); duplicate
            # effort on a rare race is fine, corruption is not
            fresh = None
            for engine in self.engines.values():
                fn = getattr(engine, "embed_texts", None)
                if fn is None:
                    continue
                try:
                    fresh = fn(missing)
                except Exception:  # noqa: BLE001 — retrieval must degrade
                    continue
                if fresh is not None:
                    break
            if fresh is None:
                return None
            with self._lock:
                for t, vec in zip(missing, fresh):
                    cache[t] = vec
                while len(cache) > 512:
                    cache.popitem(last=False)
        with self._lock:
            try:
                rows = [cache[t] for t in texts]
            except KeyError:
                return None
            for t in texts:
                cache.move_to_end(t, last=True)
        return np.stack(rows)

    # ------------------------------------------------------------------

    def call_model(
        self,
        prompt: str,
        call_type: str = "question",
        *,
        preferred_lane: Optional[str] = None,
        timeout: Optional[float] = None,
        max_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        context: Optional[dict] = None,
        return_meta: bool = False,
    ):
        if self.mode == "off":
            raise GatewayError("AI disabled (mode=off)")
        with self._lock:
            self.call_count += 1

        candidates = [
            lane for lane in resolve_lanes(call_type, preferred_lane)
            if lane in self.lanes
        ]
        candidates = self._adaptive_order(candidates)
        usable = [l for l in candidates if not self.breaker.in_cooldown(l)]
        if not usable:
            usable = candidates[:1]  # forced-open fallback (ref :15076)

        t_start = time.monotonic()
        last_error: Optional[str] = None
        attempts = 0
        for lane_name in usable:
            profile = self.lanes[lane_name]
            lane_timeout = timeout or profile.timeout_s
            lane_max_tokens = max_tokens or profile.max_tokens
            attempts += 1
            try:
                text, meta = self._call_lane(
                    profile, prompt, call_type, lane_timeout,
                    lane_max_tokens, temperature, context,
                )
            except TimeoutError as e:
                # Prompt-shrink retry: 70% + truncation note (ref
                # web/server.py:26791-26815), once, same lane.
                last_error = f"timeout: {e}"
                attempts += 1
                try:
                    shrunk = self._shrink_prompt(prompt)
                    text, meta = self._call_lane(
                        profile, shrunk, call_type, lane_timeout,
                        lane_max_tokens, temperature, context,
                    )
                    meta["prompt_shrunk"] = True
                except Exception as e2:  # noqa: BLE001
                    self.breaker.record_failure(lane_name, "timeout")
                    self._record_lane_stat(lane_name, False, None)
                    last_error = f"{type(e2).__name__}: {e2}"
                    continue
            except Exception as e:  # noqa: BLE001
                self.breaker.record_failure(lane_name, "error")
                self._record_lane_stat(lane_name, False, None)
                last_error = f"{type(e).__name__}: {e}"
                continue

            produced_tokens = meta.get("completion_tokens", 0)
            if not (text or "").strip() and not produced_tokens:
                # Empty-response detection (the reference's empty guard).
                # Engine mode counts tokens: non-text tokens (specials) can
                # decode to empty text without being a lane failure.
                self.breaker.record_failure(lane_name, "empty")
                self._record_lane_stat(lane_name, False, None)
                last_error = "empty response"
                continue

            self.breaker.record_success(lane_name)
            self._record_lane_stat(
                lane_name, True, meta.get("total_ms")
                or (time.monotonic() - t_start) * 1e3)
            meta.update(
                lane=lane_name,
                call_type=call_type,
                attempts=attempts,
                total_ms=round((time.monotonic() - t_start) * 1e3, 1),
                failure_reason=None,
            )
            if self.metrics_hook:
                self.metrics_hook(call_type, meta)
            return (text, meta) if return_meta else text

        meta = {
            "lane": usable[-1] if usable else None,
            "call_type": call_type,
            "attempts": attempts,
            "total_ms": round((time.monotonic() - t_start) * 1e3, 1),
            "failure_reason": last_error or "no usable lane",
        }
        if self.metrics_hook:
            self.metrics_hook(call_type, meta)
        raise GatewayError(
            f"all lanes failed for call_type={call_type}: {last_error}"
        )

    # ------------------------------------------------------------------

    @staticmethod
    def _shrink_prompt(prompt: str) -> str:
        keep = int(len(prompt) * 0.7)
        return (
            prompt[:keep]
            + "\n\n[注意：上下文因超时已截断，请基于以上内容作答]"
        )

    def _call_lane(
        self, profile: LaneProfile, prompt: str, call_type: str,
        timeout: float, max_tokens: int, temperature: Optional[float],
        context: Optional[dict],
    ):
        if self.mode == "template":
            text = template_backend.generate(call_type, prompt, context)
            return text, {
                "model": "template",
                "queue_wait_ms": 0.0,
                "completion_tokens": len(text),
            }
        engine = self.engines.get(profile.engine) or next(
            iter(self.engines.values()), None
        )
        if engine is None:
            raise GatewayError(f"no engine registered for lane {profile.name}")
        temp = profile.temperature if temperature is None else temperature
        # Sessions reuse their prompt head across calls; keying the engine's
        # prefix cache by session makes follow-up prefills skip the shared
        # pages (device-side analogue of the reference's per-session prompt
        # cache, web/server.py:4920).
        prefix_key = (context or {}).get("session_id")
        return engine.generate_text(
            prompt,
            max_tokens=max_tokens,
            temperature=temp,
            top_k=profile.top_k,
            top_p=profile.top_p,
            priority=profile.priority,
            timeout=timeout,
            prefix_key=prefix_key,
            json_mode=call_type in JSON_CALL_TYPES,
        )

    # ------------------------------------------------------------------

    def circuit_snapshot(self) -> dict:
        return self.breaker.snapshot()


# ---------------------------------------------------------------------------
# Process-wide gateway (the app configures this at startup)
# ---------------------------------------------------------------------------

_gateway: Optional[ModelGateway] = None
_gateway_lock = threading.Lock()


def configure_gateway(gateway: ModelGateway) -> ModelGateway:
    global _gateway
    with _gateway_lock:
        _gateway = gateway
    return gateway


def get_gateway() -> ModelGateway:
    global _gateway
    with _gateway_lock:
        if _gateway is None:
            _gateway = ModelGateway(mode="template")
        return _gateway


def call_model(prompt: str, call_type: str = "question", **kw):
    return get_gateway().call_model(prompt, call_type, **kw)
