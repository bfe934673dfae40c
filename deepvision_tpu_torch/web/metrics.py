"""Metrics: async-batched collector + stage latency percentiles.

Re-implements the reference's MetricsCollector (deque + flush thread,
web/server.py:14406-14895), per-stage latency profiles with percentiles
(:5921-6130), and cache/endpoint counters, persisted into
``runtime_metrics_store``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional

from deepvision_tpu_torch.web.meta_index import MetaIndex, utc_now_iso


def percentiles(values: List[float], ps=(50, 95, 99)) -> Dict[str, float]:
    if not values:
        return {f"p{p}": 0.0 for p in ps}
    vals = sorted(values)
    out = {}
    for p in ps:
        idx = min(len(vals) - 1, int(round((p / 100.0) * (len(vals) - 1))))
        out[f"p{p}"] = round(vals[idx], 2)
    return out


class MetricsCollector:
    def __init__(self, meta: Optional[MetaIndex] = None, *,
                 max_calls: int = 1000, flush_interval: float = 30.0):
        self.meta = meta
        self.max_calls = max_calls
        self.flush_interval = flush_interval
        self._lock = threading.Lock()
        self._ai_calls: deque = deque(maxlen=max_calls)
        self._stage_samples: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=500)
        )
        self._counters: Dict[str, int] = defaultdict(int)
        self._endpoint_samples: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=500)
        )
        self._question_gen: dict = self._empty_question_gen()
        self._flusher: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @staticmethod
    def _empty_question_gen() -> dict:
        return {
            "count": 0, "by_tier": {}, "by_lane": {},
            "hedge_triggered": 0, "fallback_triggered": 0,
            "cache_hits": 0, "by_mode": {},
        }

    # -- question generation aggregates (reference get_question_generation_
    # stats_snapshot, web/server.py:44909-44913) --------------------------
    def record_question_generation(
        self, *, mode: str = "", tier: str = "", lane: str = "",
        hedged: bool = False, fallback: bool = False, cached: bool = False,
    ) -> None:
        with self._lock:
            agg = self._question_gen
            agg["count"] += 1
            if tier:
                agg["by_tier"][tier] = agg["by_tier"].get(tier, 0) + 1
            if lane:
                agg["by_lane"][lane] = agg["by_lane"].get(lane, 0) + 1
            if hedged:
                agg["hedge_triggered"] += 1
            if fallback:
                agg["fallback_triggered"] += 1
            if cached:
                agg["cache_hits"] += 1
            m = agg["by_mode"].setdefault(
                mode or "standard", {"count": 0, "fallback_triggered": 0}
            )
            m["count"] += 1
            if fallback:
                m["fallback_triggered"] += 1

    def question_generation_stats(self) -> dict:
        with self._lock:
            return json.loads(json.dumps(self._question_gen))

    def search_decision_stats(self) -> dict:
        with self._lock:
            yes = self._counters.get("search.decision.yes", 0)
            no = self._counters.get("search.decision.no", 0)
        return {"total": yes + no, "need_search": yes, "no_search": no}

    # -- recording -------------------------------------------------------
    def record_ai_call(self, call_type: str, meta: dict) -> None:
        with self._lock:
            self._ai_calls.append(
                {"call_type": call_type, "ts": time.time(), **meta}
            )
            self._counters[f"ai_calls.{call_type}"] += 1
            if meta.get("failure_reason"):
                self._counters[f"ai_failures.{call_type}"] += 1

    def record_stage(self, pipeline: str, stage: str, ms: float) -> None:
        with self._lock:
            self._stage_samples[f"{pipeline}.{stage}"].append(ms)

    def record_stages(self, pipeline: str, stages: Dict[str, float]) -> None:
        for stage, ms in stages.items():
            self.record_stage(pipeline, stage, ms)

    def record_endpoint(self, endpoint: str, ms: float, status: int) -> None:
        with self._lock:
            self._endpoint_samples[endpoint].append(ms)
            self._counters[f"http.{endpoint}.{status // 100}xx"] += 1

    def incr(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self._counters[counter] += n

    # -- reporting -------------------------------------------------------
    def stage_latency_profiles(self) -> dict:
        with self._lock:
            return {
                key: {"count": len(samples), **percentiles(list(samples))}
                for key, samples in self._stage_samples.items()
            }

    def statistics(self, last_n: Optional[int] = None) -> dict:
        with self._lock:
            calls = list(self._ai_calls)[-(last_n or self.max_calls):]
            counters = dict(self._counters)
            endpoints = {
                ep: {"count": len(s), **percentiles(list(s))}
                for ep, s in self._endpoint_samples.items()
            }
        total_ms = [c.get("total_ms", 0) for c in calls if c.get("total_ms")]
        queue_ms = [
            c.get("queue_wait_ms", 0) for c in calls
            if c.get("queue_wait_ms") is not None
        ]
        by_lane: Dict[str, int] = defaultdict(int)
        for c in calls:
            if c.get("lane"):
                by_lane[c["lane"]] += 1
        return {
            "ai_calls": {
                "count": len(calls),
                "total_ms": percentiles(total_ms),
                "queue_wait_ms": percentiles(queue_ms),
                "by_lane": dict(by_lane),
            },
            "counters": counters,
            "list_endpoints": endpoints,
            "stage_latency": self.stage_latency_profiles(),
        }

    def reset(self) -> None:
        with self._lock:
            self._ai_calls.clear()
            self._stage_samples.clear()
            self._counters.clear()
            self._endpoint_samples.clear()
            self._question_gen = self._empty_question_gen()

    # -- persistence (flush thread; reference :14421) --------------------
    def start_flusher(self) -> None:
        if self._flusher or self.meta is None:
            return
        self._stop.clear()
        self._flusher = threading.Thread(
            target=self._flush_loop, name="dv-metrics-flush", daemon=True
        )
        self._flusher.start()

    def stop_flusher(self) -> None:
        self._stop.set()
        if self._flusher:
            self._flusher.join(2)
            self._flusher = None

    def _flush_loop(self) -> None:
        while not self._stop.wait(self.flush_interval):
            self.flush()

    def flush(self) -> None:
        if self.meta is None:
            return
        snapshot = self.statistics()
        self.meta.execute(
            "INSERT INTO runtime_metrics_store (kind, payload, created_at) "
            "VALUES (?, ?, ?)",
            ("snapshot", json.dumps(snapshot, ensure_ascii=False),
             utc_now_iso()),
        )


class StageTimer:
    """Per-request stage accounting (reference stage dicts
    web/server.py:29872-29880)."""

    def __init__(self):
        self.stages: Dict[str, float] = {}
        self._t = time.monotonic()

    def mark(self, stage: str) -> None:
        now = time.monotonic()
        self.stages[stage] = round((now - self._t) * 1e3, 1)
        self._t = now
