"""Engine replica router — scale-out in front of N engine replicas.

A copy of the JAX package's ``engine/router.py`` over the port's engines.

The reference scaled by running Gunicorn workers against 8 remote HTTP
lanes (SURVEY.md §5.8); here requests route across local engine replicas
(one per device on a host) and, across hosts, over the network to remote
engine services (engine/service.py).  The router only moves requests;
tensors stay inside each replica.

Routing policy (in order):
1. **Prefix stickiness** — requests with a ``prefix_key`` hash to a home
   replica so its device-side KV prefix cache keeps hitting;
2. **Health** — replicas with recent consecutive errors are skipped for a
   cooldown window (per-replica mini-breaker, the engine-level analogue of
   the gateway's lane breaker);
3. **Least-loaded** — among the healthy candidates, lowest queue depth
   (pending + active) wins;
4. **Failover** — on error/overload the request retries once on the next
   candidate.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import List, Optional

from deepvision_tpu_torch.engine.scheduler import EngineOverloadedError


class _ReplicaHealth:
    def __init__(self, cooldown_s: float = 10.0, threshold: int = 2):
        self.cooldown_s = cooldown_s
        self.threshold = threshold
        self.failures = 0
        self.open_until = 0.0
        self._lock = threading.Lock()

    def ok(self) -> bool:
        return time.monotonic() >= self.open_until

    def record_success(self):
        with self._lock:
            self.failures = 0

    def record_failure(self):
        with self._lock:
            self.failures += 1
            if self.failures >= self.threshold:
                self.open_until = time.monotonic() + self.cooldown_s
                self.failures = 0


class EngineRouter:
    """Routes the LLMEngine surface across replicas.

    Exposes the same ``generate_text`` / ``stats`` / ``shutdown`` API as a
    single engine, so the gateway can hold a router wherever it holds an
    engine (drop-in, reference's client-reuse pattern web/server.py:15221).
    """

    def __init__(self, replicas: List, *, cooldown_s: float = 10.0):
        if not replicas:
            raise ValueError("EngineRouter needs at least one replica")
        self.replicas = list(replicas)
        self.health = [_ReplicaHealth(cooldown_s) for _ in self.replicas]
        self.routed = [0] * len(self.replicas)
        self.inflight = [0] * len(self.replicas)
        self.failovers = 0
        self._lock = threading.Lock()
        # model_cfg passthrough for stats/meta consumers
        self.model_cfg = getattr(replicas[0], "model_cfg", None)
        self.json_dfa = getattr(replicas[0], "json_dfa", None)

    # -- candidate selection ---------------------------------------------
    def _queue_depth(self, eng) -> int:
        try:
            q = eng.scheduler.queue_depths()
            return q["high"] + q["low"] + q["active"] + q["prefilling"]
        except Exception:  # remote replicas: no cheap depth probe
            return 0

    def _candidates(self, prefix_key: Optional[str]) -> List[int]:
        n = len(self.replicas)
        healthy = [i for i in range(n) if self.health[i].ok()]
        if not healthy:
            healthy = list(range(n))  # forced-open fallback
        if prefix_key:
            # stable across processes/restarts (built-in hash() is
            # PYTHONHASHSEED-randomized, which would re-home every session
            # on restart and defeat the device-side prefix cache)
            home = zlib.crc32(str(prefix_key).encode()) % n
            # home first (prefix-cache locality), then the rest by load
            rest = sorted(
                (i for i in healthy if i != home),
                key=self._load_of,
            )
            return ([home] + rest) if home in healthy else rest + [home]
        return sorted(healthy, key=self._load_of)

    def _load_of(self, idx: int) -> int:
        # router-tracked in-flight covers remote replicas too (their
        # scheduler depth is not cheaply observable over HTTP)
        return self.inflight[idx] + self._queue_depth(self.replicas[idx])

    # -- engine surface ----------------------------------------------------
    def start(self) -> None:
        # one unhealthy replica must not block boot: mark its breaker
        # open and let the health loop recover it later
        last_exc = None
        started = 0
        for i, eng in enumerate(self.replicas):
            try:
                eng.start()
                started += 1
            except Exception as e:  # noqa: BLE001
                self.health[i].record_failure()
                self.health[i].record_failure()  # force-open the breaker
                last_exc = e
        if started == 0 and last_exc is not None:
            raise last_exc

    def shutdown(self) -> None:
        for eng in self.replicas:
            eng.shutdown()

    def generate_text(self, prompt: str, **kw):
        prefix_key = kw.get("prefix_key")
        candidates = self._candidates(prefix_key)
        last_exc: Optional[Exception] = None
        for attempt, idx in enumerate(candidates[:2]):  # one failover hop
            eng = self.replicas[idx]
            try:
                with self._lock:
                    self.inflight[idx] += 1
                try:
                    text, meta = eng.generate_text(prompt, **kw)
                finally:
                    with self._lock:
                        self.inflight[idx] -= 1
            except (EngineOverloadedError, TimeoutError,
                    RuntimeError, OSError) as e:
                # OSError covers urllib URLError (connection refused/reset)
                # from remote replicas
                self.health[idx].record_failure()
                last_exc = e
                if attempt == 0 and len(candidates) > 1:
                    with self._lock:
                        self.failovers += 1
                continue
            self.health[idx].record_success()
            with self._lock:
                self.routed[idx] += 1
            meta["replica"] = idx
            if attempt > 0:
                meta["failover"] = True
            return text, meta
        raise last_exc if last_exc else RuntimeError("no replica available")

    def stats(self) -> dict:
        per = []
        for i, eng in enumerate(self.replicas):
            try:
                s = eng.stats()
            except Exception as e:  # noqa: BLE001
                s = {"error": str(e)}
            s["routed"] = self.routed[i]
            s["healthy"] = self.health[i].ok()
            per.append(s)
        return {
            "router": {
                "replicas": len(self.replicas),
                "failovers": self.failovers,
                "routed": list(self.routed),
            },
            "replicas": per,
            # single-engine compat keys (first replica representative)
            "model": per[0].get("model") if per else None,
            "queues": per[0].get("queues") if per else {},
            "tokens_generated": sum(
                s.get("tokens_generated", 0) for s in per),
            "requests_finished": sum(
                s.get("requests_finished", 0) for s in per),
            "rejected_overload": sum(
                s.get("rejected_overload", 0) for s in per),
            "decode_steps": sum(s.get("decode_steps", 0) for s in per),
        }
