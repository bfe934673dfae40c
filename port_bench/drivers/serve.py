"""Serving window: closed-loop clients over ``LLMEngine.submit_tokens``.

Set-up builds the engine on the benchmark's weights with the mix's engine
settings (the engine's own warm-up runs every prefill bucket and one decode
call).  Then every client keeps one request in flight: when it finishes,
the client submits its next one.  The first ``settle_seconds`` of that are
set-up (the mix's shapes run once and the slots fill); the window follows.
At the close the clients stop submitting and the requests in flight are
awaited.  Then the engine is shut down and freed, and the reference scores
a sample of the finished greedy requests without the grammar (json_mode
requests are constrained by the grammar's mask, which the reference does
not model).
"""

from __future__ import annotations

import gc
import os
import queue
import random
import sys
import threading
import time

import torch

from port_bench import weights as bench_weights
from port_bench.harness import DeviceTrace, process_age_s
from port_bench.reference import model as ref
from port_bench.traffic_gen.streams import STREAMS

CHECKS = "serve"   # the configuration's limits this driver takes


def build_engine(ctx, params):
    """The program's engine on ``params``: its boot path would draw or
    load weights itself, so its loader hands over the benchmark's."""
    from deepvision_tpu_torch.engine import engine as engine_mod
    from deepvision_tpu_torch.engine.config import ModelConfig

    settings = dict(ctx.traffic["engine"], **ctx.engine_overrides)
    ecfg = engine_mod.EngineConfig(
        model=ctx.config["model"]["name"],
        tokenizer=os.path.join(ctx.root, ctx.config["tokenizer"]),
        checkpoint_dir=None, device=ctx.device, seed=ctx.seed % 2 ** 63,
        **settings)
    loader = engine_mod.load_or_init
    engine_mod.load_or_init = lambda *a, **k: params
    try:
        eng = engine_mod.LLMEngine(ecfg, ModelConfig(**ctx.config["model"]))
    finally:
        engine_mod.load_or_init = loader
    return eng


class _Client:
    """One closed-loop client: its stream and its request in flight."""

    def __init__(self, stream):
        self.stream = stream
        self.req = None
        self.spec = None


class _Clients:
    """The clients, woken once per finished request: each request's
    ``finish`` also puts its client on a queue, so the one client thread
    sleeps until a request finishes instead of polling the engine."""

    def __init__(self, eng, streams):
        self.eng = eng
        self.clients = [_Client(s) for s in streams]
        self.finished = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._queued = set()

    def _notify(self, client, req) -> None:
        with self._lock:
            if id(req) in self._queued:
                return
            self._queued.add(id(req))
        self.finished.put((client, req))

    def submit(self, client) -> int:
        spec = next(client.stream)
        req = self.eng.submit_tokens(
            spec.prompt, max_tokens=spec.max_tokens, temperature=0.0,
            stop_token_ids=[], prefix_key=spec.prefix_key,
            json_mode=spec.json_mode)
        finish = req.finish

        def hooked(result, _finish=finish, _client=client, _req=req):
            _finish(result)
            self._notify(_client, _req)

        req.finish = hooked
        client.spec, client.req = spec, req
        if req.wait(0) is not None:   # finished before the hook was set
            self._notify(client, req)
        return len(spec.prompt)

    def run(self, until: float, done: list, stop=None) -> int:
        """Resubmit for every client whose request finished, until
        ``until`` (or until ``stop()``); finished requests go to ``done``.
        Returns the prompt tokens submitted."""
        prompt_tokens = 0
        while not (stop is not None and stop()):
            left = until - time.monotonic()
            if left <= 0:
                break
            try:
                client, req = self.finished.get(timeout=min(left, 0.05))
            except queue.Empty:
                continue
            done.append((client.spec, req.wait(0)))
            prompt_tokens += self.submit(client)
        return prompt_tokens


def _trace_decode(eng, trace: DeviceTrace, begin: threading.Event,
                  seconds: float, calls: list):
    """Wraps the runner's decode call: once ``begin`` is set the trace
    starts before the next call and stops after the call that ends
    ``seconds`` later (the profiler records the torch ops of the thread
    that starts it: the scheduler's); each traced call's lengths and
    budgets are kept."""
    runner = eng.runner
    orig = runner.decode

    def decode(tokens, seq_lens, block_tables, temperature, top_k, top_p,
               n_steps=1, dfa_states=None, budgets=None):
        if trace.prof is None and begin.is_set():
            trace.start()
        with torch.profiler.record_function("runner.decode"):
            out = orig(tokens, seq_lens, block_tables, temperature, top_k,
                       top_p, n_steps=n_steps, dfa_states=dfa_states,
                       budgets=budgets)
        if trace.active:
            calls.append((seq_lens.copy(), budgets.copy(), n_steps))
            if time.monotonic() >= trace.t0 + seconds:
                trace.stop()
        return out

    runner.decode = decode
    for name in ("prefill_batch", "prefill"):
        fn = getattr(runner, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            with torch.profiler.record_function("runner." + _name):
                return _fn(*a, **k)

        setattr(runner, name, wrapped)


def run(ctx) -> dict:
    from deepvision_tpu_torch.engine.tokenizer import get_tokenizer

    mix = ctx.traffic
    params = bench_weights.make_params(ctx.config["model"], ctx.seed,
                                       ctx.device, torch.bfloat16)
    ctx.mark("weights")
    eng = build_engine(ctx, params)
    ctx.mark("engine")
    ctx.plant(eng)
    eng.start()
    ctx.mark("engine warm-up")
    tokenizer = get_tokenizer(os.path.join(ctx.root, ctx.config["tokenizer"]))
    make = STREAMS[mix["kind"]]
    clients = _Clients(eng, [make(mix, ctx.seed, c, tokenizer)
                             for c in range(mix["clients"])])
    for c in clients.clients:
        clients.submit(c)
    clients.run(time.monotonic() + mix["settle_seconds"], [])
    ctx.mark("settling")
    trace, calls = DeviceTrace(ctx.device == "cuda"), []
    begin = threading.Event()
    if ctx.trace:
        _trace_decode(eng, trace, begin, mix["trace_seconds"], calls)
    setup_peak = 0
    if ctx.device == "cuda":
        setup_peak = torch.cuda.max_memory_allocated()
    stats0 = eng.stats()
    t0 = time.monotonic()
    setup_s = process_age_s()
    done = []
    submitted = clients.run(t0 + ctx.seconds, done)
    stats1 = eng.stats()
    t1 = time.monotonic()
    if ctx.trace:
        # the traced slice follows the window under the same load, so the
        # profiler's start and stop stall no part of the window
        begin.set()
        clients.run(t1 + mix["trace_seconds"] + mix["drain_seconds"], [],
                    stop=lambda: trace.done)
    # the requests in flight at the close are awaited, then checked too
    deadline = t1 + mix["drain_seconds"]
    late = []
    for c in clients.clients:
        res = c.req.wait(max(0.0, deadline - time.monotonic()))
        late.append((c.spec, res))
    if trace.active:
        trace.stop()
    window = done
    memory_peak = (max(setup_peak, torch.cuda.max_memory_allocated())
                   if ctx.device == "cuda" else 0)
    eng.shutdown()
    counters = _counters(stats0, stats1, window, t1 - t0)
    counters["prompt_tokens_submitted"] = submitted
    finished = window + [(s, r) for s, r in late if r is not None]
    failed = sum(1 for _, r in finished if not r.ok) + sum(
        1 for _, r in late if r is None)
    print(f"serve: {len(window)} requests finished in the window, "
          f"{counters['client_tokens']} of their tokens; engine deltas: "
          f"tokens_generated {counters['tokens_generated']}, decode_steps "
          f"{counters['decode_steps']}, decode_time_s "
          f"{counters['decode_time_s']:.3f}, tokens_saved "
          f"{counters['tokens_saved']}", file=sys.stderr)
    del eng
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    checks = _check(ctx, params, finished)
    return {
        "setup_s": setup_s,
        "window_s": t1 - t0,
        "e2e": {"serve_tokens_per_s": counters["tokens_generated"]
                / (t1 - t0)},
        "attempted": len(window) + len(late),
        "failed": failed,
        "memory_peak_bytes": memory_peak,
        "counters": counters,
        "trace": (dict(trace.summary(), decode_calls=calls)
                  if trace.done else None),
        "checks": checks,
    }


def _counters(stats0, stats1, window, window_s) -> dict:
    pc0 = stats0.get("prefix_cache") or {}
    pc1 = stats1.get("prefix_cache") or {}
    return {
        "window_s": window_s,
        "tokens_generated": (stats1["tokens_generated"]
                             - stats0["tokens_generated"]),
        "decode_steps": stats1["decode_steps"] - stats0["decode_steps"],
        "decode_time_s": stats1["decode_time_s"] - stats0["decode_time_s"],
        "tokens_saved": (pc1.get("tokens_saved", 0)
                         - pc0.get("tokens_saved", 0)),
        "prefix_cache": bool(pc1),
        "client_tokens": sum(len(r.token_ids) for _, r in window),
        "requests": [{"prompt": len(s.prompt), "output": len(r.token_ids),
                      "ttft_ms": r.queue_wait_ms + r.prefill_ms}
                     for s, r in window if r.ok],
    }


def _check(ctx, params, finished) -> dict:
    """Widest gap of a served greedy token below the reference's best, over
    a sample drawn from the seed with the longest finished request in it."""
    limit = ctx.limits["logit_gap"]
    plain = [(s, r) for s, r in finished if not s.json_mode and r.ok
             and r.token_ids]
    if not plain:
        return {"logit_gap": {"value": None, "limit": limit}}
    rng = random.Random(f"{ctx.seed}:check")
    longest = max(plain, key=lambda sr: len(sr[0].prompt) + len(sr[1]
                                                                .token_ids))
    rest = [sr for sr in plain if sr is not longest]
    rng.shuffle(rest)
    sample, tokens = [longest], len(longest[1].token_ids)
    want = ctx.traffic["check"]
    for sr in rest:
        if tokens >= want["min_tokens"] or len(sample) >= want["max_requests"]:
            break
        sample.append(sr)
        tokens += len(sr[1].token_ids)
    ref.exact_float32()
    worst = 0.0
    for spec, res in sample:
        gaps = ref.served_token_gaps(params, spec.prompt, res.token_ids,
                                     ctx.config["model"], ctx.device)
        worst = max(worst, float(gaps.max()))
    print(f"serve check: {len(sample)} requests, {tokens} served tokens",
          file=sys.stderr)
    return {"logit_gap": {"value": worst, "limit": limit}}
