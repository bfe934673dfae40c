"""The port's gateway layer against the JAX package's.

``lanes``, ``template_backend``, ``client`` (``ModelGateway``,
``CircuitBreaker``), ``router`` (``EngineRouter``), ``service``
(``EngineService``/``RemoteEngine``) and ``web/gateway.py``
(``build_gateway``) are copies of the JAX package's modules.  These tests
port ``tests/test_lanes.py``, ``tests/test_gateway_failover.py`` (with its
``FakeEngine``) and ``tests/test_engine_router.py`` onto the port's CPU
engines (``device="cpu"``, ``dv-tiny-test``), hold the tables, the template
outputs and the gateway's decisions against the JAX modules on the same
inputs, and hold ``build_gateway`` against the JAX app's
``AppState._build_gateway`` with ``LLMEngine`` replaced by a recorder on
both sides.  ``test_engine_router.py``'s multihost dry run
(``test_multihost_dcn_dryrun``) drives ``jax.distributed`` and has no
counterpart in the port; it is not ported.
"""

import dataclasses
import json
import threading
import types
import zlib

import pytest
import torch

from deepvision_tpu.engine import client as jclient
from deepvision_tpu.engine import lanes as jlanes
from deepvision_tpu.engine import router as jrouter
from deepvision_tpu.engine import template_backend as jtemplate
from deepvision_tpu_torch.engine import client as tclient
from deepvision_tpu_torch.engine import router as trouter
from deepvision_tpu_torch.engine import template_backend as ttemplate
from deepvision_tpu_torch.engine.client import (
    CircuitBreaker,
    GatewayError,
    ModelGateway,
)
from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine
from deepvision_tpu_torch.engine.lanes import (
    CALL_TYPE_LANES,
    DEFAULT_LANES,
    LaneProfile,
    resolve_lanes,
)
from deepvision_tpu_torch.engine.router import EngineRouter
from deepvision_tpu_torch.engine.scheduler import (
    HIGH,
    LOW,
    EngineOverloadedError,
)
from deepvision_tpu_torch.engine.service import EngineService, RemoteEngine
from deepvision_tpu_torch.web import gateway as tgateway

torch.set_num_threads(2)


# -- lanes (tests/test_lanes.py) ---------------------------------------------

def test_every_call_type_resolves_to_known_lanes():
    for call_type, (primary, fallback) in CALL_TYPE_LANES.items():
        assert primary in DEFAULT_LANES, call_type
        if fallback is not None:
            assert fallback in DEFAULT_LANES, call_type
            assert fallback != primary, call_type


def test_resolution_order_primary_then_fallback():
    assert resolve_lanes("question") == ["question", "question_deep"]
    assert resolve_lanes("report_review") == ["report_review",
                                              "report_draft"]
    assert resolve_lanes("summary") == ["summary"]


def test_preferred_lane_goes_first_without_duplicates():
    assert resolve_lanes("question", "question_deep") == [
        "question_deep", "question"]
    assert resolve_lanes("question", "report") == [
        "report", "question", "question_deep"]
    assert resolve_lanes("question", "no-such-lane") == [
        "question", "question_deep"]


def test_unknown_call_type_defaults_to_question():
    assert resolve_lanes("mystery")[0] == "question"


def test_interactive_lanes_are_high_priority():
    for name in ("question", "question_fast", "question_deep", "report",
                 "report_draft", "report_review"):
        assert DEFAULT_LANES[name].priority == HIGH, name


def test_background_lanes_are_low_priority():
    for name in ("summary", "search_decision", "assessment"):
        assert DEFAULT_LANES[name].priority == LOW, name


def test_operational_envelope_tracks_baseline():
    assert DEFAULT_LANES["question"].max_tokens == 2200
    assert DEFAULT_LANES["report_draft"].max_tokens == 8000
    assert DEFAULT_LANES["summary"].max_tokens == 600
    fast = DEFAULT_LANES["question_fast"]
    assert fast.max_tokens == 900 and fast.timeout_s == 8.0


def test_deterministic_lanes_use_zero_temperature():
    assert DEFAULT_LANES["search_decision"].temperature == 0.0
    assert DEFAULT_LANES["assessment"].temperature == 0.0


def test_profile_replace_is_pure():
    base = DEFAULT_LANES["question"]
    hot = base.replace(max_tokens=100)
    assert hot.max_tokens == 100 and base.max_tokens == 2200
    assert isinstance(hot, LaneProfile)


def test_lane_tables_equal_the_jax_tables():
    """Every profile, every call-type pairing and every resolution
    (with each preferred lane, a wrong one and none) as in JAX."""
    assert {k: dataclasses.asdict(v) for k, v in DEFAULT_LANES.items()} == {
        k: dataclasses.asdict(v) for k, v in jlanes.DEFAULT_LANES.items()}
    assert CALL_TYPE_LANES == jlanes.CALL_TYPE_LANES
    for call_type in list(CALL_TYPE_LANES) + ["mystery"]:
        for preferred in [None, "no-such-lane", *DEFAULT_LANES]:
            assert resolve_lanes(call_type, preferred) == \
                jlanes.resolve_lanes(call_type, preferred)


# -- template backend --------------------------------------------------------

TEMPLATE_CONTEXTS = [
    {},
    {"dimension_name": "客户需求", "key_aspects": ["核心痛点", "期望价值"],
     "question_number": 4, "is_follow_up": True, "topic": "仓储管理系统"},
    {"topic": "库存系统", "q_ids": ["Q1", "Q2", "Q3"],
     "session_id": "dv-1"},
]


@pytest.mark.parametrize("call_type", [
    "question", "question_fast", "question_deep", "report", "report_draft",
    "report_review", "summary", "doc_summary", "search_decision",
    "assessment", "scenario", "chat", "solution_copy", "mystery"])
def test_template_outputs_equal_jax(call_type):
    for ctx in TEMPLATE_CONTEXTS:
        prompt = f"访谈主题：库存系统 {call_type}"
        assert ttemplate.generate(call_type, prompt, dict(ctx)) == \
            jtemplate.generate(call_type, prompt, dict(ctx))


def test_template_gateway_equals_jax():
    """Template mode end to end: text and meta (but its clock) as JAX."""
    tg, jg = ModelGateway(mode="template"), jclient.ModelGateway(
        mode="template")
    for call_type in ("question", "report_draft", "summary", "scenario"):
        ctx = {"topic": "库存系统", "question_number": 2}
        t_text, t_meta = tg.call_model("提示", call_type, context=ctx,
                                       return_meta=True)
        j_text, j_meta = jg.call_model("提示", call_type, context=ctx,
                                       return_meta=True)
        t_meta.pop("total_ms"), j_meta.pop("total_ms")
        assert (t_text, t_meta) == (j_text, j_meta)
    with pytest.raises(GatewayError):
        ModelGateway(mode="off").call_model("提示")


# -- gateway failure paths (tests/test_gateway_failover.py) ------------------

class FakeEngine:
    """Scriptable engine: pops one behavior per call from `script`."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = []  # (prompt, kwargs)

    def generate_text(self, prompt, **kw):
        self.calls.append((prompt, kw))
        step = self.script.pop(0) if self.script else "ok"
        if step == "timeout":
            raise TimeoutError("engine deadline")
        if step == "error":
            raise RuntimeError("engine exploded")
        if step == "empty":
            return "", {"completion_tokens": 0, "total_ms": 5.0}
        return f"回复：{prompt[:20]}", {
            "completion_tokens": 12, "total_ms": 5.0}


def _gw(script, **kw):
    eng = FakeEngine(script)
    gw = ModelGateway(mode="engine", engines={"default": eng}, **kw)
    return gw, eng


def test_timeout_triggers_shrink_retry_same_lane():
    gw, eng = _gw(["timeout", "ok"])
    prompt = "长" * 1000
    text, meta = gw.call_model(prompt, call_type="summary", return_meta=True)
    assert text.startswith("回复")
    assert meta["prompt_shrunk"] is True
    assert meta["attempts"] == 2
    assert len(eng.calls) == 2
    shrunk = eng.calls[1][0]
    assert len(shrunk) < len(prompt)
    assert "截断" in shrunk
    assert shrunk.startswith("长" * 100)


def test_error_fails_over_to_fallback_lane():
    gw, eng = _gw(["error", "ok"])
    text, meta = gw.call_model("问题", call_type="question", return_meta=True)
    assert meta["lane"] == "question_deep"
    assert meta["attempts"] == 2
    assert meta["failure_reason"] is None


def test_empty_response_counts_as_lane_failure():
    gw, eng = _gw(["empty", "ok"])
    text, meta = gw.call_model("问题", call_type="question", return_meta=True)
    assert meta["lane"] == "question_deep"
    assert text


def test_all_lanes_failing_raises_with_meta_hook():
    seen = []
    gw, eng = _gw(["error", "error", "error"],
                  metrics_hook=lambda ct, m: seen.append(m))
    with pytest.raises(GatewayError, match="all lanes failed"):
        gw.call_model("问题", call_type="question")
    assert seen and seen[-1]["failure_reason"]
    assert seen[-1]["attempts"] >= 2


def test_breaker_cooldown_skips_lane():
    br = CircuitBreaker(threshold=1, window_s=60, cooldown_s=60)
    br.record_failure("question")
    gw, eng = _gw(["ok"], breaker=br)
    _, meta = gw.call_model("问题", call_type="question", return_meta=True)
    assert meta["lane"] == "question_deep"
    assert meta["attempts"] == 1


def test_forced_open_when_all_lanes_cooling():
    br = CircuitBreaker(threshold=1, window_s=60, cooldown_s=60)
    br.record_failure("question")
    br.record_failure("question_deep")
    gw, eng = _gw(["ok"], breaker=br)
    _, meta = gw.call_model("问题", call_type="question", return_meta=True)
    assert meta["lane"] == "question"
    # the success closes the forced lane's circuit; the other stays open
    assert set(gw.circuit_snapshot()) == {"question_deep"}


def test_adaptive_order_demotes_failing_primary():
    gw, eng = _gw(["ok"])
    for _ in range(gw.ADAPTIVE_MIN_SAMPLES):
        gw._record_lane_stat("question", False, None)
        gw._record_lane_stat("question_deep", True, 5.0)
    stats = gw.lane_stats_snapshot()
    assert stats["question"]["failures"] >= gw.ADAPTIVE_MIN_SAMPLES
    _, meta = gw.call_model("问题", call_type="question", return_meta=True)
    assert meta["lane"] == "question_deep"
    assert meta["attempts"] == 1


def test_adaptive_order_sticky_below_min_samples():
    gw, eng = _gw(["ok"])
    gw._record_lane_stat("question", False, None)
    _, meta = gw.call_model("问题", call_type="question", return_meta=True)
    assert meta["lane"] == "question"


def test_engine_mode_passes_lane_profile_parameters():
    gw, eng = _gw(["ok"])
    gw.call_model("问题", call_type="question_fast",
                  context={"session_id": "dv-x-1"})
    _, kw = eng.calls[0]
    assert kw["max_tokens"] == 900
    assert kw["timeout"] == 8.0
    assert kw["prefix_key"] == "dv-x-1"


def test_json_call_types_request_constrained_decoding():
    gw, eng = _gw(["ok", "ok"])
    gw.call_model("草稿", call_type="report_draft")
    assert eng.calls[0][1]["json_mode"] is True
    gw.call_model("总结", call_type="summary")
    assert eng.calls[1][1]["json_mode"] is False
    assert tclient.JSON_CALL_TYPES == jclient.JSON_CALL_TYPES


def test_explicit_overrides_beat_profile_defaults():
    gw, eng = _gw(["ok"])
    gw.call_model("问题", call_type="question", timeout=3.0,
                  max_tokens=64, temperature=0.1)
    _, kw = eng.calls[0]
    assert kw["timeout"] == 3.0
    assert kw["max_tokens"] == 64
    assert kw["temperature"] == 0.1


SCRIPTS = [
    ("summary", ["timeout", "ok"]),
    ("summary", ["timeout", "timeout"]),
    ("question", ["error", "ok"]),
    ("question", ["empty", "empty", "ok"]),
    ("question", ["error", "error", "error"]),
    ("report_review", ["error", "ok"]),
    ("report_draft", ["ok"]),
    ("chat", ["error"]),
]


@pytest.mark.parametrize("call_type,script", SCRIPTS)
def test_failure_paths_equal_jax(call_type, script):
    """The same scripted engine behind both gateways: the same engine
    calls (prompts and every keyword), the same result or error, the same
    meta (but the clock) and the same breaker and lane statistics."""
    outcomes = []
    for mod in (tclient, jclient):
        eng, seen = FakeEngine(script), []
        gw = mod.ModelGateway(mode="engine", engines={"default": eng},
                              metrics_hook=lambda ct, m: seen.append(dict(m)))
        try:
            text, meta = gw.call_model("长" * 200, call_type,
                                       context={"session_id": "s-1"},
                                       return_meta=True)
            result = ("ok", text)
        except mod.GatewayError as e:
            result = ("error", str(e))
        for m in seen:
            m.pop("total_ms")
        outcomes.append((eng.calls, result, seen, gw.circuit_snapshot(),
                         gw.lane_stats_snapshot()))
    assert outcomes[0] == outcomes[1]


def test_embed_texts_returns_none_without_engines_and_raises_with_them():
    """Template mode, no engine, or engines that cannot embed: None, from
    the port's gateway as from the JAX one.  (The name is the one this
    test had while the port raised in engine mode; the embedder is ported
    now and the two gateways agree.)"""
    for cls in (ModelGateway, jclient.ModelGateway):
        assert cls(mode="template").embed_texts(["a"]) is None
        assert cls(mode="engine").embed_texts(["a"]) is None
        gw = cls(mode="engine", engines={"default": FakeEngine(["ok"])})
        assert gw.embed_texts(["a"]) is None
        assert len(gw._embed_cache) == 0


def test_process_wide_gateway():
    default = tclient.get_gateway()
    try:
        assert default.mode == "template"
        gw, eng = _gw(["ok"])
        assert tclient.configure_gateway(gw) is gw
        assert tclient.get_gateway() is gw
        text = tclient.call_model("问题", "question")
        assert text.startswith("回复") and gw.call_count == 1
    finally:
        tclient.configure_gateway(default)


# -- the router and the remote engine (tests/test_engine_router.py) ----------

def tiny_engine(seed=0):
    return LLMEngine(EngineConfig(
        model="dv-tiny-test", tokenizer="byte", max_slots=2, num_pages=64,
        page_size=16, max_pages_per_seq=8, seed=seed, json_dfa=False,
        device="cpu"))


@pytest.fixture()
def pair():
    a, b = tiny_engine(0), tiny_engine(1)
    router = EngineRouter([a, b], cooldown_s=5.0)
    yield router, a, b
    router.shutdown()


def test_router_generates_and_records_routing(pair):
    router, _, _ = pair
    text, meta = router.generate_text("你好", max_tokens=4, temperature=0.0,
                                      timeout=120)
    assert meta["completion_tokens"] >= 1
    assert meta["replica"] in (0, 1)
    assert sum(router.routed) == 1


def test_router_prefix_stickiness(pair):
    router, _, _ = pair
    homes = set()
    for _ in range(3):
        _, meta = router.generate_text(
            "会话前缀", max_tokens=2, temperature=0.0, timeout=120,
            prefix_key="sess-sticky")
        homes.add(meta["replica"])
    assert homes == {zlib.crc32(b"sess-sticky") % 2}


def test_router_failover_on_dead_replica(pair):
    router, a, b = pair
    home = zlib.crc32(b"sess-x") % 2
    dead = (a, b)[home]
    dead.shutdown()
    dead.scheduler.submit = lambda req: (_ for _ in ()).throw(
        EngineOverloadedError("dead"))
    _, meta = router.generate_text(
        "路由容错", max_tokens=2, temperature=0.0, timeout=120,
        prefix_key="sess-x")
    assert meta["replica"] != home
    assert meta.get("failover") is True
    assert router.failovers >= 1
    _, meta2 = router.generate_text(
        "路由容错2", max_tokens=2, temperature=0.0, timeout=120,
        prefix_key="sess-x")
    assert meta2["replica"] != home


def test_router_stats_aggregate(pair):
    router, _, _ = pair
    router.generate_text("a", max_tokens=2, temperature=0.0, timeout=120)
    s = router.stats()
    assert s["router"]["replicas"] == 2
    assert s["tokens_generated"] >= 1
    assert len(s["replicas"]) == 2
    assert s["model"] == "dv-tiny-test"


def test_router_candidates_equal_jax():
    """Replica order for keyed and unkeyed requests, with healthy and
    cooling replicas, as the JAX router picks it."""

    class Rep:
        def __init__(self, depth):
            self.model_cfg = None
            self.scheduler = types.SimpleNamespace(queue_depths=lambda: {
                "high": depth, "low": 0, "active": 1, "prefilling": 0})

    reps = [Rep(d) for d in (3, 0, 5, 1)]
    routers = [mod.EngineRouter(reps) for mod in (trouter, jrouter)]
    for r in routers:
        r.health[2].record_failure()
        r.health[2].record_failure()   # replica 2 cools down
        r.inflight[3] = 4
    for key in (None, "", "sess-1", "dv-abc", "会话", 12345):
        assert routers[0]._candidates(key) == routers[1]._candidates(key)


def test_remote_engine_over_http():
    eng = tiny_engine()
    svc = EngineService(eng, host="127.0.0.1", port=0)
    port = svc.start(background=True)
    try:
        remote = RemoteEngine(f"http://127.0.0.1:{port}")
        remote.start()
        text, meta = remote.generate_text("远程调用", max_tokens=4,
                                          temperature=0.0, timeout=120)
        assert meta["completion_tokens"] >= 1
        assert meta["remote"].endswith(str(port))
        local_text, _ = eng.generate_text("远程调用", max_tokens=4,
                                          temperature=0.0, timeout=120)
        assert text == local_text
        assert remote.stats()["model"] == "dv-tiny-test"
        local = tiny_engine(2)
        router = EngineRouter([local, remote])
        _, m = router.generate_text("混合路由", max_tokens=2,
                                    temperature=0.0, timeout=120)
        assert m["replica"] in (0, 1)
        local.shutdown()
    finally:
        svc.shutdown()


def test_remote_engine_unreachable_raises():
    remote = RemoteEngine("http://127.0.0.1:1", connect_timeout=0.5)
    with pytest.raises(OSError):
        remote.start()
    assert "error" in remote.stats()


# -- build_gateway against the JAX app's _build_gateway ----------------------

SMALL = {"ENGINE_NUM_PAGES": 32, "ENGINE_PAGE_SIZE": 16,
         "ENGINE_MAX_PAGES_PER_SEQ": 4, "ENGINE_MAX_SLOTS": 2}
TINY_ALL = {"QUESTION_MODEL_NAME": "dv-tiny-test",
            "REPORT_MODEL_NAME": "dv-tiny-test",
            "REPORT_DRAFT_MODEL_NAME": "dv-tiny-test",
            "REPORT_REVIEW_MODEL_NAME": "dv-tiny-test"}
DISTINCT = {**TINY_ALL, "REPORT_DRAFT_MODEL_NAME": "dv-smoke",
            "REPORT_REVIEW_MODEL_NAME": "dv-smoke"}

# tests/test_multimodel.py's settings, the app's defaults ("auto" models,
# paired tokenizers, in-repo checkpoints), and the other keys read
BUILD_CASES = {
    "distinct_models": {"AI_MODE": "engine", **DISTINCT, **SMALL},
    "single_model": {"AI_MODE": "engine", **TINY_ALL, **SMALL},
    "replicas": {"AI_MODE": "engine", **TINY_ALL, **SMALL,
                 "ENGINE_REPLICAS": 2},
    "report_decode_steps": {"AI_MODE": "engine", **DISTINCT, **SMALL,
                            "ENGINE_REPORT_DECODE_STEPS": 12,
                            "ENGINE_DECODE_STEPS_PER_CALL": "4"},
    "app_defaults": {"AI_MODE": "engine"},
    "other_keys": {"AI_MODE": "engine", **DISTINCT,
                   "REPORT_REVIEW_MODEL_NAME": "auto",
                   "ENGINE_KV_QUANTIZE": "int8", "ENGINE_TOKENIZER": "byte",
                   "ENGINE_CHUNKED_PREFILL": "false",
                   "ENGINE_PREFILL_CHUNK_SIZE": 128,
                   "ENGINE_CHECKPOINT_DIR": "/nonexistent/ckpt.npz",
                   "ENGINE_WARMUP": "yes", "ENGINE_MAX_CHAINED_DECODES": 2,
                   "ENGINE_REMOTE_URLS": "http://127.0.0.1:1, ,"},
    "template": {"AI_MODE": "template"},
    "ai_disabled": {"AI_MODE": "engine", "ENABLE_AI": "0"},
}


def _recorder(made):
    class Recorder:
        """Stands in for LLMEngine: records its config, serves nothing."""

        def __init__(self, cfg, model_cfg=None):
            self.cfg = cfg
            self.model_cfg = types.SimpleNamespace(name=cfg.model)
            self.started = threading.Event()
            made.append(self)

        def start(self):
            self.started.set()

        def shutdown(self):
            pass

    return Recorder


def _jax_gateway(overrides, monkeypatch, made):
    from deepvision_tpu.engine import engine as jengine
    from deepvision_tpu.web.env import ConfigResolver
    from deepvision_tpu.web.server import AppState

    monkeypatch.setattr(jengine, "LLMEngine", _recorder(made))
    state = AppState.__new__(AppState)
    state.resolver = ConfigResolver()
    for key, value in overrides.items():
        state.resolver.set_runtime(key, value)
    state.metrics = types.SimpleNamespace(record_ai_call=None)
    return AppState._build_gateway(state)


def _summary(gw, made):
    for rec in made:
        assert rec.started.wait(10), rec.cfg.model
    cfgs = {}
    for rec in made:
        fields = {f.name: getattr(rec.cfg, f.name)
                  for f in dataclasses.fields(rec.cfg) if f.name != "device"}
        cfgs.setdefault(rec.cfg.model, []).append(fields)
    engines = {}
    for name, eng in gw.engines.items():
        reps = getattr(eng, "replicas", [eng])
        engines[name] = (type(eng).__name__,
                         [type(r).__name__ for r in reps])
    return {
        "mode": gw.mode, "engines": engines, "configs": cfgs,
        "lanes": {k: dataclasses.asdict(v) for k, v in gw.lanes.items()},
    }


@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_build_gateway_makes_the_apps_decisions(case, monkeypatch):
    """The same lane -> model map, the same engines (router or not, local
    and remote replicas), every shared ``EngineConfig`` field of every
    engine, and the same lane profiles as the JAX app's gateway."""
    overrides = BUILD_CASES[case]
    made_j, made_t = [], []
    want = _summary(_jax_gateway(overrides, monkeypatch, made_j), made_j)
    monkeypatch.setattr(tgateway, "LLMEngine", _recorder(made_t))
    got = _summary(tgateway.build_gateway(overrides, device="cpu"), made_t)
    assert got == want
    assert all(rec.cfg.device == "cpu" for rec in made_t)
    if case == "report_decode_steps":
        steps = {m: c[0]["decode_steps_per_call"]
                 for m, c in got["configs"].items()}
        assert steps == {"dv-tiny-test": 4, "dv-smoke": 12}
    if case == "app_defaults":
        assert set(got["engines"]) == {
            m for m in ("dv-fast", "dv-base")
            if tgateway.default_checkpoint(m)} or {"dv-1b"}
        assert {c[0]["max_slots"] for c in got["configs"].values()} == {32}


def test_build_gateway_reads_the_environment(monkeypatch):
    """Keys not overridden come from the process environment, as the app
    resolves them."""
    monkeypatch.setenv("ENGINE_MAX_SLOTS", "3")
    monkeypatch.setenv("QUESTION_MODEL_NAME", "dv-smoke")
    overrides = {"AI_MODE": "engine", **TINY_ALL, **SMALL}
    overrides.pop("ENGINE_MAX_SLOTS")
    overrides.pop("QUESTION_MODEL_NAME")
    made_j, made_t = [], []
    want = _summary(_jax_gateway(overrides, monkeypatch, made_j), made_j)
    monkeypatch.setattr(tgateway, "LLMEngine", _recorder(made_t))
    got = _summary(tgateway.build_gateway(overrides, device="cpu"), made_t)
    assert got == want
    assert got["configs"]["dv-smoke"][0]["max_slots"] == 3


def test_build_gateway_serves_on_cpu_engines(monkeypatch, tmp_path):
    """Real engines on the CPU: a question and its follow-up in one
    session (the second resumes through the prefix cache), a report draft
    on its own engine with the report decode window, and int8 KV."""
    monkeypatch.setenv("DV_DFA_CACHE_DIR", str(tmp_path))
    gw = tgateway.build_gateway(
        {"AI_MODE": "engine", **DISTINCT, "ENGINE_NUM_PAGES": 64,
         "ENGINE_PAGE_SIZE": 16, "ENGINE_MAX_PAGES_PER_SEQ": 16,
         "ENGINE_MAX_SLOTS": 2, "ENGINE_PREFILL_CHUNK_SIZE": 16,
         "ENGINE_KV_QUANTIZE": "int8"}, device="cpu")
    try:
        q_eng, r_eng = gw.engines["dv-tiny-test"], gw.engines["dv-smoke"]
        assert q_eng.cfg.decode_steps_per_call == 8
        assert r_eng.cfg.decode_steps_per_call == 16
        assert q_eng.cache_cfg.quantized and q_eng.kv_scales is not None
        ctx = {"session_id": "dv-sess-1"}
        prompt = "访谈主题：仓储管理系统选型。请生成下一个访谈问题："
        text, meta = gw.call_model(prompt, "question", max_tokens=12,
                                   temperature=0.0, context=ctx,
                                   return_meta=True)
        json.loads(text)
        assert (meta["lane"], meta["model"]) == ("question", "dv-tiny-test")
        text2, _ = gw.call_model(prompt + text + "回答：三个区域仓。",
                                 "question", max_tokens=12, temperature=0.0,
                                 context=ctx, return_meta=True)
        json.loads(text2)
        assert q_eng.stats()["prefix_cache"]["hits"] >= 1
        text3, meta3 = gw.call_model("报告草稿：", "report_draft",
                                     max_tokens=12, temperature=0.0,
                                     context=ctx, return_meta=True)
        json.loads(text3)
        assert (meta3["lane"], meta3["model"]) == ("report_draft", "dv-smoke")
    finally:
        for eng in gw.engines.values():
            eng.shutdown()


def test_build_gateway_runs_on_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgateway.build_gateway({"AI_MODE": "engine", **TINY_ALL, **SMALL})
