"""Tensor-parallel serving, whole engine: the port's
``LLMEngine(EngineConfig(tp=n), device="cpu")`` (rank 0 here, the other
ranks spawned worker processes over gloo) against the JAX
``LLMEngine(tp=n, interpret=True)`` on the conftest's virtual devices, on
one set of weights both load from a ``.npz``.

This file holds the vocab-sharded H8/KV4 geometry of
``tests/test_vocab_sharding.py`` at tp=4 and the engine's TP life cycle
(``stats``, restart, no process left behind); the helpers serve
``test_torch_parallel_{mqa,int8,gateway}.py`` too.

* greedy tokens equal over the golden window (``tests/test_engine_golden.py``:
  7 tokens) and, here and for MQA, one JSON-mode call's tokens equal;
* teacher-forced logits (``LLMEngine.teacher_forced_logits``: the prompt
  prefilled, every later token decoded) within ``BF16_LOGIT_ATOL`` of the
  JAX tp=1 serving forwards (prefill, then decode steps) on the same
  weights.

Steadiness: the workers' rendezvous is a file under ``tmp_path``
(``tempfile.tempdir`` points there), every engine is shut down in a
``finally`` (its workers joined with a timeout), and each test fails if a
child process outlives it.
"""

import dataclasses
import json
import multiprocessing
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine import kv_cache as jkv
from deepvision_tpu.engine import model as jmodel
from deepvision_tpu.engine.config import ModelConfig as JModelConfig
from deepvision_tpu_torch.engine.config import ModelConfig
from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine

torch.set_num_threads(2)

# bf16 logits through two layers (tests/test_torch_model.py's bound)
BF16_LOGIT_ATOL = 5e-2
GOLDEN_TOKENS = 7
PROMPT = "访谈主题：库存系统。请生成下一个问题："
SERVING = dict(tokenizer="byte", max_slots=2, num_pages=64, page_size=16,
               max_pages_per_seq=8, seed=0)
TP_CFG = ModelConfig(
    name="dv-vocab-shard-test", vocab_size=512, d_model=128, n_layers=2,
    n_heads=8, n_kv_heads=4, d_ff=256, head_dim=64, max_seq_len=256)


@pytest.fixture(autouse=True)
def tp_steadiness(tmp_path, monkeypatch):
    """Rendezvous files under ``tmp_path``; no child process outlives the
    test."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    yield
    left = multiprocessing.active_children()
    for p in left:
        p.kill()
        p.join(10)
    assert not left, f"worker processes outlived the test: {left}"


def jcfg_of(cfg: ModelConfig) -> JModelConfig:
    return JModelConfig(**dataclasses.asdict(cfg))


def save_weights(tmp_path_factory, cfg: ModelConfig, seed: int = 0) -> str:
    """JAX ``init_params`` of ``cfg`` as a ``.npz`` both engines load."""
    from deepvision_tpu.engine.weights import init_params, save_npz

    path = str(tmp_path_factory.mktemp("ckpt") / f"{cfg.name}.npz")
    save_npz(path, init_params(jcfg_of(cfg), seed=seed))
    return path


def port_engine(cfg, ckpt, tp, **kw) -> LLMEngine:
    return LLMEngine(EngineConfig(model=cfg.name, checkpoint_dir=ckpt, tp=tp,
                                  device="cpu", **SERVING, **kw),
                     model_cfg=cfg)


def jax_engine(cfg, ckpt, tp, **kw):
    from deepvision_tpu.engine.engine import EngineConfig as JEngineConfig
    from deepvision_tpu.engine.engine import LLMEngine as JLLMEngine

    return JLLMEngine(JEngineConfig(model=cfg.name, checkpoint_dir=ckpt,
                                    tp=tp, interpret=True, **SERVING, **kw),
                      model_cfg=jcfg_of(cfg))


def serve(eng, prompts=(PROMPT,), n=GOLDEN_TOKENS, json_mode=False,
          **kw) -> list:
    """Each prompt's greedy token ids (submitted together)."""
    reqs = [eng.submit_tokens(eng.tokenizer.encode(p), max_tokens=n,
                              temperature=0.0, json_mode=json_mode, **kw)
            for p in prompts]
    out = []
    for r in reqs:
        res = r.wait(300)
        assert res is not None and res.ok, res
        out.append(res.token_ids)
    return out


def jax_teacher_forced(jeng, ids, n_prompt) -> np.ndarray:
    """The JAX tp=1 serving forwards, teacher-forced as
    ``LLMEngine.teacher_forced_logits``: ``ids[:n_prompt]`` prefilled, then
    each later token decoded; the engine's (possibly int8) params and KV
    scales, fresh pools."""
    cfg, page = jeng.model_cfg, jeng.cache_cfg.page_size
    MP = jeng.cache_cfg.max_pages_per_seq
    cache = jkv.init_cache(cfg, jkv.CacheConfig(
        num_pages=MP + 1, page_size=page, max_pages_per_seq=MP,
        dtype=jeng.cache_cfg.dtype), kv_scales=jeng._kv_scales)
    bucket = -(-n_prompt // page) * page
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :n_prompt] = ids[:n_prompt]
    bt = np.arange(1, MP + 1, dtype=np.int32)[None]
    logits, cache = jmodel.forward_prefill(
        jeng.runner.params, cache, jnp.asarray(toks),
        jnp.asarray([n_prompt], jnp.int32),
        jnp.asarray(bt[:, :bucket // page]), cfg=cfg, interpret=True)
    rows = [np.asarray(logits)]
    for t in range(n_prompt, len(ids)):
        logits, cache = jmodel.forward_decode(
            jeng.runner.params, cache, jnp.asarray([ids[t]], jnp.int32),
            jnp.asarray([t + 1], jnp.int32), jnp.asarray(bt), cfg=cfg,
            interpret=True)
        rows.append(np.asarray(logits))
    return np.concatenate(rows)


def check_against_jax(cfg, ckpt, tp, json_mode_tokens=0, **kw):
    """The port's tp-rank engine against the JAX engine at the same tp
    (greedy window; with ``json_mode_tokens``, one JSON-mode call) and
    against the JAX tp=1 serving forwards (teacher-forced logits); returns
    the port's greedy and JSON-mode tokens."""
    jeng = jax_engine(cfg, ckpt, tp, **kw)
    try:
        want = serve(jeng)[0]
        want_json = (serve(jeng, n=json_mode_tokens, json_mode=True)[0]
                     if json_mode_tokens else None)
    finally:
        jeng.shutdown()
    eng = port_engine(cfg, ckpt, tp, **kw)
    try:
        got = serve(eng)[0]
        got_json = (serve(eng, n=json_mode_tokens, json_mode=True)[0]
                    if json_mode_tokens else None)
        ids = eng.tokenizer.encode(PROMPT)
        tf = eng.teacher_forced_logits(ids + got, len(ids)).numpy()
        assert eng.plan.n_model == tp
    finally:
        eng.shutdown()
    assert got == want
    assert got_json == want_json
    jeng1 = jax_engine(cfg, ckpt, 1, **kw)
    try:
        tf_want = jax_teacher_forced(jeng1, ids + got, len(ids))
    finally:
        jeng1.shutdown()
    assert tf.shape == (GOLDEN_TOKENS + 1, cfg.vocab_size)
    np.testing.assert_allclose(tf, tf_want, atol=BF16_LOGIT_ATOL)
    return got, got_json


@pytest.fixture(scope="module")
def tp_ckpt(tmp_path_factory):
    return save_weights(tmp_path_factory, TP_CFG)


def test_tp4_vocab_sharded_engine_matches_jax(tp_ckpt):
    """H8/KV4 at tp=4, vocab sharded (each rank 2 query heads, 1 kv head,
    128 vocab rows): the JAX tp=4 engine's greedy and JSON-mode tokens,
    the JAX tp=1 forwards' teacher-forced logits; the JSON output parses
    when it completes."""
    _, got_json = check_against_jax(TP_CFG, tp_ckpt, 4, json_mode_tokens=48,
                                    vocab_sharded=True)
    from deepvision_tpu_torch.engine.tokenizer import get_tokenizer

    text = get_tokenizer("byte").decode(got_json)
    if len(got_json) < 48:            # stopped: the grammar closed it
        json.loads(text)


def test_tp_engine_stats_restart_and_worker_lifetime(tp_ckpt):
    """A tp=2 engine spawns one worker on ``start()``, ``stats()`` lists
    both ranks (gloo, CPU) and folds the worker's launch counts in, the
    engine serves the tp=1 port engine's tokens, ``shutdown()`` ends the
    worker, a restart raises, and ``tp`` with a geometry it cannot cut
    raises ValueError before any process starts."""
    one = port_engine(TP_CFG, tp_ckpt, 1)
    try:
        want = serve(one)[0]
    finally:
        one.shutdown()
    eng = port_engine(TP_CFG, tp_ckpt, 2)
    try:
        assert not multiprocessing.active_children()   # spawned on start()
        assert serve(eng)[0] == want
        tp = eng.stats()["tp"]
        assert tp["ranks"] == 2 and tp["backend"] == "gloo"
        assert tp["devices"] == ["cpu", "cpu"]
        assert tp["kv_sharded"] and not tp["vocab_sharded"]
        assert tp["collectives"] > 0 and len(tp["worker_launches"]) == 1
        assert len(multiprocessing.active_children()) == 1
    finally:
        eng.shutdown()
    assert not multiprocessing.active_children()
    with pytest.raises(RuntimeError, match="does not restart"):
        eng.start()
    with pytest.raises(ValueError, match="n_heads"):
        port_engine(dataclasses.replace(TP_CFG, n_heads=6, n_kv_heads=2,
                                        name="t-h6"),
                    tp_ckpt, 4)
