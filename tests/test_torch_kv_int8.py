"""Engine-level int8 KV in the port against the JAX package.

``model.calibrate_kv_scales`` against JAX's on the same parameters and
tokens; the engine with ``kv_quantize="int8"`` (boot calibration on the
fixed interview prompt, int8 pools through prefill, chunked prefill and
decode) against JAX's int8-KV engine, greedy token for token over the
golden window (7 tokens, ``tests/test_engine_golden.py``); and the two
engine tests of ``tests/test_kv_int8.py`` on the prefix cache over int8
pools.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine import model as jmodel
from deepvision_tpu.engine import weights as jweights
from deepvision_tpu.engine.config import DV_MINI, TINY_TEST
from deepvision_tpu_torch.engine import model as tmodel
from deepvision_tpu_torch.engine import weights as tweights
from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine

torch.set_num_threads(2)

TINY = dict(model="dv-tiny-test", tokenizer="byte", max_slots=2,
            num_pages=64, page_size=16, max_pages_per_seq=8, seed=0,
            chunked_prefill=True, prefill_chunk_size=16)

# A scale is max|x| * 1.25 / 127 of a bf16 tensor: both frameworks pick
# the same element, and its bf16 value may differ by one ulp (2^-8
# relative) where the f32 input of a rounding point differs in its last
# bits between the frameworks' matmuls; deeper layers compound that.
SCALE_RTOL = 2e-2


def _jax_params(cfg, seed=0):
    jp = jweights.init_params(cfg, seed=seed)
    return jp, tweights.from_numpy_params(
        {k: (np.asarray(v) if not isinstance(v, dict)
             else {kk: np.asarray(vv) for kk, vv in v.items()})
         for k, v in jp.items()}, device="cpu")


@pytest.mark.parametrize("cfg", [TINY_TEST, DV_MINI], ids=lambda c: c.name)
def test_calibrate_kv_scales_matches_jax(cfg):
    """Scales of every (layer, kv head) within SCALE_RTOL of JAX's, all
    positive; the first layer's equal to the bit (its K/V come from the
    embeddings through one projection, with no rounding compounded)."""
    jp, tp = _jax_params(cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, min(cfg.vocab_size, 4000), size=(2, 64)).astype(
        np.int32)
    jks, jvs = jmodel.calibrate_kv_scales(jp, jnp.asarray(toks), cfg=cfg)
    tks, tvs = tmodel.calibrate_kv_scales(tp, torch.from_numpy(toks),
                                          cfg=cfg)
    assert tks.shape == (cfg.n_layers, cfg.n_kv_heads) == tvs.shape
    assert tks.dtype == torch.float32
    for got, want in ((tks, jks), (tvs, jvs)):
        want = np.asarray(want)
        assert (got.numpy() > 0).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=SCALE_RTOL)
        np.testing.assert_array_equal(got.numpy()[0], want[0])


def test_calibration_tokens_are_the_jax_engines():
    """The boot calibration runs on the JAX engine's prompt, repeated to
    2 rows x 256 tokens, the second row reversed."""
    eng = LLMEngine(EngineConfig(**TINY, device="cpu", json_dfa=False,
                                 kv_quantize="int8"))
    toks = eng._calibration_tokens()
    ids = eng.tokenizer.encode(eng.CALIBRATION_PROMPT)[:256]
    assert toks.shape == (2, 256) and toks.dtype == torch.int32
    assert toks[0, :len(ids)].tolist() == ids
    assert toks[1].tolist() == toks[0].tolist()[::-1]
    assert eng.cache_cfg.quantized
    ks, vs = eng.kv_scales
    assert ks.shape == (TINY_TEST.n_layers, TINY_TEST.n_kv_heads)
    for i in range(TINY_TEST.n_layers):
        assert eng.runner.cache["k"][i].dtype == torch.int8
        assert torch.equal(eng.runner.cache["ks"][i], ks[i])
        assert torch.equal(eng.runner.cache["vs"][i], vs[i])


def test_unknown_kv_quantize_mode_raises():
    with pytest.raises(ValueError, match="kv_quantize"):
        LLMEngine(EngineConfig(**TINY, device="cpu", kv_quantize="fp8"))


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    jweights.save_npz(path, jweights.init_params(TINY_TEST, seed=0))
    return path


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_int8_engine_greedy_tokens_match_jax(tiny_npz, decode_steps):
    """The int8-KV engine's greedy tokens equal the JAX int8-KV engine's
    over the golden window (7 tokens), for a prompt that prefills in
    chunks and one that is a single chunk; the calibrated scales agree
    within SCALE_RTOL."""
    from deepvision_tpu.engine.engine import EngineConfig as JEngineConfig
    from deepvision_tpu.engine.engine import LLMEngine as JLLMEngine

    prompts = ["访谈主题：库存系统。请生成下一个访谈问题：", "golden 黄金"]
    jeng = JLLMEngine(JEngineConfig(
        **TINY, checkpoint_dir=tiny_npz, kv_quantize="int8",
        decode_steps_per_call=decode_steps, interpret=True))
    try:
        want = [jeng.submit_tokens(jeng.tokenizer.encode(p), max_tokens=7,
                                   temperature=0.0).wait(300).token_ids
                for p in prompts]
        jscales = [np.asarray(s) for s in jeng._kv_scales]
    finally:
        jeng.shutdown()
    eng = LLMEngine(EngineConfig(
        **TINY, checkpoint_dir=tiny_npz, kv_quantize="int8", device="cpu",
        decode_steps_per_call=decode_steps))
    try:
        got = []
        for p in prompts:
            res = eng.submit_tokens(eng.tokenizer.encode(p), max_tokens=7,
                                    temperature=0.0).wait(300)
            assert res is not None and res.ok, res
            got.append(res.token_ids)
    finally:
        eng.shutdown()
    assert got == want
    for mine, theirs in zip(eng.kv_scales, jscales):
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=SCALE_RTOL)


def test_prefix_cache_shares_int8_pages_correctly():
    """Radix prefix reuse over int8 pools: a warm resume decodes the same
    greedy tokens as a cold run (the static scales are global, so shared
    int8 rows mean the same values)."""
    eng = LLMEngine(EngineConfig(
        model="dv-tiny-test", tokenizer="byte", max_slots=2,
        num_pages=96, page_size=16, max_pages_per_seq=16,
        chunked_prefill=True, prefill_chunk_size=16, device="cpu", seed=0,
        kv_quantize="int8"))
    try:
        head = "共享的系统提示头部 " * 6
        p2 = head + "第二个不同的问题"
        eng.generate_text(head + "第一个问题", max_tokens=6,
                          temperature=0.0, timeout=300, prefix_key="s")
        warm, _ = eng.generate_text(p2, max_tokens=6, temperature=0.0,
                                    timeout=300, prefix_key="s")
        stats = eng.scheduler.prefix_cache.stats()
        assert stats["hits"] >= 1 and stats["tokens_saved"] > 0, stats
        cold, _ = eng.generate_text(p2, max_tokens=6, temperature=0.0,
                                    timeout=300, prefix_key=None)
        assert warm == cold
    finally:
        eng.shutdown()


def test_admission_evicts_prefix_cache_under_kv_pressure():
    """When a live request needs pages the cold cache holds, admission
    evicts LRU prefix chains instead of rejecting, and generation
    completes."""
    eng = LLMEngine(EngineConfig(
        model="dv-tiny-test", tokenizer="byte", max_slots=1,
        num_pages=14, page_size=16, max_pages_per_seq=8,
        chunked_prefill=True, prefill_chunk_size=16, device="cpu", seed=0))
    try:
        for i in range(3):
            eng.generate_text(f"会话{i}" + "长提示内容填充 " * 10,
                              max_tokens=4, temperature=0.0,
                              timeout=300, prefix_key=f"p{i}")
        pages_cached = eng.scheduler.prefix_cache.stats()["pages"]
        assert pages_cached > 0
        text, meta = eng.generate_text(
            "新会话" + "需要大量页面的长提示 " * 12, max_tokens=4,
            temperature=0.0, timeout=300, prefix_key="fresh")
        assert meta["finish_reason"] in ("stop", "length")
        assert meta["completion_tokens"] >= 1
        # nothing leaked: each of the 13 usable pages is free or cached
        assert (eng.allocator.available()
                + eng.scheduler.prefix_cache.stats()["pages"]) == 13
    finally:
        eng.shutdown()
