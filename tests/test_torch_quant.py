"""The port's weight-only int8 (engine/quant.py, ``qdot``'s dict form)
against the JAX package's.

The same numpy weights go through both quantizers; the quantized params
of the JAX package reach the port through ``from_numpy_params``, so the
forwards compare the same int8 numbers.  The JAX serving forwards run
their Pallas kernels in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine import kv_cache as jkv
from deepvision_tpu.engine import model as jmodel
from deepvision_tpu.engine import quant as jquant
from deepvision_tpu.engine import weights as jweights
from deepvision_tpu.engine.config import TINY_TEST
from deepvision_tpu.engine.config import ModelConfig as JModelConfig
from deepvision_tpu_torch.engine import kv_cache as tkv
from deepvision_tpu_torch.engine import model as tmodel
from deepvision_tpu_torch.engine import quant as tquant
from deepvision_tpu_torch.engine import weights as tweights
from deepvision_tpu_torch.engine.config import ModelConfig
from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine

torch.set_num_threads(2)

# bf16 logits: each bf16 rounding point may land one ulp apart between the
# two frameworks' matmuls, compounding over the layers (as
# tests/test_torch_model.py).
BF16_LOGIT_ATOL = 5e-2
# qdot against JAX's qdot: the tolerance of tests/test_quant.py:92 (a bf16
# output is one rounding of a float32 sum whose order differs).
QDOT_TOL = 2e-2
TINY = dict(model="dv-tiny-test", tokenizer="byte", max_slots=2,
            num_pages=64, page_size=16, max_pages_per_seq=8, seed=0)
# the golden window of tests/test_engine_golden.py:26
GOLDEN_PROMPT, GOLDEN_NEW = "golden test prompt 黄金", 7

UNTIED = dict(name="dv-untied-test", vocab_size=512, d_model=128,
              n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256, head_dim=32,
              max_seq_len=256, tie_embeddings=False)


def _np_tree(tree):
    return {k: (_np_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def _both(jp):
    return jp, tweights.from_numpy_params(_np_tree(jp), device="cpu")


def _np(t):
    return t.float().numpy()


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    jweights.save_npz(path, jweights.init_params(TINY_TEST, seed=0))
    return path


# -- the quantizer -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_matches_jax(dtype):
    """``q8`` equal bit for bit (float32 division, round half to even on
    both sides); ``scale`` within 1e-7 relative (one float32 division)."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 64, 32)) * 0.1).astype(np.float32)
    # values that land exactly on a half step of the quantization grid
    w[0, :4, 0] = [1.0, -1.0, 0.5 / 127, 2.5 / 127]
    jw = jnp.asarray(w, dtype)
    want = jquant.quantize_weight(jw)
    tw = tweights.from_numpy_params({"w": np.asarray(jw)}, device="cpu")["w"]
    got = tquant.quantize_weight(tw)
    assert got["q8"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    assert tuple(got["scale"].shape) == (3, 32)
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]))
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]),
                               rtol=1e-7, atol=0)
    back = tquant.dequantize_weight(got, torch.float32).numpy()
    err = np.abs(back - np.asarray(jw, np.float32))
    assert (err <= got["scale"].numpy()[:, None, :] * 0.5 + 1e-7).all()


def test_quantize_zero_column():
    w = np.zeros((8, 4), np.float32)
    w[:, 1] = 3.0
    got = tquant.quantize_weight(torch.from_numpy(w))
    want = jquant.quantize_weight(jnp.asarray(w))
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    np.testing.assert_allclose(
        tquant.dequantize_weight(got, torch.float32).numpy(), w, atol=1e-6)


def test_quantize_params_tree_matches_jax():
    jp, tp = _both(jweights.init_params(TINY_TEST, seed=0))
    jq, tq = jquant.quantize_params(jp), tquant.quantize_params(tp)
    assert tquant.is_quantized(tq) and not tquant.is_quantized(tp)
    assert set(tq) == set(jq) and set(tq["blocks"]) == set(jq["blocks"])
    for name, leaf in jq["blocks"].items():
        if isinstance(leaf, dict):
            assert set(tq["blocks"][name]) == {"q8", "scale"}
            np.testing.assert_array_equal(tq["blocks"][name]["q8"].numpy(),
                                          np.asarray(leaf["q8"]))
            np.testing.assert_allclose(tq["blocks"][name]["scale"].numpy(),
                                       np.asarray(leaf["scale"]), rtol=1e-7)
        else:   # norms stay as they were
            assert name in ("ln1", "ln2")
            assert tq["blocks"][name] is tp["blocks"][name]
    assert tq["embed"] is tp["embed"]
    assert (tweights.param_bytes(tq["blocks"])
            < 0.65 * tweights.param_bytes(tp["blocks"]))
    back = tquant.dequantize_params(tq)
    assert not tquant.is_quantized(back)
    for name in ("wq", "w_down"):
        a = tp["blocks"][name].float()
        b = back["blocks"][name].float()
        assert (a - b).abs().max() / a.abs().max() < 0.02


def test_astype_keeps_int8_leaves():
    _, tp = _both(jweights.init_params(TINY_TEST, seed=0))
    cast = tweights.astype(tquant.quantize_params(tp), torch.float32)
    assert cast["blocks"]["wq"]["q8"].dtype == torch.int8
    assert cast["blocks"]["wq"]["scale"].dtype == torch.float32
    assert cast["blocks"]["ln1"].dtype == torch.float32


def test_from_numpy_params_carries_int8():
    jq = jquant.quantize_params(jweights.init_params(TINY_TEST, seed=0))
    tq = tweights.from_numpy_params(_np_tree(jq), device="cpu")
    assert tq["blocks"]["w_up"]["q8"].dtype == torch.int8
    np.testing.assert_array_equal(tq["blocks"]["w_up"]["q8"].numpy(),
                                  np.asarray(jq["blocks"]["w_up"]["q8"]))


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_qdot_matches_jax(out):
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((64, 48)) * 0.2).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((5, 64)), jnp.bfloat16)
    jq = jquant.quantize_weight(jnp.asarray(w))
    want = jmodel.qdot(x, jq, preferred_element_type=getattr(jnp, out))
    tq = tweights.from_numpy_params(_np_tree(jq), device="cpu")
    tx = tweights.from_numpy_params({"x": np.asarray(x)}, device="cpu")["x"]
    got = tmodel.qdot(tx, tq, getattr(torch, out))
    assert got.dtype == getattr(torch, out)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=QDOT_TOL, atol=QDOT_TOL)


def test_qdot_scales_the_float32_result_before_rounding():
    """The scale multiplies the float32 product; only then is it rounded.
    Here the product, 257, is not a bf16 value: scaled by 0.1 before
    rounding it gives bf16 25.75, rounded first (to 256) 25.625.  The port
    must give what JAX gives."""
    q8 = np.asarray([[127], [127], [3]], np.int8)
    scale = np.asarray([0.1], np.float32)
    got = tmodel.qdot(torch.ones((1, 3), dtype=torch.bfloat16),
                      {"q8": torch.from_numpy(q8),
                       "scale": torch.from_numpy(scale)}, torch.bfloat16)
    want = jmodel.qdot(jnp.ones((1, 3), jnp.bfloat16),
                       {"q8": jnp.asarray(q8), "scale": jnp.asarray(scale)})
    assert float(got[0, 0]) == float(want[0, 0]) == 25.75


# -- the forwards ----------------------------------------------------------------

@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_quantized_forward_train_matches_jax(act):
    """float32 activations: the int8 products are exact in float32 on
    both sides, the rest is summation order (1e-4 as
    tests/test_torch_model.py); bf16: BF16_LOGIT_ATOL."""
    jp, tp = _both(jquant.quantize_params(
        jweights.init_params(TINY_TEST, seed=3)))
    tokens = np.random.default_rng(0).integers(
        1, TINY_TEST.vocab_size, (2, 24)).astype(np.int32)
    jdt = getattr(jnp, act)
    want = np.asarray(jmodel.forward_train(jp, jnp.asarray(tokens),
                                           cfg=TINY_TEST, act_dtype=jdt))
    with torch.no_grad():
        got = _np(tmodel.forward_train(tp, torch.from_numpy(tokens),
                                       cfg=TINY_TEST,
                                       act_dtype=getattr(torch, act)))
    tol = 1e-4 if act == "float32" else BF16_LOGIT_ATOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _serve_both(jp, tp, jcfg, tcfg, *, steps=3):
    """forward_prefill then ``steps`` forward_decode steps on both sides;
    returns the list of (port, JAX) logits."""
    P, MP, S = 8, 8, 32
    jcache = jkv.init_cache(jcfg, jkv.CacheConfig(
        num_pages=24, page_size=P, max_pages_per_seq=MP))
    tcache = tkv.init_cache(tcfg, tkv.CacheConfig(
        num_pages=24, page_size=P, max_pages_per_seq=MP), device="cpu")
    rng = np.random.default_rng(7)
    lens = np.asarray([13, 29], np.int32)
    toks = np.zeros((2, S), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, jcfg.vocab_size, size=n)
    bt = np.zeros((2, MP), np.int32)
    bt[0, :3] = [1, 2, 3]
    bt[1, :5] = [4, 5, 6, 7, 8]
    pages = bt[:, : S // P]
    jl, jcache = jmodel.forward_prefill(
        jp, jcache, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(pages),
        cfg=jcfg, interpret=True)
    tl = tmodel.forward_prefill(
        tp, tcache, torch.from_numpy(toks), torch.from_numpy(lens),
        torch.from_numpy(pages), cfg=tcfg)
    pairs = [(_np(tl), np.asarray(jl))]
    cur = np.array(jnp.argmax(jl, -1), np.int32)
    seq = lens.copy()
    for _ in range(steps):
        seq = seq + 1
        jl, jcache = jmodel.forward_decode(
            jp, jcache, jnp.asarray(cur), jnp.asarray(seq), jnp.asarray(bt),
            cfg=jcfg, interpret=True)
        tl = tmodel.forward_decode(
            tp, tcache, torch.from_numpy(cur), torch.from_numpy(seq),
            torch.from_numpy(bt), cfg=tcfg)
        pairs.append((_np(tl), np.asarray(jl)))
        cur = np.array(jnp.argmax(jl, -1), np.int32)
    return pairs


def test_quantized_prefill_and_decode_match_jax():
    """int8 weights through forward_prefill and three forward_decode
    steps: logits within BF16_LOGIT_ATOL of JAX's on the same int8."""
    jp, tp = _both(jquant.quantize_params(
        jweights.init_params(TINY_TEST, seed=1)))
    for got, want in _serve_both(jp, tp, TINY_TEST, TINY_TEST):
        np.testing.assert_allclose(got, want, atol=BF16_LOGIT_ATOL)


def test_untied_lm_head_is_quantized_and_matches_jax():
    """An untied lm_head is quantized and taken through ``qdot`` with a
    float32 result, on both sides."""
    jcfg, tcfg = JModelConfig(**UNTIED), ModelConfig(**UNTIED)
    jp, tp = _both(jquant.quantize_params(jweights.init_params(jcfg, seed=4)))
    assert tquant.is_quantized_weight(tp["lm_head"])
    assert tp["lm_head"]["q8"].shape == (128, 512)
    for got, want in _serve_both(jp, tp, jcfg, tcfg, steps=2):
        np.testing.assert_allclose(got, want, atol=BF16_LOGIT_ATOL)
    tokens = np.arange(1, 17, dtype=np.int32)[None]
    want = np.asarray(jmodel.forward_train(jp, jnp.asarray(tokens), cfg=jcfg,
                                           act_dtype=jnp.float32))
    with torch.no_grad():
        got = _np(tmodel.forward_train(tp, torch.from_numpy(tokens),
                                       cfg=tcfg, act_dtype=torch.float32))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_calibration_runs_on_int8_params():
    """calibrate_kv_scales reads quantized blocks too (the engine calibrates
    on the raw params; the forward must still take int8 ones)."""
    jp, tp = _both(jquant.quantize_params(
        jweights.init_params(TINY_TEST, seed=2)))
    tokens = np.random.default_rng(3).integers(
        1, TINY_TEST.vocab_size, (2, 32)).astype(np.int32)
    jk, jv = jmodel.calibrate_kv_scales(jp, jnp.asarray(tokens),
                                        cfg=TINY_TEST)
    tk, tv = tmodel.calibrate_kv_scales(tp, torch.from_numpy(tokens),
                                        cfg=TINY_TEST)
    # bf16 K/V maxima: one bf16 ulp (2^-8 relative) apart at most
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-2)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-2)


# -- the engine ------------------------------------------------------------------

def test_engine_greedy_tokens_match_the_jax_engine(tiny_npz):
    """The golden window, int8 weights, K=3: the port's tokens are the JAX
    engine's, token for token."""
    from deepvision_tpu.engine.engine import EngineConfig as JEngineConfig
    from deepvision_tpu.engine.engine import LLMEngine as JLLMEngine

    kw = dict(TINY, checkpoint_dir=tiny_npz, quantize="int8",
              decode_steps_per_call=3)
    jeng = JLLMEngine(JEngineConfig(**kw, interpret=True))
    try:
        want = jeng.submit_tokens(jeng.tokenizer.encode(GOLDEN_PROMPT),
                                  max_tokens=GOLDEN_NEW,
                                  temperature=0.0).wait(300)
    finally:
        jeng.shutdown()
    eng = LLMEngine(EngineConfig(**kw, device="cpu"))
    try:
        assert tquant.is_quantized(eng.runner.params)
        got = eng.submit_tokens(eng.tokenizer.encode(GOLDEN_PROMPT),
                                max_tokens=GOLDEN_NEW,
                                temperature=0.0).wait(300)
        assert eng.embed_texts(["a"]) is None     # as the JAX engine
    finally:
        eng.shutdown()
    assert got is not None and got.ok, got
    assert got.token_ids == want.token_ids


def test_unknown_quantize_mode_raises():
    with pytest.raises(ValueError, match="fp4"):
        LLMEngine(EngineConfig(**TINY, device="cpu", quantize="fp4"))
