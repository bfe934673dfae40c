"""The port's projection fusion (engine/fuse.py: ``w_qkv``, ``w_gate_up``)
against its unfused forward and against the JAX package's fused one.

The same JAX params reach both packages through ``from_numpy_params``;
the JAX engines run their Pallas kernels in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine import fuse as jfuse
from deepvision_tpu.engine import model as jmodel
from deepvision_tpu.engine import quant as jquant
from deepvision_tpu.engine import weights as jweights
from deepvision_tpu.engine.config import TINY_TEST
from deepvision_tpu_torch.engine import fuse as tfuse
from deepvision_tpu_torch.engine import model as tmodel
from deepvision_tpu_torch.engine import quant as tquant
from deepvision_tpu_torch.engine import weights as tweights
from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine

torch.set_num_threads(2)

CFG = TINY_TEST
# fused against unfused in one package: each output column is the same
# dot product, so only the matmul's blocking may differ (1e-5, as
# tests/test_fuse.py:45)
FUSE_TOL = 1e-5
# against JAX in bf16: one ulp per bf16 rounding point, compounded over the
# layers (as tests/test_torch_model.py)
BF16_LOGIT_ATOL = 5e-2
TINY = dict(model="dv-tiny-test", tokenizer="byte", max_slots=2,
            num_pages=64, page_size=16, max_pages_per_seq=8, seed=0)
GOLDEN_PROMPT, GOLDEN_NEW = "golden test prompt 黄金", 7


def _np_tree(tree):
    return {k: (_np_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def _port(jp):
    return tweights.from_numpy_params(_np_tree(jp), device="cpu")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        1, CFG.vocab_size, shape).astype(np.int32)


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    jweights.save_npz(path, jweights.init_params(TINY_TEST, seed=0))
    return path


def test_fuse_structure_and_param_count():
    jp = jweights.init_params(CFG, seed=0)
    tp = _port(jp)
    fused = tfuse.fuse_params(tp, CFG)
    assert tfuse.is_fused(fused) and not tfuse.is_fused(tp)
    for gone in ("wq", "wk", "wv", "w_gate", "w_up"):
        assert gone not in fused["blocks"]
    assert tweights.count_params(fused) == tweights.count_params(tp)
    D = CFG.d_model
    assert tuple(fused["blocks"]["w_qkv"].shape) == (
        CFG.n_layers, D, (CFG.n_heads + 2 * CFG.n_kv_heads) * CFG.head_dim)
    assert tuple(fused["blocks"]["w_gate_up"].shape) == (
        CFG.n_layers, D, 2 * CFG.d_ff)
    want = jfuse.fuse_params(jp, CFG)
    for name in ("w_qkv", "w_gate_up"):
        np.testing.assert_array_equal(
            fused["blocks"][name].float().numpy(),
            np.asarray(want["blocks"][name], np.float32))


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_fused_forward_matches_unfused_and_jax(act):
    jp = jweights.init_params(CFG, seed=1)
    tp = _port(jp)
    toks = _tokens(0, (2, 16))
    tdt, jdt = getattr(torch, act), getattr(jnp, act)
    with torch.no_grad():
        a = tmodel.forward_train(tp, torch.from_numpy(toks), cfg=CFG,
                                 act_dtype=tdt).numpy()
        b = tmodel.forward_train(tfuse.fuse_params(tp, CFG),
                                 torch.from_numpy(toks), cfg=CFG,
                                 act_dtype=tdt).numpy()
    np.testing.assert_allclose(b, a, rtol=FUSE_TOL, atol=FUSE_TOL)
    want = np.asarray(jmodel.forward_train(
        jfuse.fuse_params(jp, CFG), jnp.asarray(toks), cfg=CFG,
        act_dtype=jdt))
    tol = 1e-4 if act == "float32" else BF16_LOGIT_ATOL
    np.testing.assert_allclose(b, want, rtol=tol, atol=tol)


def test_fused_serving_forwards_match_unfused():
    """forward_prefill and forward_decode on fused params give the unfused
    logits (FUSE_TOL) and write the same pools."""
    from deepvision_tpu_torch.engine import kv_cache as tkv

    tp = _port(jweights.init_params(CFG, seed=5))
    fp = tfuse.fuse_params(tp, CFG)
    P, MP, S = 8, 8, 32
    lens = np.asarray([13, 29], np.int32)
    toks = np.zeros((2, S), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = _tokens(b, n)
    bt = np.zeros((2, MP), np.int32)
    bt[0, :3] = [1, 2, 3]
    bt[1, :5] = [4, 5, 6, 7, 8]
    outs = []
    for params in (tp, fp):
        cache = tkv.init_cache(CFG, tkv.CacheConfig(
            num_pages=24, page_size=P, max_pages_per_seq=MP), device="cpu")
        logits = [tmodel.forward_prefill(
            params, cache, torch.from_numpy(toks), torch.from_numpy(lens),
            torch.from_numpy(bt[:, : S // P]), cfg=CFG)]
        cur = logits[0].argmax(-1).to(torch.int32)
        seq = torch.from_numpy(lens)
        for _ in range(2):
            seq = seq + 1
            logits.append(tmodel.forward_decode(
                params, cache, cur, seq, torch.from_numpy(bt), cfg=CFG))
            cur = logits[-1].argmax(-1).to(torch.int32)
        outs.append((logits, cache))
    for got, want in zip(outs[1][0], outs[0][0]):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=FUSE_TOL, atol=FUSE_TOL)
    for layer in range(CFG.n_layers):
        assert torch.equal(outs[1][1]["k"][layer], outs[0][1]["k"][layer])


def test_fuse_then_quantize_matches_jax():
    """Fused then quantized: the same int8 and scales as JAX (bit for bit
    and 1e-7), and forward_train within BF16_LOGIT_ATOL of JAX's."""
    jp = jweights.init_params(CFG, seed=2)
    jfq = jquant.quantize_params(jfuse.fuse_params(jp, CFG))
    tfq = tquant.quantize_params(tfuse.fuse_params(_port(jp), CFG))
    assert tfuse.is_fused(tfq) and tquant.is_quantized(tfq)
    for name in ("w_qkv", "w_gate_up"):
        assert tfq["blocks"][name]["q8"].dtype == torch.int8
        np.testing.assert_array_equal(tfq["blocks"][name]["q8"].numpy(),
                                      np.asarray(jfq["blocks"][name]["q8"]))
        np.testing.assert_allclose(tfq["blocks"][name]["scale"].numpy(),
                                   np.asarray(jfq["blocks"][name]["scale"]),
                                   rtol=1e-7)
    toks = _tokens(1, (1, 12))
    want = np.asarray(jmodel.forward_train(jfq, jnp.asarray(toks), cfg=CFG))
    with torch.no_grad():
        got = tmodel.forward_train(tfq, torch.from_numpy(toks),
                                   cfg=CFG).numpy()
    np.testing.assert_allclose(got, want, atol=BF16_LOGIT_ATOL)


def test_quantize_then_fuse_raises():
    tp = tquant.quantize_params(_port(jweights.init_params(CFG, seed=3)))
    with pytest.raises(ValueError, match="before quantize_params"):
        tfuse.fuse_params(tp, CFG)


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_engine_greedy_parity_with_jax(tiny_npz, quantize):
    """The golden window through fused (and fused + int8) engines, K=3:
    the port's tokens are the JAX engine's under the same setting, and the
    fused bf16 tokens are the unfused port engine's."""
    from deepvision_tpu.engine.engine import EngineConfig as JEngineConfig
    from deepvision_tpu.engine.engine import LLMEngine as JLLMEngine

    kw = dict(TINY, checkpoint_dir=tiny_npz, decode_steps_per_call=3,
              quantize=quantize)

    def run(eng):
        try:
            return eng.submit_tokens(
                eng.tokenizer.encode(GOLDEN_PROMPT), max_tokens=GOLDEN_NEW,
                temperature=0.0).wait(300)
        finally:
            eng.shutdown()

    want = run(JLLMEngine(JEngineConfig(**kw, fuse_projections=True,
                                        interpret=True)))
    eng = LLMEngine(EngineConfig(**kw, fuse_projections=True, device="cpu"))
    assert tfuse.is_fused(eng.runner.params)
    assert tquant.is_quantized(eng.runner.params) == bool(quantize)
    assert eng.embed_texts(["a"]) is None     # as the JAX engine
    got = run(eng)
    assert got is not None and got.ok, got
    assert got.token_ids == want.token_ids
    if not quantize:
        unfused = run(LLMEngine(EngineConfig(**kw, device="cpu")))
        assert unfused.token_ids == got.token_ids
