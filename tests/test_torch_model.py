"""The port's weights, KV cache writers and model forwards against JAX.

Parameters come from the JAX package (``init_params`` or the in-repo
``dv-mini.npz``) and reach the port through ``from_numpy_params`` /
``load_npz``, so both packages compute with the same numbers.  The JAX
serving forwards run their Pallas kernels in interpret mode.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine import kv_cache as jkv
from deepvision_tpu.engine import model as jmodel
from deepvision_tpu.engine import weights as jweights
from deepvision_tpu.engine.config import DV_MINI, TINY_TEST
from deepvision_tpu_torch.engine import kv_cache as tkv
from deepvision_tpu_torch.engine import model as tmodel
from deepvision_tpu_torch.engine import weights as tweights
from deepvision_tpu_torch.engine.config import get_model_config

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI_NPZ = os.path.join(ROOT, "resources", "checkpoints", "dv-mini.npz")

# bf16 tolerance on logits: each bf16 rounding point (q/k/v, gate/up, the
# residual stream) may land one ulp (2^-8 relative) apart when its f32
# input differs in the last bits between the two frameworks' matmuls, and
# such differences compound over the layer stack.
BF16_LOGIT_ATOL = 5e-2


def _np(t):
    return t.float().numpy()


def _jax_params(cfg, seed=0, dtype=jnp.bfloat16):
    jp = jweights.init_params(cfg, seed=seed, dtype=dtype)
    return jp, tweights.from_numpy_params(
        {k: (np.asarray(v) if not isinstance(v, dict)
             else {kk: np.asarray(vv) for kk, vv in v.items()})
         for k, v in jp.items()}, device="cpu")


def test_presets_are_the_same():
    for cfg in (TINY_TEST, DV_MINI):
        assert get_model_config(cfg.name).__dict__ == cfg.__dict__


def test_from_numpy_params_keeps_bf16_bits():
    jp, tp = _jax_params(TINY_TEST)
    want = np.asarray(jp["blocks"]["wq"]).view(np.uint16)
    got = tp["blocks"]["wq"].view(torch.int16).numpy().view(np.uint16)
    assert tp["blocks"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got, want)
    assert tweights.count_params(tp) == sum(
        int(np.prod(v.shape)) for v in [jp["embed"], jp["final_norm"]]
        + list(jp["blocks"].values()))


def test_init_params_names_and_shapes():
    jp = jweights.init_params(TINY_TEST)
    tp = tweights.init_params(TINY_TEST, device="cpu", seed=3)
    assert set(tp) == set(jp) and set(tp["blocks"]) == set(jp["blocks"])
    for name, leaf in jp["blocks"].items():
        assert tuple(tp["blocks"][name].shape) == leaf.shape
    again = tweights.init_params(TINY_TEST, device="cpu", seed=3)
    assert torch.equal(again["embed"], tp["embed"])


def test_load_npz_matches_jax_bit_for_bit():
    jp = jweights.load_npz(MINI_NPZ)
    tp = tweights.load_npz(MINI_NPZ, device="cpu")
    assert set(tp["blocks"]) == set(jp["blocks"])
    for name in ("wq", "w_down", "ln1"):
        want = np.asarray(jp["blocks"][name])
        got = tp["blocks"][name]
        assert got.shape == want.shape
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(), want.view(np.int16))


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_forward_train_matches_jax(act):
    """Full-sequence logits on dv-tiny-test.  float32 activations: matmul
    summation order only (1e-4); bf16: BF16_LOGIT_ATOL."""
    jp, tp = _jax_params(TINY_TEST)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, TINY_TEST.vocab_size, size=(2, 24)).astype(
        np.int32)
    jdt = jnp.float32 if act == "float32" else jnp.bfloat16
    tdt = torch.float32 if act == "float32" else torch.bfloat16
    want = np.asarray(jmodel.forward_train(
        jp, jnp.asarray(tokens), cfg=TINY_TEST, act_dtype=jdt))
    with torch.no_grad():
        got = _np(tmodel.forward_train(tp, torch.from_numpy(tokens),
                                       cfg=TINY_TEST, act_dtype=tdt))
    tol = 1e-4 if act == "float32" else BF16_LOGIT_ATOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_dv_mini_teacher_forced_logits_match_jax():
    """The trained in-repo checkpoint, bf16 serving math, one scenario
    text: logits within BF16_LOGIT_ATOL scaled by the logit range, and the
    same greedy next token at (nearly) every position."""
    from deepvision_tpu_torch.engine.tokenizer import get_tokenizer

    tok = get_tokenizer(os.path.join(ROOT, "resources", "tokenizer",
                                     "dv_bpe_8k.json"))
    ids = tok.encode("访谈主题：库存系统需求调研。请生成下一个访谈问题，"
                     "输出 JSON：{\"question\": \"")[:48]
    tokens = np.asarray([ids], np.int32)
    jp = jweights.load_npz(MINI_NPZ)
    tp = tweights.load_npz(MINI_NPZ, device="cpu")
    want = np.asarray(jmodel.forward_train(jp, jnp.asarray(tokens),
                                           cfg=DV_MINI))
    with torch.no_grad():
        got = _np(tmodel.forward_train(tp, torch.from_numpy(tokens),
                                       cfg=DV_MINI))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=BF16_LOGIT_ATOL * scale)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= 0.95, agree


# -- KV cache writers ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_cache_writers_match_jax(dtype):
    """Prefill and decode writers land the same rows (int8: same quantized
    bytes) in the same pages as the JAX writers."""
    rng = np.random.default_rng(5)
    KV, N, P, HD = 2, 12, 8, 32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.int8
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.int8
    jcache = jkv.init_cache(TINY_TEST, jkv.CacheConfig(
        num_pages=N, page_size=P, max_pages_per_seq=4, dtype=jdt))
    tcache = tkv.init_cache(TINY_TEST, tkv.CacheConfig(
        num_pages=N, page_size=P, max_pages_per_seq=4, dtype=tdt),
        device="cpu")
    assert len(tcache["k"]) == TINY_TEST.n_layers
    assert tuple(tcache["k"][0].shape) == jcache["k"][0].shape
    ks = vs = tks = tvs = None
    if dtype == "int8":
        ks, vs = jcache["ks"][0], jcache["vs"][0]
        tks, tvs = tcache["ks"][0], tcache["vs"][0]
        np.testing.assert_array_equal(tks.numpy(), np.asarray(ks))
    k_new = (rng.standard_normal((2, 16, KV, HD)) * 0.05).astype(np.float32)
    v_new = (rng.standard_normal((2, 16, KV, HD)) * 0.05).astype(np.float32)
    bt = np.asarray([[3, 5], [7, 0]], np.int32)
    jk, jv = jkv.write_prefill_pages(
        jcache["k"][0], jcache["v"][0], jnp.asarray(k_new, jnp.bfloat16),
        jnp.asarray(v_new, jnp.bfloat16), jnp.asarray(bt),
        k_scale=ks, v_scale=vs)
    tk, tv = tcache["k"][0], tcache["v"][0]
    tkv.write_prefill_pages(
        tk, tv, torch.from_numpy(k_new).bfloat16(),
        torch.from_numpy(v_new).bfloat16(), torch.from_numpy(bt),
        k_scale=tks, v_scale=tvs)
    nk = (rng.standard_normal((2, KV, HD)) * 0.05).astype(np.float32)
    dbt = np.asarray([[3, 5, 0, 0], [7, 9, 0, 0]], np.int32)
    pos = np.asarray([12, 9], np.int32)
    jk, jv = jkv.write_decode_token(
        jk, jv, jnp.asarray(nk, jnp.bfloat16), jnp.asarray(nk, jnp.bfloat16),
        jnp.asarray(dbt), jnp.asarray(pos), k_scale=ks, v_scale=vs)
    tkv.write_decode_token(
        tk, tv, torch.from_numpy(nk).bfloat16(),
        torch.from_numpy(nk).bfloat16(), torch.from_numpy(dbt),
        torch.from_numpy(pos), k_scale=tks, v_scale=tvs)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(
            got[:, 1:].float().numpy(),
            np.asarray(jnp.asarray(want[:, 1:], jnp.float32)))


def test_page_allocator_never_hands_out_the_trash_page():
    alloc = tkv.PageAllocator(5)
    pages = alloc.try_alloc(4)
    assert sorted(pages) == [1, 2, 3, 4]
    assert alloc.try_alloc(1) is None
    alloc.free(pages + [0])
    assert alloc.available() == 4
    assert tkv.pages_needed(65, 64) == 2


# -- serving forwards -----------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_prefill_and_decode_match_jax(kv_dtype):
    """forward_prefill then three forward_decode steps, ragged prompts, vs
    the JAX serving forwards (Pallas kernels in interpret mode) on the same
    params and cache layout: logits within BF16_LOGIT_ATOL, and the pools
    equal outside the trash page (the int8 pools to the byte, the bf16
    pools within one bf16 ulp of the rows both frameworks computed)."""
    cfg = TINY_TEST
    jp, tp = _jax_params(cfg, seed=1)
    P, MP, S = 8, 8, 32
    jdt = jnp.bfloat16 if kv_dtype == "bfloat16" else jnp.int8
    tdt = torch.bfloat16 if kv_dtype == "bfloat16" else torch.int8
    jcache = jkv.init_cache(cfg, jkv.CacheConfig(
        num_pages=24, page_size=P, max_pages_per_seq=MP, dtype=jdt))
    tcache = tkv.init_cache(cfg, tkv.CacheConfig(
        num_pages=24, page_size=P, max_pages_per_seq=MP, dtype=tdt),
        device="cpu")
    rng = np.random.default_rng(7)
    lens = np.asarray([13, 29], np.int32)
    toks = np.zeros((2, S), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, cfg.vocab_size, size=n)
    bt = np.zeros((2, MP), np.int32)
    bt[0, :3] = [1, 2, 3]
    bt[1, :5] = [4, 5, 6, 7, 8]
    pages = bt[:, : S // P]
    jl, jcache = jmodel.forward_prefill(
        jp, jcache, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(pages),
        cfg=cfg, interpret=True)
    tl = tmodel.forward_prefill(
        tp, tcache, torch.from_numpy(toks), torch.from_numpy(lens),
        torch.from_numpy(pages), cfg=cfg)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=BF16_LOGIT_ATOL)
    cur = np.array(jnp.argmax(jl, -1), np.int32)
    seq = lens.copy()
    for _ in range(3):
        seq = seq + 1
        jl, jcache = jmodel.forward_decode(
            jp, jcache, jnp.asarray(cur), jnp.asarray(seq), jnp.asarray(bt),
            cfg=cfg, interpret=True)
        tl = tmodel.forward_decode(
            tp, tcache, torch.from_numpy(cur), torch.from_numpy(seq),
            torch.from_numpy(bt), cfg=cfg)
        np.testing.assert_allclose(_np(tl), np.asarray(jl),
                                   atol=BF16_LOGIT_ATOL)
        cur = np.array(jnp.argmax(jl, -1), np.int32)
    for layer in range(cfg.n_layers):
        got = tcache["k"][layer][:, 1:].float().numpy()
        want = np.asarray(jnp.asarray(jcache["k"][layer][:, 1:], jnp.float32))
        if kv_dtype == "int8":
            assert np.abs(got - want).max() <= 1  # one quantization step
        else:
            np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)


def test_prefill_then_decode_equals_dense_forward():
    """The serving path (flash prefill + fused paged decode, plain versions
    on CPU) reproduces the full-sequence forward's logits at every served
    position (bf16 on both sides: BF16_LOGIT_ATOL)."""
    cfg = TINY_TEST
    _, tp = _jax_params(cfg, seed=2)
    P, MP, S = 8, 8, 32
    cache = tkv.init_cache(cfg, tkv.CacheConfig(
        num_pages=12, page_size=P, max_pages_per_seq=MP), device="cpu")
    rng = np.random.default_rng(8)
    n = 21
    seq_tokens = rng.integers(0, cfg.vocab_size, size=n + 4).astype(np.int32)
    toks = np.zeros((1, S), np.int32)
    toks[0, :n] = seq_tokens[:n]
    bt = np.zeros((1, MP), np.int32)
    bt[0, :4] = [2, 4, 6, 8]
    logits = [tmodel.forward_prefill(
        tp, cache, torch.from_numpy(toks), torch.tensor([n], dtype=torch.int32),
        torch.from_numpy(bt[:, : S // P]), cfg=cfg)[0]]
    for i in range(4):
        logits.append(tmodel.forward_decode(
            tp, cache, torch.from_numpy(seq_tokens[n + i: n + i + 1]),
            torch.tensor([n + i + 1], dtype=torch.int32),
            torch.from_numpy(bt), cfg=cfg)[0])
    with torch.no_grad():
        dense = tmodel.forward_train(tp, torch.from_numpy(seq_tokens[None]),
                                     cfg=cfg)[0]
    for i, lg in enumerate(logits):
        np.testing.assert_allclose(_np(lg), _np(dense[n - 1 + i]),
                                   atol=BF16_LOGIT_ATOL)
