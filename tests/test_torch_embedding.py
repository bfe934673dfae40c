"""The port's document embedder against the JAX package's.

``deepvision_tpu_torch/engine/embedding.py`` (``_encode_hidden``,
``DocumentEmbedder``), the tokenizers' ``encode_batch``,
``LLMEngine.embed_texts`` and ``ModelGateway.embed_texts`` are held against
their JAX counterparts on the same parameters (JAX ``init_params`` carried
over with ``from_numpy_params``), with the JAX flash kernel in interpret
mode and the port's flash wrapper running its plain version on the CPU.

Tolerance: both encoders take the same bf16 rounding points (embedding,
q/k/v, the residual stream, the MLP's gate/up), and each may land one bf16
step (2^-8 relative) apart where the two frameworks' float32 matmuls
differ in their last bits; over two layers and a mean-pool that stays
well inside 2e-2 per element of a unit vector, and the two vectors' cosine
stays above 0.999.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine import client as jclient
from deepvision_tpu.engine import embedding as jemb
from deepvision_tpu.engine import tokenizer as jtok
from deepvision_tpu.engine import weights as jweights
from deepvision_tpu.engine.config import TINY_TEST
from deepvision_tpu_torch.engine import embedding as temb
from deepvision_tpu_torch.engine import tokenizer as ttok
from deepvision_tpu_torch.engine import weights as tweights
from deepvision_tpu_torch.engine.client import ModelGateway
from deepvision_tpu_torch.engine.config import get_model_config
from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BPE_8K = os.path.join(ROOT, "resources", "tokenizer", "dv_bpe_8k.json")
ELEM_ATOL = 2e-2
MIN_COSINE = 0.999

# Two buckets: short texts pad to 128 tokens, the long ones to 256 (byte
# tokenizer: three bytes a CJK character).
TEXTS = ["客户管理流程", "数据报表", "hello world",
         "这是一段明显更长的文本内容，用于跨桶测试。" * 4,
         "仓库进货怎样自动化", "门店补货决策依赖人工经验，数据分散在多个系统中" * 3]


def _configs(vocab_size):
    jcfg = dataclasses.replace(TINY_TEST, vocab_size=vocab_size)
    tcfg = dataclasses.replace(get_model_config(TINY_TEST.name),
                               vocab_size=vocab_size)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jp = jweights.init_params(jcfg, seed=seed)
    tp = tweights.from_numpy_params(
        {k: (np.asarray(v) if not isinstance(v, dict)
             else {kk: np.asarray(vv) for kk, vv in v.items()})
         for k, v in jp.items()}, device="cpu")
    return jp, tp


def _assert_close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ELEM_ATOL, rtol=0)
    cos = np.sum(got * want, axis=-1) / (
        np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= MIN_COSINE, cos


@pytest.mark.parametrize("texts", [
    [], ["a"], TEXTS, ["", "第二段", "x" * 300]])
def test_byte_encode_batch_matches_jax(texts):
    for add_bos in (True, False):
        assert (ttok.ByteTokenizer().encode_batch(texts, add_bos)
                == jtok.ByteTokenizer().encode_batch(texts, add_bos))


def test_bpe_encode_batch_matches_jax_and_ignores_add_bos():
    texts = TEXTS + ["<|eot|>访谈主题：库存系统\n\n请生成下一个问题", ""]
    want = jtok.get_tokenizer(BPE_8K).encode_batch(texts)
    tok = ttok.get_tokenizer(BPE_8K)
    assert tok.encode_batch(texts) == want
    assert tok.encode_batch(texts, add_bos=False) == want


@pytest.mark.parametrize("bucket", [128, 256])
def test_encode_hidden_matches_jax(bucket):
    """``_encode_hidden`` on one padded batch (ragged lengths, a length-1
    row) against the JAX encoder."""
    jcfg, tcfg = _configs(TINY_TEST.vocab_size)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(bucket)
    toks = rng.integers(0, jcfg.vocab_size, (3, bucket)).astype(np.int32)
    lens = np.array([bucket, bucket // 2 + 3, 1], np.int32)
    want = np.asarray(jemb._encode_hidden(jp, jnp.asarray(toks),
                                          jnp.asarray(lens), cfg=jcfg))
    got = temb._encode_hidden(tp, torch.from_numpy(toks),
                              torch.from_numpy(lens), cfg=tcfg)
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("tokenizer", ["byte", "bpe"])
def test_document_embedder_matches_jax(tokenizer):
    """``DocumentEmbedder.embed_texts`` across two buckets and batches of
    two (inputs sorted by length), for both tokenizers."""
    spec = "byte" if tokenizer == "byte" else BPE_8K
    vocab = TINY_TEST.vocab_size if tokenizer == "byte" else 8192
    jcfg, tcfg = _configs(vocab)
    jp, tp = _params(jcfg, seed=1)
    want = jemb.DocumentEmbedder(jcfg, params=jp, tokenizer_spec=spec,
                                 batch_size=2).embed_texts(TEXTS)
    emb = temb.DocumentEmbedder(tcfg, params=tp, tokenizer_spec=spec,
                                batch_size=2)
    assert emb.device == torch.device("cpu")
    got = emb.embed_texts(TEXTS)
    _assert_close(got, want)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-3)
    assert emb.embed_texts([]).shape == (0, tcfg.d_model)


def test_document_embedder_truncates_at_the_largest_bucket():
    """A text past 1,024 tokens is cut there, so it embeds as the text of
    its first 1,024 tokens (BOS and 1,023 bytes: 341 whole characters)."""
    jcfg, tcfg = _configs(TINY_TEST.vocab_size)
    _, tp = _params(jcfg)
    emb = temb.DocumentEmbedder(tcfg, params=tp)
    long = "门店补货" * 120              # 1,441 byte tokens with BOS
    cut = long[:341]
    assert emb.tokenizer.encode(cut) == emb.tokenizer.encode(long)[:1024]
    a, b = emb.embed_texts([long, cut])
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_default_embedder_is_dv_smoke_and_needs_cuda_unless_cpu():
    emb = temb.DocumentEmbedder(device="cpu")
    assert emb.cfg.name == "dv-smoke" and emb.batch_size == 16
    assert isinstance(emb.tokenizer, ttok.ByteTokenizer)
    assert emb.params["embed"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            temb.DocumentEmbedder()


def test_rank_chunks_orders_like_jax():
    jcfg, tcfg = _configs(TINY_TEST.vocab_size)
    jp, tp = _params(jcfg)
    chunks = ["完全无关的内容 abc", "客户管理系统的报表功能说明",
              "另一段无关内容 xyz", "客户管理系统"]
    query = "客户管理系统的报表功能说明"
    want = jemb.DocumentEmbedder(jcfg, params=jp).rank_chunks(
        chunks, query, top_k=3)
    got = temb.DocumentEmbedder(tcfg, params=tp).rank_chunks(
        chunks, query, top_k=3)
    assert got[0] == 1                 # the exact match ranks first
    assert [int(i) for i in got] == [int(i) for i in want]
    assert temb.DocumentEmbedder(tcfg, params=tp).rank_chunks([], "q") == []


def test_engine_embed_texts_matches_jax(tmp_path):
    """``LLMEngine.embed_texts`` on dv-tiny-test's serving params, against
    the JAX engine's on the same checkpoint."""
    from deepvision_tpu.engine.engine import EngineConfig as JEngineConfig
    from deepvision_tpu.engine.engine import LLMEngine as JLLMEngine

    ckpt = str(tmp_path / "tiny.npz")
    jweights.save_npz(ckpt, jweights.init_params(TINY_TEST, seed=0))
    settings = dict(model="dv-tiny-test", tokenizer="byte", max_slots=2,
                    num_pages=64, page_size=16, max_pages_per_seq=8, seed=0,
                    checkpoint_dir=ckpt)
    texts = ["门店补货", "天气记录", "这是一段明显更长的文本内容。" * 10]
    jeng = JLLMEngine(JEngineConfig(**settings, interpret=True))
    try:
        want = jeng.embed_texts(texts)
    finally:
        jeng.shutdown()
    eng = LLMEngine(EngineConfig(**settings, device="cpu", json_dfa=False))
    try:
        got = eng.embed_texts(texts)
        again = eng.embed_texts(texts[:1])
    finally:
        eng.shutdown()
    assert got.shape == (3, TINY_TEST.d_model)
    _assert_close(got, want)
    np.testing.assert_array_equal(again[0], got[0])
    assert eng._embedder.params is eng.runner.params


class _VecEngine:
    """An engine whose embeddings are fixed per text; records each call."""

    def __init__(self, fail=False):
        self.fail, self.calls = fail, []

    def embed_texts(self, texts):
        self.calls.append(list(texts))
        if self.fail:
            raise RuntimeError("device busy")
        return np.asarray([[float(len(t)), 1.0] for t in texts], np.float32)


@pytest.mark.parametrize("module", ["port", "jax"])
def test_gateway_embed_cache_embeds_only_novel_texts(module):
    cls = ModelGateway if module == "port" else jclient.ModelGateway
    eng = _VecEngine()
    gw = cls(mode="engine", engines={"e": eng})
    out1 = gw.embed_texts(["块一", "块二", "查询A", "块一"])
    assert out1.shape == (4, 2)
    assert eng.calls == [["块一", "块二", "查询A"]]
    out2 = gw.embed_texts(["块一", "块二", "查询BB"])
    assert eng.calls[1] == ["查询BB"]
    np.testing.assert_array_equal(out2[:2], out1[:2])
    for i in range(600):              # the LRU keeps the newest 512 texts
        gw.embed_texts([f"t{i}"])
    assert len(gw._embed_cache) == 512 and "块一" not in gw._embed_cache


@pytest.mark.parametrize("module", ["port", "jax"])
def test_gateway_embed_degrades_to_none_and_falls_over(module):
    """An engine that raises is skipped for the next; when all fail (or
    none can embed) the gateway returns None and caches nothing."""
    cls = ModelGateway if module == "port" else jclient.ModelGateway
    bad, good = _VecEngine(fail=True), _VecEngine()
    gw = cls(mode="engine", engines={"bad": bad, "good": good})
    assert gw.embed_texts(["a", "bb"]).shape == (2, 2)
    assert bad.calls == [["a", "bb"]] and good.calls == [["a", "bb"]]
    gw = cls(mode="engine", engines={"bad": _VecEngine(fail=True),
                                     "none": object()})
    assert gw.embed_texts(["a"]) is None
    assert len(gw._embed_cache) == 0
