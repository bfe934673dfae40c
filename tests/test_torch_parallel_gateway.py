"""The app's way into tensor-parallel serving: ``build_gateway`` with
``ENGINE_TP=2`` builds a tp=2 engine for every lane model it names, and on
the CPU it answers a question (and its follow-up through the prefix cache)
and a report draft, each a JSON object, with the tp=1 gateway's texts.
``LLMEngine.embed_texts`` under TP returns the JAX tp=2 engine's
embeddings (the JAX engine embeds on its sharded serving params; the port
builds the unsharded params on rank 0).  The app's serving settings under
TP on the MQA geometry: chunked prefill with a prefix-cache resume and
pipelined decode, turn by turn against the JAX tp=2 engine."""

import json

import numpy as np
import torch

from deepvision_tpu_torch.web import gateway as tgateway
from test_torch_parallel_engine import (  # noqa: F401 — fixture
    PROMPT as TP_PROMPT,
    TP_CFG,
    jax_engine,
    port_engine,
    save_weights,
    serve,
    tp_steadiness,
)
from test_torch_parallel_mqa import MQA_CFG

torch.set_num_threads(2)

SETTINGS = {"AI_MODE": "engine", "QUESTION_MODEL_NAME": "dv-tiny-test",
            "REPORT_MODEL_NAME": "dv-tiny-test",
            "REPORT_DRAFT_MODEL_NAME": "dv-smoke",
            "REPORT_REVIEW_MODEL_NAME": "dv-smoke",
            "ENGINE_NUM_PAGES": 64, "ENGINE_PAGE_SIZE": 16,
            "ENGINE_MAX_PAGES_PER_SEQ": 16, "ENGINE_MAX_SLOTS": 2,
            "ENGINE_PREFILL_CHUNK_SIZE": 16}
PROMPT = "访谈主题：仓储管理系统选型。请生成下一个访谈问题："


def _calls(gw):
    ctx = {"session_id": "dv-tp-sess"}
    q, meta = gw.call_model(PROMPT, "question", max_tokens=12,
                            temperature=0.0, context=ctx, return_meta=True)
    follow = gw.call_model(PROMPT + q + "回答：三个区域仓。", "question",
                           max_tokens=12, temperature=0.0, context=ctx)
    report, meta_r = gw.call_model("报告草稿：", "report_draft",
                                   max_tokens=12, temperature=0.0,
                                   context=ctx, return_meta=True)
    for text in (q, follow, report):
        json.loads(text)
    assert (meta["lane"], meta["model"]) == ("question", "dv-tiny-test")
    assert (meta_r["lane"], meta_r["model"]) == ("report_draft", "dv-smoke")
    return q, follow, report


def test_build_gateway_with_engine_tp_2_answers_on_the_cpu(monkeypatch,
                                                          tmp_path):
    monkeypatch.setenv("DV_DFA_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("ENGINE_CHECKPOINT_DIR", str(tmp_path / "none.npz"))
    gw = tgateway.build_gateway(SETTINGS, device="cpu")
    try:
        assert all(e.cfg.tp == 1 for e in gw.engines.values())
        want = _calls(gw)
    finally:
        for eng in gw.engines.values():
            eng.shutdown()
    gw = tgateway.build_gateway({**SETTINGS, "ENGINE_TP": 2}, device="cpu")
    try:
        assert set(gw.engines) == {"dv-tiny-test", "dv-smoke"}
        for eng in gw.engines.values():
            eng.start()     # the report-only engine boots in a thread
            assert eng.plan.n_model == 2 and eng.stats()["tp"]["ranks"] == 2
        got = _calls(gw)
        assert gw.engines["dv-tiny-test"].stats()["prefix_cache"]["hits"] >= 1
    finally:
        for eng in gw.engines.values():
            eng.shutdown()
    assert got == want


def test_embed_texts_under_tp_matches_the_jax_tp_engine(tmp_path_factory):
    ckpt = save_weights(tmp_path_factory, TP_CFG, seed=3)
    texts = ["门店补货", "天气记录", "这是一段明显更长的文本内容。" * 10]
    jeng = jax_engine(TP_CFG, ckpt, 2, vocab_sharded=True)
    try:
        want = jeng.embed_texts(texts)
    finally:
        jeng.shutdown()
    eng = port_engine(TP_CFG, ckpt, 2, vocab_sharded=True, json_dfa=False)
    try:
        got = eng.embed_texts(texts)
        # the embedder's params are the full model, not rank 0's shard
        assert eng._embedder.params["embed"].shape[0] == TP_CFG.vocab_size
        assert eng.runner.params["embed"].shape[0] == TP_CFG.vocab_size // 2
    finally:
        eng.shutdown()
    # tests/test_torch_embedding.py's bounds: one bf16 ulp of the pooled
    # hidden state per element, and the same direction
    assert got.shape == want.shape == (3, TP_CFG.d_model)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    cos = np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1)
                                    * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999, cos


SESSION = dict(chunked_prefill=True, prefill_chunk_size=16,
               pipeline_decode=True, decode_steps_per_call=3,
               max_chained_decodes=3, vocab_sharded=True)


def _session(eng):
    """Two prompts decoded together (pipelined, 12 tokens), then a
    session's two turns under one prefix key: the second turn extends the
    first with its answer and resumes past the cached pages."""
    both = serve(eng, [TP_PROMPT, TP_PROMPT + "补充：预算有限。"], n=12)
    first = serve(eng, n=6, prefix_key="sess")[0]
    turn2 = TP_PROMPT + eng.tokenizer.decode(first) + "回答：三个区域仓。"
    second = serve(eng, [turn2], n=6, prefix_key="sess")[0]
    return both, first, second, eng.stats()["prefix_cache"]


def test_mqa_tp2_chunked_prefix_resume_and_pipelined_decode(
        tmp_path_factory):
    mqa_ckpt = save_weights(tmp_path_factory, MQA_CFG, seed=1)
    jeng = jax_engine(MQA_CFG, mqa_ckpt, 2, **SESSION)
    try:
        want = _session(jeng)
    finally:
        jeng.shutdown()
    eng = port_engine(MQA_CFG, mqa_ckpt, 2, **SESSION)
    try:
        got = _session(eng)
    finally:
        eng.shutdown()
    assert got[:3] == want[:3]
    assert got[3]["hits"] >= 1 and got[3]["tokens_saved"] > 0
