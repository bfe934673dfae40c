"""The port's pipelined decode (chained decode calls, scheduler
``_decode_step_pipelined``) against its unpipelined path and against the
JAX engine's pipelined tokens (the JAX engine in interpret mode).

The port's counterpart of tests/test_pipeline_decode.py.
"""

import threading

import numpy as np
import pytest
import torch

from deepvision_tpu_torch.engine import runner as runner_lib
from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine

torch.set_num_threads(2)

CFG = dict(model="dv-tiny-test", tokenizer="byte", max_slots=4,
           num_pages=128, page_size=16, max_pages_per_seq=8,
           decode_steps_per_call=4, max_chained_decodes=3, seed=0)

PROMPTS = [
    "访谈主题：库存系统。请生成下一个问题：",
    "report draft about constraints",
    "短提示",
]


def _engine(pipeline: bool, **kw):
    return LLMEngine(EngineConfig(**CFG, device="cpu",
                                  pipeline_decode=pipeline, **kw))


def _serve(eng, max_tokens):
    try:
        out = []
        for p in PROMPTS:
            text, meta = eng.generate_text(p, max_tokens=max_tokens,
                                           temperature=0.0, timeout=300)
            out.append((text, meta["completion_tokens"]))
        return out
    finally:
        eng.shutdown()


@pytest.mark.parametrize("max_tokens", [5, 23])
def test_pipelined_matches_unpipelined_greedy(max_tokens):
    eng = _engine(True)
    assert eng.scheduler.pipeline_decode
    assert eng.scheduler.max_chained_decodes == 3
    chained = []
    decode_async = eng.runner.decode_async

    def spy(tokens, *args, **kw):
        chained.append(isinstance(tokens, torch.Tensor))
        return decode_async(tokens, *args, **kw)

    eng.runner.decode_async = spy
    got = _serve(eng, max_tokens)
    assert got == _serve(_engine(False), max_tokens)
    if max_tokens > 2 * CFG["decode_steps_per_call"]:
        # calls were chained from device-resident tokens
        assert any(chained) and eng.scheduler.readback_wait_s > 0.0


def test_pipelined_concurrent_batch():
    """Concurrent requests of different lengths finish under chaining (an
    early finisher's tokens from the call in flight are discarded), with
    the same tokens as each request alone, unpipelined."""
    eng = _engine(True)
    results = {}
    lock = threading.Lock()

    def run(i, n):
        res = eng.submit_tokens(eng.tokenizer.encode(PROMPTS[i % 3]),
                                max_tokens=n, temperature=0.0).wait(300)
        with lock:
            results[i] = res

    try:
        threads = [threading.Thread(target=run, args=(i, 4 + 7 * i))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = eng.stats()
    finally:
        eng.shutdown()
    assert len(results) == 4
    # every page came back: the drained calls freed what they held
    assert stats["queues"]["free_pages"] == CFG["num_pages"] - 1
    ref = _engine(False)
    try:
        for i, res in results.items():
            assert res is not None and res.ok, res
            assert len(res.token_ids) <= 4 + 7 * i
            alone = ref.submit_tokens(ref.tokenizer.encode(PROMPTS[i % 3]),
                                      max_tokens=4 + 7 * i,
                                      temperature=0.0).wait(300)
            assert res.token_ids == alone.token_ids
    finally:
        ref.shutdown()


def test_pipelined_respects_max_tokens():
    eng = _engine(True)
    try:
        for n in (1, 4, 9):
            _, meta = eng.generate_text(PROMPTS[0], max_tokens=n,
                                        temperature=0.0, timeout=300)
            assert meta["completion_tokens"] <= n
    finally:
        eng.shutdown()


def test_pipelined_tokens_match_the_jax_engine(tmp_path):
    """The same params (a JAX checkpoint both load), pipelined on both
    sides: the same greedy tokens for every prompt."""
    from deepvision_tpu.engine.config import TINY_TEST
    from deepvision_tpu.engine.engine import EngineConfig as JEngineConfig
    from deepvision_tpu.engine.engine import LLMEngine as JLLMEngine
    from deepvision_tpu.engine.weights import init_params, save_npz

    npz = str(tmp_path / "tiny.npz")
    save_npz(npz, init_params(TINY_TEST, seed=0))
    jeng = JLLMEngine(JEngineConfig(**CFG, checkpoint_dir=npz,
                                    pipeline_decode=True, interpret=True))
    try:
        want = [jeng.submit_tokens(jeng.tokenizer.encode(p), max_tokens=13,
                                   temperature=0.0).wait(300).token_ids
                for p in PROMPTS]
    finally:
        jeng.shutdown()
    eng = _engine(True, checkpoint_dir=npz)
    try:
        got = [eng.submit_tokens(eng.tokenizer.encode(p), max_tokens=13,
                                 temperature=0.0).wait(300).token_ids
               for p in PROMPTS]
    finally:
        eng.shutdown()
    assert got == want


def test_decode_async_takes_device_tensors_without_numpy(monkeypatch):
    """A chained call feeds the previous call's ``last_tok`` /
    ``last_state`` tensors back as they are: they never pass through
    ``np.asarray``, and the chained call gives the tokens of one longer
    call."""
    eng = _engine(False, json_dfa=False)
    runner = eng.runner
    B, MP = CFG["max_slots"], CFG["max_pages_per_seq"]
    prompt = list(range(1, 20))
    pages = eng.allocator.try_alloc(4)
    first = runner.prefill(prompt, pages)
    bt = np.zeros((B, MP), np.int32)
    bt[0, :4] = pages
    lens = np.ones(B, np.int32)
    lens[0] = len(prompt) + 1
    tokens = np.zeros(B, np.int32)
    tokens[0] = first
    zf, zi = np.zeros(B, np.float32), np.zeros(B, np.int32)
    one = np.ones(B, np.float32)
    out, last_tok, last_state = runner.decode_async(
        tokens, lens, bt, zf, zi, one, n_steps=3)
    assert isinstance(last_tok, torch.Tensor)

    real_asarray = np.asarray

    def guarded(a, *args, **kw):
        assert not isinstance(a, torch.Tensor), "np.asarray on a tensor"
        return real_asarray(a, *args, **kw)

    monkeypatch.setattr(runner_lib.np, "asarray", guarded)
    out2, _, _ = runner.decode_async(
        last_tok, lens + 3, bt, zf, zi, one, n_steps=2,
        dfa_states=last_state)
    chained = torch.cat([out, out2])[:, 0].tolist()
    monkeypatch.undo()
    head = runner.start_readback(out).wait()
    assert head[:, 0].tolist() == chained[:3]

    # the same five steps as one call into fresh pages
    pages2 = eng.allocator.try_alloc(4)
    first2 = runner.prefill(prompt, pages2)
    assert first2 == first
    bt[0, :4] = pages2
    whole = runner.decode(tokens, lens, bt, zf, zi, one, n_steps=5)
    assert whole[:, 0].tolist() == chained
    eng.shutdown()
