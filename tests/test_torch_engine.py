"""The port's serving engine end to end on the CPU, against the JAX engine.

``LLMEngine(device="cpu")`` runs tokenizer -> scheduler thread -> batched
prefill -> paged decode -> constrained sampling with the kernels' plain
versions; greedy output must be the JAX engine's token for token.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(model="dv-tiny-test", tokenizer="byte", max_slots=2,
            num_pages=64, page_size=16, max_pages_per_seq=8, seed=0)


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    """dv-tiny-test params from the JAX package, as a flat .npz both
    engines load."""
    from deepvision_tpu.engine.config import TINY_TEST
    from deepvision_tpu.engine.weights import init_params, save_npz

    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    save_npz(path, init_params(TINY_TEST, seed=0))
    return path


@pytest.mark.parametrize("decode_steps", [1, 3])
def test_greedy_tokens_match_the_jax_engine(tiny_npz, decode_steps):
    from deepvision_tpu.engine.engine import EngineConfig as JEngineConfig
    from deepvision_tpu.engine.engine import LLMEngine as JLLMEngine

    prompts = ["golden test prompt 黄金", "second prompt, longer than the first one"]
    want = []
    jeng = JLLMEngine(JEngineConfig(**TINY, checkpoint_dir=tiny_npz,
                                    decode_steps_per_call=decode_steps,
                                    interpret=True))
    try:
        for p in prompts:
            res = jeng.submit_tokens(jeng.tokenizer.encode(p), max_tokens=7,
                                     temperature=0.0).wait(300)
            want.append(res.token_ids)
    finally:
        jeng.shutdown()
    eng = LLMEngine(EngineConfig(**TINY, checkpoint_dir=tiny_npz,
                                 device="cpu",
                                 decode_steps_per_call=decode_steps))
    try:
        got = []
        for p in prompts:
            res = eng.submit_tokens(eng.tokenizer.encode(p), max_tokens=7,
                                    temperature=0.0).wait(300)
            assert res is not None and res.ok, res
            got.append(res.token_ids)
        text, meta = eng.generate_text(prompts[0], max_tokens=7,
                                       temperature=0.0, timeout=300)
    finally:
        eng.shutdown()
    assert got == want
    assert meta["completion_tokens"] == len(want[0])
    assert set(meta) == {
        "model", "queue_wait_ms", "prefill_ms", "decode_ms", "total_ms",
        "completion_tokens", "prompt_tokens", "finish_reason",
        "json_constrained"}
    assert eng.scheduler._thread is None      # shutdown joined the thread


def test_json_mode_on_dv_mini_parses(tmp_path, monkeypatch):
    """The trained in-repo checkpoint with its paired BPE vocabulary and the
    grammar mask: concurrent json_mode requests, each output parses."""
    monkeypatch.setenv("DV_DFA_CACHE_DIR", str(tmp_path))
    eng = LLMEngine(EngineConfig(
        model="dv-mini",
        tokenizer=os.path.join(ROOT, "resources", "tokenizer",
                               "dv_bpe_8k.json"),
        checkpoint_dir=os.path.join(ROOT, "resources", "checkpoints",
                                    "dv-mini.npz"),
        device="cpu", max_slots=2, num_pages=64, page_size=16,
        max_pages_per_seq=16, decode_steps_per_call=8, warmup=True))
    try:
        reqs = [eng.submit_tokens(
            eng.tokenizer.encode(f"访谈主题：{topic}\n\n请生成下一个访谈问题，"
                                 "输出 JSON："),
            max_tokens=24, temperature=0.0, json_mode=True)
            for topic in ("库存系统", "招投标调研", "用户研究")]
        for req in reqs:
            res = req.wait(300)
            assert res is not None and res.ok, res
            json.loads(eng.tokenizer.decode(res.token_ids))
        text, meta = eng.generate_text("输出 JSON：", max_tokens=16,
                                       temperature=0.8, json_mode=True,
                                       timeout=300)
        assert meta["json_constrained"] is True
        json.loads(text)
        assert eng.stats()["requests_finished"] == 4
    finally:
        eng.shutdown()


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "import deepvision_tpu_torch\n"
        "for m in pkgutil.walk_packages(deepvision_tpu_torch.__path__,\n"
        "                               'deepvision_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m in ('jax', 'tokenizers', 'regex')\n"
        "       or m.startswith('jax.') or m == 'deepvision_tpu'\n"
        "       or m.startswith('deepvision_tpu.')]\n"
        "assert not bad, bad\n"
        "for m in ('deepvision_tpu_torch.engine.engine',\n"
        "          'deepvision_tpu_torch.engine.training',\n"
        "          'deepvision_tpu_torch.train_model'):\n"
        "    assert m in sys.modules, m\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_engine_raises_without_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(EngineConfig(**TINY))


@pytest.mark.parametrize("setting", [
    {"tp": 2}, {"quantize": "int8"},
    {"kv_quantize": "int8"}, {"fuse_projections": True},
    {"pipeline_decode": True},
])
def test_unported_settings_raise(setting):
    with pytest.raises(NotImplementedError):
        LLMEngine(EngineConfig(**TINY, device="cpu", **setting))


def test_embed_texts_is_not_ported_yet():
    eng = LLMEngine(EngineConfig(**TINY, device="cpu", json_dfa=False))
    with pytest.raises(NotImplementedError):
        eng.embed_texts(["a"])


def test_warmup_and_batched_admission():
    """Warmup runs every batch bucket; four concurrent prompts of mixed
    lengths are admitted as one padded batch and all finish."""
    eng = LLMEngine(EngineConfig(**TINY, device="cpu", warmup=True,
                                 json_dfa=False, decode_steps_per_call=2))
    try:
        eng.start()
        assert eng.warmup_s is not None
        rng = np.random.default_rng(0)
        reqs = [eng.submit_tokens(
            rng.integers(0, 256, size=n).tolist(), max_tokens=5,
            temperature=0.0) for n in (3, 40, 17, 90)]
        results = [r.wait(300) for r in reqs]
        assert all(r is not None and r.ok for r in results)
        assert all(len(r.token_ids) <= 5 for r in results)
        assert eng.stats()["queues"]["free_pages"] == 63
    finally:
        eng.shutdown()
