"""The port's HuggingFace importer (engine/hf_import.py) against the JAX
package's and against ``transformers`` itself, on random tiny configs
(nothing is downloaded).

The port's counterpart of tests/test_hf_parity.py.
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from deepvision_tpu.engine import hf_import as jhf  # noqa: E402
from deepvision_tpu.engine import model as jmodel  # noqa: E402
from deepvision_tpu_torch.engine import hf_import as thf  # noqa: E402
from deepvision_tpu_torch.engine import kv_cache as tkv  # noqa: E402
from deepvision_tpu_torch.engine import model as tmodel  # noqa: E402
from deepvision_tpu_torch.engine import weights as tweights  # noqa: E402
from deepvision_tpu_torch.engine.engine import (  # noqa: E402
    EngineConfig,
    LLMEngine,
)

torch.set_num_threads(2)

# float32 activations against HF's float32 forward: the tolerance of
# tests/test_hf_parity.py:60 (summation order through two layers)
HF_TOL = 2e-3

LLAMA = dict(vocab_size=300, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128,
             rms_norm_eps=1e-5, rope_theta=10000.0,
             tie_word_embeddings=False, attention_bias=False)


@pytest.fixture(scope="module")
def tiny_llama():
    cfg = transformers.LlamaConfig(**LLAMA)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg)
    model.eval()
    return cfg, model


def _port_params(hf_model, cfg):
    return tweights.from_numpy_params(
        thf.convert_hf_state_dict(dict(hf_model.state_dict()), cfg),
        device="cpu")


@pytest.mark.parametrize("kind", ["llama", "gemma"])
def test_infer_config_matches_jax(kind):
    if kind == "llama":
        hf_cfg = transformers.LlamaConfig(**LLAMA)
    else:
        hf_cfg = transformers.GemmaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=1, head_dim=32)
    got = thf.infer_config_from_hf(hf_cfg, name="x")
    want = jhf.infer_config_from_hf(hf_cfg, name="x")
    assert got.__dict__ == want.__dict__
    assert got.scale_embeddings == (kind == "gemma")


@pytest.mark.parametrize("tied", [False, True])
def test_convert_state_dict_equals_jax(tiny_llama, tied):
    """Every leaf equal to the JAX converter's, exactly; an untied config
    without ``lm_head.weight`` takes the embedding's transpose."""
    hf_cfg, hf_model = tiny_llama
    sd = dict(hf_model.state_dict())
    if tied:
        sd.pop("lm_head.weight")
    for norm_offset in (-1.0, 0.0):
        got = thf.convert_hf_state_dict(
            sd, thf.infer_config_from_hf(hf_cfg), norm_offset=norm_offset)
        want = jhf.convert_hf_state_dict(
            sd, jhf.infer_config_from_hf(hf_cfg), norm_offset=norm_offset)
        assert set(got) == set(want) and set(got["blocks"]) == set(
            want["blocks"])
        for name in ("embed", "final_norm", "lm_head"):
            assert got[name].dtype == np.float32
            np.testing.assert_array_equal(got[name], want[name])
        for name, leaf in want["blocks"].items():
            np.testing.assert_array_equal(got["blocks"][name], leaf)
    if tied:
        np.testing.assert_array_equal(got["lm_head"], got["embed"].T)


def test_logits_match_hf(tiny_llama):
    hf_cfg, hf_model = tiny_llama
    cfg = thf.infer_config_from_hf(hf_cfg)
    params = _port_params(hf_model, cfg)
    tokens = np.random.RandomState(0).randint(0, hf_cfg.vocab_size, (2, 17))
    with torch.no_grad():
        want = hf_model(torch.tensor(tokens)).logits.numpy()
        got = tmodel.forward_train(
            params, torch.from_numpy(tokens.astype(np.int32)), cfg=cfg,
            act_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=HF_TOL, atol=HF_TOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    # and the JAX package's forward on its own conversion
    jparams = jhf.convert_hf_state_dict(
        dict(hf_model.state_dict()), jhf.infer_config_from_hf(hf_cfg))
    jgot = np.asarray(jmodel.forward_train(
        jparams, jnp.asarray(tokens, jnp.int32),
        cfg=jhf.infer_config_from_hf(hf_cfg), act_dtype=jnp.float32))
    np.testing.assert_allclose(got, jgot, rtol=1e-4, atol=1e-4)


def test_decode_path_matches_hf_greedy(tiny_llama):
    """The port's paged prefill + decode continue like HF greedy decoding."""
    hf_cfg, hf_model = tiny_llama
    cfg = thf.infer_config_from_hf(hf_cfg)
    params = _port_params(hf_model, cfg)
    cache_cfg = tkv.CacheConfig(num_pages=32, page_size=16,
                                max_pages_per_seq=8)
    cache = tkv.init_cache(cfg, cache_cfg, device="cpu")
    prompt = list(np.random.RandomState(1).randint(0, hf_cfg.vocab_size,
                                                   size=9))
    with torch.no_grad():
        hf_out = hf_model.generate(
            torch.tensor([prompt]), max_new_tokens=5, do_sample=False,
            pad_token_id=0)[0].tolist()
    toks = np.zeros((1, 16), np.int32)
    toks[0, : len(prompt)] = prompt
    logits = tmodel.forward_prefill(
        params, cache, torch.from_numpy(toks),
        torch.tensor([len(prompt)], dtype=torch.int32),
        torch.tensor([[1]], dtype=torch.int32), cfg=cfg)
    seq = list(prompt) + [int(logits[0].argmax())]
    bt = torch.zeros((1, cache_cfg.max_pages_per_seq), dtype=torch.int32)
    bt[0, :3] = torch.tensor([1, 2, 3])
    for _ in range(4):
        logits = tmodel.forward_decode(
            params, cache, torch.tensor([seq[-1]], dtype=torch.int32),
            torch.tensor([len(seq)], dtype=torch.int32), bt, cfg=cfg)
        seq.append(int(logits[0].argmax()))
    assert seq[len(prompt):] == hf_out[len(prompt):]


def test_load_hf_model_from_a_saved_directory(tiny_llama, tmp_path):
    """``save_pretrained`` to a directory, then ``load_hf_model``: the
    JAX loader's config and params, and an int8 engine of the port serving
    them (the untied lm_head quantized) with the JAX int8 engine's greedy
    tokens."""
    from deepvision_tpu.engine.engine import EngineConfig as JEngineConfig
    from deepvision_tpu.engine.engine import LLMEngine as JLLMEngine
    from deepvision_tpu.engine.weights import save_npz

    _, hf_model = tiny_llama
    hf_model.save_pretrained(str(tmp_path / "hf"))
    cfg, params = thf.load_hf_model(str(tmp_path / "hf"))
    jcfg, jparams = jhf.load_hf_model(str(tmp_path / "hf"))
    assert cfg.__dict__ == jcfg.__dict__
    np.testing.assert_array_equal(params["lm_head"], jparams["lm_head"])
    np.testing.assert_array_equal(params["blocks"]["wq"],
                                  jparams["blocks"]["wq"])
    npz = str(tmp_path / "hf.npz")
    save_npz(npz, jparams)
    kw = dict(model=cfg.name, tokenizer="byte", checkpoint_dir=npz,
              max_slots=2, num_pages=32, page_size=16, max_pages_per_seq=8,
              quantize="int8", decode_steps_per_call=4, json_dfa=False)
    prompt = "访谈主题：仓储布局"
    jeng = JLLMEngine(JEngineConfig(**kw, interpret=True), model_cfg=jcfg)
    try:
        want = jeng.submit_tokens(jeng.tokenizer.encode(prompt),
                                  max_tokens=8, temperature=0.0).wait(300)
    finally:
        jeng.shutdown()
    eng = LLMEngine(EngineConfig(**kw, device="cpu"), model_cfg=cfg)
    try:
        assert eng.runner.params["lm_head"]["q8"].dtype == torch.int8
        got = eng.submit_tokens(eng.tokenizer.encode(prompt), max_tokens=8,
                                temperature=0.0).wait(300)
    finally:
        eng.shutdown()
    assert got is not None and got.ok, got
    assert got.token_ids == want.token_ids
