"""The port's tensor-parallel shard plan (``engine/parallel.py``) against
the JAX package's: the ``ShardPlan.for_model`` rules, the per-leaf shard
dims against the ``PartitionSpec``s (bf16 and int8 params, tied and untied
heads, the grammar table and the KV pools), and ``shard_params``' slices
against the JAX ``shard_params`` placements read back shard by shard from
the conftest's virtual CPU devices.

It also holds the geometry the reference serves wrongly (replicated K/V
with more than one kv head) and the port's refusal of it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine import parallel as jparallel
from deepvision_tpu.engine import quant as jquant
from deepvision_tpu.engine import weights as jweights
from deepvision_tpu.engine.config import ModelConfig as JModelConfig
from deepvision_tpu_torch.engine import parallel as tparallel
from deepvision_tpu_torch.engine import quant as tquant
from deepvision_tpu_torch.engine import weights as tweights
from deepvision_tpu_torch.engine.config import ModelConfig, TINY_TEST

torch.set_num_threads(2)

# the JAX tests' geometries (tests/test_vocab_sharding.py, test_quant.py)
TP_CFG = ModelConfig(
    name="dv-vocab-shard-test", vocab_size=512, d_model=128, n_layers=2,
    n_heads=8, n_kv_heads=4, d_ff=256, head_dim=64, max_seq_len=256)
GEOMETRIES = [
    TINY_TEST,
    TP_CFG,
    dataclasses.replace(TP_CFG, name="t-mqa", n_kv_heads=1),
    dataclasses.replace(TP_CFG, name="t-untied", tie_embeddings=False),
    ModelConfig(name="t-big-vocab", vocab_size=131072, d_model=128,
                n_layers=1, n_heads=4, n_kv_heads=2, d_ff=256, head_dim=32,
                max_seq_len=128),
    ModelConfig(name="t-odd-vocab", vocab_size=513, d_model=128, n_layers=1,
                n_heads=4, n_kv_heads=2, d_ff=256, head_dim=32,
                max_seq_len=128),
]


def _jcfg(cfg: ModelConfig) -> JModelConfig:
    return JModelConfig(**dataclasses.asdict(cfg))


def _plan_or_error(mod, cfg, n, vs):
    try:
        p = mod.ShardPlan.for_model(cfg, n, vocab_sharded=vs)
    except ValueError as e:
        return type(e).__name__, str(e)
    return p.n_model, p.kv_sharded, p.vocab_sharded


@pytest.mark.parametrize("cfg", GEOMETRIES, ids=lambda c: c.name)
def test_plan_rules_match_jax(cfg):
    """Every TP degree and vocab choice: the same plan, or the same
    ValueError (indivisible heads, d_ff or vocab)."""
    for n in (1, 2, 3, 4, 8):
        for vs in (None, True, False):
            assert (_plan_or_error(tparallel, cfg, n, vs)
                    == _plan_or_error(jparallel, _jcfg(cfg), n, vs)), (n, vs)
    assert tparallel.ShardPlan.VOCAB_SHARD_MIN == \
        jparallel.ShardPlan.VOCAB_SHARD_MIN


def _dim(spec):
    """A ``PartitionSpec``'s sharded axis (None: replicated)."""
    axes = [i for i, a in enumerate(spec) if a == jparallel.MODEL_AXIS]
    assert len(axes) <= 1
    return axes[0] if axes else None


def _spec_dims(tree):
    if isinstance(tree, dict):
        return {k: _spec_dims(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(
            tree, jax.sharding.PartitionSpec):
        return tuple(_spec_dims(v) for v in tree)
    return _dim(tree)


@pytest.mark.parametrize("cfg", GEOMETRIES[:4], ids=lambda c: c.name)
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("vocab_sharded", [False, True])
def test_shard_dims_match_jax_specs(cfg, quantized, vocab_sharded):
    for n in (2, 4):
        tp = tparallel.ShardPlan.for_model(cfg, n, vocab_sharded)
        jp = jparallel.ShardPlan.for_model(_jcfg(cfg), n, vocab_sharded)
        assert tp.param_dims(cfg, quantized) == _spec_dims(
            jp.param_specs(_jcfg(cfg), quantized=quantized))
        assert tp.dfa_dim() == _dim(jp.dfa_spec())
        for kvq in (False, True):
            assert tp.cache_dims(cfg.n_layers, kvq) == _spec_dims(
                jp.cache_specs(cfg.n_layers, kv_quantized=kvq))


def _np_tree(tree):
    return {k: (_np_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _bits(x):
    """A leaf's bytes as integers (bf16 compared bit for bit)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x


@pytest.mark.parametrize("cfg", [TINY_TEST, GEOMETRIES[3], GEOMETRIES[2]],
                         ids=lambda c: c.name)
@pytest.mark.parametrize("quantized", [False, True])
def test_shard_params_match_jax_placements(cfg, quantized):
    """``shard_params(params, plan, cfg, rank)`` holds, bit for bit, the
    slice the JAX ``shard_params`` puts on device ``rank`` of the mesh."""
    n = 2 if cfg.n_kv_heads % 4 else 4
    jp = jweights.init_params(_jcfg(cfg), seed=3)
    if quantized:
        jp = jquant.quantize_params(jp)
    host = _np_tree(jp)
    tp = tweights.from_numpy_params(host, device="cpu")
    jplan = jparallel.ShardPlan.for_model(_jcfg(cfg), n, vocab_sharded=True)
    tplan = tparallel.ShardPlan.for_model(cfg, n, vocab_sharded=True)
    mesh = jparallel.make_mesh(n_model=n, devices=jax.devices()[:n])
    placed = jparallel.shard_params(jp, mesh, jplan, _jcfg(cfg))
    devices = list(mesh.devices.reshape(-1))
    mine = [dict(_leaves(tparallel.shard_params(tp, tplan, cfg, r)))
            for r in range(n)]
    for name, arr in _leaves(placed):
        for shard in arr.addressable_shards:
            rank = devices.index(shard.device)
            got = mine[rank][name]
            want = np.asarray(shard.data)
            assert tuple(got.shape) == want.shape, (name, rank)
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"{name} rank {rank}")


# -- the geometry the reference serves wrongly ------------------------------

TRAP_CFG = dataclasses.replace(TP_CFG, name="t-kv-trap", n_kv_heads=2,
                               head_dim=32)
PROMPT = "访谈主题：库存系统。请生成下一个问题："


def _jax_greedy(tp):
    from deepvision_tpu.engine.engine import EngineConfig, LLMEngine

    eng = LLMEngine(EngineConfig(
        model=TRAP_CFG.name, tokenizer="byte", max_slots=2, num_pages=64,
        page_size=16, max_pages_per_seq=8, tp=tp, interpret=True, seed=0),
        model_cfg=_jcfg(TRAP_CFG))
    eng.start()
    try:
        return eng.submit_tokens(eng.tokenizer.encode(PROMPT), max_tokens=12,
                                 temperature=0.0).wait(300).token_ids
    finally:
        eng.shutdown()


def test_replicated_multi_head_kv_differs_in_jax_and_raises_in_port():
    """H=8, KV=2 at tp=4: the JAX plan replicates both kv heads on every
    device and its kernels pair local query head j with kv head j // 1, so
    the JAX engine's greedy tokens differ from its tp=1 tokens (at tp=2,
    where the kv heads shard, they agree).  The port raises KVGroupError
    (a ValueError) for that geometry, and still serves MQA's one
    replicated kv head."""
    base = _jax_greedy(1)
    assert _jax_greedy(2) == base
    assert _jax_greedy(4) != base
    from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine

    with pytest.raises(tparallel.KVGroupError, match="n_kv_heads=2"):
        LLMEngine(EngineConfig(model=TRAP_CFG.name, tokenizer="byte", tp=4,
                               num_pages=64, page_size=16,
                               max_pages_per_seq=8, device="cpu"),
                  model_cfg=TRAP_CFG)
    assert issubclass(tparallel.KVGroupError, ValueError)
    mqa = tparallel.ShardPlan.for_model(GEOMETRIES[2], 4)
    assert not mqa.kv_sharded
    mqa.check_kv_groups(GEOMETRIES[2])          # one kv head: served
    tparallel.ShardPlan.for_model(TRAP_CFG, 2).check_kv_groups(TRAP_CFG)


def test_port_imports_no_jax_in_the_tp_modules():
    """The modules of this slice import nothing of JAX or the JAX package
    (checked in a fresh interpreter with both blocked)."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'jax' or name.startswith('jax.') or name == "
        "'deepvision_tpu' or name.startswith('deepvision_tpu.'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import deepvision_tpu_torch.engine.parallel\n"
        "import deepvision_tpu_torch.engine.tp_workers\n"
        "import deepvision_tpu_torch.engine.engine\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
