"""The port's sharded serving forwards against the JAX package's.

``forward_prefill``, ``forward_decode`` and ``forward_prefill_chunk`` run on
every rank's shard of a tensor-parallel group (the ranks are threads of
this process, ``test_torch_parallel_ops.run_ranks``), vocab sharded, with
bf16 or int8 pools, and their logits gathered over the vocab are held
against the JAX unsharded serving forwards (Pallas kernels in interpret
mode) on the same params."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine import kv_cache as jkv
from deepvision_tpu.engine import model as jmodel
from deepvision_tpu.engine import weights as jweights
from deepvision_tpu.engine.config import ModelConfig as JModelConfig
from deepvision_tpu_torch.engine import kv_cache as tkv
from deepvision_tpu_torch.engine import model as tmodel
from deepvision_tpu_torch.engine import weights as tweights
from deepvision_tpu_torch.engine.config import ModelConfig
from deepvision_tpu_torch.engine.parallel import (
    ShardPlan,
    shard,
    shard_params,
)
from test_torch_parallel_ops import run_ranks

torch.set_num_threads(1)

# bf16 logits through two layers (tests/test_torch_model.py's bound): the
# ranks' partial products are summed in float32 in another order than one
# device's matmul, which moves a bf16 rounding point by at most one ulp
BF16_LOGIT_ATOL = 5e-2

TP_CFG = ModelConfig(
    name="dv-vocab-shard-test", vocab_size=512, d_model=128, n_layers=2,
    n_heads=8, n_kv_heads=4, d_ff=256, head_dim=64, max_seq_len=256)
MQA_CFG = dataclasses.replace(TP_CFG, name="t-mqa", n_kv_heads=1)


@pytest.mark.parametrize("cfg", [TP_CFG, MQA_CFG], ids=lambda c: c.name)
def test_sharded_forwards_match_jax(cfg, tmp_path):
    """bf16 pools (int8 pools: ``test_torch_parallel_forwards_int8.py``)."""
    check_forwards(cfg, "bfloat16", tmp_path)


def check_forwards(cfg, kv, tmp_path):
    """forward_prefill, three forward_decode steps and one
    forward_prefill_chunk on every rank's shard at tp 2 and 4 (vocab
    sharded; int8 pools at static scales), logits gathered over the vocab,
    against the JAX unsharded serving forwards."""
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    jp = jweights.init_params(jcfg, seed=1)
    tp = tweights.from_numpy_params(
        {k: (np.asarray(v) if not isinstance(v, dict)
             else {kk: np.asarray(vv) for kk, vv in v.items()})
         for k, v in jp.items()}, device="cpu")
    P, MP, S = 8, 8, 32
    jdt = jnp.bfloat16 if kv == "bfloat16" else jnp.int8
    tdt = torch.bfloat16 if kv == "bfloat16" else torch.int8
    ccfg = dict(num_pages=24, page_size=P, max_pages_per_seq=MP)
    scales = np.random.RandomState(2).uniform(
        0.02, 0.06, size=(2, cfg.n_layers, cfg.n_kv_heads)).astype(np.float32)
    jcache = jkv.init_cache(jcfg, jkv.CacheConfig(**ccfg, dtype=jdt),
                            kv_scales=(jnp.asarray(scales[0]),
                                       jnp.asarray(scales[1])))
    rng = np.random.default_rng(7)
    lens = np.asarray([13, 29], np.int32)
    toks = np.zeros((2, S), np.int32)
    for b, m in enumerate(lens):
        toks[b, :m] = rng.integers(0, cfg.vocab_size, size=m)
    bt = np.zeros((2, MP), np.int32)
    bt[0, :5] = [1, 2, 3, 9, 10]
    bt[1, :6] = [4, 5, 6, 7, 8, 11]
    pages = bt[:, : S // P]
    steps = rng.integers(0, cfg.vocab_size, size=(3, 2)).astype(np.int32)
    chunk = rng.integers(0, cfg.vocab_size, size=(2, 8)).astype(np.int32)

    want = []
    jl, jcache = jmodel.forward_prefill(
        jp, jcache, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(pages),
        cfg=jcfg, interpret=True)
    want.append(np.asarray(jl))
    seq = lens.copy()
    for cur in steps:
        seq = seq + 1
        jl, jcache = jmodel.forward_decode(
            jp, jcache, jnp.asarray(cur), jnp.asarray(seq), jnp.asarray(bt),
            cfg=jcfg, interpret=True)
        want.append(np.asarray(jl))
    starts = seq.copy()
    jl, jcache = jmodel.forward_prefill_chunk(
        jp, jcache, jnp.asarray(chunk), jnp.asarray(starts),
        jnp.asarray(starts + 8), jnp.asarray(bt), cfg=jcfg, interpret=True)
    want.append(np.asarray(jl))

    def rank_fn(g):
        n = g.size
        plan = ShardPlan.for_model(cfg, n, vocab_sharded=True)
        params = shard_params(tp, plan, cfg, g.rank)
        kv_local = cfg.n_kv_heads // n if plan.kv_sharded else cfg.n_kv_heads
        sc = [shard(torch.from_numpy(s), 1 if plan.kv_sharded else None,
                    g.rank, n) for s in scales]
        cache = tkv.init_cache(cfg, tkv.CacheConfig(**ccfg, dtype=tdt),
                               device="cpu", kv_scales=sc,
                               n_kv_heads=kv_local)
        kw = dict(cfg=cfg, group=g, vocab_sharded=True)
        out = [tmodel.forward_prefill(
            params, cache, torch.from_numpy(toks), torch.from_numpy(lens),
            torch.from_numpy(pages), **kw)]
        s = lens.copy()
        for cur in steps:
            s = s + 1
            out.append(tmodel.forward_decode(
                params, cache, torch.from_numpy(cur), torch.from_numpy(s),
                torch.from_numpy(bt), **kw))
        out.append(tmodel.forward_prefill_chunk(
            params, cache, torch.from_numpy(chunk), torch.from_numpy(s),
            torch.from_numpy(s + 8), torch.from_numpy(bt), **kw))
        return [g.all_gather(x, dim=-1).numpy() for x in out]

    for n in (2, 4):
        for got in run_ranks(n, rank_fn, tmp_path):
            for i, (a, b) in enumerate(zip(got, want)):
                np.testing.assert_allclose(a, b, atol=BF16_LOGIT_ATOL,
                                           err_msg=f"tp {n}, forward {i}")
