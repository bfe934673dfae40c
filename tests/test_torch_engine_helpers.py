"""The port's byte counts and cache stacking against the JAX package's:
``weights.param_bytes``, ``kv_cache.cache_hbm_bytes`` and
``kv_cache.stack_cache``.

Both sides get the same numpy-made inputs: params from the JAX
``init_params`` (and ``quantize_params``) handed to the port through
``from_numpy_params``, and per-layer pools filled from one numpy seed.
Byte counts are integers, and stacking copies values, so every comparison
is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine import kv_cache as jkv
from deepvision_tpu.engine import quant as jquant
from deepvision_tpu.engine import weights as jweights
from deepvision_tpu.engine.config import DV_MINI as J_DV_MINI
from deepvision_tpu.engine.config import TINY_TEST as J_TINY
from deepvision_tpu_torch.engine import kv_cache as tkv
from deepvision_tpu_torch.engine import weights as tweights
from deepvision_tpu_torch.engine.config import get_model_config

torch.set_num_threads(2)


def _np_tree(tree):
    return {k: (_np_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("form", ["bfloat16", "float32", "int8"])
def test_param_bytes_matches_jax(form):
    """bf16 params, float32 params and weight-only int8 params (``{q8,
    scale}`` leaves: int8 weights and their float32 scales)."""
    dtype = jnp.float32 if form == "float32" else jnp.bfloat16
    jp = jweights.init_params(J_TINY, seed=0, dtype=dtype)
    if form == "int8":
        jp = jquant.quantize_params(jp)
    tp = tweights.from_numpy_params(_np_tree(jp), device="cpu")
    want = jweights.param_bytes(jp)
    assert tweights.param_bytes(tp) == want
    count = jweights.count_params(jp)
    if form == "bfloat16":
        assert want == 2 * count
    elif form == "float32":
        assert want == 4 * count
    else:
        assert count < want < 2 * count


@pytest.mark.parametrize("name", ["dv-tiny-test", "dv-mini"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_cache_hbm_bytes_matches_jax(name, dtype):
    """Both pools of every layer; int8 pools take half the bf16 bytes."""
    jcfg = {"dv-tiny-test": J_TINY, "dv-mini": J_DV_MINI}[name]
    tcfg = get_model_config(name)
    kw = dict(num_pages=96, page_size=16, max_pages_per_seq=8)
    want = jkv.cache_hbm_bytes(
        jcfg, jkv.CacheConfig(dtype=getattr(jnp, dtype), **kw))
    got = tkv.cache_hbm_bytes(
        tcfg, tkv.CacheConfig(dtype=getattr(torch, dtype), **kw))
    assert got == want
    half = tkv.cache_hbm_bytes(tcfg, tkv.CacheConfig(dtype=torch.int8, **kw))
    assert 2 * half == tkv.cache_hbm_bytes(
        tcfg, tkv.CacheConfig(dtype=torch.bfloat16, **kw))
    # the bytes of the pools init_cache allocates
    pools = tkv.init_cache(
        tcfg, tkv.CacheConfig(dtype=getattr(torch, dtype), **kw),
        device="meta")
    assert got == sum(t.numel() * t.element_size()
                      for t in pools["k"] + pools["v"])


@pytest.mark.parametrize("quantized", [False, True])
def test_stack_cache_matches_jax(quantized):
    """Per-layer pools stacked to ``[L, ...]``; int8 pools' per-layer
    scales too."""
    rng = np.random.default_rng(4)
    L, KV, N, P, HD = 3, 2, 5, 4, 8
    if quantized:
        pools = {x: [rng.integers(-127, 128, (KV, N, P, HD), dtype=np.int8)
                     for _ in range(L)] for x in ("k", "v")}
        pools.update({x: [rng.random(KV, dtype=np.float32)
                          for _ in range(L)] for x in ("ks", "vs")})
    else:
        pools = {x: [rng.standard_normal((KV, N, P, HD)).astype(np.float32)
                     for _ in range(L)] for x in ("k", "v")}
    want = jkv.stack_cache({x: tuple(jnp.asarray(a) for a in arrs)
                            for x, arrs in pools.items()})
    got = tkv.stack_cache({x: [torch.from_numpy(a) for a in arrs]
                           for x, arrs in pools.items()})
    assert set(got) == set(want) == set(pools)
    for x in pools:
        assert got[x].dtype == torch.from_numpy(pools[x][0]).dtype
        np.testing.assert_array_equal(got[x].numpy(), np.asarray(want[x]))
