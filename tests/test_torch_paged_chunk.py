"""The port's paged chunk attention, chunk writer and chunked forward against
the JAX package.

On the CPU ``paged_chunk_attention`` runs its plain PyTorch version; it is
held against the JAX Pallas kernel in interpret mode (and the jnp
reference) on the same numpy inputs: the ``(start, total)`` cases of the
JAX package's own test, ragged batches, head dims 32 and 128, int8 pools
with scales.  The CUDA kernel itself is held against the plain version by
the ``cuda``-marked test at the end, which skips without a GPU (and by
``chip_smoke.py`` on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine import kv_cache as jkv
from deepvision_tpu.engine import model as jmodel
from deepvision_tpu.engine import weights as jweights
from deepvision_tpu.engine.config import TINY_TEST
from deepvision_tpu.engine.kernels.paged_chunk import (
    paged_chunk_attention as jchunk,
    paged_chunk_attention_reference as jchunk_ref,
)
from deepvision_tpu_torch.engine import kv_cache as tkv
from deepvision_tpu_torch.engine import model as tmodel
from deepvision_tpu_torch.engine import weights as tweights
from deepvision_tpu_torch.engine.kernels import paged_attention as tpa
from deepvision_tpu_torch.engine.kernels import paged_chunk as tpc

torch.set_num_threads(2)

# bf16 logit tolerance, as in test_torch_model.py: one bf16 ulp at each
# rounding point, compounded over the layer stack.
BF16_LOGIT_ATOL = 5e-2


def _t(x, dtype=None):
    """numpy/jax array -> torch (bf16 through float32, which is exact)."""
    a = np.asarray(jnp.asarray(x).astype(jnp.float32))
    t = torch.from_numpy(a.copy())
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.float().numpy()


def _i32(x):
    return torch.from_numpy(np.asarray(x, np.int32))


def _chunk_inputs(rng, B, C, H, KV, HD, P, N):
    q = rng.standard_normal((B, C, H, HD)).astype(np.float32)
    kp = rng.standard_normal((KV, N, P, HD)).astype(np.float32)
    vp = rng.standard_normal((KV, N, P, HD)).astype(np.float32)
    return q, kp, vp


@pytest.mark.parametrize("start,total", [(0, 8), (16, 24), (30, 46)])
def test_chunk_plain_matches_jax(start, total):
    """The JAX package's own cases (float32): every output row, the padded
    rows past ``total`` included, within summation order (1e-5)."""
    B, C, H, KV, HD, P, N = 1, 16, 4, 2, 32, 8, 32
    q, kp, vp = _chunk_inputs(np.random.default_rng(0), B, C, H, KV, HD, P,
                              N)
    bt = np.asarray([[1, 2, 3, 4, 5, 6, 7, 8]], np.int32)
    args = (jnp.asarray(bt), jnp.asarray([start], jnp.int32),
            jnp.asarray([total], jnp.int32))
    want_kernel = jchunk(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                         *args, interpret=True)
    want_ref = jchunk_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                          *args)
    got = tpc.paged_chunk_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        _i32(bt), _i32([start]), _i32([total]))
    assert got.shape == (B, C, H, HD) and got.dtype == torch.float32
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("HD", [32, 128])
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_chunk_plain_ragged_batch_matches_jax(HD, pool):
    """B=2 with ragged starts and ends (one last chunk partial, one
    exactly full), bf16 queries, bf16 or int8 pools with per-kv-head
    scales, vs the JAX kernel in interpret mode: bf16 outputs of O(1)
    values round once on each side, 1e-2 absolute."""
    B, C, H, KV, P, N = 2, 16, 6, 2, 8, 20
    rng = np.random.default_rng(1)
    q, kp, vp = _chunk_inputs(rng, B, C, H, KV, HD, P, N)
    bt = np.zeros((B, 8), np.int32)
    bt[0, :3] = [4, 9, 2]            # 0 .. 13 live (start 0, partial)
    bt[1, :6] = [1, 7, 3, 12, 5, 8]  # 24 .. 40 live (full chunk of 16)
    starts, ends = [0, 24], [13, 40]
    jq = jnp.asarray(q, jnp.bfloat16)
    if pool == "int8":
        ks = (np.abs(kp).max(axis=(1, 2, 3)) / 127.0).astype(np.float32)
        vs = (np.abs(vp).max(axis=(1, 2, 3)) / 127.0).astype(np.float32)
        jkp = jkv.quantize_rows(jnp.asarray(kp), jnp.asarray(ks), 0)
        jvp = jkv.quantize_rows(jnp.asarray(vp), jnp.asarray(vs), 0)
        tkp = torch.from_numpy(np.asarray(jkp).copy())
        tvp = torch.from_numpy(np.asarray(jvp).copy())
        jks, jvs = jnp.asarray(ks), jnp.asarray(vs)
        tks, tvs = torch.from_numpy(ks), torch.from_numpy(vs)
    else:
        jkp, jvp = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
        tkp, tvp = _t(jkp, torch.bfloat16), _t(jvp, torch.bfloat16)
        jks = jvs = tks = tvs = None
    want = jchunk(jq, jkp, jvp, jnp.asarray(bt), jnp.asarray(starts),
                  jnp.asarray(ends), k_scale=jks, v_scale=jvs,
                  interpret=True)
    got = tpc.paged_chunk_attention(
        _t(jq, torch.bfloat16), tkp, tvp, _i32(bt), _i32(starts),
        _i32(ends), k_scale=tks, v_scale=tvs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        _np(got), np.asarray(jnp.asarray(want, jnp.float32)), atol=1e-2,
        rtol=1e-2)


def test_chunk_of_one_equals_paged_decode():
    """A C=1 chunk at position ``n - 1`` is a decode step: the plain chunk
    version equals the plain paged decode attention (float32, 1e-5)."""
    rng = np.random.default_rng(2)
    B, H, KV, HD, P, N = 3, 4, 2, 32, 8, 16
    q, kp, vp = _chunk_inputs(rng, B, 1, H, KV, HD, P, N)
    bt = (1 + rng.permutation(15)).reshape(3, 5).astype(np.int32)
    lens = [1, 17, 40]
    got = tpc.paged_chunk_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        _i32(bt), _i32([n - 1 for n in lens]), _i32(lens))
    want = tpa.paged_attention_reference(
        torch.from_numpy(q[:, 0]), torch.from_numpy(kp),
        torch.from_numpy(vp), _i32(bt), _i32(lens))
    np.testing.assert_allclose(_np(got[:, 0]), _np(want), atol=1e-5,
                               rtol=1e-5)


def test_row_without_a_valid_column_is_zero():
    """``seq_lens`` 0 leaves every column masked: the plain version gives
    0, as the kernel's ``l == 0 -> 1`` does."""
    q, kp, vp = _chunk_inputs(np.random.default_rng(3), 1, 4, 2, 1, 32, 8, 4)
    got = tpc.paged_chunk_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        _i32([[1, 2]]), _i32([0]), _i32([0]))
    assert not got.any()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_write_chunk_tokens_matches_jax(dtype):
    """The chunk writer lands the same rows (int8: the same quantized
    bytes) in the same pages as the JAX writer, bit for bit outside the
    trash page, and the padded rows of a last chunk touch no real page."""
    rng = np.random.default_rng(4)
    KV, N, P, HD, C, MP = 2, 12, 8, 32, 8, 4
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.int8
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.int8
    jcache = jkv.init_cache(TINY_TEST, jkv.CacheConfig(
        num_pages=N, page_size=P, max_pages_per_seq=MP, dtype=jdt))
    tcache = tkv.init_cache(TINY_TEST, tkv.CacheConfig(
        num_pages=N, page_size=P, max_pages_per_seq=MP, dtype=tdt),
        device="cpu")
    ks = vs = tks = tvs = None
    if dtype == "int8":
        ks, vs = jcache["ks"][0], jcache["vs"][0]
        tks, tvs = tcache["ks"][0], tcache["vs"][0]
    k_new = (rng.standard_normal((2, C, KV, HD)) * 0.05).astype(np.float32)
    v_new = (rng.standard_normal((2, C, KV, HD)) * 0.05).astype(np.float32)
    bt = np.asarray([[3, 5, 0, 0], [7, 9, 11, 0]], np.int32)
    starts = np.asarray([0, 13], np.int32)
    lens = np.asarray([5, 19], np.int32)   # both chunks end with padding
    pos = starts[:, None] + np.arange(C, dtype=np.int32)[None, :]
    jk, jv = jkv.write_chunk_tokens(
        jcache["k"][0], jcache["v"][0], jnp.asarray(k_new, jnp.bfloat16),
        jnp.asarray(v_new, jnp.bfloat16), jnp.asarray(bt), jnp.asarray(pos),
        jnp.asarray(lens), k_scale=ks, v_scale=vs)
    tk, tv = tcache["k"][0], tcache["v"][0]
    tkv.write_chunk_tokens(
        tk, tv, torch.from_numpy(k_new).bfloat16(),
        torch.from_numpy(v_new).bfloat16(), _i32(bt), _i32(pos), _i32(lens),
        k_scale=tks, v_scale=tvs)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(
            got[:, 1:].float().numpy(),
            np.asarray(jnp.asarray(want[:, 1:], jnp.float32)))
    # rows 5.. of sequence 0 and 19.. of sequence 1 are padding: page 5
    # (sequence 0's second page) and offsets past 19 % 8 of page 11 stay 0
    assert not tk[:, 5].float().any()
    assert not tk[:, 11, 19 % P:].float().any()
    assert tk[:, 3, :5].float().abs().sum() > 0


def _jax_params(cfg, seed=0):
    jp = jweights.init_params(cfg, seed=seed)
    return jp, tweights.from_numpy_params(
        {k: (np.asarray(v) if not isinstance(v, dict)
             else {kk: np.asarray(vv) for kk, vv in v.items()})
         for k, v in jp.items()}, device="cpu")


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_forward_prefill_chunk_matches_jax(kv_dtype):
    """A 21-token prompt in chunks of 8 (the last one partial) through
    ``forward_prefill_chunk`` on dv-tiny-test, against the JAX forward
    (Pallas kernels in interpret mode): each chunk's logits within
    BF16_LOGIT_ATOL, and the pools outside the trash page equal (int8 to
    one quantization step, bf16 within one bf16 ulp)."""
    cfg = TINY_TEST
    jp, tp = _jax_params(cfg, seed=3)
    P, MP, C, n = 8, 4, 8, 21
    jdt = jnp.bfloat16 if kv_dtype == "bfloat16" else jnp.int8
    tdt = torch.bfloat16 if kv_dtype == "bfloat16" else torch.int8
    jcache = jkv.init_cache(cfg, jkv.CacheConfig(
        num_pages=8, page_size=P, max_pages_per_seq=MP, dtype=jdt))
    tcache = tkv.init_cache(cfg, tkv.CacheConfig(
        num_pages=8, page_size=P, max_pages_per_seq=MP, dtype=tdt),
        device="cpu")
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
    bt = np.asarray([[6, 2, 5, 0]], np.int32)
    for start in range(0, n, C):
        chunk = np.zeros((1, C), np.int32)
        piece = prompt[start:start + C]
        chunk[0, : len(piece)] = piece
        jl, jcache = jmodel.forward_prefill_chunk(
            jp, jcache, jnp.asarray(chunk), jnp.asarray([start], jnp.int32),
            jnp.asarray([n], jnp.int32), jnp.asarray(bt), cfg=cfg,
            interpret=True)
        tl = tmodel.forward_prefill_chunk(
            tp, tcache, torch.from_numpy(chunk), _i32([start]), _i32([n]),
            torch.from_numpy(bt), cfg=cfg)
        np.testing.assert_allclose(_np(tl), np.asarray(jl),
                                   atol=BF16_LOGIT_ATOL)
    for layer in range(cfg.n_layers):
        got = tcache["k"][layer][:, 1:].float().numpy()
        want = np.asarray(jnp.asarray(jcache["k"][layer][:, 1:],
                                      jnp.float32))
        if kv_dtype == "int8":
            assert np.abs(got - want).max() <= 1
        else:
            np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)


def test_chunked_forward_equals_dense_forward():
    """Chunks of 8 (resumed from a page boundary, the last one partial)
    reproduce the full-sequence forward's last-position logits (bf16 on
    both sides: BF16_LOGIT_ATOL)."""
    cfg = TINY_TEST
    _, tp = _jax_params(cfg, seed=4)
    P, C, n = 8, 8, 29
    cache = tkv.init_cache(cfg, tkv.CacheConfig(
        num_pages=8, page_size=P, max_pages_per_seq=4), device="cpu")
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=n).astype(np.int32)
    bt = torch.from_numpy(np.asarray([[3, 1, 7, 4]], np.int32))
    for start in range(0, n, C):
        chunk = np.zeros((1, C), np.int32)
        chunk[0, : len(prompt[start:start + C])] = prompt[start:start + C]
        logits = tmodel.forward_prefill_chunk(
            tp, cache, torch.from_numpy(chunk), _i32([start]), _i32([n]), bt,
            cfg=cfg)
    with torch.no_grad():
        dense = tmodel.forward_train(tp, torch.from_numpy(prompt[None]),
                                     cfg=cfg)[0, -1]
    np.testing.assert_allclose(_np(logits[0]), _np(dense),
                               atol=BF16_LOGIT_ATOL)


def test_wrapper_refuses_other_devices():
    meta = torch.empty(1, 4, 2, 32, device="meta")
    lens = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tpc.paged_chunk_attention(meta, None, None, None, lens, lens)


# -- the CUDA kernel (GPU only) ----------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("pool", [torch.bfloat16, torch.int8])
def test_cuda_chunk_kernel_matches_plain(pool):
    """The CUDA kernel against its plain version on the card, ragged
    B=2 (bf16 outputs: 2e-2 absolute, every row)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    q, kp, vp = _chunk_inputs(rng, 2, 64, 6, 2, 128, 16, 17)
    qd = torch.from_numpy(q).to(dev).bfloat16()
    ks = vs = None
    if pool == torch.int8:
        ks = vs = torch.full((2,), 4.0 / 127, device=dev)
        kp = tkv.quantize_rows(torch.from_numpy(kp).to(dev), ks, 0)
        vp = tkv.quantize_rows(torch.from_numpy(vp).to(dev), vs, 0)
    else:
        kp = torch.from_numpy(kp).to(dev).bfloat16()
        vp = torch.from_numpy(vp).to(dev).bfloat16()
    bt = torch.from_numpy(
        (1 + rng.permutation(16)).reshape(2, 8).astype(np.int32)).to(dev)
    starts = torch.tensor([0, 64], dtype=torch.int32, device=dev)
    ends = torch.tensor([50, 128], dtype=torch.int32, device=dev)
    got = tpc.paged_chunk_attention(qd, kp, vp, bt, starts, ends,
                                    k_scale=ks, v_scale=vs)
    want = tpc.paged_chunk_attention_reference(qd, kp, vp, bt, starts, ends,
                                               k_scale=ks, v_scale=vs)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
