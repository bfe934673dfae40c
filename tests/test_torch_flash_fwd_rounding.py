"""The rounding points of the tensor-core flash forward and paged chunk
attention, checked on the CPU.

The bf16 kernels ``csrc/flash_fwd.cu`` (``flash_fwd_tc_kernel``) and
``csrc/paged_chunk.cu`` compute both products on the tensor cores: bf16
operands (int8 pool values converted to bf16, which is exact for
``|x| <= 127``), the products exact and summed in float32.  The softmax
scale (and, for int8 pools, ``k_scale``) goes onto the float32 scores after
``q . k``; the running max and sum stay float32; ``p`` is rounded to bf16
only where it becomes the A operand of ``P . V``; ``v_scale`` is applied at
the final normalize.  The chunk kernel's column split merges its
partial sums in float32, so it adds no rounding point.  The plain
``*_reference`` functions keep ``p`` in float32; they stay the yardstick on
the card.

``_emulate_flash`` and ``_emulate_chunk`` below repeat those rounding
points in plain PyTorch (test code only).  They round ``p`` against the
row's final max where the kernels round it against the running max and
rescale in float32: the same relative rounding of 2^-9 an element.  The
tests hold them against the JAX package's Pallas kernels in interpret mode
on inputs made from a numpy seed, within 2e-2 absolute, the bound
``chip_smoke.py`` applies to the kernels on the card.  A rounding choice
that failed that bound would fail here before it reached the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine import kv_cache as jkv
from deepvision_tpu.engine.kernels.flash_attention import (
    flash_attention as jflash,
)
from deepvision_tpu.engine.kernels.paged_chunk import (
    paged_chunk_attention as jchunk,
)
from deepvision_tpu_torch.engine.kernels import flash_attention as tfa
from deepvision_tpu_torch.engine.kernels import paged_chunk as tpc

torch.set_num_threads(2)

ATOL = 2e-2  # chip_smoke.py's bound for both kernels' bf16 outputs


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _softmax_operand(s, mask):
    """``(bf16(p), l)``: ``p = exp(s - max)`` in float32 over the valid
    columns, rounded to bf16 as the operand of ``P . V``, and its float32
    row sum ``l`` (0 for a row without a valid column, counted as 1)."""
    s = torch.where(mask, s, torch.full_like(s, float("-inf")))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    return _bf16(p), torch.where(l_sum == 0, torch.ones_like(l_sum), l_sum)


def _emulate_flash(q, k, v, seq_lens):
    """The flash forward with the tensor-core kernel's rounding points;
    q, k, v bf16 ``[B, H|KV, S, HD]``."""
    H, S, HD = q.shape[1], q.shape[2], q.shape[3]
    G = H // k.shape[1]
    kr = k.float().repeat_interleave(G, dim=1)
    vr = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * HD ** -0.5
    mask, _ = tfa._masks(S, seq_lens, q.device)
    p, l_sum = _softmax_operand(s, mask)
    return (torch.einsum("bhqk,bhkd->bhqd", p, vr) / l_sum).to(q.dtype)


def _emulate_chunk(q, k_pages, v_pages, block_tables, chunk_starts,
                   seq_lens, k_scale, v_scale):
    """The paged chunk attention with the tensor-core kernel's rounding
    points; q bf16 ``[B, C, H, HD]``, pools bf16 or int8."""
    B, C, H, HD = q.shape
    KV, _, P, _ = k_pages.shape
    MP = block_tables.shape[1]
    G = H // KV
    bt = block_tables.long()
    k = k_pages.float()[:, bt].permute(1, 2, 3, 0, 4).reshape(B, MP * P, KV,
                                                               HD)
    v = v_pages.float()[:, bt].permute(1, 2, 3, 0, 4).reshape(B, MP * P, KV,
                                                               HD)
    k, v = (x.repeat_interleave(G, dim=2) for x in (k, v))
    ks = k_scale.float().repeat_interleave(G)[None, None, :, None]
    vs = v_scale.float().repeat_interleave(G)[None, None, :, None]
    s = torch.einsum("bchd,bkhd->bchk", q.float(), k) * (HD ** -0.5 * ks)
    col = torch.arange(MP * P)
    q_pos = chunk_starts.long()[:, None] + torch.arange(C)[None, :]
    mask = ((col[None, None, :] <= q_pos[:, :, None])
            & (col[None, None, :] < seq_lens.long()[:, None, None]))
    p, l_sum = _softmax_operand(s, mask[:, :, None, :])
    return (torch.einsum("bchk,bkhd->bchd", p, v) / l_sum * vs).to(q.dtype)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_t(x):
    return torch.from_numpy(_np(x).copy()).to(torch.bfloat16)


def _within(got, want, name):
    err = float(np.abs(got.float().numpy() - _np(want)).max())
    assert err <= ATOL, f"{name}: max_abs_err {err} > {ATOL}"


@pytest.mark.parametrize("HD", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 8])
def test_flash_forward_rounding_matches_jax(G, HD):
    """The emulated forward against the JAX Pallas forward (interpret
    mode): a full row, a partial one, a length-1 and a length-0 sequence,
    S a multiple of no 64-row tile, every output row compared."""
    B, KV, S = 4, 1, 200
    H = G * KV
    lens = [S, 131, 1, 0]
    rng = np.random.default_rng(G * 10 + HD)
    q = jnp.asarray(rng.standard_normal((B, H, S, HD)), jnp.bfloat16)
    k, v = (jnp.asarray(rng.standard_normal((B, KV, S, HD)), jnp.bfloat16)
            for _ in range(2))
    seq = np.asarray(lens, np.int32)
    want = jflash(q, k, v, jnp.asarray(seq), blk_q=40, blk_k=40,
                  interpret=True)
    got = _emulate_flash(_bf16_t(q), _bf16_t(k), _bf16_t(v),
                         torch.from_numpy(seq))
    assert got.dtype == torch.bfloat16
    _within(got, want, "flash")
    assert not got[3].float().abs().any()  # the length-0 sequence is 0


def _chunk_inputs(rng, HD, G, pool):
    """Two sequences over 16-row pages: a resume that ends inside its last
    chunk (padded rows) and a fresh first chunk."""
    B, C, KV, P, N, MP = 2, 24, 1, 16, 12, 4
    H = G * KV
    q = rng.standard_normal((B, C, H, HD)).astype(np.float32)
    kp, vp = (rng.standard_normal((KV, N, P, HD)).astype(np.float32)
              for _ in range(2))
    bt = np.zeros((B, MP), np.int32)
    bt[0] = [5, 2, 9, 11]   # 40 .. 53 live: a last chunk of 14 of 24 rows
    bt[1, :2] = [1, 7]      # 0 .. 24 live: a first chunk, no padding
    starts, ends = np.asarray([40, 0], np.int32), np.asarray([54, 24],
                                                             np.int32)
    if pool == "int8":
        ks = (np.abs(kp).max(axis=(1, 2, 3)) / 127.0).astype(np.float32)
        vs = (np.abs(vp).max(axis=(1, 2, 3)) / 127.0).astype(np.float32)
        jkp = jkv.quantize_rows(jnp.asarray(kp), jnp.asarray(ks), 0)
        jvp = jkv.quantize_rows(jnp.asarray(vp), jnp.asarray(vs), 0)
    else:
        ks = vs = np.ones(KV, np.float32)
        jkp, jvp = (jnp.asarray(x, jnp.bfloat16) for x in (kp, vp))
    return (jnp.asarray(q, jnp.bfloat16), jkp, jvp, bt, starts, ends, ks,
            vs)


@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
@pytest.mark.parametrize("HD", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 8])
def test_chunk_rounding_matches_jax(G, HD, pool):
    """The emulated chunk attention against the JAX Pallas kernel
    (interpret mode) on bf16 and int8 pools with per-kv-head scales: every
    output row, the padded rows of a last chunk included."""
    rng = np.random.default_rng(G * 100 + HD + (pool == "int8"))
    q, kp, vp, bt, starts, ends, ks, vs = _chunk_inputs(rng, HD, G, pool)
    scales = ({} if pool == "bfloat16" else
              {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)})
    want = jchunk(q, kp, vp, jnp.asarray(bt), jnp.asarray(starts),
                  jnp.asarray(ends), interpret=True, **scales)
    if pool == "int8":
        tkp, tvp = (torch.from_numpy(np.asarray(x).copy()) for x in (kp, vp))
    else:
        tkp, tvp = _bf16_t(kp), _bf16_t(vp)
    got = _emulate_chunk(_bf16_t(q), tkp, tvp, torch.from_numpy(bt),
                         torch.from_numpy(starts), torch.from_numpy(ends),
                         torch.from_numpy(ks), torch.from_numpy(vs))
    assert got.dtype == torch.bfloat16
    _within(got, want, f"chunk {pool}")


def test_emulations_are_the_plain_versions_up_to_their_rounding():
    """On small cases the emulations and the plain fp32 versions differ
    only by the bf16 rounding of p (and where the scales are applied):
    within the same bound, and not bit-equal."""
    rng = np.random.default_rng(5)
    B, H, KV, S, HD = 2, 4, 2, 96, 64
    q = torch.from_numpy(rng.standard_normal((B, H, S, HD)).astype(
        np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((B, KV, S, HD)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    seq = torch.tensor([S, 40], dtype=torch.int32)
    got = _emulate_flash(q, k, v, seq)
    want = tfa.flash_attention_reference(q, k, v, seq)
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    assert not torch.equal(got, want)

    jq, jkp, jvp, bt, starts, ends, ks, vs = _chunk_inputs(rng, 64, 3,
                                                           "int8")
    tq = _bf16_t(jq)
    tkp, tvp = (torch.from_numpy(np.asarray(x).copy()) for x in (jkp, jvp))
    args = (tq, tkp, tvp, torch.from_numpy(bt), torch.from_numpy(starts),
            torch.from_numpy(ends))
    got = _emulate_chunk(*args, torch.from_numpy(ks), torch.from_numpy(vs))
    want = tpc.paged_chunk_attention_reference(
        *args, k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    assert not torch.equal(got, want)
