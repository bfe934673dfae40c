"""The port's attention kernels against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX Pallas kernels in interpret mode (and the jnp
references) on the same numpy inputs: ragged lengths, GQA, bf16 and int8
pools.  The CUDA kernels themselves are held against the plain versions by
the ``cuda``-marked test at the end, which skips without a GPU (and by
``chip_smoke.py`` on the card).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine.kernels.flash_attention import (
    flash_attention as jflash,
    flash_attention_reference as jflash_ref,
)
from deepvision_tpu.engine.kernels.paged_attention import (
    paged_attention_reference as jpaged_ref,
    paged_attention_update as jpaged_update,
)
from deepvision_tpu.engine.kv_cache import quantize_rows as jquantize_rows
from deepvision_tpu_torch.engine.kernels import flash_attention as tfa
from deepvision_tpu_torch.engine.kv_cache import quantize_rows

# the module (the package exports its function of the same name)
tpa = importlib.import_module(
    "deepvision_tpu_torch.engine.kernels.paged_attention")

torch.set_num_threads(2)


def _t(x, dtype=None):
    """numpy/jax array -> torch (bf16 through float32, which is exact)."""
    a = np.asarray(jnp.asarray(x).astype(jnp.float32))
    t = torch.from_numpy(a.copy())
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.float().numpy()


# -- flash attention ---------------------------------------------------------

FLASH_CASES = [
    # (B, H, KV, S, HD, lens)
    (2, 4, 2, 256, 32, [256, 77]),
    (3, 6, 2, 128, 64, [1, 128, 100]),
    (1, 2, 1, 128, 128, [65]),
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax(case, dtype):
    """Plain ``flash_attention`` (CPU) vs JAX ``flash_attention`` in
    interpret mode and vs the jnp reference, on valid rows.

    Tolerance: float32 — summation order only (1e-5); bf16 — both sides
    round one fp32 result per element to bf16, so one bf16 ulp of an O(1)
    value (2^-8 relative) plus order effects: 1e-2 absolute.
    """
    B, H, KV, S, HD, lens = case
    rng = np.random.default_rng(0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    q = jnp.asarray(rng.standard_normal((B, H, S, HD)), jdt)
    k = jnp.asarray(rng.standard_normal((B, KV, S, HD)), jdt)
    v = jnp.asarray(rng.standard_normal((B, KV, S, HD)), jdt)
    seq = np.asarray(lens, np.int32)
    want_kernel = jflash(q, k, v, jnp.asarray(seq), interpret=True)
    want_ref = jflash_ref(q, k, v, jnp.asarray(seq))
    got = tfa.flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                              torch.from_numpy(seq))
    assert got.dtype == tdt and got.shape == (B, H, S, HD)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for b, n in enumerate(lens):
        for want in (want_kernel, want_ref):
            np.testing.assert_allclose(
                _np(got[b, :, :n]),
                np.asarray(jnp.asarray(want[b, :, :n], jnp.float32)),
                atol=tol, rtol=tol)


def test_flash_plain_padded_rows_follow_the_kernel():
    """Rows past seq_len attend to every valid column (as the JAX kernel's
    mask ``col <= row & col < len`` says); a length-0 row is all zeros."""
    rng = np.random.default_rng(1)
    B, H, KV, S, HD = 2, 2, 1, 128, 32
    q = jnp.asarray(rng.standard_normal((B, H, S, HD)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((B, KV, S, HD)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, KV, S, HD)), jnp.float32)
    seq = np.asarray([40, 0], np.int32)
    want = np.asarray(jflash(q, k, v, jnp.asarray(seq), interpret=True))
    got = _np(tfa.flash_attention(_t(q), _t(k), _t(v),
                                  torch.from_numpy(seq)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert not got[1].any()


# -- fused paged decode ------------------------------------------------------

def _paged_inputs(rng, B, H, KV, HD, P, MP, lens):
    N = B * MP + 1
    q = rng.standard_normal((B, H, HD)).astype(np.float32)
    nk = rng.standard_normal((B, KV, HD)).astype(np.float32)
    nv = rng.standard_normal((B, KV, HD)).astype(np.float32)
    kp = rng.standard_normal((KV, N, P, HD)).astype(np.float32)
    vp = rng.standard_normal((KV, N, P, HD)).astype(np.float32)
    bt = (1 + rng.permutation(B * MP)).reshape(B, MP).astype(np.int32)
    for i, n in enumerate(lens):
        if n == 1:          # an inactive scheduler slot: trash page only
            bt[i] = 0
    return q, nk, nv, kp, vp, bt, np.asarray(lens, np.int32)


PAGED_CASES = [
    # (B, H, KV, HD, P, MP, lens)
    (3, 4, 2, 32, 8, 4, [32, 1, 9]),
    (2, 6, 2, 64, 16, 3, [17, 48]),
    (2, 8, 1, 32, 8, 5, [1, 40]),
]


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_paged_update_plain_matches_jax(case, pool):
    """Plain ``paged_attention_update`` (write row, then attend) vs JAX
    ``paged_attention_update(interpret=True)``: outputs on active slots and
    the pools outside trash page 0, which must be bit-identical.

    Tolerance on outputs (bf16 q, bf16 output): one bf16 ulp of an O(1)
    value plus summation order, 1e-2 absolute.
    """
    B, H, KV, HD, P, MP, lens = case
    rng = np.random.default_rng(2)
    q, nk, nv, kp, vp, bt, seq = _paged_inputs(rng, B, H, KV, HD, P, MP,
                                               lens)
    jq = jnp.asarray(q, jnp.bfloat16)
    if pool == "int8":
        ks = np.abs(kp).max(axis=(1, 2, 3)).astype(np.float32) / 127.0
        vs = np.abs(vp).max(axis=(1, 2, 3)).astype(np.float32) / 127.0
        jkp = jquantize_rows(jnp.asarray(kp), jnp.asarray(ks), 0)
        jvp = jquantize_rows(jnp.asarray(vp), jnp.asarray(vs), 0)
        jnk, jnv = jnp.asarray(nk), jnp.asarray(nv)
        tkp = torch.from_numpy(np.asarray(jkp).copy())
        tvp = torch.from_numpy(np.asarray(jvp).copy())
        assert torch.equal(
            tkp, quantize_rows(torch.from_numpy(kp), torch.from_numpy(ks), 0))
        tnk, tnv = torch.from_numpy(nk), torch.from_numpy(nv)
        jks, jvs = jnp.asarray(ks), jnp.asarray(vs)
        tks, tvs = torch.from_numpy(ks), torch.from_numpy(vs)
    else:
        jkp = jnp.asarray(kp, jnp.bfloat16)
        jvp = jnp.asarray(vp, jnp.bfloat16)
        jnk = jnp.asarray(nk, jnp.bfloat16)
        jnv = jnp.asarray(nv, jnp.bfloat16)
        tkp, tvp = _t(jkp, torch.bfloat16), _t(jvp, torch.bfloat16)
        tnk, tnv = _t(jnk, torch.bfloat16), _t(jnv, torch.bfloat16)
        jks = jvs = tks = tvs = None
    want, wkp, wvp = jpaged_update(
        jq, jnk, jnv, jkp, jvp, jnp.asarray(bt), jnp.asarray(seq),
        k_scale=jks, v_scale=jvs, interpret=True)
    got, gkp, gvp = tpa.paged_attention_update(
        _t(jq, torch.bfloat16), tnk, tnv, tkp, tvp, torch.from_numpy(bt),
        torch.from_numpy(seq), k_scale=tks, v_scale=tvs)
    assert gkp is tkp and gvp is tvp          # updated in place
    active = [i for i, n in enumerate(lens) if n > 1]
    np.testing.assert_allclose(
        _np(got[active]), np.asarray(jnp.asarray(want, jnp.float32))[active],
        atol=1e-2, rtol=1e-2)
    for g, w in ((gkp, wkp), (gvp, wvp)):
        np.testing.assert_array_equal(
            _np(g[:, 1:]), np.asarray(jnp.asarray(w[:, 1:], jnp.float32)))


def test_paged_reference_matches_jax_reference():
    """The plain read-only paged attention vs the jnp reference (float32
    pools, float32 math: 1e-5)."""
    rng = np.random.default_rng(3)
    q, _, _, kp, vp, bt, seq = _paged_inputs(rng, 3, 6, 2, 32, 8, 4,
                                             [5, 32, 17])
    want = jpaged_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(seq))
    got = tpa.paged_attention_reference(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(seq))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_wrappers_refuse_other_devices():
    """A wrapper launches on CUDA or runs the plain version on the CPU;
    anything else raises instead of silently picking one."""
    meta = torch.empty(1, 2, 128, 32, device="meta")
    lens = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(meta, meta[:, :1], meta[:, :1], lens)
    with pytest.raises(ValueError):
        tpa.paged_attention_update(
            torch.empty(1, 2, 32, device="meta"), None, None, None, None,
            None, lens)


# -- the CUDA kernels (GPU only) ---------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("pool", [torch.bfloat16, torch.int8])
def test_cuda_kernels_match_plain(pool):
    """Both CUDA kernels against their plain versions on the card (bf16
    outputs: 2e-2 absolute; pools bit-identical outside page 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, 6, 256, 128, generator=gen, device=dev).bfloat16()
    k = torch.randn(2, 2, 256, 128, generator=gen, device=dev).bfloat16()
    v = torch.randn(2, 2, 256, 128, generator=gen, device=dev).bfloat16()
    seq = torch.tensor([256, 97], dtype=torch.int32, device=dev)
    got = tfa.flash_attention(q, k, v, seq)
    want = tfa.flash_attention_reference(q, k, v, seq)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2

    rng = np.random.default_rng(4)
    qn, nk, nv, kp, vp, bt, lens = _paged_inputs(rng, 4, 6, 2, 128, 16, 4,
                                                 [64, 1, 3, 40])
    qd = torch.from_numpy(qn).to(dev).bfloat16()
    nk = torch.from_numpy(nk).to(dev).bfloat16()
    nv = torch.from_numpy(nv).to(dev).bfloat16()
    ks = vs = None
    if pool == torch.int8:
        ks = vs = torch.full((2,), 4.0 / 127, device=dev)
        kp = quantize_rows(torch.from_numpy(kp).to(dev), ks, 0)
        vp = quantize_rows(torch.from_numpy(vp).to(dev), vs, 0)
    else:
        kp = torch.from_numpy(kp).to(dev).bfloat16()
        vp = torch.from_numpy(vp).to(dev).bfloat16()
    bt = torch.from_numpy(bt).to(dev)
    lens = torch.from_numpy(lens).to(dev)
    kp2, vp2 = kp.clone(), vp.clone()
    got, _, _ = tpa.paged_attention_update(qd, nk, nv, kp, vp, bt, lens,
                                           k_scale=ks, v_scale=vs)
    want, _, _ = tpa.paged_attention_update_reference(
        qd, nk, nv, kp2, vp2, bt, lens, k_scale=ks, v_scale=vs)
    active = [0, 2, 3]
    assert (got[active].float() - want[active].float()).abs().max() <= 2e-2
    assert torch.equal(kp[:, 1:], kp2[:, 1:])
    assert torch.equal(vp[:, 1:], vp2[:, 1:])
