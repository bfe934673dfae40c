"""The port's read-only paged decode attention (TPU kernel #6) and the
(B, KV)-grid fused decode update (#7) against the JAX package's.

On the CPU, ``paged_attention`` and ``paged_attention_update`` (any
``grid_mode``) run their plain PyTorch versions; these are held against
JAX ``paged_attention`` and ``paged_attention_update(grid_mode="bkv")`` in
Pallas interpret mode on the same numpy inputs: ragged lengths, GQA and
MQA, bf16 and int8 pools, the cases of ``tests/test_engine_kernels.py``,
``tests/test_kernel_properties.py`` and ``tests/test_kv_int8.py``.  The
CUDA kernels are held against the plain versions by the ``cuda``-marked
tests at the end, which skip without a GPU (and by ``chip_smoke.py`` on
the card).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine import kernels as jkernels
from deepvision_tpu.engine.kernels.paged_attention import (
    paged_attention as jpaged,
    paged_attention_reference as jpaged_ref,
    paged_attention_update as jpaged_update,
)
from deepvision_tpu.engine.kv_cache import quantize_rows as jquantize_rows
from deepvision_tpu_torch.engine import kernels as tkernels
from deepvision_tpu_torch.engine.kv_cache import (
    quantize_rows,
    write_decode_token,
)

# the module (the package exports its function of the same name)
tpa = importlib.import_module(
    "deepvision_tpu_torch.engine.kernels.paged_attention")

torch.set_num_threads(2)

# float32 inputs, float32 math on both sides: the JAX kernel's online
# softmax and the plain dense softmax differ in summation order only
F32_TOL = 1e-5
# bf16 q and outputs: both sides round one fp32 value per element to bf16,
# so one bf16 ulp of an O(1) value (2^-8) plus order effects
BF16_TOL = 1e-2


def _np(t):
    return t.float().numpy()


def _jnp(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _tables(rng, B, MP, N, lens, P):
    """Distinct non-zero pages per sequence, zeros past its live pages."""
    bt = np.zeros((B, MP), np.int32)
    perm = rng.permutation(np.arange(1, N))
    i = 0
    for b, n in enumerate(lens):
        k = -(-n // P)
        bt[b, :k] = perm[i:i + k]
        i += k
    return bt


# -- read-only paged attention (#6) ------------------------------------------

# (B, H, KV, HD, P, N, MP, lens): the cases of test_engine_kernels.py
# (test_paged_attention_matches_reference) and GQA groups up to 8
READ_CASES = [
    (2, 8, 2, 64, 16, 64, 16, [5, 64]),
    (2, 8, 2, 64, 16, 64, 16, [1, 1]),
    (2, 8, 2, 64, 16, 64, 16, [63, 130]),
    (3, 6, 2, 32, 8, 32, 8, [17, 64, 3]),
    (2, 8, 1, 32, 8, 32, 8, [40, 9]),
]


@pytest.mark.parametrize("case", READ_CASES)
def test_paged_attention_plain_matches_jax(case):
    """Plain ``paged_attention`` (CPU) vs JAX ``paged_attention`` in
    interpret mode and vs its jnp reference, float32 (F32_TOL)."""
    B, H, KV, HD, P, N, MP, lens = case
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, HD)).astype(np.float32)
    kp = rng.standard_normal((KV, N, P, HD)).astype(np.float32)
    vp = rng.standard_normal((KV, N, P, HD)).astype(np.float32)
    bt = _tables(rng, B, MP, N, lens, P)
    seq = np.asarray(lens, np.int32)
    args = [jnp.asarray(x) for x in (q, kp, vp, bt, seq)]
    got = tkernels.paged_attention(*[torch.from_numpy(x)
                                     for x in (q, kp, vp, bt, seq)])
    assert got.shape == (B, H, HD) and got.dtype == torch.float32
    for want in (jpaged(*args, interpret=True), jpaged_ref(*args)):
        np.testing.assert_allclose(_np(got), _jnp(want), atol=F32_TOL,
                                   rtol=F32_TOL)


def test_paged_attention_mqa_single_kv_head():
    """MQA (one kv head, Gemma style), as test_engine_kernels.py has it:
    the block table names pages out of order and ends in zeros."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 32)).astype(np.float32)
    kp = rng.standard_normal((1, 16, 8, 32)).astype(np.float32)
    vp = rng.standard_normal((1, 16, 8, 32)).astype(np.float32)
    bt = np.asarray([[3, 7, 1, 0, 0, 0, 0, 0]], np.int32)
    seq = np.asarray([20], np.int32)
    want = jpaged(*[jnp.asarray(x) for x in (q, kp, vp, bt, seq)],
                  interpret=True)
    got = tkernels.paged_attention(*[torch.from_numpy(x)
                                     for x in (q, kp, vp, bt, seq)])
    np.testing.assert_allclose(_np(got), _jnp(want), atol=F32_TOL,
                               rtol=F32_TOL)


def _setup(seed, B=2, KV=2, H=4, HD=32, P=8, N=32):
    """test_kernel_properties.py's paged setup, from numpy."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, HD)).astype(np.float32))
    kp = torch.from_numpy(
        rng.standard_normal((KV, N, P, HD)).astype(np.float32))
    vp = torch.from_numpy(
        rng.standard_normal((KV, N, P, HD)).astype(np.float32))
    bt = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8],
                       [9, 10, 11, 12, 13, 14, 15, 16]],
                      dtype=torch.int32)[:B]
    seq = torch.tensor([30, 46], dtype=torch.int32)[:B]
    return q, kp, vp, bt, seq


def test_paged_page_permutation_invariance():
    """The same KV content reached through other page ids gives the same
    output: the block table is pure indirection."""
    q, kp, vp, bt, seq = _setup(20)
    out1 = tkernels.paged_attention(q, kp, vp, bt, seq)
    perm = list(range(21, 29))
    k2, v2 = kp.clone(), vp.clone()
    for src, dst in zip(range(1, 9), perm):
        k2[:, dst] = kp[:, src]
        v2[:, dst] = vp[:, src]
    bt2 = bt.clone()
    bt2[0] = torch.tensor(perm, dtype=torch.int32)
    out2 = tkernels.paged_attention(q, k2, v2, bt2, seq)
    np.testing.assert_allclose(_np(out1), _np(out2), atol=1e-5, rtol=1e-5)


def test_paged_unused_table_entries_ignored():
    """Entries past a sequence's last page (0, the trash page, here
    poisoned) do not touch the output; the JAX kernel agrees."""
    q, kp, vp, bt, seq = _setup(30)
    kp[:, 0] = 1e4
    vp[:, 0] = -1e4
    out1 = tkernels.paged_attention(q, kp, vp, bt, seq)
    bt2 = bt.clone()
    bt2[0, 4:] = 0       # row 0 uses ceil(30 / 8) = 4 pages
    out2 = tkernels.paged_attention(q, kp, vp, bt2, seq)
    np.testing.assert_allclose(_np(out1), _np(out2), atol=1e-5, rtol=1e-5)
    want = jpaged(*[jnp.asarray(x.numpy()) for x in (q, kp, vp, bt2, seq)],
                  interpret=True)
    np.testing.assert_allclose(_np(out2), _jnp(want), atol=F32_TOL,
                               rtol=F32_TOL)


def test_package_exports_match_the_jax_kernels_package():
    """The kernels package exports the read-only paged attention and its
    plain version, as the JAX kernels package does."""
    assert callable(tkernels.paged_attention)
    assert tkernels.paged_attention is tpa.paged_attention
    assert tkernels.paged_attention_reference is tpa.paged_attention_reference
    for name in ("paged_attention", "paged_attention_reference"):
        assert name in jkernels.__all__


# -- the fused update on the (B, KV) grid (#7) ------------------------------

def _update_inputs(rng, B, H, KV, HD, P, MP, lens):
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


UPDATE_CASES = [
    # (B, H, KV, HD, P, MP, lens)
    (3, 4, 2, 32, 8, 4, [32, 1, 9]),
    (2, 6, 2, 64, 16, 3, [17, 48]),
    (2, 8, 1, 32, 8, 5, [1, 40]),
    (2, 16, 2, 32, 8, 4, [8, 25]),
]


@pytest.mark.parametrize("case", UPDATE_CASES)
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_update_bkv_plain_matches_jax_bkv(case, pool):
    """Port ``paged_attention_update(grid_mode="bkv")`` vs JAX's
    ``grid_mode="bkv"`` in interpret mode: outputs of active slots
    (BF16_TOL) and the pools outside trash page 0 bit for bit."""
    B, H, KV, HD, P, MP, lens = case
    rng = np.random.default_rng(5)
    q, nk, nv, kp, vp, bt, seq = _update_inputs(rng, B, H, KV, HD, P, MP,
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
        tnk, tnv = torch.from_numpy(nk), torch.from_numpy(nv)
        jks, jvs = jnp.asarray(ks), jnp.asarray(vs)
        tks, tvs = torch.from_numpy(ks), torch.from_numpy(vs)
    else:
        jkp, jvp = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
        jnk, jnv = jnp.asarray(nk, jnp.bfloat16), jnp.asarray(nv, jnp.bfloat16)
        tkp, tvp = (torch.from_numpy(_jnp(x)).bfloat16() for x in (jkp, jvp))
        tnk, tnv = (torch.from_numpy(_jnp(x)).bfloat16() for x in (jnk, jnv))
        jks = jvs = tks = tvs = None
    want, wkp, wvp = jpaged_update(
        jq, jnk, jnv, jkp, jvp, jnp.asarray(bt), jnp.asarray(seq),
        k_scale=jks, v_scale=jvs, interpret=True, grid_mode="bkv")
    got, gkp, gvp = tpa.paged_attention_update(
        torch.from_numpy(_jnp(jq)).bfloat16(), tnk, tnv, tkp, tvp,
        torch.from_numpy(bt), torch.from_numpy(seq), k_scale=tks,
        v_scale=tvs, grid_mode="bkv")
    assert gkp is tkp and gvp is tvp          # updated in place
    active = [i for i, n in enumerate(lens) if n > 1]
    np.testing.assert_allclose(_np(got[active]), _jnp(want)[active],
                               atol=BF16_TOL, rtol=BF16_TOL)
    for g, w in ((gkp, wkp), (gvp, wvp)):
        np.testing.assert_array_equal(_np(g[:, 1:]), _jnp(w[:, 1:]))


def test_update_grid_modes_agree():
    """``grid_mode="b"`` and ``"bkv"`` are the same function: equal
    outputs and pool writes, ragged lens and a group of 4 (as
    test_kernel_properties.py's test_paged_update_grid_modes_agree), and
    both equal write-then-``paged_attention``, which only touches one slot
    per (sequence, kv head); the JAX ``"bkv"`` kernel agrees."""
    q, kp, vp, bt, seq = _setup(80, H=8)
    rng = np.random.default_rng(81)
    B, KV, HD = q.shape[0], kp.shape[0], q.shape[2]
    nk = torch.from_numpy(rng.standard_normal((B, KV, HD)).astype(np.float32))
    nv = torch.from_numpy(rng.standard_normal((B, KV, HD)).astype(np.float32))
    outs = {}
    for mode in ("b", "bkv"):
        k1, v1 = kp.clone(), vp.clone()
        outs[mode] = tpa.paged_attention_update(q, nk, nv, k1, v1, bt, seq,
                                                grid_mode=mode)
    (ob, kb, vb), (og, kg, vg) = outs["b"], outs["bkv"]
    np.testing.assert_allclose(_np(ob), _np(og), atol=1e-5, rtol=1e-5)
    assert torch.equal(kb, kg) and torch.equal(vb, vg)
    k2, v2 = kp.clone(), vp.clone()
    write_decode_token(k2, v2, nk, nv, bt, seq.long() - 1)
    two_step = tkernels.paged_attention(q, k2, v2, bt, seq)
    np.testing.assert_allclose(_np(ob), _np(two_step), atol=1e-5, rtol=1e-5)
    assert torch.equal(kb, k2) and torch.equal(vb, v2)
    assert int((kb != kp).any(dim=-1).sum()) == B * KV
    want, wk, _ = jpaged_update(
        *[jnp.asarray(x.numpy()) for x in (q, nk, nv, kp, vp, bt, seq)],
        interpret=True, grid_mode="bkv")
    np.testing.assert_allclose(_np(og), _jnp(want), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_array_equal(_np(kg), _jnp(wk))


def test_update_bkv_len1_first_token():
    """len 1: the first decode token attends only to itself, so the output
    is its value row, repeated over the group."""
    rng = np.random.default_rng(60)
    q = torch.from_numpy(rng.standard_normal((1, 4, 32)).astype(np.float32))
    kp = torch.zeros(2, 8, 8, 32)
    vp = torch.zeros(2, 8, 8, 32)
    nk = torch.from_numpy(rng.standard_normal((1, 2, 32)).astype(np.float32))
    nv = torch.from_numpy(rng.standard_normal((1, 2, 32)).astype(np.float32))
    bt = torch.tensor([[1, 0, 0, 0]], dtype=torch.int32)
    seq = torch.tensor([1], dtype=torch.int32)
    out, _, _ = tpa.paged_attention_update(q, nk, nv, kp, vp, bt, seq,
                                           grid_mode="bkv")
    np.testing.assert_allclose(_np(out), _np(nv.repeat_interleave(2, dim=1)),
                               atol=1e-6, rtol=1e-6)


# -- int8 pools (test_kv_int8.py's cases) ------------------------------------

def _quantized(rng, KV=2, N=16, P=8, HD=32, margin=1.0):
    kf = rng.standard_normal((KV, N, P, HD)).astype(np.float32)
    vf = rng.standard_normal((KV, N, P, HD)).astype(np.float32)
    ks = (np.abs(kf).max(axis=(1, 2, 3)) * margin / 127.0).astype(np.float32)
    vs = (np.abs(vf).max(axis=(1, 2, 3)) * margin / 127.0).astype(np.float32)
    kq = quantize_rows(torch.from_numpy(kf), torch.from_numpy(ks), 0)
    vq = quantize_rows(torch.from_numpy(vf), torch.from_numpy(vs), 0)
    assert np.array_equal(kq.numpy(), np.asarray(
        jquantize_rows(jnp.asarray(kf), jnp.asarray(ks), 0)))
    return kf, vf, kq, vq, torch.from_numpy(ks), torch.from_numpy(vs)


def test_paged_attention_int8_matches_jax():
    """int8 pools: the plain version vs JAX ``paged_attention`` over the
    same quantized pools (F32_TOL: the same dequantized values), and within
    the JAX test's int8 error budget (0.08 absolute, 0.1 relative) of the
    float32 pools it came from."""
    rng = np.random.default_rng(1)
    B, H = 2, 4
    q = rng.standard_normal((B, H, 32)).astype(np.float32)
    kf, vf, kq, vq, ks, vs = _quantized(rng)
    bt = rng.choice(np.arange(1, 16), size=(B, 4), replace=False).astype(
        np.int32)
    seq = np.asarray([8 * 4 - 3, 8 + 2], np.int32)
    tq, tbt, tseq = (torch.from_numpy(x) for x in (q, bt, seq))
    got = tkernels.paged_attention(tq, kq, vq, tbt, tseq, k_scale=ks,
                                   v_scale=vs)
    want = jpaged(jnp.asarray(q), jnp.asarray(kq.numpy()),
                  jnp.asarray(vq.numpy()), jnp.asarray(bt), jnp.asarray(seq),
                  k_scale=jnp.asarray(ks.numpy()),
                  v_scale=jnp.asarray(vs.numpy()), interpret=True)
    np.testing.assert_allclose(_np(got), _jnp(want), atol=F32_TOL,
                               rtol=F32_TOL)
    full = tkernels.paged_attention(tq, torch.from_numpy(kf),
                                    torch.from_numpy(vf), tbt, tseq)
    np.testing.assert_allclose(_np(got), _np(full), atol=0.08, rtol=0.1)


def test_update_bkv_int8_writes_and_attends_in_place():
    """int8 pools: the bkv update quantizes the new rows, writes them
    within half a scale step of the float rows, and attends over the
    written pools as ``paged_attention`` does; JAX's bkv kernel writes the
    same int8 rows."""
    rng = np.random.default_rng(2)
    B, H, KV, HD, P = 2, 4, 2, 32, 8
    _, _, kq, vq, ks, vs = _quantized(rng, margin=1.5)
    q = torch.from_numpy(rng.standard_normal((B, H, HD)).astype(np.float32))
    nk = torch.from_numpy(rng.standard_normal((B, KV, HD)).astype(np.float32))
    nv = torch.from_numpy(rng.standard_normal((B, KV, HD)).astype(np.float32))
    bt = torch.from_numpy(rng.choice(np.arange(1, 16), size=(B, 4),
                                     replace=False).astype(np.int32))
    seq = torch.tensor([P + 1, 2 * P], dtype=torch.int32)
    jk = jnp.asarray(kq.numpy())
    jv = jnp.asarray(vq.numpy())
    out, kq2, vq2 = tpa.paged_attention_update(
        q, nk, nv, kq, vq, bt, seq, k_scale=ks, v_scale=vs, grid_mode="bkv")
    assert kq2.dtype == torch.int8
    for b in range(B):
        pos = int(seq[b]) - 1
        page, off = int(bt[b, pos // P]), pos % P
        back = kq2[:, page, off].float() * ks[:, None]
        np.testing.assert_allclose(back.numpy(), nk[b].numpy(),
                                   atol=float(ks.max()) * 0.51)
    ref = tkernels.paged_attention(q, kq2, vq2, bt, seq, k_scale=ks,
                                   v_scale=vs)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-6, rtol=1e-6)
    _, wk, wv = jpaged_update(
        jnp.asarray(q.numpy()), jnp.asarray(nk.numpy()),
        jnp.asarray(nv.numpy()), jk, jv, jnp.asarray(bt.numpy()),
        jnp.asarray(seq.numpy()), k_scale=jnp.asarray(ks.numpy()),
        v_scale=jnp.asarray(vs.numpy()), interpret=True, grid_mode="bkv")
    np.testing.assert_array_equal(kq2.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(vq2.numpy(), np.asarray(wv))


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor CUDA raises; it never runs the plain
    version."""
    q = torch.empty(1, 2, 32, device="meta")
    pools = torch.empty(1, 3, 8, 32, device="meta")
    bt = torch.empty(1, 2, dtype=torch.int32, device="meta")
    lens = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tkernels.paged_attention(q, pools, pools, bt, lens)
    with pytest.raises(ValueError):
        tpa.paged_attention_update(q, q[:, :1], q[:, :1], pools, pools, bt,
                                   lens, grid_mode="bkv")


# -- the CUDA kernels (GPU only) ---------------------------------------------

def _cuda_inputs(pool, lens, B=4, H=6, KV=2, HD=128, P=16, MP=4):
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    q, nk, nv, kp, vp, bt, seq = _update_inputs(rng, B, H, KV, HD, P, MP,
                                                lens)
    q, nk, nv = (torch.from_numpy(x).to(dev).bfloat16() for x in (q, nk, nv))
    ks = vs = None
    if pool == torch.int8:
        ks = vs = torch.full((KV,), 4.0 / 127, device=dev)
        kp = quantize_rows(torch.from_numpy(kp).to(dev), ks, 0)
        vp = quantize_rows(torch.from_numpy(vp).to(dev), vs, 0)
    else:
        kp = torch.from_numpy(kp).to(dev).bfloat16()
        vp = torch.from_numpy(vp).to(dev).bfloat16()
    return (q, nk, nv, kp, vp, torch.from_numpy(bt).to(dev),
            torch.from_numpy(seq).to(dev), ks, vs)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [torch.bfloat16, torch.int8])
def test_cuda_paged_attention_matches_plain(pool):
    """#6 on the card against its plain version (bf16 outputs: 2e-2
    absolute; every slot, since nothing is written)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q, _, _, kp, vp, bt, seq, ks, vs = _cuda_inputs(pool, [64, 1, 3, 40])
    got = tkernels.paged_attention(q, kp, vp, bt, seq, k_scale=ks, v_scale=vs)
    want = tkernels.paged_attention_reference(q, kp, vp, bt, seq, ks, vs)
    assert (got.float() - want.float()).abs().max() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [torch.bfloat16, torch.int8])
def test_cuda_update_bkv_matches_plain_and_grid_b(pool):
    """#7 on the card against its plain version and against #1 (grid "b")
    on copies of the same pools: outputs of active slots within 2e-2, pools
    bit-identical outside page 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q, nk, nv, kp, vp, bt, seq, ks, vs = _cuda_inputs(pool, [64, 1, 17, 33])
    copies = [(kp.clone(), vp.clone()) for _ in range(3)]
    got, _, _ = tpa.paged_attention_update(
        q, nk, nv, *copies[0], bt, seq, k_scale=ks, v_scale=vs,
        grid_mode="bkv")
    want, _, _ = tpa.paged_attention_update_reference(
        q, nk, nv, *copies[1], bt, seq, k_scale=ks, v_scale=vs)
    grid_b, _, _ = tpa.paged_attention_update(
        q, nk, nv, *copies[2], bt, seq, k_scale=ks, v_scale=vs)
    active = [0, 2, 3]
    for other in (want, grid_b):
        assert (got[active].float() - other[active].float()).abs().max() \
            <= 2e-2
    for pools in copies[1:]:
        assert torch.equal(copies[0][0][:, 1:], pools[0][:, 1:])
        assert torch.equal(copies[0][1][:, 1:], pools[1][:, 1:])
