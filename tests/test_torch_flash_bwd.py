"""The port's flash-attention backward against the JAX package's.

On the CPU the port's wrappers run their plain versions (explicit formulas
for the row logsumexp, dQ and dK/dV); these are held against the JAX
package's Pallas backward kernels (``_flash_backward`` in interpret mode),
its ``_row_logsumexp``, and ``jax.vjp`` of its differentiable
``flash_attention``, on the same numpy inputs.  The CUDA kernels are held
against the plain versions by the ``cuda``-marked tests at the end, which
skip without a GPU (and by ``chip_smoke.py`` on the card).

Tolerances: float32 inputs — both sides compute in float32 and differ in
summation order only (1e-4, below the JAX tests' own 2e-3); bf16 inputs —
both sides compute in float32 from the same bf16 values and round each
output once to bf16, so an element may land one bf16 step (2^-7 relative)
apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine.kernels.flash_attention import (
    _DKV_VMEM_BUDGET_BYTES,
    _flash_backward,
    _row_logsumexp,
    flash_attention as jflash,
)
from deepvision_tpu_torch.engine.kernels import flash_attention as tfa

torch.set_num_threads(2)

F32_TOL = 1e-4
BF16_RTOL = 2.0 ** -7


def _t(x, dtype):
    """numpy/jax array -> torch (bf16 through float32, which is exact)."""
    return torch.from_numpy(
        np.asarray(jnp.asarray(x).astype(jnp.float32)).copy()).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, dtype, err_msg=""):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL,
                                   err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                                   atol=BF16_RTOL * 1e-2
                                   * float(np.abs(want).max()),
                                   err_msg=err_msg)


# (B, H, KV, S, HD, lens, blk_q, blk_k)
RAGGED_GQA = (2, 4, 2, 128, 64, [128, 80], 64, 32)  # tests/test_flash_vjp.py
UNEVEN = (1, 3, 1, 96, 32, [96], 32, 48)
CASES = {"ragged_gqa": RAGGED_GQA, "uneven": UNEVEN}


def _inputs(case, dtype, seed=0):
    """q, k, v and a cotangent that is nonzero on padded rows too."""
    B, H, KV, S, HD, lens, _, _ = case
    rng = np.random.default_rng(seed)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q = jnp.asarray(rng.standard_normal((B, H, S, HD)), jdt)
    k = jnp.asarray(rng.standard_normal((B, KV, S, HD)), jdt)
    v = jnp.asarray(rng.standard_normal((B, KV, S, HD)), jdt)
    g = jnp.asarray(rng.standard_normal((B, H, S, HD)), jdt)
    return q, k, v, g, jnp.asarray(np.asarray(lens, np.int32))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_kernels(name, dtype):
    """``flash_bwd_dq``/``flash_bwd_dkv`` (plain, CPU) vs the JAX Pallas
    backward kernels in interpret mode, with the same forward output and a
    nonzero cotangent on padded rows: dK/dV over all rows (both mask padded
    rows), dQ over valid rows."""
    case = CASES[name]
    B, H, KV, S, HD, lens, blk_q, blk_k = case
    q, k, v, g, seq = _inputs(case, dtype)
    out = jflash(q, k, v, seq, blk_q=blk_q, blk_k=blk_k, interpret=True)
    jdq, jdk, jdv = _flash_backward(q, k, v, seq, out, g, blk_q=blk_q,
                                    blk_k=blk_k, interpret=True)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tq, tk, tv, tg, tout = (_t(x, tdt) for x in (q, k, v, g, out))
    tseq = torch.from_numpy(np.array(seq))
    lse = tfa.row_logsumexp_reference(tq, tk, tseq)
    delta = tfa.flash_bwd_delta(tout, tg)
    dq = tfa.flash_bwd_dq(tq, tk, tv, tseq, tg, lse, delta)
    dk, dv = tfa.flash_bwd_dkv(tq, tk, tv, tseq, tg, lse, delta)
    assert dq.dtype == dk.dtype == dv.dtype == tdt
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    _close(_np(dk), jdk, dtype, "dk")
    _close(_np(dv), jdv, dtype, "dv")
    for b, n in enumerate(lens):
        _close(_np(dq[b, :, :n]), jdq[b, :, :n], dtype, f"dq[{b}]")


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_row_logsumexp_matches_jax(name):
    """``row_logsumexp_reference`` vs JAX ``_row_logsumexp`` on every row,
    padded rows included (neither masks rows)."""
    case = CASES[name]
    HD, blk_k = case[4], case[7]
    q, k, _, _, seq = _inputs(case, "float32")
    want = _row_logsumexp(q, k, seq, blk_k=blk_k, scale=HD ** -0.5)
    got = tfa.row_logsumexp_reference(_t(q, torch.float32),
                                      _t(k, torch.float32),
                                      torch.from_numpy(np.array(seq)))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


def test_row_logsumexp_of_a_fully_masked_row():
    """A sequence of length 0 masks every column: lse is -1e30 (in
    float32, -1e30 + log(n) for any n up to S is -1e30), the forward gives
    0 and the backward gives 0, with nothing NaN."""
    B, H, KV, S, HD = 2, 2, 1, 16, 8
    rng = np.random.default_rng(1)
    q, g = (torch.from_numpy(rng.standard_normal((B, H, S, HD)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, KV, S, HD)).astype(
        np.float32)) for _ in range(2))
    seq = torch.tensor([S, 0], dtype=torch.int32)
    lse = tfa.row_logsumexp_reference(q, k, seq)
    assert torch.all(lse[1] == torch.tensor(-1e30))
    want = _row_logsumexp(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                          jnp.asarray(seq.numpy()), blk_k=S,
                          scale=HD ** -0.5)
    np.testing.assert_array_equal(_np(lse[1]), np.asarray(want[1]))
    out = tfa.flash_attention_reference(q, k, v, seq)
    delta = tfa.flash_bwd_delta(out, g)
    dq = tfa.flash_bwd_dq(q, k, v, seq, g, lse, delta)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, seq, g, lse, delta)
    for t in (out[1], dq[1], dk[1], dv[1]):
        assert torch.all(t == 0)
    for t in (out, dq, dk, dv):
        assert torch.isfinite(t).all()


def _vjp_case(case, dtype):
    B, H, KV, S, HD, lens, blk_q, blk_k = case
    q, k, v, g, seq = _inputs(case, dtype, seed=2)
    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, seq, blk_q=blk_q,
                                            blk_k=blk_k, interpret=True),
                     q, k, v)
    want = vjp(g)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tq, tk, tv = (_t(x, tdt).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, torch.from_numpy(np.array(seq)))
    got = torch.autograd.grad(out, (tq, tk, tv), _t(g, tdt))
    return lens, want, got


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_matches_jax_vjp(name, dtype):
    """``torch.autograd.grad`` through the port's ``flash_attention``
    against ``jax.vjp`` of the JAX package's ``flash_attention`` (its
    ``custom_vjp`` with the Pallas backward kernels, interpret mode), with a
    nonzero cotangent on padded rows: dK/dV over all rows, dQ over valid
    rows."""
    lens, (jdq, jdk, jdv), (dq, dk, dv) = _vjp_case(CASES[name], dtype)
    _close(_np(dk), jdk, dtype, "dk")
    _close(_np(dv), jdv, dtype, "dv")
    for b, n in enumerate(lens):
        _close(_np(dq[b, :, :n]), jdq[b, :, :n], dtype, f"dq[{b}]")


def test_autograd_matches_jax_above_its_dense_switch():
    """A query group above the JAX package's 8 MiB switch (f32, G=8,
    HD=256, S=640: 10.5 MB; S=512 lands on 8 MiB exactly, which the JAX
    test ``>`` does not switch on), where JAX runs the dense VJP: the
    port's kernels take every shape, and give the same gradients."""
    case = (1, 8, 1, 640, 256, [640], 128, 128)
    B, H, KV, S, HD = case[:5]
    assert 2 * (H // KV) * S * HD * 4 > _DKV_VMEM_BUDGET_BYTES
    _, (jdq, jdk, jdv), (dq, dk, dv) = _vjp_case(case, "float32")
    for got, want, name in ((dq, jdq, "dq"), (dk, jdk, "dk"),
                            (dv, jdv, "dv")):
        _close(_np(got), want, "float32", name)


@pytest.mark.parametrize("lens", [[6, 6], [6, 0]])
def test_gradcheck_float64(lens):
    """``torch.autograd.gradcheck`` of the Function in float64 at a tiny
    GQA shape (no padded rows: their cotangent deliberately never reaches
    dK/dV, so there the backward is not the dense Jacobian)."""
    rng = np.random.default_rng(3)
    B, H, KV, S, HD = 2, 4, 2, 6, 4
    q = torch.from_numpy(rng.standard_normal((B, H, S, HD)))
    k = torch.from_numpy(rng.standard_normal((B, KV, S, HD)))
    v = torch.from_numpy(rng.standard_normal((B, KV, S, HD)))
    seq = torch.tensor(lens, dtype=torch.int32)
    args = [x.requires_grad_(True) for x in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: tfa.flash_attention(a, b, c, seq), args,
        eps=1e-6, atol=1e-8, rtol=1e-6)


def test_serving_calls_build_no_graph():
    """Without grad-requiring inputs (or under no_grad) the forward runs
    alone: no autograd node, no row logsumexp."""
    q = torch.randn(1, 2, 8, 4)
    k = torch.randn(1, 1, 8, 4)
    seq = torch.tensor([8], dtype=torch.int32)
    assert tfa.flash_attention(q, k, k, seq).grad_fn is None
    with torch.no_grad():
        out = tfa.flash_attention(q.requires_grad_(True), k, k, seq)
    assert out.grad_fn is None


def test_backward_wrappers_refuse_other_devices():
    meta = torch.empty(1, 2, 128, 32, device="meta")
    kv = torch.empty(1, 1, 128, 32, device="meta")
    lens = torch.empty(1, dtype=torch.int32, device="meta")
    rows = torch.empty(1, 2, 128, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_bwd_dq(meta, kv, kv, lens, meta, rows, rows)
    with pytest.raises(ValueError):
        tfa.flash_bwd_dkv(meta, kv, kv, lens, meta, rows, rows)


# -- the CUDA kernels (GPU only) ----------------------------------------------

def _cuda_case(B, H, KV, S, HD, lens, dtype):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, H, S, HD, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, KV, S, HD, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, KV, S, HD, generator=gen, device=dev).to(dtype)
    g = torch.randn(B, H, S, HD, generator=gen, device=dev).to(dtype)
    return q, k, v, g, torch.tensor(lens, dtype=torch.int32, device=dev)


CUDA_CASES = [
    (2, 6, 2, 256, 128, [256, 97], torch.bfloat16),
    (1, 4, 1, 192, 64, [150], torch.float32),
    (2, 4, 2, 128, 32, [128, 0], torch.bfloat16),
    (1, 8, 1, 128, 256, [100], torch.bfloat16),
    (2, 4, 2, 200, 64, [200, 150], torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_backward_kernels_match_plain(case):
    """lse from the forward kernel, dQ and dK/dV kernels against their
    plain versions on the card (bf16 outputs: 2e-2 absolute on O(1)
    gradients; f32: 1e-3, summation order over up to 256 columns)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    *shape, dtype = case
    q, k, v, g, seq = _cuda_case(*shape, dtype)
    out, lse = tfa.flash_forward(q, k, v, seq, with_lse=True)
    want_lse = tfa.row_logsumexp_reference(q, k, seq)
    assert (lse - want_lse).abs().max().item() <= 1e-3
    delta = tfa.flash_bwd_delta(out, g)
    dq = tfa.flash_bwd_dq(q, k, v, seq, g, lse, delta)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, seq, g, lse, delta)
    wdq = tfa.flash_bwd_dq_reference(q, k, v, seq, g, lse, delta)
    wdk, wdv = tfa.flash_bwd_dkv_reference(q, k, v, seq, g, lse, delta)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-3
    for got, want in ((dq, wdq), (dk, wdk), (dv, wdv)):
        assert torch.isfinite(got).all()
        assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_cuda_autograd_launches_both_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q, k, v, g, seq = _cuda_case(2, 6, 2, 128, 128, [128, 64],
                                 torch.bfloat16)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    n_dq, n_dkv = tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches
    out = tfa.flash_attention(q, k, v, seq)
    torch.autograd.grad(out, (q, k, v), g)
    assert tfa.flash_bwd_dq.launches == n_dq + 1
    assert tfa.flash_bwd_dkv.launches == n_dkv + 1
