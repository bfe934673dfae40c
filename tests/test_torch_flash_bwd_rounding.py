"""The rounding points of the tensor-core flash backward, checked on the CPU.

The bf16 path of ``csrc/flash_bwd.cu`` computes every product on the
tensor cores: bf16 operands, float32 accumulation.  It applies the softmax
scale in float32 after ``q . k`` (and to dQ and dK at write-out), keeps
``p`` and ``dS`` in float32 for the masks and the ``delta`` subtraction,
and rounds ``p`` and ``dS`` to bf16 only where they become an operand of
the second products (``dV = p^T . dO``, ``dQ = dS . k``, ``dK = dS^T . q``).
The plain ``flash_bwd_*_reference`` functions keep ``p`` and ``dS`` in
float32; they stay the yardstick on the card.

``_emulate`` below repeats those rounding points in plain PyTorch (test
code only), and the tests hold it against the JAX package's Pallas backward
kernels in interpret mode on inputs made from a numpy seed, with the
tolerance ``chip_smoke.py`` applies to the kernels on the card: the max
absolute error within 2^-7 x max(|reference|, 1) (one bf16 step of the
largest gradient).  A rounding choice that failed that bound would fail
here before it reached the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine.kernels.flash_attention import (
    _flash_backward,
    flash_attention as jflash,
)
from deepvision_tpu_torch.engine.kernels import flash_attention as tfa

torch.set_num_threads(2)

BF16_REL = 2.0 ** -7


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate(q, k, v, seq_lens, dout, lse, delta):
    """dQ, dK, dV with the tensor-core kernel's rounding points (see the
    module docstring); inputs bf16, ``lse``/``delta`` float32."""
    B, H, S, HD = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = HD ** -0.5
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    kr = kf.repeat_interleave(G, dim=1)
    vr = vf.repeat_interleave(G, dim=1)
    cols, rows = tfa._masks(S, seq_lens, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kr) * scale
    e = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)
    out = {}
    for name, mask in (("dq", cols), ("dkv", rows)):
        p = torch.where(mask, e, torch.zeros_like(e))
        ds = p * (dp - delta[..., None])
        if name == "dq":
            out["dq"] = (torch.einsum("bhqk,bhkd->bhqd", _bf16(ds), kr)
                         * scale).to(q.dtype)
        else:
            dv = torch.einsum("bhqk,bhqd->bhkd", _bf16(p), dof)
            dk = torch.einsum("bhqk,bhqd->bhkd", _bf16(ds), qf) * scale
            out["dk"] = dk.reshape(B, KV, G, S, HD).sum(2).to(k.dtype)
            out["dv"] = dv.reshape(B, KV, G, S, HD).sum(2).to(v.dtype)
    return out["dq"], out["dk"], out["dv"]


def _t(x):
    return torch.from_numpy(
        np.asarray(jnp.asarray(x).astype(jnp.float32)).copy()).to(
            torch.bfloat16)


def _within(got, want, name):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    err = float(np.abs(got - want).max())
    tol = BF16_REL * max(float(np.abs(want).max()), 1.0)
    assert err <= tol, f"{name}: max_abs_err {err} > {tol}"


@pytest.mark.parametrize("HD", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("S", [200, 512])
def test_tensor_core_rounding_matches_jax_backward(S, G, HD):
    """The emulation against the JAX Pallas backward (interpret mode),
    ragged (a full row and a partial one), with a cotangent that is
    nonzero on padded rows: dK/dV over all rows, dQ over valid rows (the
    JAX tests compare dQ there too)."""
    B, KV = 2, 1
    H = G * KV
    lens = [S, S * 3 // 5 + 1]
    blk = 40 if S == 200 else 128
    rng = np.random.default_rng(S * 100 + G * 10 + HD)
    q, g = (jnp.asarray(rng.standard_normal((B, H, S, HD)), jnp.bfloat16)
            for _ in range(2))
    k, v = (jnp.asarray(rng.standard_normal((B, KV, S, HD)), jnp.bfloat16)
            for _ in range(2))
    seq = jnp.asarray(np.asarray(lens, np.int32))
    out = jflash(q, k, v, seq, blk_q=blk, blk_k=blk, interpret=True)
    jdq, jdk, jdv = _flash_backward(q, k, v, seq, out, g, blk_q=blk,
                                    blk_k=blk, interpret=True)
    tq, tk, tv, tg, tout = (_t(x) for x in (q, k, v, g, out))
    tseq = torch.from_numpy(np.array(seq))
    lse = tfa.row_logsumexp_reference(tq, tk, tseq)
    delta = tfa.flash_bwd_delta(tout, tg)
    dq, dk, dv = _emulate(tq, tk, tv, tseq, tg, lse, delta)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    _within(dk, jdk, "dk")
    _within(dv, jdv, "dv")
    for b, n in enumerate(lens):
        _within(dq[b, :, :n], jdq[b, :, :n], f"dq[{b}]")


def test_emulation_is_the_plain_backward_up_to_its_rounding():
    """On one small case the emulation and the plain fp32 backward differ
    only by the bf16 rounding of p and dS (and where the scale is
    applied): within the same bound, and not bit-equal."""
    rng = np.random.default_rng(5)
    B, H, KV, S, HD = 2, 4, 2, 96, 64
    q, g = (torch.from_numpy(rng.standard_normal((B, H, S, HD)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, KV, S, HD)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    seq = torch.tensor([S, 40], dtype=torch.int32)
    out = tfa.flash_attention_reference(q, k, v, seq)
    lse = tfa.row_logsumexp_reference(q, k, seq)
    delta = tfa.flash_bwd_delta(out, g)
    got = _emulate(q, k, v, seq, g, lse, delta)
    want = (tfa.flash_bwd_dq_reference(q, k, v, seq, g, lse, delta),
            *tfa.flash_bwd_dkv_reference(q, k, v, seq, g, lse, delta))
    differs = False
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= BF16_REL * max(b.float().abs().max().item(), 1.0)
        differs |= not torch.equal(a, b)
    assert differs
