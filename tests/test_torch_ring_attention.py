"""The port's ring attention (sequence parallelism) against the JAX
package's ``ring_attention`` and the dense reference.

The counterpart of ``tests/test_ring_attention.py``: the JAX ring runs on
the virtual CPU devices (``tests/conftest.py``), the port's on ranks that
are threads of this process, each with its own gloo group
(``make_seq_mesh``, a file rendezvous under ``tmp_path``) and its chunk of
the sequence.  Inputs come from one numpy seed.  Both rings accumulate
float32 online softmaxes in another order than the dense reference, so
the tolerance is ``tests/test_ring_attention.py``'s: 2e-5 absolute and
relative on outputs of size O(1).

The backward is held against ``jax.vjp`` of the JAX ring on the same
cotangent, over every row (rows past a sequence's length included: their
cotangents reach the valid keys' dK/dV in both rings).  2e-5 absolute and
relative in float32: the gradients are O(1) to O(10), and besides the
summation order the JAX ring differentiates through its running max, a
path that cancels in exact arithmetic and leaves about 2e-6 of float32
noise.  In bf16 each of the port's gradients is one bf16 rounding of its
float32 result (2^-8 relative), held to 2^-7 x max(|g|, 1) of the JAX
ring's float32 gradient on the same bf16 values.
"""

import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine.kernels.flash_attention import (
    flash_attention_reference as jreference,
)
from deepvision_tpu.engine.ring_attention import make_seq_mesh as jmesh
from deepvision_tpu.engine.ring_attention import ring_attention as jring
from deepvision_tpu_torch.engine.kernels.flash_attention import (
    flash_attention_reference,
)
from deepvision_tpu_torch.engine.ring_attention import (
    make_seq_mesh,
    ring_attention,
)

torch.set_num_threads(1)

JOIN_S = 60.0
TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(B, H, KV, S, HD, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, HD)).astype(np.float32),
            rng.standard_normal((B, KV, S, HD)).astype(np.float32),
            rng.standard_normal((B, KV, S, HD)).astype(np.float32))


def run_ring(n, q, k, v, lens, tmp_path, dtype=torch.float32, ct=None):
    """The port's ring over ``n`` thread ranks on the full numpy inputs
    (each rank takes its chunk); the ranks' outputs joined along S.  With
    a cotangent ``ct`` every rank also runs the backward from its chunk of
    it, and the call returns ``(out, (dq, dk, dv))``, each joined along S."""
    store = os.path.join(tempfile.mkdtemp(dir=tmp_path), "rendezvous")
    S = q.shape[2]
    c = S // n
    out, grads, errs = [None] * n, [None] * n, []

    def chunk(x, r):
        return torch.from_numpy(x[:, :, r * c:(r + 1) * c]).to(dtype)

    def body(r):
        try:
            group = make_seq_mesh(n, rank=r, store_path=store, device="cpu")
            part = [chunk(x, r).requires_grad_(ct is not None)
                    for x in (q, k, v)]
            out[r] = ring_attention(*part, torch.tensor(lens), group)
            if ct is None:
                assert out[r].grad_fn is None
                return
            calls = group.calls
            out[r].backward(chunk(ct, r))
            # one sendrecv (a send and a receive) a hop, n hops
            assert group.calls - calls == 2 * n
            grads[r] = [x.grad for x in part]
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    if errs:
        raise errs[0]
    got = torch.detach(torch.cat(out, dim=2)).float().numpy()
    if ct is None:
        return got
    for g, x in zip(grads[0], (q, k, v)):
        assert g.dtype == dtype and g.shape[2] == x.shape[2] // n
    return got, tuple(torch.cat([gr[i] for gr in grads], dim=2).float()
                      .numpy() for i in range(3))


def _jax_grads(n, q, k, v, lens, ct):
    """``jax.vjp`` of the JAX ring at the cotangent ``ct``: (dq, dk, dv)."""
    mesh = jmesh(n, devices=jax.devices()[:n])
    jlens = jnp.asarray(lens, jnp.int32)

    @jax.jit
    def grads(a, b, c, d_out):
        return jax.vjp(lambda x, y, z: jring(x, y, z, jlens, mesh),
                       a, b, c)[1](d_out)

    return tuple(np.asarray(g) for g in grads(
        *(jnp.asarray(x) for x in (q, k, v, ct))))


def _cotangent(q, seed):
    return np.random.default_rng(seed).standard_normal(q.shape).astype(
        np.float32)


def _jax(n, q, k, v, lens):
    mesh = jmesh(n, devices=jax.devices()[:n])
    got = jring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(lens, jnp.int32), mesh)
    ref = jreference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(lens, jnp.int32))
    return np.asarray(got), np.asarray(ref)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_and_dense(n, tmp_path):
    """Full-length rows, kv heads = query heads: the port's ring against
    the JAX ring and both dense references, every row."""
    B, H, KV, S, HD = 2, 4, 4, 64, 16
    q, k, v = _rand(B, H, KV, S, HD)
    lens = [S, S]
    got = run_ring(n, q, k, v, lens, tmp_path)
    jgot, jref = _jax(n, q, k, v, lens)
    tref = flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.tensor(lens))
    np.testing.assert_allclose(got, jgot, **TOL)
    np.testing.assert_allclose(got, jref, **TOL)
    np.testing.assert_allclose(got, tref.numpy(), **TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_gqa_and_padding(n, tmp_path):
    """GQA (4 query heads on 2 kv heads) and a padded row whose length
    ends inside a chunk, at n = 2 and 4; rows past a sequence's length are
    junk by contract, so valid rows are compared."""
    B, H, KV, S, HD = 2, 4, 2, 128, 32
    q, k, v = _rand(B, H, KV, S, HD, seed=3)
    lens = [S, 70]
    got = run_ring(n, q, k, v, lens, tmp_path)
    jgot, jref = _jax(n, q, k, v, lens)
    for b, length in enumerate(lens):
        np.testing.assert_allclose(got[b, :, :length],
                                   jgot[b, :, :length], **TOL)
        np.testing.assert_allclose(got[b, :, :length],
                                   jref[b, :, :length], **TOL)


def test_ring_fully_masked_rows_and_bf16(tmp_path):
    """A length-0 row (every block masked: the output is 0, as ``l == 0 ->
    1`` makes it in the JAX ring) beside a row that ends in the first
    chunk, so later ranks' blocks are fully masked for it; and bf16 inputs
    (the output in bf16, accumulated in float32: one bf16 rounding of the
    float32 result, 2^-8 relative)."""
    B, H, KV, S, HD = 2, 2, 1, 32, 8
    q, k, v = _rand(B, H, KV, S, HD, seed=5)
    lens = [0, 5]
    got = run_ring(4, q, k, v, lens, tmp_path)
    jgot, _ = _jax(4, q, k, v, lens)
    assert np.all(got[0] == 0.0) and np.all(jgot[0] == 0.0)
    np.testing.assert_allclose(got[1, :, :5], jgot[1, :, :5], **TOL)
    half = run_ring(2, q, k, v, lens, tmp_path, dtype=torch.bfloat16)
    ref = flash_attention_reference(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        torch.tensor(lens)).float().numpy()
    np.testing.assert_allclose(half[1, :, :5], ref[1, :, :5], rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_backward_matches_jax(n, tmp_path):
    """Full-length rows, kv heads = query heads: dq, dk and dv of the
    port's ring against ``jax.vjp`` of the JAX ring, every row."""
    B, H, KV, S, HD = 2, 4, 4, 64, 16
    q, k, v = _rand(B, H, KV, S, HD, seed=7)
    ct = _cotangent(q, 8)
    lens = [S, S]
    _, got = run_ring(n, q, k, v, lens, tmp_path, ct=ct)
    for g, want in zip(got, _jax_grads(n, q, k, v, lens, ct)):
        np.testing.assert_allclose(g, want, **TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_backward_gqa_and_padding(n, tmp_path):
    """GQA (4 query heads on 2 kv heads: dK/dV summed over each kv head's
    query group) and a row that ends inside a chunk, the cotangent on
    every row, padded ones included."""
    B, H, KV, S, HD = 2, 4, 2, 128, 32
    q, k, v = _rand(B, H, KV, S, HD, seed=9)
    ct = _cotangent(q, 10)
    lens = [S, 70]
    _, got = run_ring(n, q, k, v, lens, tmp_path, ct=ct)
    for g, want in zip(got, _jax_grads(n, q, k, v, lens, ct)):
        np.testing.assert_allclose(g, want, **TOL)


def test_ring_backward_fully_masked_row(tmp_path):
    """A length-0 row beside a row that ends in the first chunk, at n = 4:
    the length-0 entry's gradients are exactly 0 in both rings (its output
    is 0 whatever q, k and v are).  The dense reference differs there: its
    softmax over a row with every column masked averages V, so its dV for
    that entry is not 0; the port follows the JAX ring."""
    B, H, KV, S, HD = 2, 2, 1, 32, 8
    q, k, v = _rand(B, H, KV, S, HD, seed=11)
    ct = _cotangent(q, 12)
    lens = [0, 5]
    _, got = run_ring(4, q, k, v, lens, tmp_path, ct=ct)
    want = _jax_grads(4, q, k, v, lens, ct)
    for g, w in zip(got, want):
        assert np.all(g[0] == 0.0) and np.all(w[0] == 0.0)
        np.testing.assert_allclose(g, w, **TOL)


def test_ring_backward_bf16(tmp_path):
    """bf16 inputs and cotangent at n = 2, GQA and a padded row: the
    gradients come back in bf16, each one rounding of the float32 result,
    so they are held against ``jax.vjp`` of the JAX ring in float32 on the
    same bf16 values.  (The JAX ring's own bf16 vjp is no sharper a
    reference: the cotangents of its bf16 loop carry and of ``jnp.repeat``
    are bf16, so it sums the ring's steps and a GQA group's heads in bf16,
    up to 1.34 x this bound from its float32 gradient on these inputs
    against the port's 0.48 x.)"""
    B, H, KV, S, HD = 2, 4, 2, 64, 16
    q, k, v = _rand(B, H, KV, S, HD, seed=13)
    ct = _cotangent(q, 14)
    lens = [S, 40]
    _, got = run_ring(2, q, k, v, lens, tmp_path, dtype=torch.bfloat16,
                      ct=ct)
    as_bf16 = [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
               for x in (q, k, v, ct)]
    for g, want in zip(got, _jax_grads(2, *as_bf16[:3], lens, as_bf16[3])):
        bound = 2 ** -7 * np.maximum(np.abs(want), 1.0)
        assert np.all(np.abs(g - want) <= bound), np.abs(g - want).max()


def test_seq_mesh_rejects_a_rank_outside_it(tmp_path):
    with pytest.raises(ValueError, match="outside"):
        make_seq_mesh(2, rank=2, store_path=str(tmp_path / "rv"),
                      device="cpu")
