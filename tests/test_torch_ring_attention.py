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


def run_ring(n, q, k, v, lens, tmp_path, dtype=torch.float32):
    """The port's ring over ``n`` thread ranks on the full numpy inputs
    (each rank takes its chunk); the ranks' outputs joined along S."""
    store = os.path.join(tempfile.mkdtemp(dir=tmp_path), "rendezvous")
    S = q.shape[2]
    c = S // n
    out, errs = [None] * n, []

    def body(r):
        try:
            group = make_seq_mesh(n, rank=r, store_path=store, device="cpu")
            part = [torch.from_numpy(x[:, :, r * c:(r + 1) * c]).to(dtype)
                    for x in (q, k, v)]
            out[r] = ring_attention(*part, torch.tensor(lens), group)
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
    return torch.cat(out, dim=2).float().numpy()


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


def test_seq_mesh_rejects_a_rank_outside_it(tmp_path):
    with pytest.raises(ValueError, match="outside"):
        make_seq_mesh(2, rank=2, store_path=str(tmp_path / "rv"),
                      device="cpu")
