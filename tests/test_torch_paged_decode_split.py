"""The column split of the paged decode kernels, emulated on the CPU.

On the card, ``paged_attention_update`` (``csrc/paged_decode.cu``, TPU
kernel #1; ``csrc/paged_attention.cu``, #6/#7) splits each sequence's
columns over ``splits`` blocks and merges their fp32 softmax states in a
second kernel (``csrc/decode_split.cuh``).  The kernels run only on the
card, so this file emulates their arithmetic in plain fp32 PyTorch: the
same column ranges from ``len`` and ``splits`` (whole pages, the last
splits possibly empty), column ``len - 1`` taken from ``new_k``/``new_v``
and never from the pool, each range's (m, l, acc) in natural-log units,
and the same merge (max over the non-empty splits, ``exp(m_s - M)``
weights, ``l == 0 -> 1``, ``v_scale`` at the normalize).  The emulation is
held against the plain ``paged_attention_update_reference`` for splits
1..16 (fp32, 1e-5) and against the JAX ``paged_attention_update`` in
Pallas interpret mode (bf16 output, 2e-2) on the same numpy inputs, with
the step's destination row poisoned in the pool before the call.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine.kernels.paged_attention import (
    paged_attention_update as jpaged_update,
)
from deepvision_tpu_torch.engine.kv_cache import quantize_rows

# the module (the package exports its function of the same name)
tpa = importlib.import_module(
    "deepvision_tpu_torch.engine.kernels.paged_attention")

torch.set_num_threads(2)


def col_ranges(n, P, splits):
    """decode_split.cuh's dv_split_cols for every split."""
    per = -(-(-(-n // P)) // splits) * P
    return [(s * per, min(n, s * per + per)) for s in range(splits)]


def emulate(q, new_k, new_v, k_pages, v_pages, block_tables, seq_lens,
            k_scale, v_scale, splits):
    """The split kernels' function in fp32: returns ``[B, H, HD]`` float32
    and writes each step's row into the pools as the owning split does."""
    B, H, HD = q.shape
    KV, N, P, _ = k_pages.shape
    MP = block_tables.shape[1]
    G = H // KV
    ks, vs = tpa._scales(k_scale, v_scale, KV, q.device)
    nk, nv = tpa._rows(new_k, new_v, k_pages, ks, vs)
    kp0, vp0 = k_pages.clone(), v_pages.clone()  # what every block reads
    out = torch.zeros(B, H, HD)
    for b in range(B):
        length = int(seq_lens[b])
        n, wpos = min(max(length, 0), MP * P), length - 1
        for kv in range(KV):
            qf = q[b, kv * G:(kv + 1) * G].float() * (HD ** -0.5
                                                      * float(ks[kv]))
            parts = []
            for c0, c1 in col_ranges(n, P, splits):
                if c0 >= c1:
                    parts.append((-math.inf, 0.0, None))
                    continue
                cols = torch.arange(c0, c1)
                page = block_tables[b].long()[cols // P]
                k = kp0[kv, page, cols % P].float()
                v = vp0[kv, page, cols % P].float()
                if c0 <= wpos < c1:  # the new row: from new_k / new_v
                    k[wpos - c0] = nk[b, kv].float()
                    v[wpos - c0] = nv[b, kv].float()
                    dst = int(block_tables[b, wpos // P])
                    k_pages[kv, dst, wpos % P] = nk[b, kv]
                    v_pages[kv, dst, wpos % P] = nv[b, kv]
                s = qf @ k.T                                    # [G, cols]
                m = s.max(dim=-1).values
                p = torch.exp(s - m[:, None])
                parts.append((m, p.sum(-1), p @ v))
            live = [pt for pt in parts if pt[2] is not None]
            if not live:
                continue                                        # 0
            big_m = torch.stack([m for m, _, _ in live]).max(dim=0).values
            acc, l_sum = torch.zeros(G, HD), torch.zeros(G)
            for m, l, a in live:
                w = torch.exp(m - big_m)
                acc += w[:, None] * a
                l_sum += w * l
            l_sum = torch.where(l_sum == 0, torch.ones_like(l_sum), l_sum)
            out[b, kv * G:(kv + 1) * G] = acc / l_sum[:, None] * float(vs[kv])
    return out


def _inputs(seed, B, H, KV, HD, P, MP, lens, pool, inactive=()):
    """Numpy inputs (float32; bf16-exact where the pools are bf16), each
    sequence on its own pages, entries past its live pages on trash page
    0; ``inactive`` slots point at page 0 only (the scheduler's idle
    slots, len 1)."""
    rng = np.random.default_rng(seed)
    N = B * MP + 1

    def bf(x):
        return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))

    q = bf(rng.standard_normal((B, H, HD)))
    nk = bf(rng.standard_normal((B, KV, HD)))
    nv = bf(rng.standard_normal((B, KV, HD)))
    kp = rng.standard_normal((KV, N, P, HD)).astype(np.float32)
    vp = rng.standard_normal((KV, N, P, HD)).astype(np.float32)
    bt = (1 + rng.permutation(B * MP)).reshape(B, MP).astype(np.int32)
    for i, n in enumerate(lens):
        bt[i, -(-n // P):] = 0
        if i in inactive:
            bt[i] = 0
    ks = vs = None
    if pool == "int8":
        ks = np.full((KV,), 3.0 / 127, np.float32)
        vs = np.full((KV,), 3.0 / 127, np.float32)
        kp = quantize_rows(torch.from_numpy(kp), torch.from_numpy(ks),
                           0).numpy()
        vp = quantize_rows(torch.from_numpy(vp), torch.from_numpy(vs),
                           0).numpy()
    else:
        kp, vp = bf(kp), bf(vp)
    _poison(q, kp, vp, bt, lens, inactive)
    return q, nk, nv, kp, vp, bt, np.asarray(lens, np.int32), ks, vs


def _poison(q, kp, vp, bt, lens, inactive):
    """Fill every active destination row before the step: NaN in bf16
    pools; in int8 pools a K row of +-127 with the signs of the kv head's
    summed q (its score dwarfs every other column's) and a V row of 127.
    A kernel that reads the row from the pool instead of new_k / new_v
    then misses the plain version on that sequence."""
    KV, P, G = kp.shape[0], kp.shape[2], q.shape[1] // kp.shape[0]
    for i, n in enumerate(lens):
        if i in inactive:
            continue
        dst, off = bt[i, (n - 1) // P], (n - 1) % P
        if kp.dtype == np.int8:
            sign = np.sign(q[i].reshape(KV, G, -1).sum(1))
            kp[:, dst, off] = np.where(sign < 0, -127, 127)
            vp[:, dst, off] = 127
        else:
            kp[:, dst, off] = np.nan
            vp[:, dst, off] = np.nan


def _torch(x, pool):
    t = torch.from_numpy(np.array(x))
    return t.to(torch.int8 if pool == "int8" else torch.bfloat16)


CASES = [
    # (B, H, KV, HD, P, MP, lens, inactive slots)
    (4, 6, 2, 32, 8, 4, [1, 8, 9, 32], ()),        # len 1, P, P+1, P*MP
    (3, 3, 1, 128, 16, 4, [64, 1, 17], (1,)),      # G 3, an idle slot
    (2, 8, 1, 256, 8, 3, [24, 5], ()),             # G 8, HD 256
    (3, 2, 2, 32, 4, 8, [32, 13, 1], (2,)),        # G 1
]


@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
@pytest.mark.parametrize("case", CASES)
def test_split_emulation_matches_the_plain_version(case, pool):
    """For every split count 1..16 (more splits than pages included) the
    emulated partition and merge equal the plain write-then-attend
    version in fp32 (1e-5: two fp32 sums in another order), and leave the
    same pools outside trash page 0 (bit for bit)."""
    B, H, KV, HD, P, MP, lens, inactive = case
    q, nk, nv, kp, vp, bt, seq, ks, vs = _inputs(1, B, H, KV, HD, P, MP,
                                                 lens, pool, inactive)
    tq = torch.from_numpy(q)                       # fp32 q: fp32 outputs
    tnk, tnv = torch.from_numpy(nk), torch.from_numpy(nv)
    tbt, tseq = torch.from_numpy(bt), torch.from_numpy(seq)
    tks = None if ks is None else torch.from_numpy(ks)
    tvs = None if vs is None else torch.from_numpy(vs)
    rkp, rvp = _torch(kp, pool), _torch(vp, pool)
    want, _, _ = tpa.paged_attention_update_reference(
        tq, tnk, tnv, rkp, rvp, tbt, tseq, k_scale=tks, v_scale=tvs)
    active = [i for i in range(B) if i not in inactive]
    for splits in range(1, 17):
        ekp, evp = _torch(kp, pool), _torch(vp, pool)
        got = emulate(tq, tnk, tnv, ekp, evp, tbt, tseq, tks, tvs, splits)
        torch.testing.assert_close(got[active], want[active], atol=1e-5,
                                   rtol=1e-5, msg=f"splits {splits}")
        assert torch.equal(ekp[:, 1:], rkp[:, 1:])
        assert torch.equal(evp[:, 1:], rvp[:, 1:])


@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
@pytest.mark.parametrize("case", CASES[:3])
def test_split_emulation_matches_jax(case, pool):
    """The emulation at 1, 3 and 16 splits, output rounded to bf16 as the
    kernels round it, against the JAX ``paged_attention_update`` in Pallas
    interpret mode on the same numpy inputs (bf16 output: one bf16 ulp of
    an O(1) value plus summation order, 2e-2, as chip_smoke holds the
    kernels); the pools equal outside trash page 0."""
    B, H, KV, HD, P, MP, lens, inactive = case
    q, nk, nv, kp, vp, bt, seq, ks, vs = _inputs(2, B, H, KV, HD, P, MP,
                                                 lens, pool, inactive)
    jks = None if ks is None else jnp.asarray(ks)
    jvs = None if vs is None else jnp.asarray(vs)
    pool_j = jnp.int8 if pool == "int8" else jnp.bfloat16
    row_j = jnp.float32 if pool == "int8" else jnp.bfloat16  # JAX quantizes
    want, wkp, wvp = jpaged_update(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(nk, row_j),
        jnp.asarray(nv, row_j),
        jnp.asarray(kp, pool_j), jnp.asarray(vp, pool_j), jnp.asarray(bt),
        jnp.asarray(seq), k_scale=jks, v_scale=jvs, interpret=True)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    active = [i for i in range(B) if i not in inactive]
    for splits in (1, 3, 16):
        ekp, evp = _torch(kp, pool), _torch(vp, pool)
        got = emulate(
            torch.from_numpy(q).bfloat16(), torch.from_numpy(nk),
            torch.from_numpy(nv), ekp, evp, torch.from_numpy(bt),
            torch.from_numpy(seq),
            None if ks is None else torch.from_numpy(ks),
            None if vs is None else torch.from_numpy(vs), splits)
        got = got.bfloat16().float().numpy()
        np.testing.assert_allclose(got[active], want[active], atol=2e-2,
                                   rtol=0, err_msg=f"splits {splits}")
        for g, w in ((ekp, wkp), (evp, wvp)):
            np.testing.assert_array_equal(
                g[:, 1:].float().numpy(),
                np.asarray(jnp.asarray(w[:, 1:], jnp.float32)))


def test_a_read_of_the_poisoned_row_would_show():
    """The poison is strong enough: attention that reads column len - 1
    from the pool as it stands before the write (what a kernel reading
    the row from the pool instead of new_k / new_v would see) is not
    finite or misses the plain version by far more than the kernels'
    2e-2, on every active sequence."""
    B, H, KV, HD, P, MP, lens, inactive = CASES[1]
    for pool in ("bfloat16", "int8"):
        q, nk, nv, kp, vp, bt, seq, ks, vs = _inputs(1, B, H, KV, HD, P, MP,
                                                     lens, pool, inactive)
        args = (torch.from_numpy(q), torch.from_numpy(nk),
                torch.from_numpy(nv))
        tks = None if ks is None else torch.from_numpy(ks)
        tvs = None if vs is None else torch.from_numpy(vs)
        want, _, _ = tpa.paged_attention_update_reference(
            *args, _torch(kp, pool), _torch(vp, pool), torch.from_numpy(bt),
            torch.from_numpy(seq), k_scale=tks, v_scale=tvs)
        # the pools as they stand before the write, read as they are
        stale = tpa.paged_attention_reference(
            args[0], _torch(kp, pool), _torch(vp, pool),
            torch.from_numpy(bt), torch.from_numpy(seq), tks, tvs)
        active = [i for i in range(B) if i not in inactive]
        bad = (~torch.isfinite(stale)) | ((stale - want).abs() > 0.5)
        assert bad[active].flatten(1).any(dim=1).all(), pool


def test_wrapper_on_the_cpu_takes_splits_and_runs_the_plain_version():
    """``splits`` reaches only the card: on CPU tensors both entry points
    return the plain version's result whatever it is."""
    q, nk, nv, kp, vp, bt, seq, _, _ = _inputs(3, 2, 4, 2, 32, 8, 4,
                                               [20, 9], "bfloat16")
    tq = torch.from_numpy(q).bfloat16()
    base, _, _ = tpa.paged_attention_update_reference(
        tq, torch.from_numpy(nk), torch.from_numpy(nv), _torch(kp, "bfloat16"),
        _torch(vp, "bfloat16"), torch.from_numpy(bt), torch.from_numpy(seq))
    for splits in (1, 5):
        got, _, _ = tpa.paged_attention_update(
            tq, torch.from_numpy(nk), torch.from_numpy(nv), _torch(kp, "bfloat16"),
            _torch(vp, "bfloat16"), torch.from_numpy(bt), torch.from_numpy(seq),
            splits=splits)
        assert torch.equal(got, base)
        ro = tpa.paged_attention(tq, _torch(kp, "bfloat16"), _torch(vp, "bfloat16"),
                                 torch.from_numpy(bt), torch.from_numpy(seq),
                                 splits=splits)
        assert ro.shape == base.shape


@pytest.mark.parametrize("sms", [132, 114, 1])
def test_decode_splits_fill_the_card(monkeypatch, sms):
    """The host's split choice: never 0; enough (B, KV) x splits blocks
    to fill every SM twice where the block tables allow it; at most 32
    and at most one a page of capacity; 1 when (B, KV) fills the card."""
    monkeypatch.setattr(tpa, "_sm_count", lambda device: sms)
    dev = torch.device("cpu")
    for B in (1, 2, 8, 32, 64, 256):
        for KV in (1, 2, 4):
            for MP in (1, 4, 32, 512):
                s = tpa.decode_splits(B, KV, MP, dev)
                assert 1 <= s <= min(32, MP)
                if B * KV >= 2 * sms:
                    assert s == 1
                elif s < min(32, MP):
                    assert B * KV * (s + 1) > 2 * sms
    # the report lane's shape on an H100: 16 splits, one page each at 1,024
    assert (tpa.decode_splits(8, 2, 32, dev) == 16) == (sms == 132)
