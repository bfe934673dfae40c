"""Ring attention: sequence-parallel causal attention over a group of ranks.

The counterpart of the JAX package's ``engine/ring_attention.py``.  There
one process drives a ``seq`` mesh axis through ``shard_map`` and rotates
K/V with ``ppermute``; here each rank is a process with its own chunk of
the sequence, and K/V travel to the next rank over the group's gloo
point-to-point sends:

* rank ``i`` holds query chunk ``i`` and starts with K/V chunk ``i``;
* at ring step ``s`` it attends its queries against K/V chunk
  ``(i - s) mod n`` with a global-position causal and padding mask, then
  passes the K/V block to rank ``i + 1`` and takes rank ``i - 1``'s;
* an online softmax (m, l, acc) in float32 accumulates the blocks, as in
  the flash kernel, so the result matches single-device attention up to
  float32 summation order.

GQA repeats each kv head over its query heads inside the local block.  The
JAX block is a float32 einsum outside any Pallas kernel; its port is plain
``torch.matmul`` in float32.

The JAX ring is differentiable (``shard_map`` over ``fori_loop`` with
``ppermute``); here :class:`_RingAttention` gives it a backward that runs
the ring again: each rank keeps its dQ, and every K/V chunk travels with
its dK/dV, which gather the chunk's share from each rank's queries on the
way and reach their owner after ``n`` hops.  Per rank this keeps O(S / n)
plus one block's scores, where autograd through the forward's loop would
keep all ``n`` blocks' probabilities.
"""

from __future__ import annotations

import torch

from deepvision_tpu_torch.engine.parallel import TPGroup, join_axis

_NEG_INF = -1e30


def make_seq_mesh(n: int, *, rank: int, store_path: str,
                  device="cuda") -> TPGroup:
    """Rank ``rank``'s group of an ``n``-rank sequence axis, meeting the
    others at the file ``store_path``; rank ``r`` on ``cuda:(r %
    device_count)`` (one card holds every rank) or on the CPU."""
    return join_axis(n, rank=rank, store_path=store_path, device=device,
                     what="sequence axis")


def _mask(Sq: int, Sk: int, q_off: int, k_off: int, seq_lens, device):
    """``[B, 1, Sq, Sk]``: global-position causal and ``cols < seq_lens``."""
    rows = q_off + torch.arange(Sq, device=device)[:, None]
    cols = k_off + torch.arange(Sk, device=device)[None, :]
    valid = cols[None] < seq_lens.long()[:, None, None]
    return ((cols <= rows)[None] & valid)[:, None]


def _local_block(q, k, v, q_off: int, k_off: int, seq_lens, scale, carry):
    """One (query chunk x K/V chunk) block into the online softmax.

    q: ``[B, H, Sq, HD]``; k, v: ``[B, KV, Sk, HD]``; offsets are the
    chunks' global token positions; ``carry = (m, l, acc)`` float32.
    """
    H, Sq = q.shape[1], q.shape[2]
    KV, Sk = k.shape[1], k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    m_prev, l_prev, acc_prev = carry
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = _mask(Sq, Sk, q_off, k_off, seq_lens, q.device)
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    # a fully masked row keeps m at -1e30, where exp(s - m) would be 1:
    # zero the masked entries explicitly
    p = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
    alpha = torch.exp(torch.clamp(m_prev - m_new, max=0.0))
    alpha = torch.where(torch.isfinite(m_prev), alpha,
                        torch.zeros_like(alpha))
    l_new = l_prev * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc_prev * alpha + torch.matmul(p, v.float())
    return m_new, l_new, acc_new


def _ring_forward(q, k, v, seq_lens, group: TPGroup):
    """The ring's float32 output and the rows' ``l`` and ``m``."""
    n, idx = group.size, group.rank
    Sq = q.shape[2]
    scale = q.shape[-1] ** -0.5
    m = torch.full(q.shape[:-1] + (1,), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l_sum = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for s in range(n):
        src = (idx - s) % n                   # the chunk kv holds now
        m, l_sum, acc = _local_block(q, kv[0], kv[1], idx * Sq, src * Sq,
                                     seq_lens, scale, (m, l_sum, acc))
        if s + 1 < n:
            kv = group.sendrecv(kv, (idx + 1) % n, (idx - 1) % n, tag=s)
    out = acc / torch.where(l_sum == 0.0, torch.ones_like(l_sum), l_sum)
    return out, l_sum, m


def _ring_backward(q, k, v, out, lse, d_out, seq_lens, group: TPGroup):
    """dQ of this rank's queries and dK/dV of its own K/V chunk, in float32.

    ``out`` is the forward's float32 output and ``lse`` its rows' ``m +
    log l``, +inf where ``l == 0`` (every column masked, output 0): there
    ``p = exp(s - lse)`` is 0, so those rows give no gradient, as the JAX
    ring's rows with ``l == 0 -> 1`` give none.
    """
    n, idx = group.size, group.rank
    H, Sq = q.shape[1], q.shape[2]
    KV, Sk = k.shape[1], k.shape[2]
    rep = H // KV
    scale = q.shape[-1] ** -0.5
    qf, d_out = q.float(), d_out.float()
    delta = (d_out * out).sum(dim=-1, keepdim=True)
    dq = torch.zeros_like(qf)
    # what travels: chunk src's k and v, and the dK and dV gathered for it
    zeros = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    kv = torch.stack([k.float(), v.float(), zeros, zeros])
    for s in range(n):
        src = (idx - s) % n
        kc = kv[0].repeat_interleave(rep, dim=1) if rep > 1 else kv[0]
        vc = kv[1].repeat_interleave(rep, dim=1) if rep > 1 else kv[1]
        mask = _mask(Sq, Sk, idx * Sq, src * Sq, seq_lens, q.device)
        scores = torch.matmul(qf, kc.transpose(-1, -2)) * scale
        p = torch.where(mask, torch.exp(scores - lse),
                        torch.zeros_like(scores))
        ds = p * (torch.matmul(d_out, vc.transpose(-1, -2)) - delta)
        dq += scale * torch.matmul(ds, kc)
        dk = scale * torch.matmul(ds.transpose(-1, -2), qf)
        dv = torch.matmul(p.transpose(-1, -2), d_out)
        # GQA: a kv head's query heads are contiguous (repeat_interleave)
        kv[2] += dk.unflatten(1, (KV, rep)).sum(dim=2)
        kv[3] += dv.unflatten(1, (KV, rep)).sum(dim=2)
        if s + 1 < n:
            kv = group.sendrecv(kv, (idx + 1) % n, (idx - 1) % n, tag=n + s)
    d_kv = kv[2:]
    if n > 1:                  # the last hop takes dK/dV home to their owner
        d_kv = group.sendrecv(d_kv, (idx + 1) % n, (idx - 1) % n,
                              tag=2 * n - 1)
    return dq, d_kv[0], d_kv[1]


class _RingAttention(torch.autograd.Function):
    """The ring's forward, and a backward that runs the ring again (tags
    ``n`` to ``2n - 1``, disjoint from the forward's ``0`` to ``n - 2``)."""

    @staticmethod
    def forward(ctx, q, k, v, seq_lens, group):
        out, l_sum, m = _ring_forward(q, k, v, seq_lens, group)
        lse = torch.where(l_sum == 0.0, torch.full_like(m, float("inf")),
                          m + torch.log(l_sum))
        ctx.save_for_backward(q, k, v, out, lse, seq_lens)
        ctx.group = group
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse, seq_lens = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, d_out, seq_lens,
                                    ctx.group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   seq_lens: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """Causal attention with the sequence axis cut over ``group``'s ranks.

    Args:
      q: ``[B, H, S / n, HD]``, this rank's chunk of the sequence (chunk
        ``group.rank`` of ``n = group.size`` equal chunks).
      k, v: ``[B, KV, S / n, HD]``, the same chunk.
      seq_lens: ``[B]`` valid lengths of the whole sequences (the same on
        every rank).
      group: the ``seq`` axis (:func:`make_seq_mesh`).

    Returns this rank's ``[B, H, S / n, HD]`` attention output in ``q``'s
    dtype; rows past ``seq_lens`` are junk (the flash kernel's contract).
    Every rank of the group must call it with chunks of one shape.

    Differentiable in ``q``, ``k`` and ``v`` (gradients in their dtypes,
    computed in float32).  The backward is collective too: every rank of
    the group must run it, as every rank ran the forward.  With no input
    that requires a gradient, nothing is saved for one.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _RingAttention.apply(q, k, v, seq_lens, group)
    with torch.no_grad():
        return _ring_forward(q, k, v, seq_lens, group)[0].to(q.dtype)
