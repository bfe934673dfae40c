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
``torch.matmul`` in float32.  Forward only, as the JAX package uses it
(long-context prefill and scoring; the decode path keeps paged attention).
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
    rows = q_off + torch.arange(Sq, device=q.device)[:, None]
    cols = k_off + torch.arange(Sk, device=q.device)[None, :]
    causal = cols <= rows                                      # [Sq, Sk]
    valid = cols[None] < seq_lens.long()[:, None, None]        # [B, Sq, Sk]
    mask = (causal[None] & valid)[:, None]                     # [B,1,Sq,Sk]
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


@torch.no_grad()
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
    """
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
    l_sum = torch.where(l_sum == 0.0, torch.ones_like(l_sum), l_sum)
    return (acc / l_sum).to(q.dtype)
