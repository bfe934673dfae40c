"""Token sampling: temperature / top-k / top-p, vectorised over the batch,
with the grammar mask of constrained decoding.

Branch-free over the batch (masks, not Python control flow), so one decode
step serves every slot's own sampling settings and never waits on the host.

Two divergences from the JAX package's ``engine/sampling.py``:

* The JAX package takes its ``MAX_K = 64`` candidates with the TPU's
  ``approx_max_k`` for vocabularies of 8192 and more; here they come from
  an exact ``torch.topk``.  This changes only which tail candidates a
  temperature > 0 draw may pick; greedy (temperature 0) is an exact
  ``argmax`` in both, taking the first index on ties.
* Random draws come from a ``torch.Generator`` (Gumbel-max over the
  candidates), not from ``jax.random``; the two streams differ, so
  temperature > 0 agrees with the JAX package only in distribution.

Vocab-sharded mode (``group`` set, a tensor-parallel
:class:`~deepvision_tpu_torch.engine.parallel.TPGroup`): each rank holds
``[B, V / n]`` logits of its own slice of the vocab.  Each rank takes its
local top-``MAX_K``, one ``all_gather`` unites the ranks' candidates with
their global ids, and the global top-k is picked from the union; ties go
to the lower global id, as ``lax.top_k`` gives them in the JAX package.
Every rank draws from its own identically seeded and identically advanced
generator over identical candidates, so all ranks hold the same token.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_NEG_INF = -1e30
MAX_K = 64


def _top_k_stable(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest along the last axis,
    ties in index order (a stable sort), as ``lax.top_k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _global_candidates(logits: torch.Tensor, group):
    """Local ``[B, V_local]`` logits -> the merged top candidates
    ``(vals, idx)`` ``[B, K]`` with global token ids, the same on every
    rank."""
    B, v_local = logits.shape
    vals, idx = _top_k_stable(logits, min(MAX_K, v_local))
    idx = idx + group.rank * v_local
    # one all_gather for both: ids are exact in float32 below 2**24
    both = group.all_gather(torch.stack([vals, idx.float()]), dim=-1)
    vals, idx = both[0], both[1].long()      # [B, n * K_local], rank order
    merged_vals, pos = _top_k_stable(vals, min(MAX_K, vals.shape[-1]))
    return merged_vals, torch.gather(idx, 1, pos)


def sample_tokens(
    logits: torch.Tensor,        # [B, V] float32 (local [B, V/n] w/ group)
    generator: torch.Generator,
    temperature: torch.Tensor,   # [B] (0 => greedy)
    top_k: torch.Tensor,         # [B] int32 (0 => disabled)
    top_p: torch.Tensor,         # [B] (1.0 => disabled)
    group=None,
) -> torch.Tensor:
    """Returns ``[B]`` int32 sampled token ids (global ids under vocab
    sharding)."""
    if group is not None:
        top_vals, top_idx = _global_candidates(logits, group)
        greedy = top_idx[:, 0]
    else:
        k_cand = min(MAX_K, logits.shape[-1])
        top_vals, top_idx = torch.topk(logits, k_cand, dim=-1)
        greedy = torch.argmax(logits, dim=-1)
    k_cand = top_vals.shape[-1]

    temp = torch.clamp(temperature, min=1e-4)[:, None]
    scaled = top_vals / temp                                   # [B, K]
    pos = torch.arange(k_cand, device=logits.device)[None, :]
    k = torch.where(top_k > 0, torch.clamp(top_k, max=k_cand),
                    torch.full_like(top_k, k_cand))[:, None]
    keep_k = pos < k
    probs = torch.softmax(scaled, dim=-1)
    prefix = torch.cumsum(probs, dim=-1) - probs
    keep_p = prefix < top_p[:, None]
    masked = torch.where(keep_k & keep_p, scaled,
                         torch.full_like(scaled, _NEG_INF))
    u = torch.rand(masked.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    choice = torch.argmax(masked + gumbel, dim=-1)             # [B] in [0, K)
    sampled = torch.gather(top_idx, 1, choice[:, None])[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


def sample_tokens_constrained(
    logits: torch.Tensor,        # [B, V] float32 (local [B, V/n] w/ group)
    generator: torch.Generator,
    temperature: torch.Tensor,   # [B]
    top_k: torch.Tensor,         # [B]
    top_p: torch.Tensor,         # [B]
    dfa_states: torch.Tensor,    # [B] int32 — row of the table (0 = FREE)
    dfa_table: torch.Tensor,     # [S, V] packed int32 (local [S, V/n])
    *,
    budgets: Optional[torch.Tensor] = None,  # [B] tokens left, incl. this
    group=None,
):
    """Grammar-constrained sampling over the PACKED table (the serving
    runner's form): each entry is ``(min(dist[next], 32767) << 16) |
    (next_state + 1)``, so one row gather yields both the transition
    (``-1`` = forbidden) and the next state's distance to ACCEPT.  With
    ``budgets``, transitions that cannot close the JSON within the
    remaining tokens are masked too, so output cut at ``max_tokens`` still
    parses; when nothing can close any more the plain grammar mask applies.
    Returns ``(tokens [B] int32, next_states [B] int32)``.

    Under vocab sharding (``group``) the logits and the table are the
    rank's vocab slice: the mask applies rank-locally, whether any token
    can still close is summed over the ranks, and the next state comes
    from the rank that owns the sampled token (the others add 0 in a
    one-int ``all_reduce``).
    """
    g = dfa_table[dfa_states.long()]                          # [B, V]
    rows = (g & 0xFFFF) - 1
    allowed = rows >= 0
    if budgets is not None:
        nxt_dist = g >> 16
        bud = torch.clamp(budgets - 1, max=32766)[:, None]
        can_close = allowed & (nxt_dist <= bud)
        some = can_close.any(dim=-1, keepdim=True)
        if group is not None:
            some = group.all_reduce(some.to(torch.int32)) > 0
        allowed = torch.where(some, can_close, allowed)
    masked = torch.where(allowed, logits, torch.full_like(logits, _NEG_INF))
    tok = sample_tokens(masked, generator, temperature, top_k, top_p,
                        group=group)
    if group is None:
        new_states = torch.gather(rows, 1, tok.long()[:, None])[:, 0]
        return tok, new_states.to(torch.int32)
    v_local = rows.shape[-1]
    local = tok.long() - group.rank * v_local
    owns = (local >= 0) & (local < v_local)
    mine = torch.gather(rows, 1, local.clamp(0, v_local - 1)[:, None])[:, 0]
    # a sampled token is allowed, so its owner's next state is >= 0
    new_states = group.all_reduce(
        torch.where(owns, mine, torch.zeros_like(mine)).to(torch.int32))
    return tok, new_states


def pack_dfa_table(table, dist):
    """Packed table of :func:`sample_tokens_constrained` from a numpy
    ``table [S, V]`` (next state or -1) and ``dist [S]``."""
    table = np.asarray(table, dtype=np.int32)
    dist = np.asarray(dist, dtype=np.int32)
    if table.max(initial=0) >= 32766:
        raise ValueError("packed DFA needs state ids < 32766")
    if dist[dist < (1 << 20)].max(initial=0) >= 32766:
        raise ValueError("packed DFA needs finite close-distances < 32766")
    dist_next = dist[np.maximum(table, 0)]
    return ((np.clip(dist_next, 0, 32767).astype(np.int64) << 16)
            | (table.astype(np.int64) + 1)).astype(np.int32)
