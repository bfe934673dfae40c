"""Paged chunk attention for chunked prefill: CUDA kernel + plain version.

``paged_chunk_attention`` replaces the JAX package's Pallas kernel
``deepvision_tpu/engine/kernels/paged_chunk.py::_chunk_kernel``: C chunk
queries attend over the page pool, causally from ``chunk_starts``.  On
CUDA tensors it launches ``csrc/paged_chunk.cu`` (design notes, bound and
what is left for later are in that file's header); on CPU tensors it runs
:func:`paged_chunk_attention_reference`.  It never falls back from one to
the other.
"""

from __future__ import annotations

import torch

from deepvision_tpu_torch.engine.kernels import _build
from deepvision_tpu_torch.engine.kernels.paged_attention import (
    HEAD_DIMS,
    MAX_GROUP,
    POOL_DTYPES,
    _scales,
    _sm_count,
)

_NEG_INF = -1e30


def paged_chunk_attention(q, k_pages, v_pages, block_tables, chunk_starts,
                          seq_lens, *, k_scale=None, v_scale=None,
                          splits=None):
    """One layer's attention for a prefill chunk over the page pools.

    Args:
      q: ``[B, C, H, HD]`` bf16 chunk queries (RoPE applied).
      k_pages, v_pages: ``[KV, N, P, HD]`` pools, bf16 or int8, with the
        chunk's rows already written (:func:`write_chunk_tokens`).
      block_tables: ``[B, MP]`` int32 page ids.
      chunk_starts: ``[B]`` int32 position of each chunk's first query.
      seq_lens: ``[B]`` int32 end of each chunk (columns ``< seq_lens``
        are valid).
      k_scale, v_scale: ``[KV]`` float32 static scales (int8 pools).
      splits: how many blocks share each row tile's columns on the card
        (their partial softmax merged by a second kernel); None chooses
        from the grid (:func:`chunk_splits`).  The plain version has no
        use for it.

    Returns ``[B, C, H, HD]`` in q's dtype: query ``c`` of head ``h``
    attends to columns ``col <= chunk_starts + c`` and ``col < seq_lens``
    of kv head ``h // (H // KV)``; a row with no such column is 0.
    """
    if q.device.type == "cpu":
        return paged_chunk_attention_reference(
            q, k_pages, v_pages, block_tables, chunk_starts, seq_lens,
            k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_chunk_attention: unsupported device "
                         f"{q.device}")
    B, C, H, HD = q.shape
    KV, N, P, _ = k_pages.shape
    MP = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if (q.dtype != torch.bfloat16 or k_pages.dtype not in POOL_DTYPES
            or v_pages.dtype != k_pages.dtype):
        raise TypeError(f"paged_chunk_attention: dtypes q {q.dtype} pools "
                        f"{k_pages.dtype}/{v_pages.dtype} not supported")
    if (k_pages.shape != (KV, N, P, HD) or v_pages.shape != k_pages.shape
            or block_tables.shape != (B, MP) or chunk_starts.shape != (B,)
            or seq_lens.shape != (B,) or H % KV):
        raise ValueError("paged_chunk_attention: inconsistent shapes")
    if HD not in HEAD_DIMS or H // KV > MAX_GROUP:
        raise ValueError(f"paged_chunk_attention: head_dim {HD} / group "
                         f"{H // KV} not supported")
    if (block_tables.dtype != torch.int32 or chunk_starts.dtype != torch.int32
            or seq_lens.dtype != torch.int32):
        raise TypeError("paged_chunk_attention: block_tables, chunk_starts "
                        "and seq_lens must be int32")
    k_scale, v_scale = _scales(k_scale, v_scale, KV, q.device)
    tensors = (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
               ("block_tables", block_tables), ("chunk_starts", chunk_starts),
               ("seq_lens", seq_lens), ("k_scale", k_scale),
               ("v_scale", v_scale))
    for name, t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_chunk_attention: {name} must be "
                             f"contiguous on {q.device}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("paged_chunk_attention: scales must be float32")
    if splits is None:
        splits = chunk_splits(B, C, H, KV, HD, P * MP, q.device)
    if not isinstance(splits, int) or splits < 1:
        raise ValueError(f"paged_chunk_attention: splits {splits!r} is not "
                         f"a positive int")
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if splits > 1:  # each split's unnormalised (acc, m, l), fp32
        rows = B * KV * splits * C * (H // KV)
        part_acc = torch.empty(rows * HD, dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty(rows * 2, dtype=torch.float32, device=q.device)
    lib = _build.library()
    rc = lib.dv_paged_chunk(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), chunk_starts.data_ptr(), seq_lens.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
        part_acc.data_ptr() if splits > 1 else None,
        part_ml.data_ptr() if splits > 1 else None,
        B, C, H, KV, N, P, MP, HD, _build.DTYPE_CODES[q.dtype],
        _build.DTYPE_CODES[k_pages.dtype], splits, HD ** -0.5,
        _build.stream_ptr(q.device))
    _build.check(rc, "paged_chunk_attention")
    paged_chunk_attention.launches += 1
    return out


paged_chunk_attention.launches = 0


_ROWS_PER_BLOCK = 64   # csrc/paged_chunk.cu TcChunk::BR
_BLOCKS_PER_SM = 2     # TcChunk::MIN_BLOCKS
_MAX_SPLITS = 8


def chunk_splits(B, C, H, KV, HD, max_cols, device) -> int:
    """Column splits for the chunk kernel: enough blocks to fill the card
    twice over (up to 8 splits), and at least two column tiles a split at
    the longest sequence the block tables can hold (``max_cols``); 1 when
    the grid of row tiles alone fills it."""
    blocks = -(-C * (H // KV) // _ROWS_PER_BLOCK) * KV * B
    max_tiles = -(-max_cols // (32 if HD >= 256 else 64))
    slots = _sm_count(device) * _BLOCKS_PER_SM
    return max(1, min(_MAX_SPLITS, slots // blocks, max_tiles // 2))


def paged_chunk_kernel_info(head_dim: int, pool_dtype) -> dict:
    """How the card runs the chunk kernel for ``pool_dtype`` pools:
    registers a thread, dynamic shared memory and local (spill) bytes,
    blocks an SM and threads a block."""
    return _build.kernel_info("dv_paged_chunk_info", head_dim,
                              _build.DTYPE_CODES[pool_dtype])


def paged_chunk_attention_reference(q, k_pages, v_pages, block_tables,
                                    chunk_starts, seq_lens, *, k_scale=None,
                                    v_scale=None):
    """Plain PyTorch version: gathers every sequence's pages densely, fp32
    scores, masked softmax; a row with no valid column gives 0, as the
    kernel's ``l == 0 -> 1`` does."""
    B, C, H, HD = q.shape
    KV, N, P, _ = k_pages.shape
    MP = block_tables.shape[1]
    kp, vp = k_pages.float(), v_pages.float()
    if k_pages.dtype == torch.int8:
        k_scale, v_scale = _scales(k_scale, v_scale, KV, q.device)
        kp = kp * k_scale.float()[:, None, None, None]
        vp = vp * v_scale.float()[:, None, None, None]
    bt = block_tables.long()
    # [KV, B, MP, P, HD] -> [B, MP * P, KV, HD]
    k = kp[:, bt].permute(1, 2, 3, 0, 4).reshape(B, MP * P, KV, HD)
    v = vp[:, bt].permute(1, 2, 3, 0, 4).reshape(B, MP * P, KV, HD)
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bchd,bkhd->bchk", q.float(), k) * (HD ** -0.5)
    col = torch.arange(MP * P, device=q.device)
    q_pos = (chunk_starts.long()[:, None]
             + torch.arange(C, device=q.device)[None, :])        # [B, C]
    mask = ((col[None, None, :] <= q_pos[:, :, None])
            & (col[None, None, :] < seq_lens.long()[:, None, None]))
    mask = mask[:, :, None, :]                                   # [B,C,1,K]
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1) * mask.any(dim=-1, keepdim=True)
    return torch.einsum("bchk,bkhd->bchd", p, v).to(q.dtype)
