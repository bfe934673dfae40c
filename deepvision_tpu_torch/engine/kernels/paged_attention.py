"""Fused paged-KV decode step: CUDA kernel + plain version.

``paged_attention_update`` replaces the JAX package's Pallas kernel
``deepvision_tpu/engine/kernels/paged_attention.py::_fused_kernel_b`` (its
``grid_mode="b"``): write this step's K/V row into the page pools in place,
then attend over each sequence's pages.  On CUDA tensors it launches
``csrc/paged_decode.cu`` (design notes, bound and what is left for later
are in that file's header); on CPU tensors it runs
:func:`paged_attention_update_reference`.  It never falls back from one to
the other.
"""

from __future__ import annotations

import torch

from deepvision_tpu_torch.engine.kernels import _build
from deepvision_tpu_torch.engine.kv_cache import (
    quantize_rows,
    write_decode_token,
)

_NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP = 8  # query heads per kv head the kernel takes
POOL_DTYPES = (torch.bfloat16, torch.int8)  # the kernel takes bf16 q


def _scales(k_scale, v_scale, kv: int, device):
    ones = None
    if k_scale is None or v_scale is None:
        ones = torch.ones(kv, dtype=torch.float32, device=device)
    return (ones if k_scale is None else k_scale,
            ones if v_scale is None else v_scale)


def paged_attention_update(q, new_k, new_v, k_pages, v_pages, block_tables,
                           seq_lens, *, k_scale=None, v_scale=None):
    """One layer's decode attention with the KV write fused in.

    Args:
      q: ``[B, H, HD]`` bf16 (RoPE applied).
      new_k, new_v: ``[B, KV, HD]`` this step's rows; float rows are
        quantized here for int8 pools.
      k_pages, v_pages: ``[KV, N, P, HD]`` pools, bf16 or int8; updated in
        place.
      block_tables: ``[B, MP]`` int32 page ids.
      seq_lens: ``[B]`` int32 lengths INCLUDING the current token (>= 1).
      k_scale, v_scale: ``[KV]`` float32 static scales (int8 pools).

    Returns ``(out [B, H, HD], k_pages, v_pages)`` (the same pool tensors).
    """
    if q.device.type == "cpu":
        return paged_attention_update_reference(
            q, new_k, new_v, k_pages, v_pages, block_tables, seq_lens,
            k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_update: unsupported device "
                         f"{q.device}")
    B, H, HD = q.shape
    KV, N, P, _ = k_pages.shape
    MP = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if (q.dtype != torch.bfloat16 or k_pages.dtype not in POOL_DTYPES
            or v_pages.dtype != k_pages.dtype):
        raise TypeError(f"paged_attention_update: dtypes q {q.dtype} pools "
                        f"{k_pages.dtype}/{v_pages.dtype} not supported")
    if (new_k.shape != (B, KV, HD) or new_v.shape != new_k.shape
            or k_pages.shape != (KV, N, P, HD) or v_pages.shape != k_pages.shape
            or block_tables.shape != (B, MP) or seq_lens.shape != (B,)
            or H % KV):
        raise ValueError("paged_attention_update: inconsistent shapes")
    if HD not in HEAD_DIMS or H // KV > MAX_GROUP:
        raise ValueError(f"paged_attention_update: head_dim {HD} / group "
                         f"{H // KV} not supported")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention_update: block_tables and seq_lens "
                        "must be int32")
    k_scale, v_scale = _scales(k_scale, v_scale, KV, q.device)
    if k_pages.dtype == torch.int8:
        new_k = quantize_rows(new_k, k_scale, 1)
        new_v = quantize_rows(new_v, v_scale, 1)
    new_k = new_k.to(k_pages.dtype)
    new_v = new_v.to(v_pages.dtype)
    tensors = (("q", q), ("new_k", new_k), ("new_v", new_v),
               ("k_pages", k_pages), ("v_pages", v_pages),
               ("block_tables", block_tables), ("seq_lens", seq_lens),
               ("k_scale", k_scale), ("v_scale", v_scale))
    for name, t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_attention_update: {name} must be "
                             f"contiguous on {q.device}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("paged_attention_update: scales must be float32")
    out = torch.empty_like(q)
    lib = _build.library()
    rc = lib.dv_paged_decode_update(
        q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
        B, H, KV, N, P, MP, HD, _build.DTYPE_CODES[q.dtype],
        _build.DTYPE_CODES[k_pages.dtype], HD ** -0.5,
        _build.stream_ptr(q.device))
    _build.check(rc, "paged_attention_update")
    paged_attention_update.launches += 1
    return out, k_pages, v_pages


paged_attention_update.launches = 0


def paged_attention_update_reference(q, new_k, new_v, k_pages, v_pages,
                                     block_tables, seq_lens, *,
                                     k_scale=None, v_scale=None):
    """Plain PyTorch version: :func:`write_decode_token` (in place), then
    :func:`paged_attention_reference`."""
    k_scale, v_scale = _scales(k_scale, v_scale, k_pages.shape[0], q.device)
    write_decode_token(k_pages, v_pages, new_k, new_v, block_tables,
                       seq_lens.long() - 1, k_scale=k_scale, v_scale=v_scale)
    out = paged_attention_reference(q, k_pages, v_pages, block_tables,
                                    seq_lens, k_scale=k_scale,
                                    v_scale=v_scale)
    return out, k_pages, v_pages


def paged_attention_reference(q, k_pages, v_pages, block_tables, seq_lens,
                              k_scale=None, v_scale=None):
    """Plain PyTorch paged decode attention: gathers every sequence's pages
    densely, fp32 scores, masked softmax over columns < seq_lens."""
    B, H, HD = q.shape
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
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k) * (HD ** -0.5)
    valid = (torch.arange(MP * P, device=q.device)[None, :]
             < seq_lens.long()[:, None])
    s = torch.where(valid[:, None, :], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, v).to(q.dtype)
