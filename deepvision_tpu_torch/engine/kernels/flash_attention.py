"""Causal GQA flash attention for prefill: CUDA kernel + plain version.

``flash_attention`` replaces the JAX package's Pallas kernel
``deepvision_tpu/engine/kernels/flash_attention.py::_flash_kernel``.  On a
CUDA tensor it launches ``csrc/flash_fwd.cu`` (the design notes, the bound
on this card and what is left for later are in that file's header); on a
CPU tensor it runs :func:`flash_attention_reference`.  It never falls back
from one to the other.
"""

from __future__ import annotations

import torch

from deepvision_tpu_torch.engine.kernels import _build

_NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seq_lens: torch.Tensor) -> torch.Tensor:
    """Causal self-attention over a right-padded prompt batch.

    Args:
      q: ``[B, H, S, HD]`` queries, bf16 or float32.
      k, v: ``[B, KV, S, HD]`` keys/values of q's dtype; q head ``h`` reads
        kv head ``h // (H // KV)``.
      seq_lens: ``[B]`` int32 valid lengths (<= S).

    Returns ``[B, H, S, HD]``: row ``r`` attends to columns
    ``c <= r and c < seq_lens[b]``; a row with no such column is 0.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, H, S, HD = q.shape
    KV = k.shape[1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention: q dtype {q.dtype} not bf16/f32")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share a dtype")
    if k.shape != (B, KV, S, HD) or v.shape != k.shape or H % KV:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if HD not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {HD} not in {HEAD_DIMS}")
    if seq_lens.dtype != torch.int32 or seq_lens.shape != (B,):
        raise TypeError("flash_attention: seq_lens must be int32 [B]")
    for name, t in (("q", q), ("k", k), ("v", v), ("seq_lens", seq_lens)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"on {q.device}")
    out = torch.empty_like(q)
    lib = _build.library()
    rc = lib.dv_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), B, H, KV, S, HD, _build.DTYPE_CODES[q.dtype],
        HD ** -0.5, _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_reference(q, k, v, seq_lens):
    """Plain PyTorch version: dense fp32 scores, masked softmax.  Rows with
    no valid column give 0, as the kernel's ``l == 0 -> 1`` does."""
    B, H, S, HD = q.shape
    KV = k.shape[1]
    kf = k.float().repeat_interleave(H // KV, dim=1)
    vf = v.float().repeat_interleave(H // KV, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (HD ** -0.5)
    idx = torch.arange(S, device=q.device)
    causal = idx[None, :] <= idx[:, None]
    valid = idx[None, None, :] < seq_lens.to(q.device).long()[:, None, None]
    mask = (causal[None] & valid)[:, None]               # [B, 1, S, S]
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1) * mask.any(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
