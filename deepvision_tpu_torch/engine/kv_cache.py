"""Paged KV cache: per-layer page pools on the device + a host page allocator.

Layout, shared with the JAX package so a test can hand one cache to both:

* ``cache["k"][l]`` / ``cache["v"][l]``: ``[KV_HEADS, N_PAGES, PAGE,
  HEAD_DIM]``, one tensor per layer, bf16 or int8.
* int8 pools carry static per-(layer, kv-head) scales ``cache["ks"][l]`` /
  ``cache["vs"][l]`` (``[KV]`` float32).
* Page 0 is the trash page: block-table padding and inactive decode slots
  point at it, so the writes need no data-dependent guards.

Every writer here updates the pools in place (the JAX package donates them
to its jitted steps to the same effect).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List

import torch

from deepvision_tpu_torch.engine.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    num_pages: int = 2048
    page_size: int = 64
    max_pages_per_seq: int = 64  # => max context = page_size * this
    dtype: torch.dtype = torch.bfloat16

    @property
    def max_context(self) -> int:
        return self.page_size * self.max_pages_per_seq

    @property
    def quantized(self) -> bool:
        return self.dtype == torch.int8


def init_cache(model: ModelConfig, cache: CacheConfig, *, device,
               kv_scales=None) -> dict:
    """Per-layer page pools (one ``(k, v)`` pair per layer).

    int8 pools get static scales: ``kv_scales`` is ``(k_scales [L, KV],
    v_scales [L, KV])``, or 1/16 everywhere when not given (the JAX
    package's default for RMS-normed, RoPE-rotated heads).
    """
    shape = (model.n_kv_heads, cache.num_pages, cache.page_size,
             model.head_dim)
    out = {
        "k": [torch.zeros(shape, dtype=cache.dtype, device=device)
              for _ in range(model.n_layers)],
        "v": [torch.zeros(shape, dtype=cache.dtype, device=device)
              for _ in range(model.n_layers)],
    }
    if cache.quantized:
        if kv_scales is None:
            ks = vs = torch.full((model.n_layers, model.n_kv_heads),
                                 1.0 / 16.0, dtype=torch.float32)
        else:
            ks = torch.as_tensor(kv_scales[0], dtype=torch.float32)
            vs = torch.as_tensor(kv_scales[1], dtype=torch.float32)
        out["ks"] = [ks[i].to(device).contiguous()
                     for i in range(model.n_layers)]
        out["vs"] = [vs[i].to(device).contiguous()
                     for i in range(model.n_layers)]
    return out


def quantize_rows(x: torch.Tensor, scale: torch.Tensor,
                  kv_axis: int) -> torch.Tensor:
    """Symmetric int8 quantization with a per-kv-head ``scale [KV]``;
    int8 input passes through untouched.  Rounds half to even, as
    ``jnp.round`` does."""
    if x.dtype == torch.int8:
        return x
    shape = [1] * x.dim()
    shape[kv_axis] = -1
    q = torch.round(x.float() / scale.reshape(shape))
    return q.clamp_(-127.0, 127.0).to(torch.int8)


class PageAllocator:
    """Thread-safe refcounting allocator over the shared page pool.

    Page 0 is never handed out (trash page).  Pages are refcounted so the
    prefix cache can share fully written pages across sequences: a shared
    page returns to the free list only when its last reference drops.
    The scheduler allocates at admission and decode growth, and frees at
    retirement.
    """

    def __init__(self, num_pages: int):
        self._lock = threading.Lock()
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: dict = {}
        self.num_pages = num_pages

    def available(self) -> int:
        with self._lock:
            return len(self._free)

    def alloc(self, n: int) -> List[int]:
        """``n`` page ids with one reference each; raises MemoryError when
        fewer are free."""
        with self._lock:
            if n > len(self._free):
                raise MemoryError(
                    f"KV page pool exhausted: want {n}, have {len(self._free)}")
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._refs[p] = 1
        return pages

    def try_alloc(self, n: int):
        """``n`` page ids, or None when fewer are free."""
        try:
            return self.alloc(n)
        except MemoryError:
            return None

    def share(self, pages: List[int]) -> None:
        """Add a reference to already allocated pages (prefix reuse)."""
        with self._lock:
            for p in pages:
                if p > 0:
                    self._refs[p] = self._refs.get(p, 0) + 1

    def free(self, pages: List[int]) -> None:
        """Drop one reference per page; a page whose last reference drops
        goes back to the free list."""
        with self._lock:
            for p in pages:
                if p <= 0:
                    continue
                refs = self._refs.get(p, 1) - 1
                if refs <= 0:
                    self._refs.pop(p, None)
                    self._free.append(p)
                else:
                    self._refs[p] = refs


def pages_needed(seq_len: int, page_size: int) -> int:
    return -(-seq_len // page_size)


def write_prefill_pages(k_pages_l, v_pages_l, k_new, v_new, block_table,
                        k_scale=None, v_scale=None) -> None:
    """Scatter a prefilled prompt's K/V into one layer's pools, in place.

    ``k_new``/``v_new``: ``[B, S, KV, HD]`` with S a multiple of the page
    size; ``block_table``: ``[B, S // P]`` destination pages (0-padded
    tails write into the trash page).
    """
    if k_pages_l.dtype == torch.int8:
        k_new = quantize_rows(k_new, k_scale, k_new.dim() - 2)
        v_new = quantize_rows(v_new, v_scale, v_new.dim() - 2)
    KV, N, P, HD = k_pages_l.shape
    B, S = k_new.shape[0], k_new.shape[1]
    n_chunks = S // P

    def chunked(x):
        # [B, S, KV, HD] -> [KV, B * n_chunks, P, HD]
        return (x.reshape(B, n_chunks, P, KV, HD).permute(3, 0, 1, 2, 4)
                .reshape(KV, B * n_chunks, P, HD).to(k_pages_l.dtype))

    flat = block_table.reshape(-1).long()
    k_pages_l[:, flat] = chunked(k_new)
    v_pages_l[:, flat] = chunked(v_new)


def write_decode_token(k_pages_l, v_pages_l, k_new, v_new, block_tables,
                       positions, k_scale=None, v_scale=None) -> None:
    """Scatter one decode step's K/V (one row per sequence), in place.

    ``k_new``/``v_new``: ``[B, KV, HD]``; ``positions``: ``[B]`` zero-based
    position of the new token.
    """
    if k_pages_l.dtype == torch.int8:
        k_new = quantize_rows(k_new, k_scale, k_new.dim() - 2)
        v_new = quantize_rows(v_new, v_scale, v_new.dim() - 2)
    P = k_pages_l.shape[2]
    positions = positions.long()
    page = torch.gather(block_tables.long(), 1,
                        (positions // P)[:, None])[:, 0]
    off = positions % P
    k_pages_l[:, page, off] = k_new.transpose(0, 1).to(k_pages_l.dtype)
    v_pages_l[:, page, off] = v_new.transpose(0, 1).to(v_pages_l.dtype)


def write_chunk_tokens(k_pages_l, v_pages_l, k_new, v_new, block_tables,
                       positions, seq_lens, k_scale=None,
                       v_scale=None) -> None:
    """Scatter a prefill chunk's K/V rows into one layer's pools, in place.

    ``k_new``/``v_new``: ``[B, C, KV, HD]``; ``block_tables``: ``[B, MP]``;
    ``positions``: ``[B, C]`` absolute token positions; ``seq_lens``:
    ``[B]`` prompt lengths.  Rows at ``positions >= seq_lens`` (the padded
    tail of the last chunk) go to trash page 0, offset 0, never to a real
    page, so a chunk never touches pages past its own prompt.
    """
    if k_pages_l.dtype == torch.int8:
        k_new = quantize_rows(k_new, k_scale, k_new.dim() - 2)
        v_new = quantize_rows(v_new, v_scale, v_new.dim() - 2)
    P = k_pages_l.shape[2]
    MP = block_tables.shape[1]
    positions = positions.long()
    valid = positions < seq_lens.long()[:, None]
    slot = (positions // P).clamp(0, MP - 1)
    pages = torch.gather(block_tables.long(), 1, slot)
    pages = torch.where(valid, pages, torch.zeros_like(pages))
    offs = torch.where(valid, positions % P, torch.zeros_like(positions))
    # [B, C, KV, HD] -> [KV, B, C, HD]
    k_pages_l[:, pages, offs] = k_new.permute(2, 0, 1, 3).to(k_pages_l.dtype)
    v_pages_l[:, pages, offs] = v_new.permute(2, 0, 1, 3).to(v_pages_l.dtype)
