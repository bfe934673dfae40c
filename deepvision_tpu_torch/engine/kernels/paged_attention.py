"""Paged decode attention: CUDA kernels + plain versions.

Three functions of the JAX package's
``deepvision_tpu/engine/kernels/paged_attention.py``, each launching a
hand-written kernel on CUDA tensors and running its plain version on CPU
tensors (never falling back from one to the other):

* :func:`paged_attention_update` with ``grid_mode="b"`` (the default, the
  engine's decode path) replaces ``_fused_kernel_b``: write this step's K/V
  row into the page pools in place, then attend over each sequence's pages
  (``csrc/paged_decode.cu``);
* :func:`paged_attention_update` with any other ``grid_mode`` (``"bkv"``)
  replaces ``_fused_kernel``, the same function on a (B, KV) grid
  (``csrc/paged_attention.cu``, ``WRITE=true``);
* :func:`paged_attention` replaces ``_paged_kernel``: read-only paged
  decode attention (``csrc/paged_attention.cu``, ``WRITE=false``).

On the card both sources split each sequence's columns over
:func:`decode_splits` blocks and merge the blocks' fp32 softmax states in
a second kernel (``csrc/decode_split.cuh``).  Design notes, bounds and
what is left for later are in the sources' headers.
"""

from __future__ import annotations

import functools

import torch

from deepvision_tpu_torch.engine.kernels import _build
from deepvision_tpu_torch.engine.kv_cache import (
    quantize_rows,
    write_decode_token,
)

_NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP = 8  # query heads per kv head the kernels take
POOL_DTYPES = (torch.bfloat16, torch.int8)  # the kernels take bf16 q
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
_BLOCKS_PER_SM = 2     # the split aims to fill every SM this many times
_MAX_SPLITS = 32


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_splits(B, KV, max_pages, device) -> int:
    """Column splits for the decode kernels: enough blocks to fill the
    card's SMs twice over, at most 32 and at most one a page of the block
    tables' capacity (``max_pages`` = MP); 1 when the (B, KV) grid alone
    fills the card.  Chosen from shapes only: the lengths stay on the
    card."""
    slots = _sm_count(device) * _BLOCKS_PER_SM
    return max(1, min(_MAX_SPLITS, slots // (B * KV), max_pages))


def _scales(k_scale, v_scale, kv: int, device):
    ones = None
    if k_scale is None or v_scale is None:
        ones = torch.ones(kv, dtype=torch.float32, device=device)
    return (ones if k_scale is None else k_scale,
            ones if v_scale is None else v_scale)


def _check(name, q, k_pages, v_pages, block_tables, seq_lens, new_k=None,
           new_v=None):
    """Device, dtype and shape checks shared by the CUDA paths; raises on
    anything the kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, H, HD = q.shape
    KV, N, P, _ = k_pages.shape
    MP = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if (q.dtype != torch.bfloat16 or k_pages.dtype not in POOL_DTYPES
            or v_pages.dtype != k_pages.dtype):
        raise TypeError(f"{name}: dtypes q {q.dtype} pools "
                        f"{k_pages.dtype}/{v_pages.dtype} not supported")
    if ((new_k is not None and (new_k.shape != (B, KV, HD)
                                or new_v.shape != new_k.shape))
            or k_pages.shape != (KV, N, P, HD) or v_pages.shape != k_pages.shape
            or block_tables.shape != (B, MP) or seq_lens.shape != (B,)
            or H % KV):
        raise ValueError(f"{name}: inconsistent shapes")
    if HD not in HEAD_DIMS or H // KV > MAX_GROUP:
        raise ValueError(f"{name}: head_dim {HD} / group {H // KV} not "
                         f"supported")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError(f"{name}: block_tables and seq_lens must be int32")


def _rows(new_k, new_v, k_pages, k_scale, v_scale):
    """This step's rows in the pool dtype (quantized for int8 pools)."""
    if k_pages.dtype == torch.int8:
        new_k = quantize_rows(new_k, k_scale, 1)
        new_v = quantize_rows(new_v, v_scale, 1)
    return new_k.to(k_pages.dtype), new_v.to(k_pages.dtype)


def _check_operands(name, device, tensors, scales):
    for tname, t in tensors:
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous on "
                             f"{device}")
    if any(t.dtype != torch.float32 for _, t in scales):
        raise TypeError(f"{name}: scales must be float32")


def _smem_bytes(P, HD, G, itemsize):
    """Shared memory of ``csrc/paged_attention.cu`` (its ``smem_bytes``):
    two stages of one K page (rows padded by 16 bytes) and one V page
    (rows rounded up to 4), q as float, the score items, the softmax
    state and, at HD < 256, the column groups' partial sums."""
    pp = -(-P // 4) * 4
    groups = 256 // HD
    return (2 * P * (HD + 16 // itemsize) * itemsize + 2 * pp * HD * itemsize
            + 4 * (G * HD + HD // 32 * G * pp + 24
                   + (groups * G * HD if groups > 1 else 0)))


def _splits_and_scratch(splits, q, KV, MP):
    """The column splits (None: :func:`decode_splits`) and, with more than
    one, the fp32 scratch the blocks' states go to: ``B * KV * splits *
    G * (HD + 2)`` floats, from the caching allocator on the current
    stream."""
    B, H, HD = q.shape
    if splits is None:
        splits = decode_splits(B, KV, MP, q.device)
    if not isinstance(splits, int) or not 1 <= splits <= _MAX_SPLITS:
        raise ValueError(f"splits {splits!r} is not an int in "
                         f"[1, {_MAX_SPLITS}]")
    part = (torch.empty(B * H * splits * (HD + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    return splits, part


def _launch(name, q, k_pages, v_pages, block_tables, seq_lens, k_scale,
            v_scale, new_k=None, new_v=None, splits=None, grid_b=False):
    """Launch ``csrc/paged_decode.cu`` (``grid_b``, with the write) or
    ``csrc/paged_attention.cu`` (the write when ``new_k`` is given) and,
    with more than one split, the merge; returns the output.  A scale
    left None reaches the kernels as a null pointer (1.0), so bf16 pools
    need no tensor of ones."""
    _check(name, q, k_pages, v_pages, block_tables, seq_lens, new_k, new_v)
    B, H, HD = q.shape
    KV, N, P, _ = k_pages.shape
    MP = block_tables.shape[1]
    if k_pages.dtype == torch.int8:  # the rows are quantized with them
        k_scale, v_scale = _scales(k_scale, v_scale, KV, q.device)
    write = new_k is not None
    # cp.async and the row copies move 16-byte pieces of these
    staged = [("k_pages", k_pages), ("v_pages", v_pages)]
    if write:
        new_k, new_v = _rows(new_k, new_v, k_pages, k_scale, v_scale)
        staged += [("new_k", new_k), ("new_v", new_v)]
    scales = [(n, t) for n, t in (("k_scale", k_scale), ("v_scale", v_scale))
              if t is not None]
    _check_operands(name, q.device, staged + scales + [
        ("q", q), ("block_tables", block_tables), ("seq_lens", seq_lens)],
        scales)
    for tname, t in staged:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} is not 16-byte aligned")
    if not grid_b:
        smem = _smem_bytes(P, HD, H // KV, k_pages.element_size())
        if smem > SMEM_LIMIT:
            raise ValueError(f"{name}: page size {P} at head_dim {HD} needs "
                             f"{smem} bytes of shared memory (> "
                             f"{SMEM_LIMIT})")
    splits, part = _splits_and_scratch(splits, q, KV, MP)
    out = torch.empty_like(q)
    ptrs = [None if t is None else t.data_ptr()
            for t in (new_k, new_v, k_scale, v_scale, part)]
    pool = _build.DTYPE_CODES[k_pages.dtype]
    lib = _build.library()
    if grid_b:
        rc = lib.dv_paged_decode_update(
            q.data_ptr(), ptrs[0], ptrs[1], k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
            ptrs[2], ptrs[3], out.data_ptr(), ptrs[4], B, H, KV, N, P, MP,
            HD, _build.DTYPE_CODES[q.dtype], pool, splits, HD ** -0.5,
            _build.stream_ptr(q.device))
    else:
        rc = lib.dv_paged_attention(
            q.data_ptr(), ptrs[0], ptrs[1], k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
            ptrs[2], ptrs[3], out.data_ptr(), ptrs[4], B, H, KV, N, P, MP,
            HD, pool, int(write), splits, HD ** -0.5,
            _build.stream_ptr(q.device))
    _build.check(rc, name)
    return out


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                    k_scale=None, v_scale=None, splits=None):
    """Decode-step attention over a paged KV cache, read-only.

    Args:
      q: ``[B, H, HD]`` this step's queries (bf16 on CUDA).
      k_pages, v_pages: ``[KV, N, P, HD]`` shared page pools (bf16, or int8
        with ``k_scale``/``v_scale``).
      block_tables: ``[B, MP]`` int32 page ids (page 0 is the trash page;
        unused entries may be 0).
      seq_lens: ``[B]`` int32 lengths including the current token.
      k_scale, v_scale: ``[KV]`` float32 static scales (int8 pools).
      splits: blocks that share each sequence's columns on the card (None:
        :func:`decode_splits`); the plain version has no use for it.

    Returns ``[B, H, HD]``.
    """
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         seq_lens, k_scale, v_scale)
    out = _launch("paged_attention", q, k_pages, v_pages, block_tables,
                  seq_lens, k_scale, v_scale, splits=splits)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_update(q, new_k, new_v, k_pages, v_pages, block_tables,
                           seq_lens, *, k_scale=None, v_scale=None,
                           grid_mode: str = "b", splits=None):
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
      grid_mode: ``"b"`` launches ``csrc/paged_decode.cu`` (the engine's
        decode path); any other value the (B, KV)-grid kernel of
        ``csrc/paged_attention.cu``.  Both compute the same function.
      splits: blocks that share each sequence's columns on the card (None:
        :func:`decode_splits`); the plain version has no use for it.

    Returns ``(out [B, H, HD], k_pages, v_pages)`` (the same pool tensors).
    Launches are counted in ``paged_attention_update.launches`` (grid
    ``"b"``) and ``paged_attention_update.bkv_launches`` (the other).
    """
    if q.device.type == "cpu":
        return paged_attention_update_reference(
            q, new_k, new_v, k_pages, v_pages, block_tables, seq_lens,
            k_scale=k_scale, v_scale=v_scale)
    out = _launch("paged_attention_update", q, k_pages, v_pages,
                  block_tables, seq_lens, k_scale, v_scale, new_k, new_v,
                  splits, grid_b=grid_mode == "b")
    if grid_mode == "b":
        paged_attention_update.launches += 1
    else:
        paged_attention_update.bkv_launches += 1
    return out, k_pages, v_pages


paged_attention_update.launches = 0
paged_attention_update.bkv_launches = 0


def paged_decode_kernel_info(head_dim: int, pool_dtype, group: int) -> dict:
    """How the card runs ``csrc/paged_decode.cu``'s kernel for
    ``pool_dtype`` pools and a GQA group: registers a thread, shared
    memory and local (spill) bytes, blocks an SM and threads a block."""
    return _build.kernel_info("dv_paged_decode_info", head_dim,
                              _build.DTYPE_CODES[pool_dtype], group)


def paged_attention_kernel_info(head_dim: int, pool_dtype, write: bool,
                                page_size: int, group: int) -> dict:
    """The same for ``csrc/paged_attention.cu`` (#6 without the write, #7
    with it) at a page size and GQA group, which size its shared
    memory."""
    return _build.kernel_info("dv_paged_attention_info", head_dim,
                              _build.DTYPE_CODES[pool_dtype], int(write),
                              page_size, group)


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
