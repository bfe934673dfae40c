"""Causal GQA flash attention, forward and backward: CUDA kernels + plain
versions.

``flash_attention`` replaces the JAX package's Pallas kernels in
``deepvision_tpu/engine/kernels/flash_attention.py``: ``_flash_kernel``
(forward, ``csrc/flash_fwd.cu``), and, through a ``torch.autograd.Function``
that stands where the JAX ``custom_vjp`` does, ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel`` (``csrc/flash_bwd.cu``).  The design notes, the
bound on this card and what is left for later are in those files' headers.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
its plain version (``*_reference``, written as explicit formulas).  It
never falls back from one to the other.  Each wrapper counts its kernel
launches in ``<wrapper>.launches``.
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

    Differentiable in q, k and v when autograd records (the forward then
    also keeps the row logsumexp for the backward kernels).  As in the JAX
    package, the cotangent of a row past ``seq_lens`` reaches dQ but never
    dK or dV.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, seq_lens)
    return flash_forward(q, k, v, seq_lens)[0]


flash_attention.launches = 0


def flash_forward(q, k, v, seq_lens, *, with_lse: bool = False):
    """The forward kernel: ``(out, lse)``; ``lse [B, H, S]`` float32 (the
    row logsumexp of the scaled scores) only when ``with_lse``, else None.
    Launches are counted in ``flash_attention.launches``."""
    if q.device.type == "cpu":
        out = flash_attention_reference(q, k, v, seq_lens)
        lse = row_logsumexp_reference(q, k, seq_lens) if with_lse else None
        return out, lse
    B, H, S, HD = _check("flash_attention", q, k, v, seq_lens)
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, S, dtype=torch.float32, device=q.device)
           if with_lse else None)
    rc = _build.library().dv_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), lse.data_ptr() if with_lse else None,
        B, H, k.shape[1], S, HD, _build.DTYPE_CODES[q.dtype], HD ** -0.5,
        _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, seq_lens, dout, lse, delta) -> torch.Tensor:
    """dQ of :func:`flash_attention` (every row, padded ones included),
    from the forward's ``lse`` and ``delta = rowsum(dout * out)``, both
    ``[B, H, S]`` float32.  Output in q's dtype."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, seq_lens, dout, lse, delta)
    B, H, S, HD = _check("flash_bwd_dq", q, k, v, seq_lens, dout, lse, delta)
    dq = torch.empty_like(q)
    rc = _build.library().dv_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), seq_lens.data_ptr(), dq.data_ptr(),
        B, H, k.shape[1], S, HD, _build.DTYPE_CODES[q.dtype], HD ** -0.5,
        _build.stream_ptr(q.device))
    _build.check(rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, seq_lens, dout, lse, delta):
    """``(dK, dV)`` of :func:`flash_attention`, summed over each kv head's
    query group, with rows past ``seq_lens`` masked.  Outputs in k's
    dtype."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, seq_lens, dout, lse, delta)
    B, H, S, HD = _check("flash_bwd_dkv", q, k, v, seq_lens, dout, lse,
                         delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _build.library().dv_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), seq_lens.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, H, k.shape[1], S, HD, _build.DTYPE_CODES[q.dtype],
        HD ** -0.5, _build.stream_ptr(q.device))
    _build.check(rc, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_fwd_kernel_info(head_dim: int, dtype) -> dict:
    """How the card runs the forward kernel of ``dtype`` (the bf16
    tensor-core or the float32 CUDA-core route): registers a thread,
    dynamic shared memory and local (spill) bytes, blocks an SM and threads
    a block."""
    return _build.kernel_info("dv_flash_fwd_info", head_dim,
                              _build.DTYPE_CODES[dtype])


def flash_bwd_kernel_info(kind: str, head_dim: int, dtype) -> dict:
    """How the card runs one backward kernel (``kind`` "dq" or "dkv"), as
    :func:`flash_fwd_kernel_info` reports the forward."""
    return _build.kernel_info("dv_flash_bwd_info", int(kind == "dq"),
                              head_dim, _build.DTYPE_CODES[dtype])


def flash_bwd_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``D = rowsum(dout * out)`` in float32 (or wider) from the output in
    its own dtype, as the JAX backward computes it outside its kernels."""
    return (_acc(dout) * _acc(out)).sum(dim=-1)


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``custom_vjp`` around the flash kernels: the
    forward keeps ``q, k, v, out`` and the row logsumexp; the backward
    runs the dQ and the dK/dV kernels.  ``seq_lens`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seq_lens):
        out, lse = flash_forward(q, k, v, seq_lens, with_lse=True)
        ctx.save_for_backward(q, k, v, seq_lens, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, seq_lens, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        delta = flash_bwd_delta(out, dout)
        dq = flash_bwd_dq(q, k, v, seq_lens, dout, lse, delta)
        dk, dv = flash_bwd_dkv(q, k, v, seq_lens, dout, lse, delta)
        return dq, dk, dv, None


def _check(name, q, k, v, seq_lens, dout=None, lse=None, delta=None):
    """Shapes, dtypes, device and layout a kernel takes; returns
    ``(B, H, S, HD)``."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, H, S, HD = q.shape
    KV = k.shape[1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: q dtype {q.dtype} not bf16/f32")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share a dtype")
    if k.shape != (B, KV, S, HD) or v.shape != k.shape or H % KV:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if HD not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {HD} not in {HEAD_DIMS}")
    if seq_lens.dtype != torch.int32 or seq_lens.shape != (B,):
        raise TypeError(f"{name}: seq_lens must be int32 [B]")
    tensors = {"q": q, "k": k, "v": v, "seq_lens": seq_lens}
    if dout is not None:
        if dout.shape != q.shape or dout.dtype != q.dtype:
            raise ValueError(f"{name}: dout must match q's shape and dtype")
        for t_name, t in (("lse", lse), ("delta", delta)):
            if t.shape != (B, H, S) or t.dtype != torch.float32:
                raise ValueError(f"{name}: {t_name} must be float32 "
                                 f"[B, H, S]")
        tensors.update(dout=dout, lse=lse, delta=delta)
    for t_name, t in tensors.items():
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous on "
                             f"{q.device}")
        if t_name in ("q", "k", "v", "dout") and t.data_ptr() % 16:
            raise ValueError(f"{name}: {t_name} must be 16-byte aligned")
    return B, H, S, HD


# ---------------------------------------------------------------------------
# Plain versions (CPU; the yardstick the card's kernels are held against)
# ---------------------------------------------------------------------------

def _acc(x: torch.Tensor) -> torch.Tensor:
    """Accumulation dtype: float32, or float64 for float64 inputs."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _masks(S, seq_lens, device):
    """``(cols, rows)`` masks ``[B, 1, S, S]``: ``cols`` is the forward's
    (causal and ``c < len``), ``rows`` adds ``r < len``."""
    idx = torch.arange(S, device=device)
    lens = seq_lens.to(device).long()
    causal = idx[None, :] <= idx[:, None]
    cols = (causal[None] & (idx[None, None, :] < lens[:, None, None]))[:, None]
    rows = cols & (idx[None, :, None] < lens[:, None, None])[:, None]
    return cols, rows


def _scores(q, k):
    """Scaled scores ``(q * HD^-0.5) . k`` ``[B, H, S, S]`` (q scaled first,
    as the backward kernels do) with k's heads repeated over the GQA
    group."""
    H, HD = q.shape[1], q.shape[-1]
    kf = _acc(k).repeat_interleave(H // k.shape[1], dim=1)
    return torch.einsum("bhqd,bhkd->bhqk", _acc(q) * (HD ** -0.5), kf)


def flash_attention_reference(q, k, v, seq_lens):
    """Plain PyTorch version: dense fp32 scores, masked softmax.  Rows with
    no valid column give 0, as the kernel's ``l == 0 -> 1`` does."""
    B, H, S, HD = q.shape
    KV = k.shape[1]
    kf = _acc(k).repeat_interleave(H // KV, dim=1)
    vf = _acc(v).repeat_interleave(H // KV, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", _acc(q), kf) * (HD ** -0.5)
    mask, _ = _masks(S, seq_lens, q.device)
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1) * mask.any(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def row_logsumexp_reference(q, k, seq_lens):
    """Row logsumexp ``[B, H, S]`` of the scaled, masked scores, rows past
    ``seq_lens`` included (the JAX package's ``_row_logsumexp``); a row
    with no valid column gives ``-1e30 + log 1``."""
    S = q.shape[2]
    mask, _ = _masks(S, seq_lens, q.device)
    s = _scores(q, k)
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)
    l_sum = (torch.exp(s - m[..., None]) * mask).sum(dim=-1)
    return m + torch.log(torch.where(l_sum == 0, torch.ones_like(l_sum),
                                     l_sum))


def _probs_and_ds(q, k, v, seq_lens, dout, lse, delta, mask_rows: bool):
    S = q.shape[2]
    cols, rows = _masks(S, seq_lens, q.device)
    mask = rows if mask_rows else cols
    s = _scores(q, k)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    vf = _acc(v).repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    dp = torch.einsum("bhqd,bhkd->bhqk", _acc(dout), vf)
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_reference(q, k, v, seq_lens, dout, lse, delta):
    """Plain dQ: ``p = exp(s - lse)`` under the forward's mask (rows past
    ``seq_lens`` not masked, as in the JAX dQ kernel),
    ``dS = p * (dO . v - D)``, ``dQ = scale * dS . k``."""
    H, HD = q.shape[1], q.shape[-1]
    _, ds = _probs_and_ds(q, k, v, seq_lens, dout, lse, delta, False)
    kf = _acc(k).repeat_interleave(H // k.shape[1], dim=1)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, kf)
            * (HD ** -0.5)).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, seq_lens, dout, lse, delta):
    """Plain dK/dV: the dQ formulas with rows past ``seq_lens`` masked too,
    ``dV = p^T . dO`` and ``dK = dS^T . (q * scale)``, each summed over the
    kv head's query group."""
    B, H, S, HD = q.shape
    KV = k.shape[1]
    p, ds = _probs_and_ds(q, k, v, seq_lens, dout, lse, delta, True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, _acc(dout))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _acc(q) * (HD ** -0.5))
    G = H // KV
    return (dk.reshape(B, KV, G, S, HD).sum(2).to(k.dtype),
            dv.reshape(B, KV, G, S, HD).sum(2).to(v.dtype))
