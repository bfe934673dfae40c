"""Decoder-only transformer (Llama/Gemma family) for serving, in PyTorch.

Same parameter tree and the same bf16 rounding points as the JAX package's
``engine/model.py``: q/k/v and gate/up projections produce bf16, the
attention out-projection, the MLP down-projection and the logits are
computed in float32 from bf16 operands, RMSNorm, RoPE and SiLU run in
float32.  Attention goes through the kernels package: the flash kernel for
batched prefill, the paged chunk kernel for chunked prefill, the fused
paged kernel for decode (each runs its plain version on CPU tensors).  The
forwards write the KV pools in place.
"""

from __future__ import annotations

import torch

from deepvision_tpu_torch.engine.config import ModelConfig
from deepvision_tpu_torch.engine.kernels.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from deepvision_tpu_torch.engine.kernels.paged_attention import (
    paged_attention_update,
)
from deepvision_tpu_torch.engine.kernels.paged_chunk import (
    paged_chunk_attention,
)
from deepvision_tpu_torch.engine.kv_cache import (
    write_chunk_tokens,
    write_prefill_pages,
)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin of the rotary angles, ``[..., 1, head_dim // 2]`` each (a
    head axis to broadcast over).  Every layer rotates by the same
    positions, so a forward computes these once."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freq = 1.0 / torch.pow(theta, exps)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, rope) -> torch.Tensor:
    """Rotary embedding, rotate-half convention, in float32.

    x: ``[..., n_heads, head_dim]``; ``rope``: :func:`rope_tables` of
    positions broadcastable to ``x.shape[:-2]``.
    """
    cos, sin = rope
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def qdot(x: torch.Tensor, w: torch.Tensor,
         out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ w`` with JAX's ``preferred_element_type`` semantics: a float32
    result (or any float32 operand) multiplies in float32, where products
    of bf16 values are exact; otherwise a bf16 product rounded once."""
    if out_dtype == torch.float32 or torch.float32 in (x.dtype, w.dtype):
        return torch.matmul(x.float(), w.float()).to(out_dtype)
    return torch.matmul(x, w.to(x.dtype)).to(out_dtype)


def _qkv_proj(h, blk, dtype=torch.bfloat16):
    return (qdot(h, blk["wq"], dtype), qdot(h, blk["wk"], dtype),
            qdot(h, blk["wv"], dtype))


def _mlp(x, blk, compute_dtype=torch.bfloat16):
    gate = qdot(x, blk["w_gate"], compute_dtype)
    up = qdot(x, blk["w_up"], compute_dtype)
    h = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return qdot(h, blk["w_down"], torch.float32).to(x.dtype)


def _embed(params, tokens, dtype=torch.bfloat16):
    return params["embed"][tokens.long()].to(dtype)


def _logits(x, params, cfg: ModelConfig):
    """x: [..., D] final hidden -> float32 logits [..., V]."""
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x.float(), w.float())
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _layer(params, i: int) -> dict:
    return {name: leaf[i] for name, leaf in params["blocks"].items()}


def _kv_scales(cache, i: int):
    if "ks" in cache:
        return cache["ks"][i], cache["vs"][i]
    return None, None


def _scaled_embed(params, tokens, cfg, dtype=torch.bfloat16):
    x = _embed(params, tokens, dtype)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


# ---------------------------------------------------------------------------
# Serving forwards
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward_prefill(params, cache, tokens, seq_lens, prefill_pages, *,
                    cfg: ModelConfig):
    """Run right-padded prompts through the model, writing their K/V pages.

    Args:
      tokens: ``[B, S]`` int32, S a multiple of the page size.
      seq_lens: ``[B]`` int32 true lengths.
      prefill_pages: ``[B, S // page]`` destination page ids (0 = trash).

    Returns ``last_logits [B, V]`` (float32) at each row's last position;
    the cache's pools are updated in place.
    """
    B, S = tokens.shape
    HD = cfg.head_dim
    x = _scaled_embed(params, tokens, cfg)
    rope = rope_tables(torch.arange(S, device=tokens.device), HD,
                       cfg.rope_theta)
    for i in range(cfg.n_layers):
        blk = _layer(params, i)
        h = rms_norm(x, blk["ln1"], cfg.rms_eps)
        q, k, v = _qkv_proj(h, blk)
        q = apply_rope(q.reshape(B, S, -1, HD), rope)
        k = apply_rope(k.reshape(B, S, -1, HD), rope)
        v = v.reshape(B, S, -1, HD)
        ksc, vsc = _kv_scales(cache, i)
        write_prefill_pages(cache["k"][i], cache["v"][i], k, v,
                            prefill_pages, k_scale=ksc, v_scale=vsc)
        attn = flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), seq_lens)   # [B, H, S, HD]
        attn = attn.transpose(1, 2).reshape(B, S, -1)
        x = x + qdot(attn, blk["wo"], torch.float32).to(x.dtype)
        x = x + _mlp(rms_norm(x, blk["ln2"], cfg.rms_eps), blk)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    last = x[torch.arange(B, device=x.device), seq_lens.long() - 1]
    return _logits(last, params, cfg)


@torch.no_grad()
def forward_prefill_chunk(params, cache, tokens, chunk_starts, seq_lens,
                          block_tables, *, cfg: ModelConfig):
    """One chunk of chunked prefill: write the chunk's K/V rows, then attend
    over every page up to each query's position.

    Args:
      tokens: ``[B, C]`` int32 this chunk's tokens (0-padded tail).
      chunk_starts: ``[B]`` int32 absolute position of ``tokens[:, 0]``.
      seq_lens: ``[B]`` int32 total prompt lengths.
      block_tables: ``[B, MAX_PAGES]`` int32.

    Returns ``last_logits [B, V]`` (float32) of the row at
    ``seq_lens - 1`` (meaningful on a prompt's last chunk); the pools are
    updated in place.
    """
    B, C = tokens.shape
    HD = cfg.head_dim
    x = _scaled_embed(params, tokens, cfg)
    positions = (chunk_starts.long()[:, None]
                 + torch.arange(C, device=tokens.device)[None, :])
    rope = rope_tables(positions, HD, cfg.rope_theta)
    chunk_end = torch.minimum(chunk_starts + C, seq_lens).to(torch.int32)
    for i in range(cfg.n_layers):
        blk = _layer(params, i)
        h = rms_norm(x, blk["ln1"], cfg.rms_eps)
        q, k, v = _qkv_proj(h, blk)
        q = apply_rope(q.reshape(B, C, -1, HD), rope)
        k = apply_rope(k.reshape(B, C, -1, HD), rope)
        v = v.reshape(B, C, -1, HD)
        ksc, vsc = _kv_scales(cache, i)
        write_chunk_tokens(cache["k"][i], cache["v"][i], k, v, block_tables,
                           positions, seq_lens, k_scale=ksc, v_scale=vsc)
        attn = paged_chunk_attention(
            q.contiguous(), cache["k"][i], cache["v"][i], block_tables,
            chunk_starts, chunk_end, k_scale=ksc, v_scale=vsc)
        x = x + qdot(attn.reshape(B, C, -1), blk["wo"],
                     torch.float32).to(x.dtype)
        x = x + _mlp(rms_norm(x, blk["ln2"], cfg.rms_eps), blk)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    last_row = (seq_lens.long() - 1 - chunk_starts.long()).clamp(0, C - 1)
    last = x[torch.arange(B, device=x.device), last_row]
    return _logits(last, params, cfg)


@torch.no_grad()
def forward_decode(params, cache, tokens, seq_lens, block_tables, *,
                   cfg: ModelConfig):
    """One continuous-batching decode step.

    Args:
      tokens: ``[B]`` int32 current tokens.
      seq_lens: ``[B]`` int32 lengths INCLUDING the current token.
      block_tables: ``[B, MAX_PAGES]`` int32.

    Returns ``logits [B, V]`` (float32); each layer's fused kernel writes
    the token's K/V row into the pools in place.
    """
    B = tokens.shape[0]
    HD = cfg.head_dim
    x = _scaled_embed(params, tokens, cfg)
    rope = rope_tables(seq_lens - 1, HD, cfg.rope_theta)
    for i in range(cfg.n_layers):
        blk = _layer(params, i)
        h = rms_norm(x, blk["ln1"], cfg.rms_eps)
        q, k, v = _qkv_proj(h, blk)
        q = apply_rope(q.reshape(B, -1, HD), rope)
        k = apply_rope(k.reshape(B, -1, HD), rope)
        v = v.reshape(B, -1, HD)
        ksc, vsc = _kv_scales(cache, i)
        attn, _, _ = paged_attention_update(
            q.contiguous(), k.contiguous(), v.contiguous(), cache["k"][i],
            cache["v"][i], block_tables, seq_lens, k_scale=ksc, v_scale=vsc)
        x = x + qdot(attn.reshape(B, -1), blk["wo"],
                     torch.float32).to(x.dtype)
        x = x + _mlp(rms_norm(x, blk["ln2"], cfg.rms_eps), blk)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _logits(x, params, cfg)


# ---------------------------------------------------------------------------
# Full-sequence forward (no cache)
# ---------------------------------------------------------------------------

def forward_train(params, tokens, *, cfg: ModelConfig,
                  act_dtype=torch.bfloat16, use_kernel: bool = False):
    """Full-sequence forward returning ``[B, S, V]`` float32 logits;
    differentiable in the params (the training step's forward).

    ``use_kernel=True`` runs attention through :func:`flash_attention`
    (the flash kernels, differentiable through their backward kernels);
    ``False`` through the plain :func:`flash_attention_reference`, which
    autograd differentiates densely.  ``act_dtype=torch.float32`` gives the
    JAX package's f32 parity mode.  Callers that only score wrap it in
    ``torch.no_grad()``."""
    attn_fn = flash_attention if use_kernel else flash_attention_reference
    B, S = tokens.shape
    HD = cfg.head_dim
    x = _scaled_embed(params, tokens, cfg, act_dtype)
    rope = rope_tables(torch.arange(S, device=tokens.device), HD,
                       cfg.rope_theta)
    seq_lens = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    for i in range(cfg.n_layers):
        blk = _layer(params, i)
        h = rms_norm(x, blk["ln1"], cfg.rms_eps)
        q, k, v = _qkv_proj(h, blk, act_dtype)
        q = apply_rope(q.reshape(B, S, -1, HD), rope)
        k = apply_rope(k.reshape(B, S, -1, HD), rope)
        v = v.reshape(B, S, -1, HD)
        attn = attn_fn(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), seq_lens)
        attn = attn.transpose(1, 2).reshape(B, S, -1)
        x = x + qdot(attn, blk["wo"], torch.float32).to(x.dtype)
        x = x + _mlp(rms_norm(x, blk["ln2"], cfg.rms_eps), blk, act_dtype)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _logits(x, params, cfg)
