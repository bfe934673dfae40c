"""Decoder-only transformer (Llama/Gemma family) for serving, in PyTorch.

Same parameter tree and the same bf16 rounding points as the JAX package's
``engine/model.py``: q/k/v and gate/up projections produce bf16, the
attention out-projection, the MLP down-projection and the logits are
computed in float32 from bf16 operands, RMSNorm, RoPE and SiLU run in
float32.  The params may carry the serving transforms of the JAX
package: int8 weights (engine/quant.py, taken through ``qdot``'s dict
form) and the fused ``w_qkv`` / ``w_gate_up`` leaves (engine/fuse.py).
Attention goes through the kernels package: the flash kernel for
batched prefill, the paged chunk kernel for chunked prefill, the fused
paged kernel for decode (each runs its plain version on CPU tensors).  The
forwards write the KV pools in place.

The serving forwards also run as one rank of a tensor-parallel group
(``group``, a :class:`~deepvision_tpu_torch.engine.parallel.TPGroup`; None
for one device), as the JAX forwards do under ``shard_map`` with
``axis="model"``: the params are the rank's shard
(``parallel.shard_params``), the local head counts come from the weights'
shapes, an ``all_reduce`` sums the attention out-projection's and the MLP
down-projection's partial products, and with ``vocab_sharded`` the
embedding sums the owner rank's rows and the logits are the rank's own
slice of the vocab.
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


def qdot(x: torch.Tensor, w, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ w`` for a plain weight or an int8 weight dict (engine/quant.py).

    Plain weights follow JAX's ``preferred_element_type``: a float32 result
    (or any float32 operand) multiplies in float32, where products of bf16
    values are exact; otherwise a bf16 product rounded once.  For
    ``{"q8", "scale"}`` weights, as the JAX package's ``qdot``: ``x`` as
    bf16 times ``q8`` as bf16 with a float32 result, then the
    per-output-channel scale multiplies that float32 result, and only the
    scaled result is rounded to ``out_dtype``."""
    if isinstance(w, dict):
        return (_q8_matmul(x, w["q8"]) * w["scale"]).to(out_dtype)
    if out_dtype == torch.float32 or torch.float32 in (x.dtype, w.dtype):
        return torch.matmul(x.float(), w.float()).to(out_dtype)
    return torch.matmul(x, w.to(x.dtype)).to(out_dtype)


def _q8_matmul(x: torch.Tensor, q8: torch.Tensor) -> torch.Tensor:
    """``bf16(x) @ bf16(q8)`` accumulated and returned in float32.  On the
    card one bf16 GEMM with a float32 output (``torch.mm(...,
    out_dtype=torch.float32)``); on the CPU, which has no such GEMM, the
    same products in a float32 matmul (bf16 values multiply exactly in
    float32)."""
    xb = x.to(torch.bfloat16)
    if xb.is_cuda:
        y = torch.mm(xb.reshape(-1, xb.shape[-1]), q8.to(torch.bfloat16),
                     out_dtype=torch.float32)
        return y.reshape(*xb.shape[:-1], q8.shape[-1])
    return torch.matmul(xb.float(), q8.float())


def _qkv_proj(h, blk, cfg: ModelConfig, dtype=torch.bfloat16):
    """q/k/v projections; one matmul when the params carry the fused
    ``w_qkv`` leaf (engine/fuse.py), split by column."""
    if "w_qkv" in blk:
        qkv = qdot(h, blk["w_qkv"], dtype)
        q_w = cfg.n_heads * cfg.head_dim
        kv_w = cfg.n_kv_heads * cfg.head_dim
        return (qkv[..., :q_w], qkv[..., q_w:q_w + kv_w],
                qkv[..., q_w + kv_w:])
    return (qdot(h, blk["wq"], dtype), qdot(h, blk["wk"], dtype),
            qdot(h, blk["wv"], dtype))


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    return group.all_reduce(x) if group is not None else x


def _mlp(x, blk, compute_dtype=torch.bfloat16, group=None):
    if "w_gate_up" in blk:
        gu = qdot(x, blk["w_gate_up"], compute_dtype)
        F = gu.shape[-1] // 2
        gate, up = gu[..., :F], gu[..., F:]
    else:
        gate = qdot(x, blk["w_gate"], compute_dtype)
        up = qdot(x, blk["w_up"], compute_dtype)
    h = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return _psum(qdot(h, blk["w_down"], torch.float32), group).to(x.dtype)


def _embed(params, tokens, dtype=torch.bfloat16, group=None,
           vocab_sharded: bool = False):
    """Embedding lookup.  Vocab-sharded, each rank holds ``V / n`` rows:
    the owner rank contributes a token's row, the others zeros, and an
    ``all_reduce`` (exact: one addend is nonzero) gives every rank the
    row."""
    embed = params["embed"]
    if group is None or not vocab_sharded:
        return embed[tokens.long()].to(dtype)
    v_local = embed.shape[0]
    local = tokens.long() - group.rank * v_local
    owns = (local >= 0) & (local < v_local)
    rows = embed[local.clamp(0, v_local - 1)].float()
    rows = torch.where(owns[..., None], rows, torch.zeros_like(rows))
    return group.all_reduce(rows).to(dtype)


def _logits(x, params, cfg: ModelConfig):
    """x: [..., D] final hidden -> float32 logits [..., V] (the rank's
    ``[..., V / n]`` slice under vocab sharding: the embedding or the
    untied ``lm_head`` it multiplies is the rank's shard)."""
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    if isinstance(w, dict):    # an int8 untied lm_head
        logits = qdot(x, w, torch.float32)
    else:
        logits = torch.matmul(x.float(), w.float())
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _layer(params, i: int) -> dict:
    """Layer ``i``'s block leaves; an int8 leaf ``{"q8", "scale"}`` is
    indexed inside."""
    return {name: ({k: t[i] for k, t in leaf.items()}
                   if isinstance(leaf, dict) else leaf[i])
            for name, leaf in params["blocks"].items()}


def _kv_scales(cache, i: int):
    if "ks" in cache:
        return cache["ks"][i], cache["vs"][i]
    return None, None


def _scaled_embed(params, tokens, cfg, dtype=torch.bfloat16, group=None,
                  vocab_sharded: bool = False):
    x = _embed(params, tokens, dtype, group, vocab_sharded)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


# ---------------------------------------------------------------------------
# Serving forwards
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward_prefill(params, cache, tokens, seq_lens, prefill_pages, *,
                    cfg: ModelConfig, group=None,
                    vocab_sharded: bool = False):
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
    x = _scaled_embed(params, tokens, cfg, group=group,
                      vocab_sharded=vocab_sharded)
    rope = rope_tables(torch.arange(S, device=tokens.device), HD,
                       cfg.rope_theta)
    for i in range(cfg.n_layers):
        blk = _layer(params, i)
        h = rms_norm(x, blk["ln1"], cfg.rms_eps)
        q, k, v = _qkv_proj(h, blk, cfg)
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
        x = x + _psum(qdot(attn, blk["wo"], torch.float32),
                     group).to(x.dtype)
        x = x + _mlp(rms_norm(x, blk["ln2"], cfg.rms_eps), blk,
                     group=group)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    last = x[torch.arange(B, device=x.device), seq_lens.long() - 1]
    return _logits(last, params, cfg)


@torch.no_grad()
def forward_prefill_chunk(params, cache, tokens, chunk_starts, seq_lens,
                          block_tables, *, cfg: ModelConfig, group=None,
                          vocab_sharded: bool = False):
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
    x = _scaled_embed(params, tokens, cfg, group=group,
                      vocab_sharded=vocab_sharded)
    positions = (chunk_starts.long()[:, None]
                 + torch.arange(C, device=tokens.device)[None, :])
    rope = rope_tables(positions, HD, cfg.rope_theta)
    chunk_end = torch.minimum(chunk_starts + C, seq_lens).to(torch.int32)
    for i in range(cfg.n_layers):
        blk = _layer(params, i)
        h = rms_norm(x, blk["ln1"], cfg.rms_eps)
        q, k, v = _qkv_proj(h, blk, cfg)
        q = apply_rope(q.reshape(B, C, -1, HD), rope)
        k = apply_rope(k.reshape(B, C, -1, HD), rope)
        v = v.reshape(B, C, -1, HD)
        ksc, vsc = _kv_scales(cache, i)
        write_chunk_tokens(cache["k"][i], cache["v"][i], k, v, block_tables,
                           positions, seq_lens, k_scale=ksc, v_scale=vsc)
        attn = paged_chunk_attention(
            q.contiguous(), cache["k"][i], cache["v"][i], block_tables,
            chunk_starts, chunk_end, k_scale=ksc, v_scale=vsc)
        x = x + _psum(qdot(attn.reshape(B, C, -1), blk["wo"],
                           torch.float32), group).to(x.dtype)
        x = x + _mlp(rms_norm(x, blk["ln2"], cfg.rms_eps), blk,
                     group=group)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    last_row = (seq_lens.long() - 1 - chunk_starts.long()).clamp(0, C - 1)
    last = x[torch.arange(B, device=x.device), last_row]
    return _logits(last, params, cfg)


@torch.no_grad()
def forward_decode(params, cache, tokens, seq_lens, block_tables, *,
                   cfg: ModelConfig, splits=None, group=None,
                   vocab_sharded: bool = False):
    """One continuous-batching decode step.

    Args:
      tokens: ``[B]`` int32 current tokens.
      seq_lens: ``[B]`` int32 lengths INCLUDING the current token.
      block_tables: ``[B, MAX_PAGES]`` int32.
      splits: the decode kernel's column splits on the card (None: chosen
        from B by the kernel's wrapper); the CPU path has no use for it.

    Returns ``logits [B, V]`` (float32); each layer's fused kernel writes
    the token's K/V row into the pools in place.
    """
    B = tokens.shape[0]
    HD = cfg.head_dim
    x = _scaled_embed(params, tokens, cfg, group=group,
                      vocab_sharded=vocab_sharded)
    rope = rope_tables(seq_lens - 1, HD, cfg.rope_theta)
    for i in range(cfg.n_layers):
        blk = _layer(params, i)
        h = rms_norm(x, blk["ln1"], cfg.rms_eps)
        q, k, v = _qkv_proj(h, blk, cfg)
        q = apply_rope(q.reshape(B, -1, HD), rope)
        k = apply_rope(k.reshape(B, -1, HD), rope)
        v = v.reshape(B, -1, HD)
        ksc, vsc = _kv_scales(cache, i)
        attn, _, _ = paged_attention_update(
            q.contiguous(), k.contiguous(), v.contiguous(), cache["k"][i],
            cache["v"][i], block_tables, seq_lens, k_scale=ksc, v_scale=vsc,
            splits=splits)
        x = x + _psum(qdot(attn.reshape(B, -1), blk["wo"],
                           torch.float32), group).to(x.dtype)
        x = x + _mlp(rms_norm(x, blk["ln2"], cfg.rms_eps), blk,
                     group=group)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _logits(x, params, cfg)


@torch.no_grad()
def calibrate_kv_scales(params, tokens, *, cfg: ModelConfig,
                        margin: float = 1.25):
    """Static int8 KV scales from one representative forward, as the JAX
    package's ``calibrate_kv_scales``.

    Runs the layer stack once over ``tokens [B, S]`` with the plain dense
    attention (later layers' K/V must come from real attention) and returns
    ``(k_scales [L, KV], v_scales [L, KV])`` float32, ``scale = margin *
    maxabs / 127`` (at least 1e-6).  K is measured after RoPE, as the pools
    store it.
    """
    B, S = tokens.shape
    HD = cfg.head_dim
    x = _scaled_embed(params, tokens, cfg)
    rope = rope_tables(torch.arange(S, device=tokens.device), HD,
                       cfg.rope_theta)
    seq_lens = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    k_maxes, v_maxes = [], []
    for i in range(cfg.n_layers):
        blk = _layer(params, i)
        h = rms_norm(x, blk["ln1"], cfg.rms_eps)
        q, k, v = _qkv_proj(h, blk, cfg)
        q = apply_rope(q.reshape(B, S, -1, HD), rope)
        k = apply_rope(k.reshape(B, S, -1, HD), rope)
        v = v.reshape(B, S, -1, HD)
        k_maxes.append(k.float().abs().amax(dim=(0, 1, 3)))
        v_maxes.append(v.float().abs().amax(dim=(0, 1, 3)))
        attn = flash_attention_reference(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), seq_lens)
        attn = attn.transpose(1, 2).reshape(B, S, -1)
        x = x + qdot(attn, blk["wo"], torch.float32).to(x.dtype)
        x = x + _mlp(rms_norm(x, blk["ln2"], cfg.rms_eps), blk)
    k_scales = torch.clamp(torch.stack(k_maxes) * margin / 127.0, min=1e-6)
    v_scales = torch.clamp(torch.stack(v_maxes) * margin / 127.0, min=1e-6)
    return k_scales, v_scales


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
        q, k, v = _qkv_proj(h, blk, cfg, act_dtype)
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
