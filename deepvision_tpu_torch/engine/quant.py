"""Int8 weight-only quantization for serving (per-output-channel symmetric).

A copy of the JAX package's ``engine/quant.py`` on torch tensors.  A block
matmul weight ``[..., in, out]`` becomes ``{"q8": int8 [..., in, out],
"scale": float32 [..., out]}`` with ``w ≈ q8 * scale``; the model's
``qdot`` multiplies bf16 activations by ``q8`` as bf16 with a float32
result and scales that result per output channel.  Embeddings and norm
scales keep their dtype; an untied ``lm_head`` is quantized too.

Weight-only: activations stay bf16, and no calibration data is needed.
The quantizer computes in float32 and rounds half to even, as
``jnp.round`` does, so the same weights give the same ``q8`` bit for bit
in both packages.
"""

from __future__ import annotations

import torch

# Block weight leaves that are matmul operands (norm scales stay as they
# are), the fused-projection leaves (engine/fuse.py) among them: fuse
# first, then quantize; per-output-channel scales concatenate along the
# fused axis.
QUANT_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                "w_qkv", "w_gate_up")

_INT8_MAX = 127.0


def quantize_weight(w: torch.Tensor) -> dict:
    """Quantize one matmul weight ``[..., in, out]`` to int8.

    Returns ``{"q8": int8 [..., in, out], "scale": float32 [..., out]}``
    (the scale folded by 1/127, so dequantizing is one multiply).
    """
    wf = w.detach().float()
    amax = wf.abs().amax(dim=-2)                          # [..., out]
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / _INT8_MAX
    q = torch.clamp(torch.round(wf / scale[..., None, :]),
                    -_INT8_MAX, _INT8_MAX).to(torch.int8)
    return {"q8": q, "scale": scale}


def dequantize_weight(qw: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return (qw["q8"].float() * qw["scale"][..., None, :]).to(dtype)


def is_quantized_weight(w) -> bool:
    return isinstance(w, dict) and "q8" in w


def quantize_params(params: dict) -> dict:
    """The params tree with its block matmul weights and an untied
    ``lm_head`` quantized to int8 (see :func:`quantize_weight`)."""
    out = dict(params)
    blocks = dict(params["blocks"])
    for name in QUANT_LEAVES:
        if name in blocks:
            blocks[name] = quantize_weight(blocks[name])
    out["blocks"] = blocks
    if "lm_head" in params:
        out["lm_head"] = quantize_weight(params["lm_head"])
    return out


def dequantize_params(params: dict, dtype=torch.bfloat16) -> dict:
    out = dict(params)
    blocks = dict(params["blocks"])
    for name, leaf in blocks.items():
        if is_quantized_weight(leaf):
            blocks[name] = dequantize_weight(leaf, dtype)
    out["blocks"] = blocks
    if is_quantized_weight(out.get("lm_head")):
        out["lm_head"] = dequantize_weight(out["lm_head"], dtype)
    return out


def is_quantized(params: dict) -> bool:
    """True when the tree carries int8 block weights."""
    blocks = params.get("blocks", {})
    return any(is_quantized_weight(blocks.get(n)) for n in QUANT_LEAVES)
