"""Projection fusion for serving: one matmul where three would run.

A copy of the JAX package's ``engine/fuse.py`` on torch tensors: ``wq|wk|wv``
become one ``w_qkv [L, D, (H + 2 KV) HD]`` and ``w_gate|w_up`` one
``w_gate_up [L, D, 2 F]``, concatenated along the output axis.  Each
output column is the same dot product as before; the model splits the
fused result by column.  In the port's eager forwards this turns five
matmul launches a layer into two.

Single-device serving only (the engine keeps unfused weights when
``tp > 1``).  Composes with int8: fuse first, then quantize.
"""

from __future__ import annotations

import torch

from deepvision_tpu_torch.engine.config import ModelConfig


def fuse_params(params: dict, cfg: ModelConfig) -> dict:
    """The params tree with ``w_qkv`` / ``w_gate_up`` in place of the
    separate projection leaves.  The leaves must be plain tensors
    (quantize after fusing)."""
    blocks = dict(params["blocks"])
    for name in ("wq", "wk", "wv", "w_gate", "w_up"):
        if isinstance(blocks.get(name), dict):
            raise ValueError("fuse_params must run before quantize_params")
    blocks["w_qkv"] = torch.cat(
        [blocks.pop("wq"), blocks.pop("wk"), blocks.pop("wv")], dim=-1)
    blocks["w_gate_up"] = torch.cat(
        [blocks.pop("w_gate"), blocks.pop("w_up")], dim=-1)
    out = dict(params)
    out["blocks"] = blocks
    return out


def is_fused(params: dict) -> bool:
    return "w_qkv" in params.get("blocks", {})
