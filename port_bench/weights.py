"""Random weights from the seed, drawn on the device, one call a leaf.

The tree has the program's leaf names and stacked ``[L, ...]`` shapes,
which both the program and the reference take; each matrix is normal with
variance ``1 / fan_in``, the norms' scales are zero (RMSNorm multiplies by
``1 + scale``).  The draws are the benchmark's own, not the program's
``init_params``.
"""

from __future__ import annotations

import torch


def make_params(cfg: dict, seed: int, device, dtype) -> dict:
    D, F, HD = cfg["d_model"], cfg["d_ff"], cfg["head_dim"]
    H, KV, L, V = (cfg["n_heads"], cfg["n_kv_heads"], cfg["n_layers"],
                   cfg["vocab_size"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return w.mul_(fan_in ** -0.5).to(dtype)

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    params = {
        "embed": normal((V, D), D),
        "final_norm": zeros((D,)),
        "blocks": {
            "ln1": zeros((L, D)),
            "ln2": zeros((L, D)),
            "wq": normal((L, D, H * HD), D),
            "wk": normal((L, D, KV * HD), D),
            "wv": normal((L, D, KV * HD), D),
            "wo": normal((L, H * HD, D), H * HD),
            "w_gate": normal((L, D, F), D),
            "w_up": normal((L, D, F), D),
            "w_down": normal((L, F, D), F),
        },
    }
    if not cfg["tie_embeddings"]:
        params["lm_head"] = normal((D, V), D)
    return params


def leaves(tree: dict, prefix: str = ""):
    """``(path, tensor)`` of every leaf, in sorted order."""
    for name in sorted(tree):
        leaf = tree[name]
        if isinstance(leaf, dict):
            yield from leaves(leaf, f"{prefix}{name}/")
        else:
            yield prefix + name, leaf
