"""Model architecture configuration and presets.

A copy of the JAX package's presets (same names, same shapes), kept here so
the PyTorch port imports nothing from the JAX package.  A checkpoint written
by either package loads in the other because the shapes below are shared.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decoder-only transformer architecture (Llama/Gemma family).

    Every serving entry point pads to a small set of static shapes per
    (model, batch-bucket, length-bucket).
    """

    name: str
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = True
    # Gemma-style sqrt(d_model) embedding scaling.
    scale_embeddings: bool = False
    # Soft-cap on final logits (Gemma-2 style); 0 disables.
    logit_softcap: float = 0.0

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0, "GQA group must divide heads"

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def kv_bytes_per_token_bf16(self) -> int:
        return 2 * self.n_layers * self.n_kv_heads * self.head_dim * 2


# ---------------------------------------------------------------------------
# Presets.  "question" default is a 2B-class model (BASELINE.json config #3:
# "Gemma-2B-it JAX draft model"); report draft/review are 8B-class
# (BASELINE.json config #4: "Llama-3-8B draft + 8B review").
# ---------------------------------------------------------------------------

PRESETS: dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    PRESETS[cfg.name] = cfg
    return cfg


# Tiny config for unit tests and CPU interpret-mode runs.
TINY_TEST = _register(
    ModelConfig(
        name="dv-tiny-test",
        vocab_size=512,
        d_model=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        head_dim=32,
        max_seq_len=512,
    )
)

# Small smoke model: head_dim 128, builds in seconds —
# for engine-mode app integration tests on real hardware.
DV_SMOKE = _register(
    ModelConfig(
        name="dv-smoke",
        vocab_size=4096,
        d_model=512,
        n_layers=4,
        n_heads=8,
        n_kv_heads=4,
        d_ff=1024,
        head_dim=128,
        max_seq_len=2048,
    )
)

# Small demo model — fast to random-init, used for single-chip smoke/bench
# when no checkpoint is configured.
DV_TINY_1B = _register(
    ModelConfig(
        name="dv-1b",
        vocab_size=32768,
        d_model=2048,
        n_layers=16,
        n_heads=16,
        n_kv_heads=8,
        d_ff=5632,
        head_dim=128,
        rope_theta=500000.0,
        max_seq_len=8192,
    )
)

# dv-mini: the in-repo REAL checkpoint — trained from scratch on TPU by
# scripts/train_dv_mini.py over the synthetic interview corpus with the
# dv_bpe_8k tokenizer (resources/tokenizer/).  vocab_size is the tokenizer's
# vocab padded up to a multiple of 128 for MXU-aligned matmuls.
DV_MINI = _register(
    ModelConfig(
        name="dv-mini",
        vocab_size=6016,
        d_model=512,
        n_layers=6,
        n_heads=4,
        n_kv_heads=2,
        d_ff=1536,
        head_dim=128,
        rope_theta=10000.0,
        max_seq_len=2048,
        tie_embeddings=True,
    )
)

# dv-fast: the question-lane model — dv-mini's geometry on the round-2
# corpus/tokenizer (16k vocab) at the full 2048 serving window.  4x fewer
# FLOPs than dv-base keeps 64-way TTFT in the low hundreds of ms while
# dv-base serves the report lanes (the reference ran exactly this split:
# a fast question model and heavyweight draft/review models per lane,
# web/config.py:14-46).
DV_FAST = _register(
    ModelConfig(
        name="dv-fast",
        vocab_size=16384,
        d_model=512,
        n_layers=6,
        n_heads=4,
        n_kv_heads=2,
        d_ff=1536,
        head_dim=128,
        rope_theta=10000.0,
        max_seq_len=2048,
        tie_embeddings=True,
    )
)

# dv-base: the round-2 flagship — ~92M params trained from scratch on TPU
# by scripts/train_model.py over the enriched synthetic corpus with the
# dv_bpe_16k tokenizer.  Trained at the full serving window (seq 2048) so
# every position the app serves is in-distribution (dv-mini only saw 512).
# head_dim 128, as every trained preset.
DV_BASE = _register(
    ModelConfig(
        name="dv-base",
        vocab_size=16384,
        d_model=768,
        n_layers=12,
        n_heads=6,
        n_kv_heads=2,
        d_ff=2048,
        head_dim=128,
        rope_theta=10000.0,
        max_seq_len=2048,
        tie_embeddings=True,
    )
)

# Gemma-2B-class architecture (question lane default).
GEMMA_2B = _register(
    ModelConfig(
        name="dv-gemma-2b",
        vocab_size=256128,
        d_model=2048,
        n_layers=18,
        n_heads=8,
        n_kv_heads=1,
        d_ff=16384,
        head_dim=256,
        rope_theta=10000.0,
        max_seq_len=8192,
        tie_embeddings=True,
        scale_embeddings=True,
    )
)

# Llama-3-8B-class architecture (report draft/review lanes).
LLAMA_8B = _register(
    ModelConfig(
        name="dv-llama-8b",
        vocab_size=128256,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        head_dim=128,
        rope_theta=500000.0,
        max_seq_len=8192,
        tie_embeddings=False,
    )
)


def get_model_config(name: str) -> ModelConfig:
    if name in PRESETS:
        return PRESETS[name]
    raise KeyError(
        f"unknown model preset {name!r}; known: {sorted(PRESETS)}"
    )
