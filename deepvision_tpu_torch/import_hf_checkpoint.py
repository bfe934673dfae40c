"""Convert a HuggingFace Llama/Gemma checkpoint into an orbax checkpoint
directory for ENGINE_CHECKPOINT_DIR.

    python -m deepvision_tpu_torch.import_hf_checkpoint HF_MODEL OUT_DIR \
        [--dtype bfloat16|float32]

The counterpart of ``scripts/import_hf_checkpoint.py``: the same arguments,
the same lines on stdout and the same ``model_config.json`` beside the
checkpoint, which either package's engine loads.  The model is read with
``transformers`` from local files (nothing is fetched); the port needs no
``ml_dtypes``: bfloat16 comes from the float32 conversion rounded to
nearest even on the bits (``weights.round_to_bf16``), as ``ml_dtypes``
rounds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from deepvision_tpu_torch.engine.config import ModelConfig
from deepvision_tpu_torch.engine.hf_import import load_hf_model
from deepvision_tpu_torch.engine.weights import (
    from_numpy_params,
    round_to_bf16,
    save_checkpoint,
)


def write_checkpoint(cfg: ModelConfig, params: dict, out_dir: str,
                     dtype: str = "bfloat16") -> None:
    """Save converted ``params`` (numpy arrays, float32) to ``out_dir`` in
    ``dtype`` as an orbax checkpoint, with ``model_config.json`` beside
    it."""
    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else round_to_bf16(v)
                for k, v in tree.items()}

    tree = from_numpy_params(params, device="cpu")
    save_checkpoint(out_dir, cast(tree) if dtype == "bfloat16" else tree)
    with open(os.path.join(out_dir, "model_config.json"), "w") as fh:
        json.dump({
            "vocab_size": cfg.vocab_size, "d_model": cfg.d_model,
            "n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
            "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta,
            "rms_eps": cfg.rms_eps, "tie_embeddings": cfg.tie_embeddings,
            "scale_embeddings": cfg.scale_embeddings,
        }, fh, indent=1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="HF -> engine checkpoint")
    p.add_argument("hf_model", help="HF model dir or hub id")
    p.add_argument("out_dir", help="orbax checkpoint output dir")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    args = p.parse_args(argv)

    cfg, params = load_hf_model(args.hf_model, dtype=np.float32)
    print(f"converted {cfg.name}: {cfg.n_layers} layers, "
          f"d_model={cfg.d_model}, vocab={cfg.vocab_size}")
    write_checkpoint(cfg, params, args.out_dir, args.dtype)
    print(f"saved to {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
