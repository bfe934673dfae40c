"""Import HuggingFace Llama/Gemma-family checkpoints into the port's params.

A copy of the JAX package's ``engine/hf_import.py``: it maps an HF
``LlamaForCausalLM`` / ``GemmaForCausalLM`` state dict onto the stacked-
layer params tree, as numpy arrays; ``weights.from_numpy_params`` carries
them onto a device.  Conventions:

* projection matrices transpose (HF stores ``[out, in]``);
* RMSNorm scale offset: the model computes ``normed * (1 + scale)`` (the
  Gemma convention); Llama-style checkpoints store the full scale, so they
  import as ``weight - 1``;
* per-layer tensors stack on a new leading layer axis;
* an untied config without ``lm_head.weight`` takes the embedding's
  transpose.

``transformers`` is imported only inside :func:`load_hf_model`; nothing
else in the port needs it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from deepvision_tpu_torch.engine.config import ModelConfig


def infer_config_from_hf(hf_config, name: str = "hf-import") -> ModelConfig:
    return ModelConfig(
        name=name,
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(
            hf_config, "num_key_value_heads", hf_config.num_attention_heads
        ),
        d_ff=hf_config.intermediate_size,
        head_dim=getattr(
            hf_config, "head_dim",
            hf_config.hidden_size // hf_config.num_attention_heads,
        ),
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        rms_eps=getattr(hf_config, "rms_norm_eps", 1e-5),
        max_seq_len=getattr(hf_config, "max_position_embeddings", 8192),
        tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        scale_embeddings=type(hf_config).__name__.startswith("Gemma"),
    )


def convert_hf_state_dict(
    state_dict: Dict[str, "np.ndarray"],
    cfg: ModelConfig,
    dtype=np.float32,
    norm_offset: float = -1.0,
) -> dict:
    """HF state dict (torch tensors or numpy arrays) -> numpy params tree.

    ``norm_offset``: -1 for Llama-style norms (HF multiplies by the weight
    itself), 0 for Gemma-style (HF already computes ``1 + weight``)."""

    def t(key):
        arr = state_dict[key]
        if hasattr(arr, "detach"):
            arr = arr.detach().cpu().float().numpy()
        return np.asarray(arr, dtype=np.float32)

    blocks = {
        "ln1": [], "ln2": [], "wq": [], "wk": [], "wv": [], "wo": [],
        "w_gate": [], "w_up": [], "w_down": [],
    }
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}"
        blocks["ln1"].append(t(f"{p}.input_layernorm.weight") + norm_offset)
        blocks["ln2"].append(
            t(f"{p}.post_attention_layernorm.weight") + norm_offset)
        blocks["wq"].append(t(f"{p}.self_attn.q_proj.weight").T)
        blocks["wk"].append(t(f"{p}.self_attn.k_proj.weight").T)
        blocks["wv"].append(t(f"{p}.self_attn.v_proj.weight").T)
        blocks["wo"].append(t(f"{p}.self_attn.o_proj.weight").T)
        blocks["w_gate"].append(t(f"{p}.mlp.gate_proj.weight").T)
        blocks["w_up"].append(t(f"{p}.mlp.up_proj.weight").T)
        blocks["w_down"].append(t(f"{p}.mlp.down_proj.weight").T)

    params = {
        "embed": t("model.embed_tokens.weight").astype(dtype),
        "final_norm": (t("model.norm.weight") + norm_offset).astype(dtype),
        "blocks": {k: np.stack(v).astype(dtype) for k, v in blocks.items()},
    }
    if not cfg.tie_embeddings:
        if "lm_head.weight" in state_dict:
            params["lm_head"] = t("lm_head.weight").T.astype(dtype)
        else:
            params["lm_head"] = params["embed"].T.copy()
    return params


def load_hf_model(model_name_or_path: str, dtype=None):
    """Load a checkpoint saved on disk (``save_pretrained``) with
    ``transformers``; returns ``(ModelConfig, numpy params)``.  Nothing is
    fetched from a hub: the files must be local."""
    from transformers import AutoConfig, AutoModelForCausalLM

    hf_cfg = AutoConfig.from_pretrained(model_name_or_path,
                                        local_files_only=True)
    cfg = infer_config_from_hf(hf_cfg)
    model = AutoModelForCausalLM.from_pretrained(model_name_or_path,
                                                 local_files_only=True)
    norm_offset = 0.0 if cfg.scale_embeddings else -1.0
    params = convert_hf_state_dict(
        dict(model.state_dict()), cfg,
        dtype=dtype or np.float32, norm_offset=norm_offset,
    )
    return cfg, params
