"""Batched text embedding: the document-ingest and retrieval path.

The counterpart of the JAX package's ``engine/embedding.py``: tokenize a
batch, run the serving transformer's blocks (no LM head) over padded
length buckets, mean-pool the valid positions and L2-normalise.  Any
loaded checkpoint doubles as the embedder, so ``LLMEngine.embed_texts``
builds one on its serving params.

The rounding points are the JAX encoder's, which differ from the
forwards' in two places: the embedding is taken in bf16 without
``scale_embeddings``, and the out-projection's float32 product is added
to the bf16 residual.  Attention runs through :func:`flash_attention`
(the flash forward kernel on CUDA tensors, its plain version on CPU
tensors).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from deepvision_tpu_torch.engine import model as model_lib
from deepvision_tpu_torch.engine.config import ModelConfig, get_model_config
from deepvision_tpu_torch.engine.engine import resolve_device
from deepvision_tpu_torch.engine.kernels.flash_attention import (
    flash_attention,
)
from deepvision_tpu_torch.engine.tokenizer import get_tokenizer
from deepvision_tpu_torch.engine.weights import init_params

EMBED_BUCKETS = (128, 256, 512, 1024)


@torch.no_grad()
def _encode_hidden(params, tokens, seq_lens, *, cfg: ModelConfig):
    """Forward through the transformer blocks, mean-pool valid positions;
    returns ``[B, d_model]`` float32 unit vectors."""
    B, S = tokens.shape
    HD = cfg.head_dim
    x = model_lib._embed(params, tokens, torch.bfloat16)
    rope = model_lib.rope_tables(torch.arange(S, device=tokens.device), HD,
                                 cfg.rope_theta)
    for i in range(cfg.n_layers):
        blk = model_lib._layer(params, i)
        h = model_lib.rms_norm(x, blk["ln1"], cfg.rms_eps)
        q, k, v = model_lib._qkv_proj(h, blk, cfg, torch.bfloat16)
        q = model_lib.apply_rope(q.reshape(B, S, -1, HD), rope)
        k = model_lib.apply_rope(k.reshape(B, S, -1, HD), rope)
        v = v.reshape(B, S, -1, HD)
        attn = flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), seq_lens)
        attn = attn.transpose(1, 2).reshape(B, S, -1)
        out = model_lib.qdot(attn, blk["wo"], torch.float32)
        x = x + out.to(x.dtype)
        h2 = model_lib.rms_norm(x, blk["ln2"], cfg.rms_eps)
        x = x + model_lib._mlp(h2, blk)
    x = model_lib.rms_norm(x, params["final_norm"], cfg.rms_eps)
    mask = (torch.arange(S, device=tokens.device)[None, :]
            < seq_lens[:, None]).float()[..., None]
    pooled = (x.float() * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)


class DocumentEmbedder:
    """Batched embedder: inputs sorted by length, batches of
    ``batch_size`` padded to the smallest bucket that holds their longest
    text, texts cut at the largest bucket."""

    def __init__(self, cfg_or_name="dv-smoke", params=None,
                 tokenizer_spec: Optional[str] = "byte",
                 batch_size: int = 16, tokenizer=None,
                 device: str = "cuda"):
        self.cfg = (cfg_or_name if isinstance(cfg_or_name, ModelConfig)
                    else get_model_config(cfg_or_name))
        if params is not None:
            self.params = params
            self.device = next(iter(params["blocks"].values())).device
        else:
            self.device = resolve_device(device)
            self.params = init_params(self.cfg, device=self.device, seed=7)
        # a live tokenizer instance (e.g. the serving engine's) wins over
        # the spec string, so the embedder shares the engine's vocab
        self.tokenizer = (tokenizer if tokenizer is not None
                          else get_tokenizer(tokenizer_spec))
        self.batch_size = batch_size

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Returns ``[N, d_model]`` float32 unit vectors."""
        if not texts:
            return np.zeros((0, self.cfg.d_model), np.float32)
        token_lists = self.tokenizer.encode_batch(list(texts))
        out = np.zeros((len(texts), self.cfg.d_model), np.float32)
        order = sorted(range(len(texts)), key=lambda i: len(token_lists[i]))
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            max_len = max(len(token_lists[i]) for i in idx)
            bucket = next((b for b in EMBED_BUCKETS if max_len <= b),
                          EMBED_BUCKETS[-1])
            toks = np.zeros((len(idx), bucket), np.int32)
            lens = np.zeros(len(idx), np.int32)
            for row, i in enumerate(idx):
                ids = token_lists[i][:bucket]
                toks[row, :len(ids)] = ids
                lens[row] = max(1, len(ids))
            emb = _encode_hidden(
                self.params, torch.from_numpy(toks).to(self.device),
                torch.from_numpy(lens).to(self.device), cfg=self.cfg)
            out[idx] = emb.cpu().numpy()
        return out

    def rank_chunks(self, chunks: Sequence[str], query: str,
                    top_k: int = 3) -> List[int]:
        """Semantic chunk retrieval: cosine ranking against the query."""
        if not chunks:
            return []
        embs = self.embed_texts(list(chunks) + [query])
        scores = embs[:-1] @ embs[-1]
        return list(np.argsort(-scores)[:top_k])
