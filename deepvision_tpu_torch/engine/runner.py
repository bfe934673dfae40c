"""ModelRunner: owns params + paged cache and runs the serving steps.

One runner = one model replica on one device.  The continuous-batching
scheduler calls:

* ``prefill_batch(prompts, pages)`` — several fresh prompts in one padded
  batch (B padded to a power of two, S to one of ``batch_buckets``); their
  K/V pages are written and the first output token is sampled on the device.
* ``decode(...)`` — ``n_steps`` decode steps for every slot, run as a
  Python loop whose tokens, grammar states and budgets stay on the device;
  the call syncs with the host once, to read the ``[n_steps, B]`` tokens.

Inactive slots point at the trash page, so the decode batch has one fixed
shape.  The pools are updated in place.  Chunked prefill (and the prefix
cache that needs it) are not ported yet: ``chunked_prefill`` is False.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from deepvision_tpu_torch.engine import model as model_lib
from deepvision_tpu_torch.engine.config import ModelConfig
from deepvision_tpu_torch.engine.kv_cache import CacheConfig, init_cache
from deepvision_tpu_torch.engine.sampling import (
    pack_dfa_table,
    sample_tokens_constrained,
)

PREFILL_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)
NO_BUDGET = 1 << 20  # "unlimited" slot budget sentinel


def pick_bucket(n: int, buckets: Sequence[int] = PREFILL_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt of {n} tokens exceeds max bucket {buckets[-1]}")


class ModelRunner:
    chunked_prefill = False

    def __init__(
        self,
        cfg: ModelConfig,
        cache_cfg: CacheConfig,
        params: dict,
        *,
        device,
        max_slots: int = 16,
        rng_seed: int = 0,
        batch_buckets: Optional[Sequence[int]] = None,
        dfa_table=None,
        dfa_dist=None,
    ):
        self.device = torch.device(device)
        self.cfg = cfg
        self.cache_cfg = cache_cfg
        self.max_slots = max_slots
        # Grammar table [S, V_tok] (next state or -1), padded on the vocab
        # axis to the model's vocab: padding ids stay allowed in the FREE
        # row 0 and forbidden elsewhere.
        V = cfg.vocab_size
        if dfa_table is None:
            table = np.zeros((1, V), dtype=np.int32)
        else:
            table = np.asarray(dfa_table, dtype=np.int32)
            if table.shape[1] < V:
                pad = np.full((table.shape[0], V - table.shape[1]), -1,
                              dtype=np.int32)
                pad[0, :] = 0
                table = np.concatenate([table, pad], axis=1)
        dist = (np.zeros(table.shape[0], dtype=np.int32) if dfa_dist is None
                else np.asarray(dfa_dist, dtype=np.int32))
        self._dfa_packed = torch.from_numpy(
            pack_dfa_table(table, dist)).to(self.device)
        # Canonical buckets of the batched admission path: powers of two
        # from 256 up to the context maximum.
        max_bucket = cache_cfg.max_pages_per_seq * cache_cfg.page_size
        if batch_buckets is None:
            batch_buckets, b = [], min(256, max_bucket)
            while b < max_bucket:
                batch_buckets.append(b)
                b *= 2
            batch_buckets.append(max_bucket)
        self.batch_buckets = tuple(
            b for b in sorted(set(batch_buckets)) if b <= max_bucket
        ) or (max_bucket,)
        self.params = params
        self.cache = init_cache(cfg, cache_cfg, device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed)

    def _tensor(self, arr, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=dtype).to(self.device)

    # ------------------------------------------------------------------
    # Public API (numpy in/out; called from the scheduler thread)
    # ------------------------------------------------------------------

    def prefill_batch(
        self,
        prompts,                      # List[Sequence[int]]
        pages_list,                   # List[Sequence[int]]
        *,
        temperatures=None,
        top_ks=None,
        top_ps=None,
        dfa_states=None,
        budgets=None,
    ) -> List[int]:
        """Prefill several fresh prompts in one padded batch; returns the
        first sampled token of each.  Padded rows write into the trash
        page."""
        n_real = len(prompts)
        B = 1
        while B < n_real:
            B *= 2
        maxlen = max(len(p) for p in prompts)
        if maxlen <= self.batch_buckets[-1]:
            bucket = pick_bucket(maxlen, self.batch_buckets)
        else:
            bucket = pick_bucket(maxlen)
        page = self.cache_cfg.page_size
        n_chunks = bucket // page
        toks = np.zeros((B, bucket), dtype=np.int32)
        pages = np.zeros((B, n_chunks), dtype=np.int32)
        seq_lens = np.ones(B, dtype=np.int32)
        for i, (p, pg) in enumerate(zip(prompts, pages_list)):
            toks[i, : len(p)] = np.asarray(p, dtype=np.int32)
            used = min(len(pg), n_chunks)
            pages[i, :used] = np.asarray(pg[:used], dtype=np.int32)
            seq_lens[i] = len(p)

        def fill(vals, default, dtype):
            out = np.full(B, default, dtype)
            if vals is not None:
                out[:n_real] = np.asarray(vals, dtype)
            return out

        with torch.no_grad():
            logits = model_lib.forward_prefill(
                self.params, self.cache, self._tensor(toks, torch.int32),
                self._tensor(seq_lens, torch.int32),
                self._tensor(pages, torch.int32), cfg=self.cfg)
            tok, _ = sample_tokens_constrained(
                logits, self._gen,
                self._tensor(fill(temperatures, 0.0, np.float32),
                             torch.float32),
                self._tensor(fill(top_ks, 0, np.int32), torch.int32),
                self._tensor(fill(top_ps, 1.0, np.float32), torch.float32),
                self._tensor(fill(dfa_states, 0, np.int32), torch.int32),
                self._dfa_packed,
                budgets=self._tensor(fill(budgets, NO_BUDGET, np.int32),
                                     torch.int32))
        return tok.cpu().tolist()[:n_real]

    def decode(
        self,
        tokens: np.ndarray,        # [B] int32
        seq_lens: np.ndarray,      # [B] int32 incl. current token
        block_tables: np.ndarray,  # [B, MAX_PAGES] int32
        temperature: np.ndarray,
        top_k: np.ndarray,
        top_p: np.ndarray,
        n_steps: int = 1,
        dfa_states: Optional[np.ndarray] = None,
        budgets: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Run ``n_steps`` decode steps; returns ``[n_steps, B]`` sampled
        tokens (callers discard post-EOS tail tokens)."""
        out, _, _ = self.decode_async(
            tokens, seq_lens, block_tables, temperature, top_k, top_p,
            n_steps=n_steps, dfa_states=dfa_states, budgets=budgets)
        return out.cpu().numpy()

    def decode_async(
        self,
        tokens,
        seq_lens: np.ndarray,
        block_tables: np.ndarray,
        temperature: np.ndarray,
        top_k: np.ndarray,
        top_p: np.ndarray,
        n_steps: int = 1,
        dfa_states=None,
        budgets=None,
    ):
        """Enqueue ``n_steps`` decode steps without a host sync.  Returns
        device tensors ``(out [n_steps, B], last_tok [B], last_state [B])``."""
        B = len(seq_lens)
        if dfa_states is None:
            dfa_states = np.zeros(B, np.int32)
        if budgets is None:
            budgets = np.full(B, NO_BUDGET, np.int32)
        toks = self._tensor(tokens, torch.int32)
        lens = self._tensor(seq_lens, torch.int32)
        bt = self._tensor(block_tables, torch.int32)
        temp = self._tensor(temperature, torch.float32)
        topk = self._tensor(top_k, torch.int32)
        topp = self._tensor(top_p, torch.float32)
        states = self._tensor(dfa_states, torch.int32)
        rem = self._tensor(budgets, torch.int32)
        outs = []
        with torch.no_grad():
            for _ in range(n_steps):
                logits = model_lib.forward_decode(
                    self.params, self.cache, toks, lens, bt, cfg=self.cfg)
                toks, states = sample_tokens_constrained(
                    logits, self._gen, temp, topk, topp, states,
                    self._dfa_packed, budgets=rem)
                outs.append(toks)
                lens = lens + 1
                rem = rem - 1
        return torch.stack(outs), toks, states
