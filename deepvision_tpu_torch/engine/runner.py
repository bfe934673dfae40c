"""ModelRunner: owns params + paged cache and runs the serving steps.

One runner = one model replica on one device.  The continuous-batching
scheduler calls:

* ``prefill_batch(prompts, pages)`` — several fresh prompts in one padded
  batch (B padded to a power of two, S to one of ``batch_buckets``); their
  K/V pages are written and the first output token is sampled on the device.
* ``prefill(tokens, pages, start_from=...)`` — one prompt.  With chunked
  prefill it runs ``prefill_chunk_step`` chunk by chunk from ``start_from``
  (a prefix-cache resume starts past the shared pages); without, it is a
  one-prompt ``prefill_batch``.
* ``prefill_chunk_step(...)`` — one chunk of ``prefill_chunk_size`` tokens;
  the scheduler interleaves these with decode for long prompts.
* ``decode(...)`` — ``n_steps`` decode steps for every slot, run as a
  Python loop whose tokens, grammar states and budgets stay on the device;
  the call syncs with the host once, to read the ``[n_steps, B]`` tokens.

Inactive slots point at the trash page, so the decode batch has one fixed
shape.  The pools are updated in place, and every step runs on the
device's current stream, so chunks and decode steps follow each other in
the order they were issued.
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
    def __init__(
        self,
        cfg: ModelConfig,
        cache_cfg: CacheConfig,
        params: dict,
        *,
        device,
        max_slots: int = 16,
        rng_seed: int = 0,
        chunked_prefill: bool = False,
        prefill_chunk_size: int = 256,
        batch_buckets: Optional[Sequence[int]] = None,
        dfa_table=None,
        dfa_dist=None,
    ):
        self.device = torch.device(device)
        self.chunked_prefill = chunked_prefill
        self.prefill_chunk_size = prefill_chunk_size
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

    def prefill(
        self,
        token_ids: Sequence[int],
        page_ids: Sequence[int],
        *,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        start_from: int = 0,
        dfa_state: int = 0,
        budget: Optional[int] = None,
    ) -> int:
        """Prefill one prompt; returns the first sampled output token id.

        ``start_from``: skip this many page-aligned tokens whose KV pages
        are already written (a prefix-cache hit); needs chunked prefill.
        ``dfa_state``: grammar state of the first sampled token (0 = FREE).
        ``budget``: output-token budget including the first token.
        """
        if self.chunked_prefill:
            n = len(token_ids)
            C = self.prefill_chunk_size
            tok = 0
            for start in range(start_from, n, C):
                # only the last chunk's sample is read: earlier chunks are
                # only enqueued, so a prompt costs one host sync
                tok = self.prefill_chunk_step(
                    token_ids, page_ids, start, temperature=temperature,
                    top_k=top_k, top_p=top_p, dfa_state=dfa_state,
                    budget=budget, sync=start + C >= n)
            return tok
        if start_from:
            raise ValueError("prefill: start_from needs chunked prefill")
        return self.prefill_batch(
            [token_ids], [page_ids], temperatures=[temperature],
            top_ks=[top_k], top_ps=[top_p], dfa_states=[dfa_state],
            budgets=[budget if budget else NO_BUDGET])[0]

    def prefill_chunk_step(
        self,
        token_ids: Sequence[int],
        page_ids: Sequence[int],
        start: int,
        *,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        dfa_state: int = 0,
        budget: Optional[int] = None,
        sync: bool = True,
    ):
        """Run one chunk ``[start, start + C)`` of a prompt; returns the
        token sampled from the chunk's last valid row (meaningful once the
        prompt's last chunk has run).

        ``sync=False`` returns that token as a ``[1]`` device tensor without
        waiting for the device: chunks chain through the pools on the
        current stream, and the caller reads only the last chunk's token.
        """
        n = len(token_ids)
        C = self.prefill_chunk_size
        MP = self.cache_cfg.max_pages_per_seq
        bt = np.zeros((1, MP), dtype=np.int32)
        bt[0, : min(len(page_ids), MP)] = np.asarray(page_ids[:MP],
                                                     dtype=np.int32)
        chunk = np.zeros((1, C), dtype=np.int32)
        piece = np.asarray(token_ids[start:start + C], dtype=np.int32)
        chunk[0, : len(piece)] = piece
        with torch.no_grad():
            logits = model_lib.forward_prefill_chunk(
                self.params, self.cache, self._tensor(chunk, torch.int32),
                self._tensor([start], torch.int32),
                self._tensor([n], torch.int32),
                self._tensor(bt, torch.int32), cfg=self.cfg)
            tok, _ = sample_tokens_constrained(
                logits, self._gen,
                self._tensor([temperature], torch.float32),
                self._tensor([top_k], torch.int32),
                self._tensor([top_p], torch.float32),
                self._tensor([dfa_state], torch.int32),
                self._dfa_packed,
                budgets=self._tensor([budget if budget else NO_BUDGET],
                                     torch.int32))
        return int(tok[0]) if sync else tok

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
