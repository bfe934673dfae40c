"""LLMEngine — the front door one model replica exposes to the app.

Owns tokenizer + runner + page allocator + continuous-batching scheduler
and exposes a blocking ``generate_text`` with the same metadata keys as the
JAX package's engine.  It runs on a CUDA device unless the caller passes
``device="cpu"``; it never drops to the CPU on its own.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from deepvision_tpu_torch.engine.config import ModelConfig, get_model_config
from deepvision_tpu_torch.engine.kv_cache import CacheConfig, PageAllocator
from deepvision_tpu_torch.engine.runner import ModelRunner
from deepvision_tpu_torch.engine.scheduler import (
    HIGH,
    ContinuousBatchingScheduler,
    GenerationRequest,
)
from deepvision_tpu_torch.engine.tokenizer import get_tokenizer
from deepvision_tpu_torch.engine.weights import load_or_init


@dataclasses.dataclass
class EngineConfig:
    model: str = "dv-1b"
    tokenizer: str = "byte"
    # a flat .npz file; any other path, or None, boots random weights from
    # seed (weights.load_or_init); an orbax directory raises
    checkpoint_dir: Optional[str] = None
    device: str = "cuda"
    max_slots: int = 8
    num_pages: int = 2048
    page_size: int = 64
    max_pages_per_seq: int = 64
    max_pending: int = 64
    prefills_per_step: int = 1
    # fresh prompts admitted in one batched prefill (padded to powers of 2)
    prefill_batch_max: int = 4
    strict_priority: bool = False
    decode_steps_per_call: int = 1
    # Chunked prefill (and the prefix cache, which needs it): prefix-cache
    # resumes and long prompts prefill in chunks of prefill_chunk_size
    # through the paged chunk kernel; fresh prompts still prefill batched.
    chunked_prefill: bool = False
    prefill_chunk_size: int = 256
    seed: int = 0
    # Grammar-constrained decoding (engine/constrained.py) for json_mode
    # requests, when the [states, vocab] table is small enough.
    json_dfa: bool = True
    json_dfa_max_vocab: int = 16384
    # Run one prefill per batch bucket and one decode call at start, so
    # the first request pays no lazy set-up (kernel build, allocator).
    warmup: bool = False
    batch_buckets: tuple = ()
    # The JAX warmup's prefill sizes for its per-bucket prefill programs.
    # The port's warmup runs batch_buckets, which every prefill pads to:
    # only the default is accepted.
    warmup_buckets: tuple = (128, 256, 512, 1024)
    # Accepted for the JAX package's EngineConfig and meaningless here:
    # Pallas interpret mode has no counterpart (a wrapper runs its plain
    # version on CPU tensors, its CUDA kernel on CUDA tensors).
    interpret: Optional[bool] = None
    # Chained fused decode calls; read only by pipelined decode, which
    # raises until it is ported.
    max_chained_decodes: int = 4
    # Settings of the JAX package this slice has not ported: anything but
    # the defaults raises NotImplementedError.
    tp: int = 1
    vocab_sharded: Optional[bool] = None
    quantize: str = ""
    kv_quantize: str = ""
    fuse_projections: bool = False
    pipeline_decode: bool = False


_NOT_PORTED = (
    ("tp", 1, "tensor parallelism comes with the multi-device slice"),
    ("vocab_sharded", None, "the vocab-sharded embedding and logits come "
                            "with the multi-device slice"),
    ("quantize", "", "weight-only int8 comes in a later slice"),
    ("kv_quantize", "", "engine-level int8 KV (with calibrate_kv_scales) "
                        "comes in a later slice"),
    ("fuse_projections", False, "projection fusion comes in a later slice"),
    ("pipeline_decode", False, "pipelined decode comes in a later slice"),
    ("warmup_buckets", (128, 256, 512, 1024),
     "the warmup runs the runner's batch_buckets, which every prefill pads "
     "to; other warmup sizes have no counterpart"),
)


def resolve_device(device: str) -> torch.device:
    """The device of an entry point (engine, trainer); raises when CUDA is
    asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class LLMEngine:
    def __init__(self, cfg: EngineConfig,
                 model_cfg: Optional[ModelConfig] = None):
        for name, default, why in _NOT_PORTED:
            if getattr(cfg, name) != default:
                raise NotImplementedError(f"{name}={getattr(cfg, name)!r}: "
                                          f"{why}")
        self.device = resolve_device(cfg.device)
        self.cfg = cfg
        self.model_cfg = model_cfg or get_model_config(cfg.model)
        self.tokenizer = get_tokenizer(cfg.tokenizer)
        self.cache_cfg = CacheConfig(
            num_pages=cfg.num_pages,
            page_size=cfg.page_size,
            max_pages_per_seq=cfg.max_pages_per_seq,
        )
        params = load_or_init(self.model_cfg, cfg.checkpoint_dir, cfg.seed,
                              device=self.device)

        self.json_dfa = None
        if (cfg.json_dfa
                and self.tokenizer.vocab_size <= cfg.json_dfa_max_vocab):
            from deepvision_tpu_torch.engine.constrained import JsonTokenDfa

            cache_dir = os.environ.get(
                "DV_DFA_CACHE_DIR",
                os.path.join(os.path.expanduser("~"), ".cache",
                             "deepvision_tpu_torch"))
            # root="object": every JSON call type in the app expects an
            # object — bans degenerate bare-literal completions.
            self.json_dfa = JsonTokenDfa.build(
                self.tokenizer, root="object", cache_dir=cache_dir)

        self.runner = ModelRunner(
            self.model_cfg,
            self.cache_cfg,
            params,
            device=self.device,
            max_slots=cfg.max_slots,
            rng_seed=cfg.seed,
            chunked_prefill=cfg.chunked_prefill,
            prefill_chunk_size=cfg.prefill_chunk_size,
            batch_buckets=cfg.batch_buckets or None,
            dfa_table=(self.json_dfa.table
                       if self.json_dfa is not None else None),
            dfa_dist=(self.json_dfa.dist
                      if self.json_dfa is not None else None),
        )
        self.allocator = PageAllocator(cfg.num_pages)
        self.scheduler = ContinuousBatchingScheduler(
            self.runner,
            self.allocator,
            max_slots=cfg.max_slots,
            max_pending=cfg.max_pending,
            prefills_per_step=cfg.prefills_per_step,
            strict_priority=cfg.strict_priority,
            decode_steps_per_call=cfg.decode_steps_per_call,
            dfa=self.json_dfa,
            prefill_batch_max=cfg.prefill_batch_max,
        )
        self.warmup_s = None
        self._started = False
        self._start_lock = threading.Lock()

    # ------------------------------------------------------------------

    def start(self) -> None:
        with self._start_lock:
            if not self._started:
                if self.cfg.warmup:
                    self._warmup()
                self.scheduler.start()
                self._started = True

    def _warmup(self) -> None:
        """One padded prefill per batch bucket, one chunked prefill when the
        runner is chunked (so the chunk kernel is built and launched before
        traffic) and one decode call, into freshly allocated pages that are
        freed again."""
        t0 = time.monotonic()
        runner, alloc = self.runner, self.allocator
        page = self.cache_cfg.page_size
        warmed_chunked = not self.cfg.chunked_prefill
        for bucket in runner.batch_buckets:
            n = bucket - 1
            pages = alloc.try_alloc(-(-n // page))
            if pages is None:
                break
            try:
                if not warmed_chunked:
                    runner.prefill([1] * n, pages)
                    warmed_chunked = True
                runner.prefill_batch([[1] * n], [pages])
            finally:
                alloc.free(pages)
        B = self.cfg.max_slots
        zeros = np.zeros(B, np.int32)
        runner.decode(zeros, np.ones(B, np.int32),
                      np.zeros((B, self.cache_cfg.max_pages_per_seq),
                               np.int32),
                      zeros.astype(np.float32), zeros,
                      np.ones(B, np.float32),
                      n_steps=self.cfg.decode_steps_per_call)
        self.warmup_s = round(time.monotonic() - t0, 3)

    def shutdown(self) -> None:
        """Stop the scheduler and join its thread."""
        with self._start_lock:
            if self._started:
                self.scheduler.shutdown()
                self._started = False

    # ------------------------------------------------------------------

    def submit_tokens(
        self,
        prompt_tokens: Sequence[int],
        **kw,
    ) -> GenerationRequest:
        self.start()
        kw.setdefault("stop_token_ids", [self.tokenizer.eos_id])
        req = GenerationRequest(prompt_tokens, **kw)
        return self.scheduler.submit(req)

    def generate_text(
        self,
        prompt: str,
        *,
        max_tokens: int = 256,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        priority: int = HIGH,
        timeout: Optional[float] = 120.0,
        request_id: Optional[str] = None,
        prefix_key: Optional[str] = None,
        json_mode: bool = False,
    ):
        """Blocking text generation.  Returns ``(text, meta dict)``.

        ``prefix_key`` (a session id) lets the request share the KV pages
        of a cached prompt head (chunked prefill only); None bypasses the
        prefix cache.

        Raises TimeoutError if the deadline expires (the request is
        cancelled engine-side so its slot frees on the next step).
        """
        t0 = time.monotonic()
        prompt_tokens = self.tokenizer.encode(prompt)
        max_ctx = self.cache_cfg.max_context
        if len(prompt_tokens) + max_tokens > max_ctx:
            keep = max(1, max_ctx - max_tokens)  # max_tokens >= ctx: keep 1
            prompt_tokens = prompt_tokens[-keep:]
        req = self.submit_tokens(
            prompt_tokens,
            max_tokens=max_tokens,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            priority=priority,
            deadline_s=timeout,
            request_id=request_id,
            prefix_key=prefix_key,
            json_mode=json_mode and self.json_dfa is not None,
        )
        result = req.wait(timeout)
        if result is None:
            req.cancel()
            raise TimeoutError(
                f"generation {req.request_id} timed out after {timeout}s"
            )
        if result.finish_reason == "error":
            raise RuntimeError(result.error or "engine generation failed")
        if result.finish_reason == "timeout":
            raise TimeoutError(
                f"generation {req.request_id} hit engine deadline"
            )
        text = self.tokenizer.decode(result.token_ids)
        meta = {
            "model": self.model_cfg.name,
            "queue_wait_ms": round(result.queue_wait_ms, 1),
            "prefill_ms": round(result.prefill_ms, 1),
            "decode_ms": round(result.decode_ms, 1),
            "total_ms": round((time.monotonic() - t0) * 1e3, 1),
            "completion_tokens": len(result.token_ids),
            "prompt_tokens": len(prompt_tokens),
            "finish_reason": result.finish_reason,
            "json_constrained": bool(json_mode and self.json_dfa is not None),
        }
        return text, meta

    # ------------------------------------------------------------------

    def embed_texts(self, texts):
        raise NotImplementedError(
            "embed_texts: the document embedder comes in a later slice")

    def stats(self) -> dict:
        s = self.scheduler
        out = {
            "model": self.model_cfg.name,
            "queues": s.queue_depths(),
            "tokens_generated": s.tokens_generated,
            "decode_steps": s.steps,
            "decode_time_s": round(s.decode_time_s, 3),
            "requests_finished": s.requests_finished,
            "rejected_overload": s.rejected_overload,
        }
        if s.prefix_cache is not None:
            out["prefix_cache"] = s.prefix_cache.stats()
        return out
