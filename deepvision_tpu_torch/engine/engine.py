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
from deepvision_tpu_torch.engine.fuse import fuse_params
from deepvision_tpu_torch.engine.kv_cache import CacheConfig, PageAllocator
from deepvision_tpu_torch.engine.model import calibrate_kv_scales
from deepvision_tpu_torch.engine.quant import is_quantized, quantize_params
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
    # Pipelined decode: chain up to max_chained_decodes decode calls, each
    # dispatched before the previous one's tokens are read back.
    pipeline_decode: bool = False
    max_chained_decodes: int = 4
    # int8 KV page pools ("int8" | ""): static per-(layer, kv head) scales
    # calibrated at boot on a fixed interview prompt (calibrate_kv_scales).
    kv_quantize: str = ""
    # Weight-only int8 ("int8" | ""): block matmul weights and an untied
    # lm_head as int8 with per-output-channel scales (engine/quant.py).
    quantize: str = ""
    # One matmul for q|k|v and one for gate|up (engine/fuse.py).
    fuse_projections: bool = False
    # Settings of the JAX package the port has not ported: anything but
    # the defaults raises NotImplementedError.
    tp: int = 1
    vocab_sharded: Optional[bool] = None


_NOT_PORTED = (
    ("tp", 1, "tensor parallelism comes with the multi-device slice"),
    ("vocab_sharded", None, "the vocab-sharded embedding and logits come "
                            "with the multi-device slice"),
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
        if cfg.kv_quantize and cfg.kv_quantize != "int8":
            raise ValueError(f"unknown kv_quantize mode {cfg.kv_quantize!r}; "
                             "supported: int8")
        self.device = resolve_device(cfg.device)
        self.cfg = cfg
        self.model_cfg = model_cfg or get_model_config(cfg.model)
        self.tokenizer = get_tokenizer(cfg.tokenizer)
        self.cache_cfg = CacheConfig(
            num_pages=cfg.num_pages,
            page_size=cfg.page_size,
            max_pages_per_seq=cfg.max_pages_per_seq,
            dtype=torch.int8 if cfg.kv_quantize == "int8" else torch.bfloat16,
        )
        params = load_or_init(self.model_cfg, cfg.checkpoint_dir, cfg.seed,
                              device=self.device)
        self.kv_scales = None
        if self.cache_cfg.quantized:
            # on the raw params, before the weight transforms below
            self.kv_scales = calibrate_kv_scales(
                params, self._calibration_tokens(), cfg=self.model_cfg)
        if cfg.fuse_projections and cfg.tp <= 1:
            params = fuse_params(params, self.model_cfg)
        if cfg.quantize == "int8":
            params = quantize_params(params)
        elif cfg.quantize:
            raise ValueError(f"unknown quantize mode {cfg.quantize!r}; "
                             "supported: int8")

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
            kv_scales=self.kv_scales,
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
            pipeline_decode=cfg.pipeline_decode,
            max_chained_decodes=cfg.max_chained_decodes,
        )
        self.warmup_s = None
        self._started = False
        self._start_lock = threading.Lock()

    # Calibration text of the JAX engine's boot (deepvision_tpu/engine/
    # engine.py): a representative interview prompt.
    CALIBRATION_PROMPT = (
        "你是一名资深需求访谈顾问，正在进行结构化访谈。\n\n"
        "访谈主题：企业客户关系管理系统需求调研\n\n"
        "【参考文档：需求说明】\n现状为多套异构系统并存，数据口径"
        "不一致，补货决策依赖人工经验，期望统一数据底座。\n\n"
        "当前维度：客户需求（关注要点：核心痛点、期望价值）\n\n"
        "请生成下一个访谈问题，输出 JSON：{\"question\": \"...\"}"
    )

    def _calibration_tokens(self) -> torch.Tensor:
        """``[2, 256]`` ids: the calibration prompt repeated to 256 tokens,
        and the same row reversed, as the JAX engine builds them."""
        ids = self.tokenizer.encode(self.CALIBRATION_PROMPT)[:256]
        ids = (ids * (256 // max(1, len(ids)) + 1))[:256]
        return torch.tensor([ids, ids[::-1]], dtype=torch.int32,
                            device=self.device)

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
        """Batched doc embedding on the SERVING params (engine/embedding.py
        encoder: transformer forward + mean-pool, no LM head), built on
        first use with the engine's tokenizer.  Unavailable (returns None)
        when the params are int8-quantized or projection-fused, as in the
        JAX engine: the encoder reads the unfused bf16 layout."""
        if getattr(self, "_embedder", None) is None:
            blocks = self.runner.params.get("blocks") or {}
            if is_quantized(self.runner.params) or "wq" not in blocks:
                return None
            from deepvision_tpu_torch.engine.embedding import (
                DocumentEmbedder,
            )

            self._embedder = DocumentEmbedder(
                self.model_cfg, params=self.runner.params,
                tokenizer=self.tokenizer)
        return self._embedder.embed_texts(texts)

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
