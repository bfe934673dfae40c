"""The app's model gateway, built from its settings, on the port's engines.

:func:`build_gateway` is the counterpart of the JAX app's
``AppState._build_gateway`` (``deepvision_tpu/web/server.py``): it reads
the same keys with the same defaults and makes the same decisions (which
model each lane runs, the tokenizer paired with each model, one engine per
distinct model, a longer decode window for report-only engines, replicas
and remote engines behind an :class:`EngineRouter`, question engines
started in the foreground and report-only engines warmed in a background
thread).  Its engines run on ``device`` (CUDA unless the caller asks for
the CPU).

Settings come from ``overrides``, then the process environment, then the
app's defaults for these keys.  The app's ``.env`` files and its admin
config centre are not read here, and the app's metrics hook is the
caller's to set (``gateway.metrics_hook``).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from deepvision_tpu_torch.engine.client import CircuitBreaker, ModelGateway
from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine
from deepvision_tpu_torch.engine.lanes import DEFAULT_LANES
from deepvision_tpu_torch.engine.router import EngineRouter
from deepvision_tpu_torch.engine.service import RemoteEngine

RESOURCES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "resources")

# The app's defaults for the keys read here (deepvision_tpu/web/config.py);
# they win over the fallbacks written at each read, as in the app.
APP_DEFAULTS = {
    "ENABLE_AI": True,
    "AI_MODE": "template",
    "QUESTION_MODEL_NAME": "auto",
    "REPORT_MODEL_NAME": "auto",
    "REPORT_DRAFT_MODEL_NAME": "auto",
    "REPORT_REVIEW_MODEL_NAME": "auto",
    "ENGINE_TOKENIZER": "auto",
    "ENGINE_CHECKPOINT_DIR": "",
    "ENGINE_MAX_SLOTS": 32,
    "ENGINE_NUM_PAGES": 1024,
    "ENGINE_PAGE_SIZE": 64,
    "ENGINE_MAX_PAGES_PER_SEQ": 32,
    "ENGINE_TP": 1,
    "ENGINE_REPLICAS": 1,
    "ENGINE_REMOTE_URLS": "",
    "ENGINE_DECODE_STEPS_PER_CALL": 8,
    "ENGINE_REPORT_DECODE_STEPS": 16,
    "ENGINE_PIPELINE_DECODE": False,
    "ENGINE_MAX_CHAINED_DECODES": 4,
    "ENGINE_CHUNKED_PREFILL": True,
    "ENGINE_PREFILL_CHUNK_SIZE": 256,
    "ENGINE_QUANTIZE": "",
    "ENGINE_KV_QUANTIZE": "",
    "ENGINE_FUSE_PROJECTIONS": False,
}

# each trained preset pairs with the vocab it was trained on
TOKENIZER_BY_MODEL = {
    "dv-fast": os.path.join(RESOURCES, "tokenizer", "dv_bpe_16k.json"),
    "dv-base": os.path.join(RESOURCES, "tokenizer", "dv_bpe_16k.json"),
    "dv-mini": os.path.join(RESOURCES, "tokenizer", "dv_bpe_8k.json"),
}

# per-lane "auto" preference: TTFT-bound lanes take the fast model,
# quality-bound report lanes the big one
FAST_PREF = ("dv-fast", "dv-base", "dv-mini")
QUALITY_PREF = ("dv-base", "dv-fast", "dv-mini")


class Settings:
    """Typed reads over ``overrides``, then ``os.environ``, then
    :data:`APP_DEFAULTS`, with the app's casting rules (a value that does
    not cast is returned as it is)."""

    def __init__(self, overrides: Optional[dict] = None):
        self.overrides = dict(overrides or {})

    def get(self, key: str, default=None, cast=None):
        if key in self.overrides:
            return self._cast(self.overrides[key], cast)
        if key in os.environ:
            return self._cast(os.environ[key], cast)
        if key in APP_DEFAULTS:
            return self._cast(APP_DEFAULTS[key], cast)
        return default

    @staticmethod
    def _cast(val, cast):
        if cast is None:
            return val
        if cast is bool:
            if isinstance(val, bool):
                return val
            return str(val).strip().lower() in ("1", "true", "yes", "on")
        try:
            return cast(val)
        except (TypeError, ValueError):
            return val

    def get_str(self, key: str, default: str = "") -> str:
        v = self.get(key, default)
        return "" if v is None else str(v)

    def get_int(self, key: str, default: int = 0) -> int:
        return self.get(key, default, cast=int)

    def get_bool(self, key: str, default: bool = False) -> bool:
        return self._cast(self.get(key, default), bool)

    def get_list(self, key: str, default=None) -> list:
        v = self.get(key, default or [])
        if isinstance(v, list):
            return v
        return [s.strip() for s in str(v).split(",") if s.strip()]


def default_checkpoint(model_name: str) -> Optional[str]:
    """The in-repo trained checkpoint of ``model_name``, if present."""
    p = os.path.join(RESOURCES, "checkpoints", f"{model_name}.npz")
    return p if os.path.isfile(p) else None


def build_gateway(overrides: Optional[dict] = None, *,
                  device: str = "cuda") -> ModelGateway:
    """The app's :class:`ModelGateway` from its settings (``AI_MODE``
    ``template`` | ``engine`` | ``off``); in engine mode its engines are
    built on ``device`` and started before this returns (report-only
    engines keep warming in a background thread)."""
    cfg = Settings(overrides)
    mode = cfg.get_str("AI_MODE", "template")
    if not cfg.get_bool("ENABLE_AI", True):
        mode = "off"
    engines = {}
    lanes = None
    if mode == "engine":
        def engine_cfg(model_name: str,
                       decode_k: Optional[int] = None) -> EngineConfig:
            tok = cfg.get_str("ENGINE_TOKENIZER", "auto")
            if tok in ("", "auto"):
                # the BPE vocab only pairs with models trained on it
                paired = TOKENIZER_BY_MODEL.get(model_name)
                tok = (paired if paired and os.path.isfile(paired)
                       else "byte")
            return EngineConfig(
                model=model_name,
                tokenizer=tok,
                checkpoint_dir=cfg.get_str("ENGINE_CHECKPOINT_DIR")
                or default_checkpoint(model_name),
                device=device,
                max_slots=cfg.get_int("ENGINE_MAX_SLOTS", 8),
                num_pages=cfg.get_int("ENGINE_NUM_PAGES", 1024),
                page_size=cfg.get_int("ENGINE_PAGE_SIZE", 64),
                max_pages_per_seq=cfg.get_int("ENGINE_MAX_PAGES_PER_SEQ", 32),
                tp=cfg.get_int("ENGINE_TP", 1),
                decode_steps_per_call=decode_k or cfg.get_int(
                    "ENGINE_DECODE_STEPS_PER_CALL", 8),
                pipeline_decode=cfg.get_bool("ENGINE_PIPELINE_DECODE", False),
                max_chained_decodes=cfg.get_int(
                    "ENGINE_MAX_CHAINED_DECODES", 4),
                chunked_prefill=cfg.get_bool("ENGINE_CHUNKED_PREFILL", True),
                prefill_chunk_size=cfg.get_int(
                    "ENGINE_PREFILL_CHUNK_SIZE", 256),
                quantize=cfg.get_str("ENGINE_QUANTIZE", ""),
                kv_quantize=cfg.get_str("ENGINE_KV_QUANTIZE", ""),
                fuse_projections=cfg.get_bool(
                    "ENGINE_FUSE_PROJECTIONS", False),
                warmup=cfg.get_bool(
                    "ENGINE_WARMUP",
                    os.environ.get("DEEPVISION_TPU_TESTING") != "1"),
            )

        def lane_model(key: str) -> str:
            # "auto" / empty resolves to the best in-repo checkpoint
            name = cfg.get_str(key, "auto")
            if name not in ("", "auto"):
                return name
            prefs = QUALITY_PREF if key.startswith("REPORT") else FAST_PREF
            return next((m for m in prefs if default_checkpoint(m)), "dv-1b")

        lane_models = {
            "question": lane_model("QUESTION_MODEL_NAME"),
            "question_fast": lane_model("QUESTION_MODEL_NAME"),
            "question_deep": lane_model("QUESTION_MODEL_NAME"),
            "report": lane_model("REPORT_MODEL_NAME"),
            "report_draft": lane_model("REPORT_DRAFT_MODEL_NAME"),
            "report_review": lane_model("REPORT_REVIEW_MODEL_NAME"),
            "summary": lane_model("QUESTION_MODEL_NAME"),
            "search_decision": lane_model("QUESTION_MODEL_NAME"),
            "assessment": lane_model("QUESTION_MODEL_NAME"),
        }
        n_replicas = max(1, cfg.get_int("ENGINE_REPLICAS", 1))
        remote_urls = [u for u in cfg.get_list("ENGINE_REMOTE_URLS") if u]
        # report-only engines take the longer fused decode window
        # (ENGINE_REPORT_DECODE_STEPS); question engines keep K for TTFT
        q_models = {lane_models[k] for k in
                    ("question", "question_fast", "question_deep")}
        r_models = {lane_models[k] for k in
                    ("report", "report_draft", "report_review")}
        report_k = cfg.get_int("ENGINE_REPORT_DECODE_STEPS", 16)
        for model_name in dict.fromkeys(lane_models.values()):
            decode_k = (report_k if model_name in r_models
                        and model_name not in q_models else None)
            replicas = [LLMEngine(engine_cfg(model_name, decode_k))
                        for _ in range(n_replicas)]
            replicas += [RemoteEngine(u) for u in remote_urls]
            engines[model_name] = (replicas[0] if len(replicas) == 1
                                   else EngineRouter(replicas))
        # question engines boot in the foreground (together); report-only
        # engines warm in the background, and a report request that comes
        # early waits in LLMEngine.start()'s lock
        report_only = {m for m in engines
                       if m in r_models and m not in q_models}
        fg = [threading.Thread(target=eng.start)
              for name, eng in engines.items() if name not in report_only]
        for t in fg:
            t.start()
        for t in fg:
            t.join()
        for name in report_only:
            threading.Thread(target=engines[name].start, daemon=True).start()
        lanes = {
            name: profile.replace(engine=lane_models.get(
                name, next(iter(engines))))
            for name, profile in DEFAULT_LANES.items()
        }
    return ModelGateway(mode=mode, engines=engines, lanes=lanes,
                        breaker=CircuitBreaker())
