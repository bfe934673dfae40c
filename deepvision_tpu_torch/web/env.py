"""Config resolution: env > .env files > config.py defaults, with runtime
overrides from the admin config center.

Re-implements the reference's 3-source resolution (``_cfg_get``
web/server.py:281, ``load_env_files`` runtime_bootstrap.py:37,
``CONFIG_RESOLUTION_MODE`` web/.env.example:21, runtime values
``_runtime_cfg`` web/server.py:454).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional

from deepvision_tpu_torch.web import config as config_defaults

ENV_FILE_VAR = "DEEPVISION_ENV_FILE"
DEFAULT_ENV_FILES = (".env", ".env.local", ".env.cloud")


def parse_env_file(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                key, val = line.split("=", 1)
                val = val.strip().strip('"').strip("'")
                out[key.strip()] = val
    except OSError:
        pass
    return out


class ConfigResolver:
    def __init__(self, defaults_module=config_defaults):
        self._defaults = defaults_module
        self._env_files: Dict[str, str] = {}
        self._runtime: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self.loaded_files: list = []

    # -- loading --------------------------------------------------------
    def load_env_files(self, base_dir: str = ".") -> None:
        explicit = os.environ.get(ENV_FILE_VAR)
        candidates = (
            [explicit] if explicit
            else [os.path.join(base_dir, f) for f in DEFAULT_ENV_FILES]
        )
        merged: Dict[str, str] = {}
        for path in candidates:
            if path and os.path.isfile(path):
                merged.update(parse_env_file(path))
                self.loaded_files.append(path)
        with self._lock:
            self._env_files = merged

    # -- runtime overrides (admin config center) ------------------------
    def set_runtime(self, key: str, value: Any) -> None:
        with self._lock:
            self._runtime[key] = value

    def clear_runtime(self, key: Optional[str] = None) -> None:
        with self._lock:
            if key is None:
                self._runtime.clear()
            else:
                self._runtime.pop(key, None)

    def runtime_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._runtime)

    # -- resolution -----------------------------------------------------
    @property
    def mode(self) -> str:
        return (
            os.environ.get("CONFIG_RESOLUTION_MODE")
            or self._env_files.get("CONFIG_RESOLUTION_MODE")
            or getattr(self._defaults, "CONFIG_RESOLUTION_MODE", "auto")
        )

    def get(self, key: str, default: Any = None, cast: Optional[Callable] = None):
        with self._lock:
            if key in self._runtime:
                val = self._runtime[key]
                return self._cast(val, cast)
        if key in os.environ:
            return self._cast(os.environ[key], cast)
        if self.mode != "env_only" and key in self._env_files:
            return self._cast(self._env_files[key], cast)
        if hasattr(self._defaults, key):
            val = getattr(self._defaults, key)
            return self._cast(val, cast) if cast else val
        return default

    def source(self, key: str) -> str:
        """Where ``key`` currently resolves from: runtime override, process
        env, config file (.env/site), or code default (reference's config
        center reports the same provenance, web/server.py:44150-44240)."""
        with self._lock:
            if key in self._runtime:
                return "runtime"
        if key in os.environ:
            return "env"
        if self.mode != "env_only" and key in self._env_files:
            return "config"
        return "default"

    @staticmethod
    def _cast(val: Any, cast: Optional[Callable]):
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

    # typed accessors (reference _cfg_get / _cfg_int / _cfg_bool family)
    def get_str(self, key: str, default: str = "") -> str:
        v = self.get(key, default)
        return "" if v is None else str(v)

    def get_int(self, key: str, default: int = 0) -> int:
        return self.get(key, default, cast=int)

    def get_float(self, key: str, default: float = 0.0) -> float:
        return self.get(key, default, cast=float)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key, default)
        return self._cast(v, bool)

    def get_list(self, key: str, default=None) -> list:
        v = self.get(key, default or [])
        if isinstance(v, list):
            return v
        return [s.strip() for s in str(v).split(",") if s.strip()]
