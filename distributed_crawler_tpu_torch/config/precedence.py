"""Four-level config precedence: CLI flags > ``CRAWLER_*`` env > YAML file >
defaults.

The port's copy of the reference's `distributed_crawler_tpu/config/
precedence.py`, with the same env mapping and search paths:

- env vars are prefixed ``CRAWLER_``, the dotted key's dots and dashes
  mapped to underscores and upper-cased;
- the YAML config file is searched in ``.``, ``~/.crawler`` and
  ``/etc/crawler``; a file named explicitly must exist.

``yaml`` is imported only when a config file is actually read, so a run
configured by flags and environment alone needs no PyYAML.  Where PyYAML
is missing, a found or named config file is an error that says so.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

ENV_PREFIX = "CRAWLER_"
CONFIG_FILENAMES = ("config.yaml", "config.yml")
CONFIG_SEARCH_PATHS = (".", os.path.expanduser("~/.crawler"), "/etc/crawler")


def _flatten(d: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def env_key(key: str) -> str:
    """``'crawler.max-pages'`` -> ``'CRAWLER_CRAWLER_MAX_PAGES'``: the
    full dotted key, dots and dashes replaced by underscores, upper-cased,
    prefixed."""
    return ENV_PREFIX + key.replace(".", "_").replace("-", "_").upper()


def _load_yaml(path: str) -> Any:
    try:
        import yaml
    except ImportError:
        raise ValueError(
            f"config file {path} needs PyYAML (the 'yaml' package), which "
            f"is not installed; configure with flags and CRAWLER_* "
            f"environment variables instead") from None
    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f)


class ConfigResolver:
    """Resolves dotted config keys through the precedence chain."""

    def __init__(
        self,
        flags: Optional[Mapping[str, Any]] = None,
        env: Optional[Mapping[str, str]] = None,
        config_file: Optional[str] = None,
    ):
        self._flags = dict(flags or {})
        self._flag_set = {k for k, v in self._flags.items() if v is not None}
        self._env = env if env is not None else os.environ
        self._file_values: Dict[str, Any] = {}
        if config_file and not os.path.exists(config_file):
            # Only search-path misses are tolerated.
            raise FileNotFoundError(f"config file not found: {config_file}")
        path = config_file or self._find_config_file()
        if path and os.path.exists(path):
            loaded = _load_yaml(path) or {}
            if not isinstance(loaded, dict):
                raise ValueError(f"config file {path} must contain a mapping")
            self._file_values = _flatten(loaded)
            self.config_file_used = path
        else:
            self.config_file_used = None

    @staticmethod
    def _find_config_file() -> Optional[str]:
        for d in CONFIG_SEARCH_PATHS:
            for name in CONFIG_FILENAMES:
                p = os.path.join(d, name)
                if os.path.exists(p):
                    return p
        return None

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._flag_set:
            return self._flags[key]
        ek = env_key(key)
        if ek in self._env:
            return self._env[ek]
        if key in self._file_values:
            return self._file_values[key]
        return default

    def get_str(self, key: str, default: str = "") -> str:
        v = self.get(key, default)
        return "" if v is None else str(v)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key, default)
        if v is None or v == "":
            return default
        return int(v)

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get(key, default)
        if v is None or v == "":
            return default
        return float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key, default)
        if isinstance(v, bool):
            return v
        if v is None or v == "":
            return default
        return str(v).strip().lower() in ("1", "true", "yes", "on")

    def get_list(self, key: str, default: Optional[list] = None) -> list:
        v = self.get(key, None)
        if v is None or v == "":
            return list(default or [])
        if isinstance(v, (list, tuple)):
            return list(v)
        return [s.strip() for s in str(v).split(",") if s.strip()]
