"""Config loading: json files + WEED_* environment overrides.

The port's copy of ``seaweedfs_tpu/util/config.py``.

Behavioral model: weed/util/config.go (viper) + scaffold.go:17-24 — files
discovered in ./, ~/.seaweedfs/, /etc/seaweedfs/; any key overridable via
`WEED_<UPPER_PATH>` env vars (dots → underscores). JSON instead of TOML
(stdlib-only, same key shapes; `weed scaffold` prints templates).
"""

from __future__ import annotations

import json
import os
from typing import Any

SEARCH_DIRS = [".", os.path.expanduser("~/.seaweedfs"), "/etc/seaweedfs"]


class Configuration:
    def __init__(self, data: dict | None = None):
        self._data = data or {}

    @classmethod
    def load(cls, name: str) -> "Configuration":
        """Find `<name>.json` in the search path (first hit wins)."""
        for d in SEARCH_DIRS:
            path = os.path.join(d, f"{name}.json")
            if os.path.exists(path):
                with open(path) as f:
                    return cls(json.load(f))
        return cls()

    def get(self, key: str, default: Any = None) -> Any:
        """Dotted key lookup with WEED_* env override
        (env beats file, like viper's AutomaticEnv)."""
        env_key = "WEED_" + key.upper().replace(".", "_")
        if env_key in os.environ:
            raw = os.environ[env_key]
            try:
                return json.loads(raw)
            except json.JSONDecodeError:
                return raw
        cur: Any = self._data
        for part in key.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur

    def get_string(self, key: str, default: str = "") -> str:
        return str(self.get(key, default))

    def get_int(self, key: str, default: int = 0) -> int:
        return int(self.get(key, default))

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key, default)
        if isinstance(v, str):
            return v.lower() in ("1", "true", "yes", "on")
        return bool(v)
