"""Runtime configuration.

The reference's only knobs are compile-time feature switches
(tuning.lisp:10-41 reader conditionals). Here configuration is a typed
runtime dataclass, read from TBZ_TORCH_* environment variables on first
use. Unlike `tbz`, the backend defaults to the device: the port exists
to run the decode on the card.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class Config:
    # Backend policy: where LZ77 resolution runs.
    backend: str = "device"          # 'device' | 'host' | 'auto' (= host)
    # Tokenizer of the streams the fused decode declines.
    frontend: str = "auto"           # 'auto' | 'native' | 'python' | 'device'

    # Encoder level of api.compress when its level is None.
    level: int = 6

    # Mesh (dp = streams, sp = sequence), read by parallel.mesh.make_mesh.
    mesh_dp: int | None = None       # None = all devices
    mesh_sp: int = 1

    @staticmethod
    def from_env(prefix: str = "TBZ_TORCH_") -> "Config":
        c = Config()
        for f in dataclasses.fields(Config):
            v = os.environ.get(prefix + f.name.upper())
            if v is not None:
                setattr(c, f.name, int(v) if "int" in f.type else v)
        return c


_default: Config | None = None


def get_config() -> Config:
    """Process-wide config; initialized from TBZ_TORCH_* env vars on
    first use (e.g. TBZ_TORCH_BACKEND=host, TBZ_TORCH_FRONTEND=device,
    TBZ_TORCH_LEVEL=9)."""
    global _default
    if _default is None:
        _default = Config.from_env()
    return _default


def set_config(cfg: Config) -> None:
    """Replace the process-wide config (e.g. Config(frontend="device"))."""
    global _default
    _default = cfg
