"""Typed configuration: the fields of the JAX package's ``Config`` that
the port reads so far, with the same environment overrides."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class Config:
    #: replicate reference quirks Q1-Q4 bit-for-bit (SURVEY.md §2.5).
    #: False switches to the mathematically intended definitions.
    replicate_quirks: bool = True
    #: rolling-moment backend for the mmt_ols_* family
    #: (ops/rolling.ROLLING_IMPLS): 'cuda' — the hand-written Hopper
    #: kernel (ops/rolling_cuda.py), which resolves to the plain torch
    #: version only for tensors on the CPU; 'torch' — the plain torch
    #: version, everywhere
    rolling_impl: str = "cuda"

    @classmethod
    def from_env(cls) -> "Config":
        cfg = cls()
        if "MFF_ROLLING_IMPL" in os.environ:
            cfg.rolling_impl = os.environ["MFF_ROLLING_IMPL"]
        if "MFF_REPLICATE_QUIRKS" in os.environ:
            cfg.replicate_quirks = os.environ["MFF_REPLICATE_QUIRKS"] not in (
                "0", "false", "False")
        return cfg


_config: Optional[Config] = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config.from_env()
    return _config
