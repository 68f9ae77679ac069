"""Typed configuration: the fields of the JAX package's ``Config`` that
the port reads so far, with the same defaults and environment
overrides."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

#: the JAX package's Config fields the port leaves out, and why
NOT_PORTED = {
    "mesh_shape": "multi-device runs are ROADMAP Queue 1 item 10",
    "profile_dir": "profiler capture is ROADMAP Queue 1 item 9",
    "compile_telemetry": "XLA compile telemetry has no torch counterpart",
    "compilation_cache_dir": "eager torch has no XLA compilation cache",
    "donate_buffers": "XLA buffer donation has no torch counterpart",
}


@dataclasses.dataclass
class Config:
    #: directory of per-trading-day minute-bar parquet files
    #: (YYYYMMDD*.parquet)
    minute_dir: str = "data/kline"
    #: how many trading days to batch into one device step
    days_per_batch: int = 8
    #: replicate reference quirks Q1-Q4 bit-for-bit (SURVEY.md §2.5).
    #: False switches to the mathematically intended definitions.
    replicate_quirks: bool = True
    #: debug sanitizer: validate day arrays (finite prices, high>=low,
    #: volume>=0 on valid lanes) before compute; raises DayDataError
    debug_validate: bool = False
    #: rolling-moment backend for the mmt_ols_* family
    #: (ops/rolling.ROLLING_IMPLS): 'cuda' — the hand-written Hopper
    #: kernel (ops/rolling_cuda.py), which resolves to the plain torch
    #: version only for tensors on the CPU; 'torch' — the plain torch
    #: version, everywhere
    rolling_impl: str = "cuda"
    #: wall-clock reconciliation gate: the fraction of a run's wall time
    #: allowed to stay unattributed (no stage accounts for it) before
    #: the run is flagged (telemetry.attribution)
    attribution_tolerance: float = 0.10
    #: ship day batches as the packed ingest wire (data/wire.py, ~3x
    #: fewer bytes than f32 bars on typical data; falls back to f32 bars
    #: per batch when unrepresentable)
    wire_transfer: bool = True
    #: fields of the JAX package's Config the port does not take
    #: (:data:`NOT_PORTED` says why); ``compute_exposures`` raises
    #: NotImplementedError when one is set
    mesh_shape: Optional[Tuple[int, int]] = None
    profile_dir: Optional[str] = None
    compile_telemetry: Optional[bool] = None
    compilation_cache_dir: Optional[str] = None
    donate_buffers: Optional[bool] = None

    def not_ported(self) -> Optional[str]:
        """Why a set field cannot run in the port, or None."""
        for name, why in NOT_PORTED.items():
            if getattr(self, name) is not None:
                return f"Config.{name} is not ported: {why}"
        return None

    @classmethod
    def from_env(cls) -> "Config":
        cfg = cls()
        if "MFF_MINUTE_DIR" in os.environ:
            cfg.minute_dir = os.environ["MFF_MINUTE_DIR"]
        if "MFF_ROLLING_IMPL" in os.environ:
            cfg.rolling_impl = os.environ["MFF_ROLLING_IMPL"]
        if "MFF_DAYS_PER_BATCH" in os.environ:
            cfg.days_per_batch = int(os.environ["MFF_DAYS_PER_BATCH"])
        if "MFF_REPLICATE_QUIRKS" in os.environ:
            cfg.replicate_quirks = os.environ["MFF_REPLICATE_QUIRKS"] not in (
                "0", "false", "False")
        if "MFF_ATTRIBUTION_TOLERANCE" in os.environ:
            cfg.attribution_tolerance = float(
                os.environ["MFF_ATTRIBUTION_TOLERANCE"])
        return cfg


_config: Optional[Config] = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config.from_env()
    return _config
