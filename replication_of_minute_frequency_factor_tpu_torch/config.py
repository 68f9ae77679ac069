"""Typed configuration: the fields of the JAX package's ``Config`` that
the port reads, with the same defaults and environment overrides (the
backend's default names the port's device path)."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass
class Config:
    """The JAX package's ``Config``, minus the fields the port does not
    take, which a caller cannot set (passing one is a TypeError): the XLA
    knobs ``compile_telemetry`` and ``compilation_cache_dir`` have no
    torch counterpart (eager torch compiles nothing). ``backend``
    defaults to ``'torch'``, the device path, where the JAX package's
    default is ``'jax'``."""

    # --- data roots ---
    #: directory of per-trading-day minute-bar parquet files
    #: (YYYYMMDD*.parquet)
    minute_dir: str = "data/kline"
    #: single parquet of daily price/volume data (CSMAR column names)
    daily_pv_path: str = "data/price_volume.parquet"
    #: directory where factor exposures are cached
    factor_dir: str = "data/factors"

    # --- execution ---
    #: 'torch' (the device pipeline), 'numpy' (the polars-semantics f64
    #: oracle on the host, oracle/), or 'polars' (refused: the reference
    #: harness that runs the reference's own kernels imports the JAX
    #: package)
    backend: str = "torch"
    #: how many trading days to batch into one device step
    days_per_batch: int = 8
    #: the ``(days, tickers)`` mesh of ranks the host driver shards over
    #: (``compute_exposures``: ``(1, n)`` only, one rank per ticker
    #: shard); None = one device
    mesh_shape: Optional[Tuple[int, int]] = None
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
    #: streaming snapshot finalize: 'exact' — the bitwise batch-prefix
    #: finalize (O(day) a snapshot); 'fast' — the foldable kernels
    #: materialize from the carried statistics (stream/fastpath.py),
    #: exact_fold bitwise, stat_fold within STAT_FOLD_BOUNDS, batch_only
    #: the same bits as 'exact'
    finalize_impl: str = "exact"
    #: donate the resident year's input buffers
    #: (pipeline.compute_packed_resident): each buffer's storage is
    #: released once its step is enqueued, so the year's inputs are not
    #: all live at once; only on the card (on the CPU nothing is donated)
    donate_buffers: bool = True
    #: index-pool membership parquet enabling cal_final_exposure's
    #: stock_pool= (data/io.py read_stock_pool); None keeps the
    #: reference's only-'full' behaviour (quirk Q9)
    stock_pool_path: Optional[str] = None
    #: capture a torch.profiler trace of each compute_exposures run into
    #: this directory (``*.trace.json``, Chrome format; post-process with
    #: telemetry.attribution.summarize_trace_dir); None = off
    profile_dir: Optional[str] = None
    #: wall-clock reconciliation gate: the fraction of a run's wall time
    #: allowed to stay unattributed (no stage accounts for it) before
    #: the run is flagged (telemetry.attribution)
    attribution_tolerance: float = 0.10
    #: ship day batches as the packed ingest wire (data/wire.py, ~3x
    #: fewer bytes than f32 bars on typical data; falls back to f32 bars
    #: per batch when unrepresentable)
    wire_transfer: bool = True
    #: runtime lock assertions (telemetry/lockcheck.py): arm the declared
    #: lock contracts so a mutation of a guarded attribute without its
    #: owning lock raises LockAssertionError and counts
    #: lockcheck.violations; MFF_LOCK_ASSERT=1 is the env override
    debug_lock_assert: bool = False

    @classmethod
    def from_env(cls) -> "Config":
        cfg = cls()
        mapping = {
            "MFF_MINUTE_DIR": "minute_dir",
            "MFF_DAILY_PV_PATH": "daily_pv_path",
            "MFF_FACTOR_DIR": "factor_dir",
            "MFF_BACKEND": "backend",
            "MFF_ROLLING_IMPL": "rolling_impl",
            "MFF_FINALIZE_IMPL": "finalize_impl",
            "MFF_STOCK_POOL_PATH": "stock_pool_path",
            "MFF_PROFILE_DIR": "profile_dir",
        }
        for env, field in mapping.items():
            if env in os.environ:
                setattr(cfg, field, os.environ[env])
        if "MFF_DAYS_PER_BATCH" in os.environ:
            cfg.days_per_batch = int(os.environ["MFF_DAYS_PER_BATCH"])
        if "MFF_REPLICATE_QUIRKS" in os.environ:
            cfg.replicate_quirks = os.environ["MFF_REPLICATE_QUIRKS"] not in (
                "0", "false", "False")
        if "MFF_DONATE_BUFFERS" in os.environ:
            cfg.donate_buffers = os.environ["MFF_DONATE_BUFFERS"] not in (
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


def set_config(cfg: Config) -> Config:
    global _config
    _config = cfg
    return cfg
