"""Run manifest: the once-per-run provenance record.

Answers "what exactly produced these numbers" after the fact: config
(and its hash), the torch, CUDA and numpy versions, the card (name,
count, power limit), the wire format spec, and the git SHA. Written as
``manifest.json`` by ``Telemetry.write`` and embedded as the first JSONL
record of the metrics stream.

The port of the JAX package's ``telemetry/manifest.py``. Its
``analysis`` block (the static-analysis verdict) is left out: the port
has no ``analysis/`` package yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import subprocess
import sys
import time
from typing import Optional

from .sink import SCHEMA_VERSION


def _git_sha() -> Optional[str]:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "-C", root, "rev-parse", "HEAD"], timeout=5,
            capture_output=True, text=True)
        return out.stdout.strip() if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired):
        return None


def _power_limit() -> Optional[str]:
    """The first card's power limit as ``nvidia-smi`` reports it, or
    None where the tool is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], timeout=10,
            capture_output=True, text=True)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _device_topology() -> dict:
    """Best-effort device inventory: the CUDA cards torch sees (name,
    count, the first card's power limit). Never raises."""
    try:
        import torch
        if not torch.cuda.is_available():
            return {"probed": True, "platform": "cpu", "device_kind": None,
                    "num_devices": 0, "process_count": 1}
        n = torch.cuda.device_count()
        return {"probed": True, "platform": "gpu",
                "device_kind": torch.cuda.get_device_name(0),
                "num_devices": n, "process_count": 1,
                "power_limit": _power_limit()}
    except Exception as e:  # noqa: BLE001 — diagnostics must not raise
        return {"probed": False, "error": f"{type(e).__name__}: {e}"}


def _wire_spec() -> dict:
    from ..data import wire  # lazy: wire imports telemetry
    from ..native import TICKS_PER_UNIT

    n_slots = 240  # the wire's cn_ashare_240 day
    return {"tick": 1.0 / TICKS_PER_UNIT, "n_slots": n_slots,
            "mask_bytes": n_slots // 8,
            "vol10_bytes": n_slots // 4 * 5, "i16_max": wire._I16}


def process_identity() -> dict:
    """The multihost identity stamps (schema v3):
    ``{"process_index", "host"}``. The index is ``MFF_PROCESS_INDEX``
    (the override launch scripts use), then the rank of an initialized
    ``torch.distributed`` group, else 0. The host label is
    ``MFF_HOST_LABEL`` or the node name."""
    idx = None
    env = os.environ.get("MFF_PROCESS_INDEX")
    if env is not None:
        try:
            idx = int(env)
        except ValueError:
            idx = None
    if idx is None and "torch.distributed" in sys.modules:
        try:
            import torch.distributed as dist
            if dist.is_available() and dist.is_initialized():
                idx = int(dist.get_rank())
        except Exception:  # noqa: BLE001 — identity must not raise
            idx = None
    return {"process_index": idx if idx is not None else 0,
            "host": os.environ.get("MFF_HOST_LABEL") or platform.node()}


def config_hash(cfg) -> str:
    """sha256 of the sorted-JSON config; the manifest's join key back to
    a reproducible configuration."""
    d = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else dict(cfg)
    return hashlib.sha256(
        json.dumps(d, sort_keys=True, default=str).encode()).hexdigest()


def build_manifest(cfg=None, extra: Optional[dict] = None) -> dict:
    if cfg is None:
        from ..config import get_config
        cfg = get_config()
    versions = {"python": platform.python_version()}
    for mod in ("torch", "numpy", "pyarrow"):
        try:
            versions[mod] = __import__(mod).__version__
        except Exception:  # noqa: BLE001 — absent/broken dep recorded as null
            versions[mod] = None
    try:
        import torch
        versions["cuda"] = torch.version.cuda
    except Exception:  # noqa: BLE001 — recorded as null
        versions["cuda"] = None
    manifest = {
        "schema": SCHEMA_VERSION,
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "config": dataclasses.asdict(cfg),
        "config_hash": config_hash(cfg),
        "versions": versions,
        "devices": _device_topology(),
        "wire_spec": _wire_spec(),
        "git_sha": _git_sha(),
        **process_identity(),
        "pid": os.getpid(),
        "argv": list(sys.argv),
    }
    if extra:
        manifest.update(extra)
    return manifest


def write_manifest(path: str, cfg=None,
                   extra: Optional[dict] = None) -> dict:
    m = build_manifest(cfg, extra)
    with open(path, "w") as fh:
        json.dump(m, fh, indent=1)
    return m
