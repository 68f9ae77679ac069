"""Replica lifecycle: N :class:`..serve.service.FactorServer` s over
disjoint device groups.

A *replica* is one resident FactorServer with its own group of devices
(:func:`partition_devices`) and its OWN :class:`..telemetry.Telemetry`.
Replicas live in one process, each with its own worker thread; a
server runs on the first device of its group (``FactorServer._device_ctx``
makes that device and its stream current on the worker thread), as the
JAX package's server runs on its submesh lead, and with
``ServeConfig.stream_sharded`` its stream carry spans the whole group
(an in-process mesh, ``parallel.local``). The replica index/label
ride the multihost identity stamps (``process_index``/``host``) on every
bundle the replica writes, so ``telemetry.aggregate`` folds a fleet's
bundles exactly like a multihost pod's — the fleet IS a pod, in-process.

Health is the existing ``healthz`` surface: :meth:`Replica.health`
returns :meth:`..serve.service.FactorServer.health` verbatim (with the
``replica`` identity block), plus :meth:`Replica.probe_device` — a
device-liveness probe that puts one tensor on the replica's device and
waits for that card.

Host syncs: the probe's wait is this module's one declared host sync.
Everything else in the layer stays sync-free; the answer fetch stays
``serve/service.py``'s declared sync.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..serve.service import FactorServer, ServeConfig
from ..telemetry import Telemetry


def partition_devices(n_replicas: int, devices: Optional[Sequence] = None
                      ) -> List[tuple]:
    """``n_replicas`` contiguous device groups out of ``devices``
    (default every visible card, ``cuda:0`` .. ``cuda:{n-1}``):
    ``len(devices) // n_replicas`` devices each, remainder devices left
    unassigned (a 9-card host at N=4 runs 4×2 and idles one — the
    partition is uniform so no replica is a structural straggler).
    Raises when there are fewer devices than replicas, and, with no
    ``devices`` given, when no card is visible: the CPU runs a fleet only
    when the caller lists it (``[torch.device('cpu')] * n``). The groups
    are disjoint positions of the list; the list itself is not checked,
    as the JAX package does not check it (its tests give it virtual
    devices of one CPU)."""
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1 (got {n_replicas})")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=[torch.device('cpu')]"
                " * n_replicas to run the fleet on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_replicas > len(devices):
        raise ValueError(
            f"cannot partition {len(devices)} device(s) into "
            f"{n_replicas} disjoint replica submeshes")
    per = len(devices) // n_replicas
    return [tuple(devices[i * per:(i + 1) * per])
            for i in range(n_replicas)]


class Replica:
    """One fleet member: a FactorServer over its device group, its own
    telemetry, and the identity the pod planes address it by."""

    def __init__(self, index: int, devices: Sequence, source,
                 names: Optional[Sequence[str]] = None,
                 serve_cfg: Optional[ServeConfig] = None,
                 replicate_quirks: bool = True,
                 rolling_impl: Optional[str] = None,
                 stream: bool = False,
                 stream_batches: Sequence[int] = (1,),
                 start: bool = True,
                 label: Optional[str] = None):
        self.index = int(index)
        self.label = label or f"r{self.index}"
        self.devices: Tuple = tuple(devices)
        if not self.devices:
            raise ValueError(f"replica {self.label} got an empty "
                             "device set")
        #: per-replica telemetry: counters/spans/requests of this
        #: replica only — the pod view is the registry-merge fold over
        #: these (fleet/http.py), never a shared mutable registry
        self.telemetry = Telemetry()
        self.stream = bool(stream)
        self.server = FactorServer(
            source, names=names, serve_cfg=serve_cfg,
            replicate_quirks=replicate_quirks,
            rolling_impl=rolling_impl, telemetry=self.telemetry,
            start=start, stream=stream, stream_batches=stream_batches,
            replica_label=self.label, devices=self.devices)
        #: the server's resolved group (a bare ``cuda`` gets its index)
        self.devices = self.server.devices

    # --- health ---------------------------------------------------------
    def health(self) -> dict:
        """The replica's ``healthz`` payload — exactly the standalone
        server's shape, so the pod rollup is a dict of these."""
        return self.server.health()

    def probe_device(self) -> bool:
        """Device liveness: put one tensor on the group's first device
        and wait for that card. The wait is this module's one declared
        host sync — a wedged card surfaces here (False), not as a hung
        request inside the worker loop. On the CPU the put is the whole
        probe."""
        try:
            dev = self.devices[0]
            torch.ones((), device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return True
        except Exception:  # noqa: BLE001 — the probe's job is the bool
            self.telemetry.counter("fleet.device_probe_failures",
                                   replica=self.label)
            return False

    def hbm_bytes(self) -> Tuple[float, bool]:
        """``(bytes_in_use summed over this replica's devices,
        available)`` from the replica telemetry's last HBM watermark
        sample (keys ``cuda:<i>``) — the headroom signal the shed policy
        demotes on. Replicas that share a card read the same card's
        bytes. Plain dict reads; never a device sync."""
        summary = self.telemetry.hbm.summary()
        keys = {str(d) for d in self.devices}
        total = sum(v.get("bytes_in_use", 0)
                    for k, v in (summary.get("devices") or {}).items()
                    if k in keys)
        return float(total), bool(summary.get("available"))

    # --- bundles (the pod aggregation leg) ------------------------------
    def write_bundle(self, out_dir: str, cfg=None) -> dict:
        """Write this replica's telemetry bundle stamped with its
        identity (``process_index=index``, ``host=label`` — the
        multihost stamps), so ``telemetry.aggregate`` folds fleet
        bundles exactly like multihost ones. Returns the artifact
        paths."""
        return self.telemetry.write(out_dir, cfg=cfg,
                                    process_index=self.index,
                                    host=self.label)

    # --- lifecycle ------------------------------------------------------
    def start(self) -> "Replica":
        self.server.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        self.server.close(timeout=timeout)

    def __repr__(self) -> str:  # debug/demo friendliness
        return (f"Replica({self.label}, devices="
                f"{[str(d) for d in self.devices]})")


def build_replicas(source, n_replicas: int,
                   devices: Optional[Sequence] = None,
                   **replica_kwargs) -> List[Replica]:
    """``n_replicas`` Replicas over :func:`partition_devices`' device
    groups, indices/labels assigned in device order."""
    groups = partition_devices(n_replicas, devices)
    return [Replica(i, g, source, **replica_kwargs)
            for i, g in enumerate(groups)]
