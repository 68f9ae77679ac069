"""Multi-process, multi-host runs: the process group and the global mesh.

The port of the JAX package's ``parallel/multihost.py``. There,
``jax.distributed.initialize`` joins the processes of a pod and one
global mesh spans every host's devices. Here every rank is a process,
so the multihost layer is the same mesh spread over hosts:
:func:`initialize` is ``torch.distributed.init_process_group`` with the
coordinator address, the process count and this process's id given
explicitly or read from the environment (``torchrun``'s
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``), and
:func:`shard_from_host_local` is each process feeding only its own
block.

The transport is chosen explicitly (:func:`choose_backend`): NCCL where
every rank of a host owns a card of its own, gloo on the CPU and where
several ranks share one card (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..telemetry import get_telemetry
from .mesh import Mesh, _to_rank, day_batch_spec, local_slice, make_mesh
from .mesh import mask_spec, rank_device

#: seconds a rendezvous or a collective may wait before it fails
DEFAULT_TIMEOUT_S = 300.0


def choose_backend(device_type: str, local_world_size: int) -> str:
    """``'nccl'`` when the ranks run on cards and each rank of this host
    has a card of its own, else ``'gloo'``."""
    if device_type == "cuda" and torch.cuda.is_available() \
            and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None,
               local_world_size: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group: ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id`` as given, else from the
    environment. No-op when the group is already up, or when no
    coordinator is named anywhere (a single-process run). The card, when
    ``device`` asks for it, is set to ``cuda:{local_rank %
    device_count}`` first; ``backend`` defaults to
    :func:`choose_backend`. A named coordinator's failure raises."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return  # single process: the one-rank mesh needs no group
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if local_world_size is None:
        local_world_size = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = choose_backend(dev.type, local_world_size)
    tel = get_telemetry()
    # spanned: it blocks until every process has dialled the coordinator,
    # so its duration is the startup skew across processes
    with tel.span("multihost.initialize"):
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=timedelta(seconds=float(timeout_s)))
    tel.gauge("multihost.process_index", process_index())
    tel.gauge("multihost.process_count", process_count())


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(shape: Optional[Tuple[int, int]] = None,
                device=None) -> Mesh:
    """The ``(days, tickers)`` mesh over every rank of every process."""
    return make_mesh(shape, device)


def shard_from_host_local(bars: np.ndarray, mask: np.ndarray, mesh: Mesh):
    """This process's block of the batch from the rows IT owns: each
    process passes its slice of the global tickers axis (the global
    axis is the processes' slices in process order; a 2-D mesh also
    splits the days axis here), and no process ever holds the full
    batch. Returns ``(bars, mask)`` on this rank's device, the
    multihost twin of :func:`..parallel.mesh.shard_day_batch`."""
    batched = np.ndim(bars) == 4
    tel = get_telemetry()
    host = str(process_index())
    with tel.span("multihost.shard_from_host_local"):
        d_spec = day_batch_spec(batched)
        m_spec = mask_spec(batched)
        if batched and mesh.shape["days"] > 1:
            # the tickers block is this process's; the days split still
            # applies to it
            bars = local_slice(np.asarray(bars),
                               (d_spec[0],) + (None,) * 3, mesh)
            mask = local_slice(np.asarray(mask),
                               (m_spec[0],) + (None,) * 2, mesh)
        out = (_to_rank(np.asarray(bars, np.float32), mesh),
               _to_rank(np.asarray(mask, bool), mesh))
    tel.counter("multihost.shards_built", host=host)
    # the fraction of this host's lanes that are real bars (the host
    # array: no device wait)
    tel.meshplane.record_occupancy(float(np.asarray(mask).mean()),
                                   boundary="multihost.ingest")
    return out
