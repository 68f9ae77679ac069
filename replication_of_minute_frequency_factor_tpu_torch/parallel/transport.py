"""The collectives' transport: ``torch.distributed`` over a mesh axis's
process group, chosen explicitly and never switched quietly.

* NCCL (every rank owns a card of its own) takes the card's tensors as
  they are: the collectives run on the device, enqueued on the current
  stream, with no host wait.
* gloo runs on host memory. CPU tensors go straight through. Card
  tensors are staged ON PURPOSE through pinned host buffers: a
  non-blocking copy down, one explicit wait for it
  (:func:`host_wait`, counted in ``mesh.staged_host_waits``), gloo on
  the host copies, a non-blocking copy back up. That wait is the
  transport's and the only host wait a collective adds; it is made
  outside ``torch.cuda.set_sync_debug_mode``'s check so a caller can
  hold the rest of a loop to zero host syncs while the transport's
  waits are counted on their own.

Bool tensors travel as their uint8 bytes. Every function takes a group
(None: the axis has one rank, and the collective is the identity).

* An in-process mesh's group (:class:`.local.GroupHandle`, one shard's
  handle on a :class:`.local.LocalGroup`) exchanges the shards' tensors
  by reference and copies them device to device, ordered by CUDA events:
  no host memory, no host wait (:mod:`.local`).

A step that must survive one rank's failure runs its collectives under
:func:`status_guard`: each :func:`all_gather` and :func:`all_reduce`
then first swaps a status over the step's group (:func:`swap_status`),
and raises :class:`PeerStepError` on every rank when any rank reported a
failure. A rank whose own work fails swaps its error once instead of
entering its next collective, so the ranks always meet in the same swap.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch
import torch.distributed as dist

from .local import GroupHandle

_LOCAL_OPS = {dist.ReduceOp.SUM: "sum", dist.ReduceOp.MIN: "min",
              dist.ReduceOp.MAX: "max"}


def backend_of(group) -> str:
    if isinstance(group, GroupHandle):
        return "local"
    return str(dist.get_backend(group))


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and backend_of(group) == "gloo"


def host_wait() -> None:
    """Wait for the current stream on the host: the gloo transport's
    staging wait, counted in
    ``mesh.staged_host_waits`` and exempt from the sync-debug check (it
    is the transport's, on purpose, and counted here instead)."""
    from ..telemetry import get_telemetry

    stream = torch.cuda.current_stream()
    mode = torch.cuda.get_sync_debug_mode()
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        stream.synchronize()
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)
    get_telemetry().counter("mesh.staged_host_waits")


def _down(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    return host


def _wire(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _unwire(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.view(torch.bool) if dtype == torch.bool else x


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order
    (JAX's tiled ``all_gather``)."""
    if group is None:
        return x
    _check_peers()
    if isinstance(group, GroupHandle):
        return group.all_gather(x, dim)
    n = dist.get_world_size(group)
    dtype, dev = x.dtype, x.device
    src = _wire(x)
    if _staged(src, group):
        src = _down(src)
        host_wait()
    if src.is_cuda:  # NCCL: one flat gather into a [n, ...] buffer
        out = torch.empty((n, *src.shape), dtype=src.dtype, device=dev)
        dist.all_gather_into_tensor(out, src, group=group)
        parts = list(out.unbind(0))
    else:
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
    full = torch.cat(parts, dim=dim)
    if full.device != dev:  # staged: back up from pinned memory
        full = full.pin_memory().to(dev, non_blocking=True)
    return _unwire(full, dtype)


def all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """A reduced copy of ``x`` (``op`` a ``dist.ReduceOp``) over the
    group; ``x`` is left as it was."""
    if group is None:
        return x
    _check_peers()
    if isinstance(group, GroupHandle):
        return group.all_reduce(x, _LOCAL_OPS[op])
    dev = x.device
    buf = x.contiguous().clone()
    if _staged(buf, group):
        buf = _down(buf)
        host_wait()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(dev, non_blocking=True) if buf.device != dev else buf


def gather(x: torch.Tensor, group) -> Optional[List]:
    """Every rank's ``x`` (equal shapes) to group rank 0 as a list in
    rank order; None on the other ranks. Built on :func:`all_gather`
    (NCCL has no gather on every version; the blocks here are one batch
    of results)."""
    if group is None:
        return [x]
    parts = all_gather(x.unsqueeze(0), group, dim=0).unbind(0)
    rank = (group.rank if isinstance(group, GroupHandle)
            else dist.get_rank(group))
    return list(parts) if rank == 0 else None


def broadcast_object(obj, group=None):
    """A picklable host object from global rank 0 to every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def all_gather_object(obj, group) -> List:
    """Every rank's picklable host ``obj``, in group-rank order."""
    if group is None:
        return [obj]
    if isinstance(group, GroupHandle):
        return group.all_gather_object(obj)
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def scatter_bytes(chunks: Optional[List[torch.Tensor]],
                  group) -> torch.Tensor:
    """Global rank 0's list of equal-length 1-D uint8 host buffers,
    one per group rank, scattered: each rank gets its own (a CPU
    tensor). Host bytes, so it runs on the host on every transport
    (gloo scatters the tensors; NCCL's groups scatter them as
    objects)."""
    if group is None:
        return chunks[0]
    is_src = dist.get_rank() == 0
    if backend_of(group) == "gloo":
        n_bytes = broadcast_object(
            int(chunks[0].numel()) if is_src else None, group)
        out = torch.empty(n_bytes, dtype=torch.uint8)
        dist.scatter(out, [c.contiguous() for c in chunks]
                     if is_src else None, src=0, group=group)
        return out
    box = [None]
    dist.scatter_object_list(box, [c.numpy() for c in chunks]
                             if is_src else None, src=0, group=group)
    return torch.from_numpy(box[0])


class PeerStepError(RuntimeError):
    """A status swap of a guarded step found failed ranks; ``errors``
    holds their reports, in group-rank order. Every rank of the step
    raises it from the same swap."""

    def __init__(self, errors: List[str]):
        super().__init__("; ".join(errors))
        self.errors = list(errors)


_GUARD = threading.local()


@contextlib.contextmanager
def status_guard(group):
    """Within the block, on this thread, every :func:`all_gather` and
    :func:`all_reduce` first swaps a status over ``group`` (None: no
    swap). One small object all-gather a collective."""
    prev = getattr(_GUARD, "group", None)
    _GUARD.group = group
    try:
        yield
    finally:
        _GUARD.group = prev


def swap_status(err: Optional[str], group) -> List[str]:
    """This rank's error report (None: it is fine) swapped over
    ``group``; returns every rank's report that is not None."""
    return [e for e in all_gather_object(err, group) if e is not None]


def _check_peers() -> None:
    group = getattr(_GUARD, "group", None)
    if group is None:
        return
    errors = swap_status(None, group)
    if errors:
        raise PeerStepError(errors)
