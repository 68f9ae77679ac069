"""Device mesh and sharding layout for the day-batch tensor.

The port of the JAX package's ``parallel/mesh.py``. JAX runs one
controller over a ``Mesh`` of devices; here each mesh coordinate is a
process of its own (one rank, ``torch.distributed``), and a
:class:`Mesh` is a ``(days, tickers)`` grid of ranks over
``torch.distributed.device_mesh.init_device_mesh``. Rank ``r`` sits at
``(r // t, r % t)`` and runs on ``cuda:{local_rank % device_count}``, or
on the CPU when the caller asks for it.

A JAX ``PartitionSpec`` becomes a plain description: a tuple naming, per
array axis, the mesh axis a rank holds a contiguous slice of (``None``:
the axis is whole on every rank). ``put_*`` and :func:`shard_day_batch`
take the host array every rank can see and return THIS rank's block on
its device. Factor kernels are pure per-(day, ticker) maps, so both axes
are data-parallel; the cross-sectional stages turn the tickers axis into
a collective axis (``collectives.py``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DAYS_AXIS = "days"
TICKERS_AXIS = "tickers"
AXES = (DAYS_AXIS, TICKERS_AXIS)


class Mesh:
    """A ``(days, tickers)`` grid of ranks, this process being one of
    them. ``shape`` maps each axis name to its extent (as the JAX mesh's
    ``shape`` does); ``coordinate`` is this rank's ``(day-shard,
    ticker-shard)``; ``device`` is where its tensors live;
    :meth:`group` is the process group along one axis (None when the
    axis has one rank: its collectives are the identity). A one-rank
    mesh needs no process group at all."""

    def __init__(self, shape: Tuple[int, int], device, device_mesh=None):
        d, t = int(shape[0]), int(shape[1])
        self.shape: Dict[str, int] = {DAYS_AXIS: d, TICKERS_AXIS: t}
        self.device = torch.device(device)
        self._dm = device_mesh
        if device_mesh is None:
            self.rank = 0
        else:
            import torch.distributed as dist
            self.rank = dist.get_rank()
        self.size = d * t
        self.coordinate = (self.rank // t, self.rank % t)

    @property
    def backend(self) -> Optional[str]:
        """The transport of the mesh's groups (``'nccl'`` or ``'gloo'``),
        None for a one-rank mesh without a process group."""
        if self._dm is None:
            return None
        import torch.distributed as dist
        return str(dist.get_backend())

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.coordinate[AXES.index(axis)]

    def group(self, axis: str):
        """The process group along ``axis`` through this rank, or None
        when the axis has one rank."""
        if self._dm is None or self.shape[axis] == 1:
            return None
        return self._dm.get_group(axis)

    def __enter__(self) -> "Mesh":
        _ACTIVE.stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.stack.pop()

    def __repr__(self) -> str:
        return (f"Mesh(days={self.shape[DAYS_AXIS]}, "
                f"tickers={self.shape[TICKERS_AXIS]}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


class _Active(threading.local):
    def __init__(self):
        self.stack: List[Mesh] = []


_ACTIVE = _Active()


def current_mesh() -> Mesh:
    """The mesh a ``with mesh:`` block made active on this thread: the
    collectives resolve an axis NAME through it, as a JAX axis name
    resolves through the enclosing ``shard_map``."""
    if not _ACTIVE.stack:
        raise RuntimeError(
            "a collective over a named mesh axis needs an active mesh: "
            "run it inside 'with mesh:' (parallel.make_mesh)")
    return _ACTIVE.stack[-1]


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:{local_rank % device_count}`` for the
    card (``device`` None or ``'cuda'``), else ``device`` as given.
    Raises when the card was asked for and is absent: a mesh never runs
    quietly on the CPU."""
    import os

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the mesh on "
            "the CPU")
    if dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(shape: Optional[Tuple[int, int]] = None, device=None
              ) -> Mesh:
    """A ``(days, tickers)`` mesh over every rank of the process group.

    Default shape ``(1, world_size)``: the ticker axis is the wide one
    (~5000 tickers vs a handful of days a batch) and per-stock kernels
    need no communication. Without a process group only the one-rank
    mesh exists (``multihost.initialize`` or ``launch.run_ranks`` start
    one). ``device`` as :func:`rank_device`."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (1, world)
    d, t = int(shape[0]), int(shape[1])
    if d < 1 or t < 1 or d * t != world:
        raise ValueError(f"mesh shape {tuple(shape)} does not match "
                         f"{world} ranks")
    dev = rank_device(device)
    if not dist.is_initialized():
        return Mesh((d, t), dev)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (d, t), mesh_dim_names=AXES)
    return Mesh((d, t), dev, dm)


def resident_mesh(n_shards: Optional[int] = None,
                  devices: Optional[Sequence] = None, shape=None,
                  device=None):
    """The resident loops' and the in-server placements' mesh (the JAX
    package's ``resident_mesh(n_shards, devices, shape)``).

    * ``devices`` given: the in-process :class:`.local.LocalMesh` over
      ``devices[:n_shards]`` (all of them by default), tickers-only, a
      worker thread a shard. ``[torch.device('cpu')] * n`` runs it on
      the CPU; a device may repeat.
    * no ``devices`` and a process group: a mesh of ranks, ``(1, n)``
      tickers-only by default or a full 2-D ``(d, t)`` via ``shape``;
      every rank of the group must be on it (a rank per coordinate), on
      ``device`` as :func:`rank_device` resolves it.
    * neither: the in-process mesh over every visible card (raising when
      there is none), unless ``device`` names the CPU, which gives the
      one-rank mesh.
    """
    import torch.distributed as dist

    if devices is None and (dist.is_initialized() or (
            device is not None and torch.device(device).type != "cuda")):
        if shape is not None:
            return make_mesh(tuple(shape), device)
        return make_mesh(None if n_shards is None else (1, int(n_shards)),
                         device)
    from .local import LocalMesh, visible_cards

    if devices is None:
        devices = visible_cards()
    devices = list(devices)
    n = len(devices) if n_shards is None else int(n_shards)
    if shape is not None and tuple(int(x) for x in shape) != (1, n):
        raise ValueError(f"an in-process mesh is tickers-only (1, {n}); "
                         f"got shape {tuple(shape)}")
    if n < 1 or n > len(devices):
        raise ValueError(f"a mesh of {n} shards needs {n} devices; "
                         f"{len(devices)} given")
    return LocalMesh(devices[:n])


# --------------------------------------------------------------------------
# layouts: per array axis, the mesh axis a rank holds a slice of
# --------------------------------------------------------------------------

def packed_year_spec() -> tuple:
    """A stacked packed-buffer year ``[N, S, L]`` (batches x shards x
    per-shard bytes): the shard axis maps onto tickers. The host-side
    twin of :func:`..data.wire.pack_sharded`."""
    return (None, TICKERS_AXIS, None)


def scan_output_spec() -> tuple:
    """The sharded resident loop's ``[N, F, D, T]`` output: only the
    trailing tickers axis is sharded."""
    return (None, None, None, TICKERS_AXIS)


def packed_year_2d_spec() -> tuple:
    """A stacked 2-D packed year ``[N, Sd, St, L]``: day-shards on the
    days axis, ticker-shards on tickers (:func:`..data.wire.
    pack_sharded_2d`)."""
    return (None, DAYS_AXIS, TICKERS_AXIS, None)


def scan_output_2d_spec() -> tuple:
    """The 2-D resident loop's ``[N, F, D, T]`` output: each batch's day
    rows over days, tickers over tickers."""
    return (None, None, DAYS_AXIS, TICKERS_AXIS)


def span_carry_spec() -> tuple:
    """A cross-day carry leaf ``[T]``: sharded over tickers, whole on
    (replicated over) the days axis."""
    return (TICKERS_AXIS,)


def day_batch_spec(batched: bool = True) -> tuple:
    """``bars [D, T, S, 5]`` (or ``[T, S, 5]``)."""
    if batched:
        return (DAYS_AXIS, TICKERS_AXIS, None, None)
    return (TICKERS_AXIS, None, None)


def mask_spec(batched: bool = True) -> tuple:
    if batched:
        return (DAYS_AXIS, TICKERS_AXIS, None)
    return (TICKERS_AXIS, None)


def local_slice(a, spec: Sequence[Optional[str]], mesh: Mesh):
    """This rank's contiguous block of ``a`` under ``spec`` (each named
    axis split into its mesh extent's equal parts)."""
    idx = []
    for ax, name in enumerate(spec):
        if name is None:
            idx.append(slice(None))
            continue
        n = mesh.shape[name]
        if a.shape[ax] % n:
            raise ValueError(f"axis {ax} of extent {a.shape[ax]} does not "
                             f"divide over {n} {name} shards")
        step = a.shape[ax] // n
        k = mesh.axis_index(name)
        idx.append(slice(k * step, (k + 1) * step))
    return a[tuple(idx)]


def _to_rank(host: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """A host block onto this rank's device: pinned and not waited for
    on the card, a copy of its own on the CPU (so donation can release
    it)."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if mesh.device.type == "cuda":
        return t.pin_memory().to(mesh.device, non_blocking=True)
    return t.clone()


def put_packed_year(stacked, mesh: Mesh) -> List[torch.Tensor]:
    """This rank's buffers of a host ``[N, S, L]`` stacked packed year:
    the N 1-D uint8 buffers of tickers-shard ``s`` on its device, as
    :func:`..pipeline.compute_packed_resident_sharded` takes them. The
    copies are enqueued, not waited for."""
    mine = local_slice(np.asarray(stacked), packed_year_spec(), mesh)
    return [_to_rank(mine[i, 0], mesh) for i in range(mine.shape[0])]


def put_packed_year_2d(stacked, mesh: Mesh) -> List[torch.Tensor]:
    """This rank's buffers of a host ``[N, Sd, St, L]`` stacked 2-D year:
    tile ``(i, j)``'s N buffers on its device."""
    mine = local_slice(np.asarray(stacked), packed_year_2d_spec(), mesh)
    return [_to_rank(mine[i, 0, 0], mesh) for i in range(mine.shape[0])]


def put_span_carry(carry, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's tickers slice of a host cross-day carry
    (``{last_close, n_bars, has}`` ``[T]`` leaves, ``stream.carry.
    init_span_state``) on its device; the same on every day-shard."""
    return {k: _to_rank(local_slice(np.asarray(v), span_carry_spec(),
                                    mesh), mesh)
            for k, v in carry.items()}


def _pad_to_multiple(a: np.ndarray, mult: int, axis: int) -> np.ndarray:
    rem = a.shape[axis] % mult
    if rem == 0:
        return a
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, mult - rem)
    return np.pad(a, pad)


def shard_day_batch(bars, mask, mesh: Mesh):
    """This rank's block of a host day-batch, zero-padding the tickers
    axis to a shard multiple (padding lanes have mask=False, so every
    masked reduction ignores them) and, batched, the days axis too. The
    ticker padding lands in ``mesh.pad_waste_frac{axis=tickers}``.

    Returns ``(bars, mask, n_tickers)`` on this rank's device; callers
    slice gathered results back to ``n_tickers``."""
    from ..telemetry import get_telemetry

    bars = np.asarray(bars, np.float32)
    mask = np.asarray(mask, bool)
    batched = bars.ndim == 4
    t_axis = 1 if batched else 0
    n_tickers = bars.shape[t_axis]
    t_shards = mesh.shape[TICKERS_AXIS]
    bars = _pad_to_multiple(bars, t_shards, t_axis)
    mask = _pad_to_multiple(mask, t_shards, t_axis)
    get_telemetry().meshplane.record_pad_waste(
        n_tickers, bars.shape[t_axis], axis="tickers")
    if batched:
        d_shards = mesh.shape[DAYS_AXIS]
        bars = _pad_to_multiple(bars, d_shards, 0)
        mask = _pad_to_multiple(mask, d_shards, 0)
    b = _to_rank(local_slice(bars, day_batch_spec(batched), mesh), mesh)
    m = _to_rank(local_slice(mask, mask_spec(batched), mesh), mesh)
    return b, m, n_tickers
