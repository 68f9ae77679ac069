"""The in-process mesh: one process drives a device list, a worker thread
a shard.

The JAX package runs a server's placements (a ticker-sharded stream
carry, a population-sharded discovery generation) as one SPMD program
over a replica's submesh. Here a :class:`LocalMesh` over ``devices``
runs one body per shard, each on a worker thread of its own that keeps
its device and a stream of its own current and holds its own
:class:`~.mesh.Mesh` view (the active mesh is thread-local). So the
per-rank bodies written for the process meshes
(:mod:`.collectives`' ``*_local`` functions, ``DayContext(
xs_axis_name=)``, ``result_wire.encode_block(xs_axis_name=)``,
``factor_stats_block(xs_axis_name=)``) run unchanged on each shard.

Their collectives reach :mod:`.transport` with a :class:`GroupHandle`,
which exchanges the shards' tensors through a :class:`LocalGroup`: a
barrier rendezvous of references, then device-to-device copies ordered
by CUDA events, so nothing goes through host memory. A sum is taken in
shard order, the same on every shard.

Stream rules (a tensor made on one stream and read on another):

* a shard's inputs wait for the caller's current stream, and each CUDA
  tensor handed in is ``record_stream``-ed on the shard's stream;
* an exchanged tensor is waited for on the reader's stream through the
  writer's event, and ``record_stream``-ed there before the reader
  copies it, since the caching allocator hands a freed block to its own
  stream's next allocation;
* :meth:`LocalMesh.run` hands each shard's outputs to the caller's
  current streams the same way.

The shards take turns on the host: a worker holds the mesh's turn lock
while its body runs and gives it up only while it waits in an exchange,
so one shard launches at a time, each up to its next exchange, while the
device runs what the others enqueued. Torch releases the GIL around each
op, and shards launching at once hand the GIL back and forth on every op:
on an NVIDIA H100 80GB HBM3 host, two such threads took 1.5 times, and
four 3.0 times, as long as the same snapshots run in turn on one thread
(``chip_smoke.py`` phase 16a; PERF.md §6).

A shard whose body raises aborts the group's barrier: every shard
waiting in an exchange, or arriving at one later, raises
:class:`~.transport.PeerStepError`, and :meth:`LocalMesh.run` raises the
failing shard's own error once every shard has returned.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional, Sequence

import torch

from .mesh import DAYS_AXIS, TICKERS_AXIS, Mesh


class LocalGroup:
    """The shards of one :class:`LocalMesh` axis as a rendezvous: each
    :meth:`exchange` returns every shard's object in shard order."""

    def __init__(self, size: int):
        self.size = int(size)
        self._barrier = threading.Barrier(self.size)
        self._slots: List[object] = [None] * self.size
        #: the mesh's turn: held by the shard whose body runs on the host
        self.turn = threading.Lock()

    def exchange(self, rank: int, obj) -> list:
        """``obj`` from every shard, in shard order. The second wait keeps
        the slots whole until every shard has read them."""
        self._slots[rank] = obj
        self._wait()
        out = list(self._slots)
        self._wait()
        return out

    def _wait(self) -> None:
        """Wait for every shard, giving up the turn meanwhile."""
        self.turn.release()
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            broken = True
        else:
            broken = False
        finally:
            self.turn.acquire()
        if broken:
            from .transport import PeerStepError
            raise PeerStepError(["a peer shard failed"])

    def abort(self) -> None:
        """Release every shard waiting in an exchange with an error (a
        shard's body raised)."""
        self._barrier.abort()

    def reset(self) -> None:
        self._barrier.reset()
        self._slots = [None] * self.size


def _ready_event(x: torch.Tensor):
    """An event on the current stream of ``x``'s device, recorded after
    the work that makes ``x`` (None for a CPU tensor)."""
    if not x.is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(x.device))
    return ev


def _take(offer, device) -> torch.Tensor:
    """Another shard's ``(tensor, event)`` on ``device``: this thread's
    current stream on the tensor's device waits for the writer and keeps
    the tensor's block until the copy has read it."""
    y, ev = offer
    if y.is_cuda:
        s = torch.cuda.current_stream(y.device)
        s.wait_event(ev)
        y.record_stream(s)
    return y.to(device, non_blocking=True)


class GroupHandle:
    """One shard's handle on a :class:`LocalGroup`: what a shard's
    :class:`~.mesh.Mesh` view returns for a mesh axis, and what
    :mod:`.transport` dispatches on."""

    def __init__(self, group: LocalGroup, rank: int):
        self.group = group
        self.rank = int(rank)

    @property
    def size(self) -> int:
        return self.group.size

    def all_gather_object(self, obj) -> list:
        return self.group.exchange(self.rank, obj)

    def _gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        offers = self.group.exchange(self.rank, (x, _ready_event(x)))
        return [_take(o, x.device) for o in offers]

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat(self._gather(x), dim=dim)

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``op`` ('sum', 'min' or 'max') over the shards, in shard
        order: the same bits on every shard."""
        parts = self._gather(x)
        out = parts[0].clone()
        fn = {"sum": torch.add, "min": torch.minimum,
              "max": torch.maximum}[op]
        for p in parts[1:]:
            out = fn(out, p)
        return out


class ShardView(Mesh):
    """Shard ``index`` of a :class:`LocalMesh`, as its worker thread sees
    the mesh: ``coordinate`` ``(0, index)``, ``device`` its own, and the
    tickers axis's group a :class:`GroupHandle`."""

    def __init__(self, mesh: "LocalMesh", index: int):
        super().__init__((1, mesh.size), mesh.devices[index])
        self.rank = int(index)
        self.coordinate = (0, self.rank)
        self._handle = GroupHandle(mesh._group, index)
        #: the shard's stream on the card (set by its worker), else None
        self.stream = None

    @property
    def backend(self) -> str:
        return "local"

    def group(self, axis: str):
        if self.shape[axis] == 1:
            return None
        return self._handle


def _record(tree, stream) -> None:
    """``record_stream`` every CUDA tensor of ``tree`` (nested dicts,
    lists and tuples) on ``stream``'s device onto ``stream``."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda and tree.device == stream.device:
            tree.record_stream(stream)
    elif isinstance(tree, dict):
        for v in tree.values():
            _record(v, stream)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _record(v, stream)


class _Worker(threading.Thread):
    """Shard ``index``'s thread: makes its device and a new stream
    current once, then runs the tasks :meth:`LocalMesh.run` puts in its
    inbox inside ``with view:``, holding the mesh's turn."""

    def __init__(self, mesh: "LocalMesh", index: int):
        super().__init__(name=f"local-mesh-shard-{index}", daemon=True)
        self.mesh = mesh
        self.index = index
        self.inbox: "queue.SimpleQueue" = queue.SimpleQueue()

    def run(self) -> None:
        view = self.mesh._views[self.index]
        setup_error = None
        try:
            if view.device.type == "cuda":
                torch.cuda.set_device(view.device)
                view.stream = torch.cuda.Stream(device=view.device)
                torch.cuda.set_stream(view.stream)
        except BaseException as e:  # every task reports it
            setup_error = e
        while True:
            task = self.inbox.get()
            if task is None:
                return
            fn, args, entry, done = task
            try:
                with self.mesh._group.turn:
                    if setup_error is not None:
                        raise setup_error
                    if view.stream is not None:
                        if entry is not None:
                            view.stream.wait_event(entry)
                        _record(args, view.stream)
                    with view:
                        out = fn(view, *args)
                    ev = None
                    if view.stream is not None:
                        ev = torch.cuda.Event()
                        ev.record(view.stream)
                done.put((self.index, True, out, ev))
            except BaseException as e:  # reported by run(), which raises
                self.mesh._group.abort()
                done.put((self.index, False, e, None))


def lead_device(mesh, device, owner: str) -> torch.device:
    """The first device of ``mesh``, where ``owner`` (an engine placed
    over it) assembles its results; raises unless ``mesh`` is an
    in-process mesh and ``device`` is left unset (the mesh names the
    devices)."""
    if not isinstance(mesh, LocalMesh):
        raise TypeError(
            f"{owner}(mesh=) takes an in-process mesh (parallel."
            f"resident_mesh(n, devices=[...])), not {type(mesh).__name__}")
    if device is not None:
        raise ValueError(f"{owner}: pass mesh= or device=, not both: the "
                         "mesh names the devices")
    return mesh.device


def visible_cards() -> List[torch.device]:
    """Every visible card, ``cuda:0`` first; raises when there is none (a
    placement never runs quietly on the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass devices=[torch.device('cpu')] * n "
            "to run the mesh on the CPU")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _placed(d) -> torch.device:
    """``d`` as a device a worker can make current: a card must exist
    (``cuda`` alone is the current one)."""
    d = torch.device(d)
    if d.type != "cuda":
        return d
    cards = visible_cards()
    if d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if d.index >= len(cards):
        raise ValueError(f"{d} is not visible ({len(cards)} card(s))")
    return d


class LocalMesh:
    """A tickers-only ``(1, n)`` mesh over ``devices``, driven from this
    process: :meth:`run` calls a body on every shard, each on its worker
    thread with its :class:`ShardView` active, the shards taking turns on
    the host between exchanges.

    ``devices`` may repeat a device: ``[cuda:0, cuda:0]`` runs two
    shards on one card (the placement's price, not scaling), and
    ``[torch.device('cpu')] * n`` runs the same code on the CPU. The
    workers start at the first :meth:`run`; :meth:`close` stops them.
    """

    backend = "local"

    def __init__(self, devices: Sequence):
        self.devices = tuple(_placed(d) for d in devices)
        if not self.devices:
            raise ValueError("an in-process mesh needs at least one device")
        n = len(self.devices)
        self.size = n
        self.shape = {DAYS_AXIS: 1, TICKERS_AXIS: n}
        #: the lead device: where a placement assembles what it returns
        self.device = self.devices[0]
        self._group = LocalGroup(n)
        self._views = [ShardView(self, i) for i in range(n)]
        self._workers: Optional[List[_Worker]] = None
        self._lock = threading.Lock()

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def key(self) -> tuple:
        """The placement as a hashable key (the executable caches')."""
        return ("local",) + tuple(str(d) for d in self.devices)

    def run(self, fn: Callable, *per_shard: Sequence) -> list:
        """``fn(view, *args_i)`` on every shard ``i``, where ``args_i``
        takes the ``i``-th item of each sequence in ``per_shard``; returns
        the shards' results in shard order, handed to the caller's current
        streams. Raises the first failing shard's
        error (``shard_errors`` lists every shard's) once all shards have
        returned."""
        n = self.size
        for a in per_shard:
            if len(a) != n:
                raise ValueError(f"{len(a)} per-shard arguments for {n} "
                                 "shards")
        with self._lock:
            if self._workers is None:
                self._workers = [_Worker(self, i) for i in range(n)]
                for w in self._workers:
                    w.start()
            entry = {}
            for d in set(self.devices):
                if d.type == "cuda":
                    entry[d] = torch.cuda.Event()
                    entry[d].record(torch.cuda.current_stream(d))
            done: "queue.SimpleQueue" = queue.SimpleQueue()
            for i, w in enumerate(self._workers):
                w.inbox.put((fn, tuple(a[i] for a in per_shard),
                             entry.get(self.devices[i]), done))
            results: list = [None] * n
            errors: List[Optional[BaseException]] = [None] * n
            events = [None] * n
            for _ in range(n):
                i, ok, val, ev = done.get()
                if ok:
                    results[i], events[i] = val, ev
                else:
                    errors[i] = val
            self._group.reset()
        failed = [e for e in errors if e is not None]
        if failed:
            from .transport import PeerStepError
            first = next((e for e in failed
                          if not isinstance(e, PeerStepError)), failed[0])
            first.shard_errors = errors
            raise first
        for i, ev in enumerate(events):
            if ev is not None:
                s = torch.cuda.current_stream(self.devices[i])
                s.wait_event(ev)
                _record(results[i], s)
        return results

    def close(self) -> None:
        """Stop the worker threads (a later :meth:`run` starts new ones)."""
        with self._lock:
            workers, self._workers = self._workers, None
        for w in workers or ():
            w.inbox.put(None)
        for w in workers or ():
            w.join()

    def __repr__(self) -> str:
        return (f"LocalMesh(tickers={self.size}, devices="
                f"{[str(d) for d in self.devices]})")
