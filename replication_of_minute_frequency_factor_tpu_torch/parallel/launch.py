"""Start a group of ranks on this host: one spawned process per rank,
joined into one process group over ``tcp://127.0.0.1:<free port>``.

:func:`run_ranks` is what ``compute --mesh-tickers N`` and
``compute_exposures(cfg.mesh_shape=(1, N))`` use when no process group
is up yet (under ``torchrun`` they join the group they were started
in). Each rank runs ``fn(rank, *args)`` with one intra-op thread;
``fn`` must be importable by its module path (a module-level
function), and what it returns comes back through a file in a
temporary directory. The whole group runs on one clock: a rank that
fails, or a group that outlives ``timeout_s``, ends every rank and
raises here, so a hung rendezvous can never hang the caller. A
rendezvous that loses the race for its port is retried on a new one.
"""

from __future__ import annotations

import os
import socket
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional, Sequence

#: rendezvous attempts (a free port can be taken between the probe and
#: the bind)
RENDEZVOUS_TRIES = 3

_RENDEZVOUS_TAG = "rendezvous failed"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, device,
               backend: Optional[str], timeout_s: float,
               args: Sequence, out_dir: str) -> None:
    """One rank: join the group, run ``fn``, leave its result (or its
    traceback) in ``out_dir``."""
    import torch

    os.environ.update({"RANK": str(rank), "LOCAL_RANK": str(rank),
                       "WORLD_SIZE": str(world),
                       "LOCAL_WORLD_SIZE": str(world)})
    # ranks share the host's cores (several groups may run at once)
    torch.set_num_threads(1)
    out = Path(out_dir)
    from . import multihost

    try:
        multihost.initialize(f"127.0.0.1:{port}", world, rank,
                             backend=backend, device=device,
                             local_world_size=world, timeout_s=timeout_s)
    except BaseException:  # noqa: BLE001 — reported to the caller
        (out / f"rank{rank}.err").write_text(
            f"{_RENDEZVOUS_TAG}\n{traceback.format_exc()}")
        os._exit(3)
    import torch.distributed as dist

    code = 0
    try:
        result = fn(rank, *args)
        torch.save(result, out / f"rank{rank}.tmp")
        os.replace(out / f"rank{rank}.tmp", out / f"rank{rank}.pt")
    except BaseException:  # noqa: BLE001 — reported to the caller
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    if code:
        # a failed rank may leave its peers inside a collective: exit at
        # once, the caller ends the group
        os._exit(code)
    try:
        dist.destroy_process_group()
    finally:
        os._exit(0)


def run_ranks(fn: Callable, world_size: int, args: Sequence = (),
              device=None, backend: Optional[str] = None,
              timeout_s: float = 600.0,
              workdir: Optional[str] = None) -> List[object]:
    """``fn(rank, *args)`` on ``world_size`` spawned ranks of one
    process group; returns their results in rank order. ``device`` is
    each rank's (``multihost.initialize``: ``'cpu'``, or the card at
    ``local_rank % device_count``), ``backend`` the transport (default
    :func:`.multihost.choose_backend`). ``workdir`` holds the result
    files (default: a temporary directory, removed after). Raises with
    the first failing rank's traceback, or ``TimeoutError`` after
    ``timeout_s`` seconds of wall; every rank is ended either way."""
    import multiprocessing as mp

    import torch

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mff_ranks_",
                                     dir=workdir) as tmp:
        for attempt in range(RENDEZVOUS_TRIES):
            run_dir = Path(tmp) / f"try{attempt}"
            run_dir.mkdir()
            port = free_port()
            procs = [ctx.Process(
                target=_rank_main,
                args=(fn, r, world_size, port, device, backend, timeout_s,
                      tuple(args), str(run_dir)),
                daemon=True) for r in range(world_size)]
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout_s
            failed = None
            try:
                while True:
                    codes = [p.exitcode for p in procs]
                    bad = [r for r, c in enumerate(codes)
                           if c not in (None, 0)]
                    if bad:
                        failed = bad[0]
                        break
                    if all(c == 0 for c in codes):
                        break
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world_size} ranks of {getattr(fn, '__name__', fn)}"
                            f" still running after {timeout_s:.0f} s")
                    time.sleep(0.05)
            finally:
                for p in procs:
                    if p.is_alive():
                        p.kill()
                for p in procs:
                    p.join(10)
            if failed is None:
                return [torch.load(run_dir / f"rank{r}.pt",
                                   weights_only=False)
                        for r in range(world_size)]
            texts = [e.read_text() for e in sorted(run_dir.glob("rank*.err"))]
            real = [t for t in texts if not t.startswith(_RENDEZVOUS_TAG)]
            if texts and not real and attempt + 1 < RENDEZVOUS_TRIES:
                continue  # the port was taken under us: another one
            text = (real or texts or [
                f"exit code {procs[failed].exitcode}"])[0]
            raise RuntimeError(
                f"rank {failed} of {world_size} failed:\n{text}")
    raise AssertionError("unreachable")
