"""The resident year: ``pipeline.compute_packed_resident`` over a year of
packed batches already on the card.

Set-up makes the year from the seed (``batches`` batches of
``days_per_batch`` days of the configuration's tickers, the frozen
``make_batch`` recipe), encodes every batch into the program's ingest
wire under one shared widen-only floor (``data/wire.encode`` and
``pack_arrays``, in threads), and puts a master copy of the
packed buffers on the card. A pass clones the master on the card (the
call donates its inputs), calls ``compute_packed_resident`` with the
configuration's ``rolling_impl`` and session, and fetches the stacked
``[batches, 58, days, tickers]`` result into pinned host memory: clone,
compute and fetch all count.

The check: ``check.batches`` batches and ``check.days_per_batch`` days in
each, ``check.tickers`` tickers of each day, drawn from the seed; the last
pass's answers there against the reference over the same bars, made
again from the seed.
"""

from __future__ import annotations

import concurrent.futures as cf
import time

import numpy as np

from perfbench import recipes
from perfbench.drivers import common
from perfbench.harness import log
from perfbench.reference import compare, sessions

#: passes of the widen-only floor before the year counts as not
#: encodable under one spec
MAX_PASSES = 4
#: the planted faults that apply to what this driver runs, by the names
#: that ``perfbench/tests/test_perfbench_run.py`` gives them: three in the
#: factor step (``pipeline._stacked``), and the year's later steps left
#: out (``pipeline.compute_packed_resident``)
FAULTS = ("step_writes_nothing", "half_the_batch_left_out",
          "an_answer_altered", "later_steps_dropped")


def encode_batch(seed: int, i: int, shape: tuple, floor: dict):
    """Batch ``i`` made and encoded under a copy of ``floor``: ``((buf,
    spec) or None, the floor after it)``."""
    from replication_of_minute_frequency_factor_tpu_torch.data import wire

    bars, mask = recipes.year_batch(seed, i, *shape)
    floor = dict(floor)
    enc = wire.encode(bars, mask, floor=floor)
    if enc is None:
        return None, floor
    return wire.pack_arrays(enc.arrays), floor


def encode_year(seed: int, n: int, shape: tuple):
    """The year's packed buffers and their one spec: every batch encoded
    under the widest floor any batch needs (a floor only widens, so the
    batches' floors merge by their maximum), again until all agree. The
    batches are made and encoded in threads, one a core: numpy and the
    native encoder release the GIL, and nothing crosses a process."""
    floors = [{} for _ in range(n)]
    packs = [None] * n
    todo = list(range(n))
    for n_pass in range(1, MAX_PASSES + 1):
        merged: dict = {}
        if todo:
            with cf.ThreadPoolExecutor(common.pool_size(len(todo))) as ex:
                res = list(ex.map(lambda i: encode_batch(
                    seed, i, shape, floors[i]), todo))
            for i, (pack, fl) in zip(todo, res):
                if pack is None:
                    raise RuntimeError(f"batch {i} of seed {seed} does not "
                                       "fit the ingest wire")
                packs[i], floors[i] = pack, fl
        for fl in floors:
            for k, v in fl.items():
                merged[k] = max(merged.get(k, 0), v)
        todo = [i for i in range(n) if floors[i] != merged]
        if not todo and len({p[1] for p in packs}) == 1:
            log(f"the year's wire floor {merged} settled in {n_pass} "
                "pass(es)")
            return [p[0] for p in packs], packs[0][1]
        floors = [dict(merged) for _ in range(n)]
        todo = todo or list(range(n))
    raise RuntimeError(f"the year of seed {seed} did not settle on one "
                       f"wire spec in {MAX_PASSES} passes")


def sampled_rows(cell, seed: int):
    """The lanes a run checks: ``((batch, day), rows, tickers)`` for each
    sampled day, ``rows`` the day's long-format rows made again from the
    seed. The sampled batches are made in threads, one a core, each
    keeping only its sampled days."""
    chk, mix = cell.mix["check"], cell.mix
    session = sessions.from_config(cell.config["session"])
    n, D, T = int(mix["batches"]), int(mix["days_per_batch"]), int(
        cell.config["tickers"])

    def days_of(b: int):
        bars, mask = recipes.year_batch(seed, b, D, T, session.n_slots)
        return [((b, int(d)), compare.grid_rows(bars[d], mask[d], session),
                 common.sample(seed, T, chk["tickers"], 1000 + b * D + int(d)))
                for d in common.sample(seed, D, chk["days_per_batch"], 1 + b)]

    picked = [int(b) for b in common.sample(seed, n, chk["batches"], 0)]
    with cf.ThreadPoolExecutor(common.pool_size(len(picked))) as ex:
        for lanes in ex.map(days_of, picked):
            yield from lanes


def control_rows(cell, seed: int):
    """:func:`sampled_rows`, for the control, which runs no program."""
    return sampled_rows(cell, seed)


class Driver:
    def __init__(self, cell, seed: int, device: str):
        import torch

        from replication_of_minute_frequency_factor_tpu_torch.ops import (
            rolling, rolling_cuda)

        cfg, mix = cell.config, cell.mix
        self.cell, self.seed, self.device = cell, seed, device
        self.session = sessions.from_config(cfg["session"])
        self.n = int(mix["batches"])
        self.shape = (int(mix["days_per_batch"]), int(cfg["tickers"]),
                      self.session.n_slots)
        self.days_per_pass = self.n * self.shape[0]
        t0 = time.perf_counter()
        bufs, self.spec = encode_year(seed, self.n, self.shape)
        t1 = time.perf_counter()
        self.master = [torch.from_numpy(b).to(device) for b in bufs]
        del bufs
        self.host = None
        self.attempted = self.failed = self.passes = 0
        t2 = time.perf_counter()
        self.run_pass()
        log(f"set-up: year made and encoded {t1 - t0:.3f} s, copied "
            f"{t2 - t1:.3f} s, warm pass {time.perf_counter() - t2:.3f} s")
        self.attempted = self.failed = self.passes = 0
        rolling.IMPL_COUNTS.clear()
        rolling_cuda.reset_launches()

    def run_pass(self) -> None:
        import torch

        from replication_of_minute_frequency_factor_tpu_torch import pipeline

        bufs = [m.clone() for m in self.master]
        ys = pipeline.compute_packed_resident(
            bufs, self.spec, "wire",
            rolling_impl=self.cell.config["rolling_impl"],
            session=self.session.name, device=self.device)
        if self.host is None:
            self.host = torch.empty(
                ys.shape, dtype=ys.dtype,
                pin_memory=self.device.startswith("cuda"))
        self.host.copy_(ys)
        self.attempted += self.days_per_pass
        self.passes += 1

    def end_to_end(self, wall: float) -> dict:
        return {"resident_days_per_s": self.attempted / wall}

    def counters(self) -> dict:
        return {"days_traced": self.attempted,
                "rolling_shape": (self.shape[0] * self.shape[1],
                                  self.shape[2])}

    def facts(self):
        from replication_of_minute_frequency_factor_tpu_torch.ops import (
            rolling, rolling_cuda)

        yield (f"{self.passes} passes of {self.n} batches x "
               f"{self.shape[0]} days x {self.shape[1]} tickers x "
               f"{self.shape[2]} slots; rolling_impl "
               f"{self.cell.config['rolling_impl']!r} resolved "
               f"{dict(rolling.IMPL_COUNTS)}; second-moment launches "
               f"{dict(rolling_cuda.launches)}")

    def release(self) -> None:
        import torch

        self.master = None
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def check(self) -> dict:
        from replication_of_minute_frequency_factor_tpu_torch.models import (
            factor_names)

        names = factor_names()
        got, want = [], []
        t0 = time.perf_counter()
        for (b, d), rows, tick in sampled_rows(self.cell, self.seed):
            want.append(compare.reference_lanes(*rows, tick, self.session))
            ys = self.host[b, :, d].numpy()[:, tick]
            got.append(common.in_reference_order(dict(zip(names, ys)),
                                                 len(tick)))
        log(f"reference over the sample {time.perf_counter() - t0:.3f} s")
        return common.hold(np.concatenate(got), np.concatenate(want),
                           self.cell.mix["check"][common.CHECK], log)

    def close(self) -> None:
        self.host = None
