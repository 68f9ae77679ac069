"""The venue year: ``pipeline.compute_packed_resident`` over a 24/7
venue's year of 1-minute klines already on the card.

Set-up draws the symbols' constants from the seed and makes the year
batch by batch (``batches`` batches of ``days_per_batch`` days of the
configuration's symbols, the frozen :mod:`perfbench.klines` recipe under
its ``venue`` block, a day a thread), and ships it as the program's host
driver would: each batch is offered to the ingest wire
(``data/wire.encode``) under one shared widen-only floor, and once any
batch is refused every batch ships raw, ``(bars f32, mask uint8)`` packed
as ``pack_arrays`` packs them (21 bytes a bar). Each batch goes to the
card as it is made, so the host holds a batch at a time. A pass clones
the master on the card (the call donates its inputs), calls
``compute_packed_resident`` with the ingest kind, the configuration's
``rolling_impl`` and session, and fetches the stacked ``[batches, 58,
days, symbols]`` result into pinned host memory: clone, compute and
fetch all count.

The check: ``check.batches`` batches and ``check.days_per_batch`` days in
each, ``check.tickers`` symbols of each day, drawn from the seed as the
resident driver draws them; the last pass's answers there against the
reference over the same bars, each sampled day made again from the seed
alone and held to the reference in a spawned process of its own, one a
core.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing as mp
import time

import numpy as np

from perfbench import klines
from perfbench.drivers import common
from perfbench.harness import log
from perfbench.reference import compare, sessions

#: the planted faults that apply to what this driver runs: the resident
#: driver's, since it runs the same loop
FAULTS = ("step_writes_nothing", "half_the_batch_left_out",
          "an_answer_altered", "later_steps_dropped")


def year_shape(cell):
    """``(batches, days a batch, symbols, slots)`` of the cell."""
    session = sessions.from_config(cell.config["session"])
    return (int(cell.mix["batches"]), int(cell.mix["days_per_batch"]),
            int(cell.config["tickers"]), session.n_slots)


def year_symbols(cell, seed: int) -> klines.Symbols:
    n, days, tickers, slots = year_shape(cell)
    return klines.symbols(seed, tickers, n * days, slots,
                          cell.config["venue"])


def raw_buffer(days: int, tickers: int, slots: int):
    """An empty raw buffer of one batch, laid out as ``pack_arrays`` lays
    out ``(bars, mask.view(uint8))``, with its spec and the two arrays'
    views into it: ``(buf, spec, bars, mask)``."""
    from replication_of_minute_frequency_factor_tpu_torch.data import wire

    mask_shape = (days, tickers, slots)
    bars_shape = mask_shape + (5,)
    spec, nbytes = wire.pack_spec((np.broadcast_to(np.float32(0), bars_shape),
                                   np.broadcast_to(np.uint8(0), mask_shape)))
    buf = np.zeros(nbytes, np.uint8)
    at = spec[1][2]
    bars = buf[:at].view(np.float32).reshape(bars_shape)
    mask = buf[at:at + days * tickers * slots].view(bool).reshape(mask_shape)
    return buf, spec, bars, mask


def make_batch(cell, seed: int, sym, i: int, out, days_map):
    """Batch ``i`` of the year into ``out`` (bars, mask), a day a call of
    ``days_map``."""
    n, days, tickers, slots = year_shape(cell)
    bars, mask = out
    list(days_map(lambda j: klines.day(
        seed, i * days + j, sym, slots, cell.config["venue"],
        out=(bars[j], mask[j])), range(days)))


def ship_year(cell, seed: int, device: str):
    """The year on ``device``: ``(buffers, spec, kind)``, made and shipped
    batch by batch (module docstring)."""
    import torch

    from replication_of_minute_frequency_factor_tpu_torch.data import wire

    n, days, tickers, slots = year_shape(cell)
    sym = year_symbols(cell, seed)
    floor: dict = {}
    kind, modes, specs, master = "wire", [], [], []

    def upload(buf):
        return torch.from_numpy(buf).to(device)

    with cf.ThreadPoolExecutor(common.pool_size(days)) as ex:
        def made(i):
            buf, spec, bars, mask = raw_buffer(days, tickers, slots)
            make_batch(cell, seed, sym, i, (bars, mask), ex.map)
            return buf, spec, bars, mask

        def wire_pack(bars, mask, floor):
            enc = wire.encode(bars, mask, floor=floor)
            if enc is None:
                return None
            packed, spec = wire.pack_arrays(enc.arrays)
            return upload(packed), spec, enc.modes

        for i in range(n):
            buf, spec, bars, mask = made(i)
            if kind == "wire":
                packed = wire_pack(bars, mask, floor)
                if packed is not None:
                    master.append(packed[0])
                    specs.append(packed[1])
                    modes.append(packed[2])
                    continue
                kind = "raw"
                log(f"batch {i} of seed {seed} does not fit the ingest "
                    "wire: the year ships raw")
                master = [upload(made(j)[0]) for j in range(i)]
            master.append(upload(buf))
            specs = [spec]
        if kind == "wire":
            # a floor only widens: a batch packed under a narrower floor
            # than the year's is packed again under it, once
            for i, m in enumerate(modes):
                if m != {k: floor.get(k, 0) for k in m}:
                    _, _, bars, mask = made(i)
                    master[i], specs[i], _ = wire_pack(bars, mask,
                                                       dict(floor))
    if len(set(specs)) != 1:
        raise RuntimeError(f"the year of seed {seed} did not settle on "
                           "one wire spec")
    return master, specs[0], kind


def sampled_days(cell, seed: int):
    """The lanes a run checks: ``(batch, day, symbols)`` for each sampled
    day, drawn as the resident driver draws them."""
    n, days, tickers, _ = year_shape(cell)
    chk = cell.mix["check"]
    for b in common.sample(seed, n, chk["batches"], 0):
        for d in common.sample(seed, days, chk["days_per_batch"], 1 + b):
            yield int(b), int(d), common.sample(
                seed, tickers, chk["tickers"], 1000 + b * days + int(d))


def day_rows(cell, seed: int, sym, b: int, d: int):
    """Day ``d`` of batch ``b`` made again from the seed, as the
    long-format rows the reference takes."""
    n, days, tickers, slots = year_shape(cell)
    bars, mask = klines.day(seed, b * days + d, sym, slots,
                            cell.config["venue"])
    return compare.grid_rows(bars, mask,
                             sessions.from_config(cell.config["session"]))


def control_rows(cell, seed: int):
    """The sampled days made again from the seed, for the control, which
    runs no program."""
    sym = year_symbols(cell, seed)
    for b, d, tick in sampled_days(cell, seed):
        yield (b, d), day_rows(cell, seed, sym, b, d), tick


def reference_day(config: dict, mix: dict, seed: int, b: int, d: int,
                  tick) -> np.ndarray:
    """The reference's ``[len(tick), F]`` over day ``d`` of batch ``b``,
    from the configuration and the mix alone: a spawned process's task,
    and a cell, whose readers are loaded from files, does not pickle."""
    from types import SimpleNamespace

    cell = SimpleNamespace(config=config, mix=mix)
    sym = year_symbols(cell, seed)
    return compare.reference_lanes(
        *day_rows(cell, seed, sym, b, d), tick,
        sessions.from_config(config["session"]))


class Driver:
    def __init__(self, cell, seed: int, device: str):
        from replication_of_minute_frequency_factor_tpu_torch.ops import (
            rolling, rolling_cuda)

        self.cell, self.seed, self.device = cell, seed, device
        self.session = sessions.from_config(cell.config["session"])
        self.n, days, tickers, slots = year_shape(cell)
        self.rows = (days * tickers, slots)
        self.days_per_pass = self.n * days
        self.host = None
        t0 = time.perf_counter()
        self.master, self.spec, self.kind = ship_year(cell, seed, device)
        self.bytes = sum(int(m.numel()) for m in self.master)
        self.bars = self.n * days * tickers * slots
        self.attempted = self.failed = self.passes = 0
        t1 = time.perf_counter()
        self.run_pass()
        log(f"set-up: year made and shipped ({self.kind}) "
            f"{t1 - t0:.3f} s, warm pass {time.perf_counter() - t1:.3f} s")
        self.attempted = self.failed = self.passes = 0
        rolling.IMPL_COUNTS.clear()
        rolling_cuda.reset_launches()

    def run_pass(self) -> None:
        import torch

        from replication_of_minute_frequency_factor_tpu_torch import pipeline

        bufs = [m.clone() for m in self.master]
        ys = pipeline.compute_packed_resident(
            bufs, self.spec, self.kind,
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
        return {"days_traced": self.attempted, "rolling_shape": self.rows}

    def facts(self):
        from replication_of_minute_frequency_factor_tpu_torch.ops import (
            rolling, rolling_cuda)

        yield (f"{self.passes} passes of {self.n} batches x "
               f"{self.rows[0]} (day, symbol) rows x {self.rows[1]} "
               f"slots; shipped {self.kind}, {self.bytes} B for "
               f"{self.bars} bars ({self.bytes / self.bars:.4f} B a bar); "
               f"rolling_impl {self.cell.config['rolling_impl']!r} "
               f"resolved {dict(rolling.IMPL_COUNTS)}; second-moment "
               f"launches {dict(rolling_cuda.launches)}")

    def release(self) -> None:
        import torch

        self.master = None
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def check(self) -> dict:
        from replication_of_minute_frequency_factor_tpu_torch.models import (
            factor_names)

        names = factor_names()
        picked = list(sampled_days(self.cell, self.seed))
        args = [(self.cell.config, self.cell.mix, self.seed, b, d, tick)
                for b, d, tick in picked]
        t0 = time.perf_counter()
        workers = common.pool_size(len(args))
        if workers == 1:
            want = [reference_day(*a) for a in args]
        else:
            with cf.ProcessPoolExecutor(
                    workers, mp_context=mp.get_context("spawn")) as ex:
                want = list(ex.map(reference_day, *zip(*args)))
        got = [common.in_reference_order(
            dict(zip(names, self.host[b, :, d].numpy()[:, tick])),
            len(tick)) for b, d, tick in picked]
        log(f"reference over the sample {time.perf_counter() - t0:.3f} s "
            f"({workers} processes)")
        got, want = np.concatenate(got), np.concatenate(want)
        shares = compare.mismatch(got, want)
        log("every factor's share out of tolerance: " + (", ".join(
            f"{n} {v:.4f}%" for n, v in shares.items() if v) or "none"))
        return common.hold(got, want, self.cell.mix["check"][common.CHECK],
                           log)

    def close(self) -> None:
        self.host = None
