"""The file backfill: whole ``pipeline.compute_exposures`` passes over a
directory of int-coded parquet day files, each from an empty cache.

Set-up writes ``days`` day files of the configuration's tickers (the
frozen ``synth_day`` recipe with the mix's ``synth`` pathologies, day
``i`` from ``default_rng([seed, i])``) into a directory under
``TMPDIR``, in spawned processes, one a core, and runs one warm pass. A
pass deletes the last pass's cache and runs ``compute_exposures(
minute_dir, cache_path)`` with the mix's ``days_per_batch`` and the
configuration's ``rolling_impl``: read, grid, encode, copy, compute,
table and the cache's save all count. The files stay in the page
cache, so ``io`` is parse time, not disk time.

The check: ``check.days`` days and ``check.tickers`` codes of each,
drawn from the seed; the rows the last pass saved in its cache there
against the reference over the same day files.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing as mp
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from perfbench import recipes
from perfbench.drivers import common
from perfbench.harness import log
from perfbench.reference import compare, sessions

#: the program's producer stages (``ExposureTable.timings``)
PRODUCER_STAGES = ("io", "grid", "wire_encode", "pack")
#: the only session ``compute_exposures`` grids
SESSION = "cn_ashare_240"
#: the planted faults that apply to what this driver runs, by the names
#: that ``perfbench/tests/test_perfbench_run.py`` gives them: three in the
#: factor step (``pipeline._stacked``, under every batch of the host
#: driver)
FAULTS = ("step_writes_nothing", "half_the_batch_left_out",
          "an_answer_altered")


def write_days(args) -> None:
    """``recipes.write_day_file(*a)`` for each ``a`` of ``args``, in
    spawned processes, one a core, when more than one (the recipe holds
    the GIL)."""
    workers = common.pool_size(len(args))
    if workers == 1:
        for a in args:
            recipes.write_day_file(*a)
        return
    with cf.ProcessPoolExecutor(workers,
                                mp_context=mp.get_context("spawn")) as ex:
        list(ex.map(recipes.write_day_file, *zip(*args)))


def synth_columns(cell, seed: int, i: int) -> dict:
    """Day ``i`` of ``seed`` made again, as the columns its file holds."""
    d = recipes.synth_day(recipes.day_rng(seed, i),
                          sessions.from_config(cell.config["session"]),
                          date=recipes.trading_dates(i + 1)[i],
                          **dict(cell.mix["synth"],
                                 n_codes=int(cell.config["tickers"])))
    return dict(d, code=d["code"].astype(np.int64))


def sampled_rows(cell, seed: int, columns):
    """The lanes a run checks: ``(day, rows, codes)`` for each sampled
    day, ``rows`` its long-format rows sorted by (code, time) from
    ``columns(i)``."""
    chk = cell.mix["check"]
    for i in common.sample(seed, int(cell.mix["days"]), chk["days"], 0):
        cols = columns(int(i))
        order = np.lexsort((cols["time"], cols["code"]))
        rows = tuple(np.asarray(cols[k])[order] for k in (
            "code", "time", "open", "high", "low", "close", "volume"))
        codes = np.unique(rows[0])
        yield int(i), rows, codes[common.sample(seed, len(codes),
                                                 chk["tickers"], 1 + int(i))]


def control_rows(cell, seed: int):
    """:func:`sampled_rows` of the days made again from the seed, for the
    control, which runs no program and writes no file."""
    return sampled_rows(cell, seed, lambda i: synth_columns(cell, seed, i))


class Driver:
    def __init__(self, cell, seed: int, device: str):
        import pyarrow as pa

        from replication_of_minute_frequency_factor_tpu_torch.config import (
            Config)
        from replication_of_minute_frequency_factor_tpu_torch.ops import (
            rolling, rolling_cuda)

        cfg, mix = cell.config, cell.mix
        if cfg["session"]["name"] != SESSION:
            raise ValueError(f"the backfill grids {SESSION} only, not "
                             f"{cfg['session']['name']}")
        self.cell, self.seed, self.device = cell, seed, device
        self.session = sessions.from_config(cfg["session"])
        self.tickers = int(cfg["tickers"])
        self.dates = recipes.trading_dates(int(mix["days"]))
        self.tmp = Path(tempfile.mkdtemp(prefix="perfbench_backfill_"))
        self.minute_dir = self.tmp / "kline"
        self.minute_dir.mkdir()
        self.cache = self.tmp / "exposures.parquet"
        synth = dict(mix["synth"], n_codes=self.tickers)
        self.program_cfg = Config(days_per_batch=int(mix["days_per_batch"]),
                                  rolling_impl=cfg["rolling_impl"])
        self.attempted = self.failed = self.passes = 0
        self.producer_s = 0.0
        self.walls = []
        try:
            t0 = time.perf_counter()
            # pyarrow's default memory pool (mimalloc) is made here, on the
            # main thread: made first on the program's producer thread,
            # inside a read, it crashes pyarrow 25.0 now and then
            pa.default_memory_pool()
            write_days([
                (self.day_path(i), date, seed, i, cfg["session"], synth)
                for i, date in enumerate(self.dates)])
            # the files' writeback happens here, not in the window
            os.sync()
            t1 = time.perf_counter()
            self.run_pass()
            log(f"set-up: day files written {t1 - t0:.3f} s, warm pass "
                f"{time.perf_counter() - t1:.3f} s")
        except BaseException:
            self.close()
            raise
        self.attempted = self.failed = self.passes = 0
        self.producer_s = 0.0
        self.walls = []
        rolling.IMPL_COUNTS.clear()
        rolling_cuda.reset_launches()

    def day_path(self, i: int) -> Path:
        return self.minute_dir / (self.dates[i].replace("-", "") + ".parquet")

    def run_pass(self) -> None:
        from replication_of_minute_frequency_factor_tpu_torch import pipeline

        for p in (self.cache, Path(str(self.cache) + ".failures.json")):
            p.unlink(missing_ok=True)
        t0 = time.perf_counter()
        table = pipeline.compute_exposures(
            str(self.minute_dir), cache_path=str(self.cache),
            cfg=self.program_cfg, progress=False, device=self.device)
        self.walls.append((time.perf_counter() - t0, table.timings))
        self.attempted += len(self.dates)
        self.failed += len(table.failures)
        self.producer_s += sum(table.timings.get(k, 0.0)
                               for k in PRODUCER_STAGES)
        self.passes += 1

    def end_to_end(self, wall: float) -> dict:
        return {"backfill_days_per_s": self.attempted / wall}

    def counters(self) -> dict:
        return {"days_traced": self.attempted, "producer_s": self.producer_s}

    def facts(self):
        from replication_of_minute_frequency_factor_tpu_torch.ops import (
            rolling, rolling_cuda)

        size = sum(p.stat().st_size for p in self.minute_dir.iterdir())
        yield (f"{self.passes} passes of {len(self.dates)} day files "
               f"({size} B) x {self.tickers} tickers, "
               f"{self.program_cfg.days_per_batch} days a batch; "
               f"{self.failed} days failed; rolling_impl "
               f"{self.program_cfg.rolling_impl!r} resolved "
               f"{dict(rolling.IMPL_COUNTS)}; second-moment launches "
               f"{dict(rolling_cuda.launches)}")
        for wall, t in self.walls:
            yield (f"pass {wall:.3f} s: " + ", ".join(
                f"{k} {v:.3f}" for k, v in sorted(t.items())))

    def release(self) -> None:
        import torch

        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def check(self) -> dict:
        import pyarrow as pa
        import pyarrow.compute as pc
        import pyarrow.parquet as pq

        saved = pq.read_table(self.cache)
        factors = [n for n in saved.column_names
                   if n not in ("code", "date")]
        got, want = [], []
        t0 = time.perf_counter()
        for i, rows, codes in sampled_rows(self.cell, self.seed,
                                           self.read_day):
            want.append(compare.reference_lanes(*rows, codes, self.session))
            day = saved.filter(pc.equal(saved["date"], pa.scalar(
                np.datetime64(self.dates[i], "D").astype(object),
                pa.date32())))
            row_of = {int(c): r for r, c in
                      enumerate(day["code"].to_pylist())}
            pick = np.array([row_of.get(int(c), -1) for c in codes])
            lanes = {}
            for n in factors:
                v = np.append(day[n].to_numpy(zero_copy_only=False), np.nan)
                lanes[n] = v[pick].astype(np.float64)
            got.append(common.in_reference_order(lanes, len(codes)))
        log(f"reference over the sample {time.perf_counter() - t0:.3f} s")
        return common.hold(np.concatenate(got), np.concatenate(want),
                           self.cell.mix["check"][common.CHECK], log)

    def read_day(self, i: int) -> dict:
        """Day file ``i`` as the columns written."""
        import pyarrow.parquet as pq

        day = pq.read_table(self.day_path(i))
        return {k: day[k].to_numpy() for k in day.column_names}

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)
