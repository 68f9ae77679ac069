"""One run of one cell: ``python3 perfbench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>``.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
its configuration file (``configs``' ``file``), its traffic mix
(``perfbench/mixes/<traffic>.json``, whose ``driver`` names the general
generator in ``perfbench/drivers/``), and a reader for each per-layer
metric (``perfbench/metrics/<name>.py``, or the file of the part of the
name before its first dot, which serves a family such as
``device_idle_pct.*``). Adding a cell, a configuration, a mix or a
metric adds files and entries; no file here changes.

A run: set-up (the driver makes its inputs from the seed and warms every
shape with one pass; ``setup_s`` is its host wall), then either the
measured window (``--trace 0``: whole passes until ``--seconds`` have
passed; the cell's end-to-end metrics over all of it) or the traced
window (``--trace 1``: the mix's ``trace_passes`` passes under
``torch.profiler``; the cell's per-layer metrics). Then the peak memory
is read, the program's state freed, and the driver's answers held to the
plain reference (:mod:`perfbench.reference`). The last line of standard
output is the result; the numbers compared, each beside its limit, are
the last lines of standard error and the last key of the result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

#: the benchmark's folder, and the root of the checkout it sits in
BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

#: top-level module names that may not be loaded in a run: JAX and the
#: JAX package (compared whole: the port's name begins with the latter)
FORBIDDEN_MODULES = frozenset({
    "jax", "jaxlib", "flax", "replication_of_minute_frequency_factor_tpu"})


class CellError(ValueError):
    """``BENCHMARK.json`` names something its files do not provide."""


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with everything it names loaded."""

    name: str
    workload: dict
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    #: per-layer metric name -> its reader's ``read(run)``
    readers: Dict[str, Callable] = field(default_factory=dict)


@dataclass
class Run:
    """What a per-layer reader reads: the traced window's summary and the
    driver's counters over it."""

    cell: Cell
    trace: object
    counters: dict


def _applies(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(bench_dir: Path, metric: str) -> Path:
    """The reader of a per-layer metric: its own file, else its
    family's (the name up to the first dot)."""
    for stem in (metric, metric.split(".", 1)[0]):
        p = bench_dir / "metrics" / f"{stem}.py"
        if p.is_file():
            return p
    raise CellError(f"no reader for per-layer metric {metric!r} under "
                    f"{bench_dir / 'metrics'}")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, its files
    loaded from ``root``; raises :class:`CellError` on any name that does
    not resolve. Drivers are the benchmark's own code and always come
    from this folder."""
    root = Path(root)
    bench_dir = root / "perfbench"
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise CellError(f"{name}: no configuration {w['config']!r}")
    cfg_path = root / configs[w["config"]]["file"]
    if not cfg_path.is_file():
        raise CellError(f"{name}: configuration file {cfg_path} missing")
    mix_path = bench_dir / "mixes" / f"{w['traffic']}.json"
    if not mix_path.is_file():
        raise CellError(f"{name}: traffic mix {mix_path} missing")
    mix = json.loads(mix_path.read_text())
    if not (BENCH_DIR / "drivers" / f"{mix['driver']}.py").is_file():
        raise CellError(f"{name}: the mix's driver {mix['driver']!r} has "
                        "no file under perfbench/drivers/")
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    readers = {}
    for m in per_layer:
        mod = _load_module(reader_path(bench_dir, m["name"]),
                           "perfbench_metric_" + m["name"].replace(".", "_"))
        readers[m["name"]] = mod.read
    return Cell(name=name, workload=w,
                config=json.loads(cfg_path.read_text()), mix=mix,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=per_layer, readers=readers)


def driver_module(cell: Cell):
    """The driver of the cell's mix (``perfbench.drivers.<driver>``)."""
    import importlib

    return importlib.import_module(f"perfbench.drivers.{cell.mix['driver']}")


def forbidden_loaded() -> List[str]:
    """Forbidden top-level module names present in ``sys.modules``."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & FORBIDDEN_MODULES)


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """One run of ``cell`` on ``device``: the result's parts, which
    :func:`result_line` writes out. Tests pass ``device='cpu'``."""
    import torch

    drv = driver_module(cell)
    on_card = device.startswith("cuda")
    t0 = time.perf_counter()
    state = drv.Driver(cell, seed, device)
    try:
        if trace:
            from . import trace as tr
            tr.warm_profiler(device)
        setup_s = time.perf_counter() - t0
        log(f"{cell.name} seed {seed}: set-up {setup_s:.3f} s")
        out: dict = {"metrics": {}}
        if not trace:
            passes, t_start = 0, time.perf_counter()
            while True:
                state.run_pass()
                passes += 1
                wall = time.perf_counter() - t_start
                if wall >= seconds:
                    break
            values = dict(state.end_to_end(wall), setup_s=setup_s)
            log(f"window: {passes} passes in {wall:.3f} s")
            for m in cell.end_to_end:
                if m["name"] not in values:
                    raise CellError(f"{cell.name}: the driver gives no "
                                    f"{m['name']!r}")
                out["metrics"][m["name"]] = {"value": values[m["name"]],
                                             "unit": m["unit"]}
        else:
            from . import trace as tr
            n = int(cell.mix["trace_passes"])
            summary = tr.traced(lambda: [state.run_pass() for _ in range(n)],
                                device)
            run = Run(cell=cell, trace=summary, counters=state.counters())
            for m in cell.per_layer:
                v = cell.readers[m["name"]](run)
                if v is not None:
                    out["metrics"][m["name"]] = {"value": v,
                                                 "unit": m["unit"]}
            out["trace"] = summary
            log(f"traced window: {n} passes, {summary.window_s:.3f} s, "
                f"device busy {summary.busy_s:.3f} s")
        out["attempted"], out["failed"] = state.attempted, state.failed
        out["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated())
                                    if on_card else 0)
        for line in state.facts():
            log(line)
        state.release()
        out["checks"] = state.check()
    finally:
        state.close()
    out["correct"] = (out["failed"] == 0
                      and all(c["value"] <= c["limit"]
                              for c in out["checks"].values()))
    return out


def result_line(out: dict, device: dict) -> str:
    """The result object as one JSON line, ``checks`` last."""
    res = {"correct": out["correct"], "attempted": out["attempted"],
           "failed": out["failed"], "metrics": out["metrics"],
           "device": device}
    if "trace" in out:
        res["breakdown"] = out["trace"].breakdown()
    res["checks"] = out["checks"]
    return json.dumps(res)


def parse(argv=None):
    p = argparse.ArgumentParser(prog="perfbench", description=__doc__.split(
        "\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    t0 = time.perf_counter()
    args = parse(argv)
    cell = resolve(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            ": no result")
        return 2
    log(f"torch imported in {time.perf_counter() - t0:.3f} s; device "
        f"{torch.cuda.get_device_name(0)}; nvidia-smi: "
        f"{power_limit()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        log(f"forbidden modules loaded in this process: {bad}: no result")
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if "trace" in out:
        device["busy_s"] = out["trace"].busy_s
        device["window_s"] = out["trace"].window_s
    line = result_line(out, device)
    for name, c in out["checks"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(line, flush=True)
    return 0
