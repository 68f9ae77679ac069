#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It imports
nothing of JAX or of the JAX package, builds the port's CUDA kernels from
the checkout's sources, and runs in phases; any failure exits non-zero:

1. device — requires CUDA; prints the card's name and power limit
   (nvidia-smi) and the torch and CUDA versions;
2. build — every kernel from ``csrc/`` (one nvcc per source, started
   together), with ptxas' register/shared-memory report, which must show
   no spills;
3. kernels vs their plain torch versions on the card, at the main path's
   shapes (the host driver's padded batch among them) and at every
   registered slot count, and the tiled second-moment kernel bit for bit
   against the rowwise one; both timed in turns with CUDA events at the
   240/390/1440-slot shapes, and each in turns with its plain version at
   the shape and window of the path whose launches the kernels line counts;
4. the main path at full width — ``synth_day`` → ``grid_day`` →
   ``compute_batch`` for all 58 factors, 5000 tickers x 8 days on
   ``cn_ashare_240`` — through the tiled kernel (launch counts reset just
   before, read just after) and held against the same batch through the
   plain version; then the generic-window path,
   ``ops.rolling.rolling_window_stats`` at window 20 on the same batch,
   through the rowwise kernel;
4c. the packed path at full width: the same batch encoded on the host into
   the ingest wire, packed into one buffer, copied, decoded on the card
   (bitwise the CPU's decode) and run by ``compute_packed_prepared``, whose
   result must equal ``compute_batch`` on the decoded bars bit for bit; the
   raw packed path likewise against ``compute_batch`` on the raw bars; one
   tiled launch per call; walls and bytes copied of both;
5. where one main-path call spends its device time (``torch.profiler``),
   the sort-based ops named;
6. the sort-based ops at full width, card against CPU bit for bit: the
   whole-frame rank and order over the batch's ``[8, 1.2M]`` day frames,
   the sorted segments over ``[40000, 240]``, and crafted rows (signed
   zeros, a valid ``+inf``, both NaN signs, all-invalid rows, a
   zero-volume day whose ``topk_sum`` is NaN on both devices);
7. the card against the CPU on small batches at ``cn_ashare_240``,
   ``us_390`` and ``crypto_1440``, through ``compute_batch`` and through
   the wire (``compute_packed``), with the wire decode of crafted batches
   at every mode of every ladder held bitwise: the CPU path is the one the
   tests hold against the JAX package. ``doc_pdf*`` must agree exactly
   except on lanes whose cumulative share at the crossing lies within
   tests/test_parity.py's ``PDF_EDGE_EPS`` of the threshold;
8. the host driver at full width: ``compute_exposures`` over 5000 tickers
   x 40 trading days of int-coded parquet day files (``synth_day`` with
   the main path's recipe, written before the timed run), all 58 factors,
   eight days a batch: five tiled launches, the native grid and wire
   encoder on every batch (the native encoding byte-identical to numpy's,
   both timed), every row bit for bit ``compute_batch`` on its batch's
   decoded bars, and that batch, pad lanes included, held against the
   plain rolling version at the parity suite's tolerances; a resume over 8 more days that computes only those and
   keeps every old row's bits; a run over all 48 days from an empty cache
   with one injected launch failure that loses no day and gives the same
   bits, under ``torch.profiler`` for the device's idle share; the pinned
   copy timed against a pageable one. It needs ``pyarrow`` and fails
   without it;
9. the evaluation on the card. 9a, the evaluation ops at full width: a
   year of an A-share universe (5000 codes x 244 trading days of a seeded
   exposure with 2% absent rows, NaN rows and ties, and a seeded daily PV
   table), pivoted on the host as ``ic_test`` pivots it, then
   ``ic_series``, ``_qcut_labels`` at 5 and 10 groups, ``coverage_counts``
   and ``decile_spread`` on the card against the same calls on the CPU
   (labels and counts bitwise, IC within tests/test_torch_masked.py's corr
   tolerance), each timed with CUDA events. 9b, the user's path on phase
   8's files and cache, before its temporary directory goes:
   ``MinFreqFactor('mmt_ols_qrs').cal_exposure_by_min_data`` over the 40
   day files into a fresh cache (one tiled launch a batch, its column
   bitwise phase 8's), ``cal_final_exposure`` (calendar week, z),
   ``coverage``/``ic_test``/``group_test`` (week, 5 groups, tmc) and the
   CLI's ``evaluate`` for one factor of each of the seven families on
   phase 8's cache, all against a PV parquet written for the 5000 codes x
   48 dates, each on the card and on the CPU: counts and group returns
   bitwise, IC statistics within rtol 1e-4 / atol 1e-6. Nothing draws, so
   matplotlib is not needed;
10. the intraday streaming engine at full width on phase 4's first day
   (5000 tickers x ``cn_ashare_240``, all 58 factors, ``rolling_impl=
   'cuda'``): three warm engines (exact, fast, and one through the plain
   rolling version) fold the day in 16-minute micro-batches; the exact
   snapshots at minutes 60, 120 and 240 are bitwise ``compute_batch`` on
   the card for the same prefix, each one tiled launch with the impl
   resolved ``cuda``; at 60 and 240 the kernel's snapshot agrees with the
   plain engine's within the parity suite's tolerances; the fast finalize
   holds every factor's pin (``parity_report``); ``snapshot_wire_stats``
   decodes within ``RESULT_BOUNDS`` with exact NaN status, its stats'
   counts/min/max are bitwise the host sketch's, and the exposures do not
   change with the side outputs; no callable is built after warmup; the
   day again as 240 cohorts of 5000 rows + advance leaves every carry leaf
   bitwise the scan path's; a save at minute 120 restored into a fresh
   engine finishes bitwise; the tiled kernel on the minute-60 prefix mask
   against its plain version and the rowwise kernel. Then phase 4's batch
   through ``compute_packed_prepared(..., result_spec=, factor_stats=True)``
   (the spill floor grown until nothing overflows), with the same holds
   and the payload/raw byte ratio. Update, cohort and snapshot times by
   CUDA events, the carry's bytes and the peak memory;
11. the factor server at full width: ``FactorServer`` on the card over
   ``SyntheticSource(16 days x 5000 tickers, seed 0)`` on ``cn_ashare_240``,
   all 58 factors, ``rolling_impl='cuda'``, ``stream=True`` warmed for
   16-minute ingests. With the launch counts set to 0 just before and read
   after each step: the cold block ``[0, 8)`` (one tiled launch), a warm
   repeat of the whole block (nothing built, one cache hit, no launch), IC,
   decile and wire answers on the cached block, 16 concurrent identical
   queries on ``[8, 16)`` (one dispatch, one launch, the impl resolved
   ``cuda``), the first query on ``[4, 12)`` with the callables warm (one
   launch, nothing built), two 16-minute ingests and an intraday query
   (one launch).
   Held: the served exposures bitwise ``compute_batch`` on the block's
   decoded bars, close/valid bitwise, IC bitwise ``eval_ops.ic_series`` and
   decile counts bitwise ``_qcut_labels`` on the cached block, the wire
   payload byte-identical to ``encode_block``, the intraday answer bitwise
   a standalone ``StreamEngine``'s snapshot, the same queries through the
   edge and the legacy HTTP doors on 127.0.0.1 bitwise the in-process
   answers (wire bodies byte-identical), ``/healthz`` naming the card and
   the HBM sampler's bytes in use between the server's tensors' bytes and
   the driver's ``mem_get_info`` count. Timed:
   the cold build, cache-hit answers, request walls by kind in process and
   over the edge, a warm ``build_block``'s enqueue and fetch apart, and the
   tiled kernel at the block's ``[40000, 240]`` against its plain version.
12. factor discovery at full width: ``DiscoveryEngine`` on
   ``synth_batch(512, 16)`` (16 days x 512 tickers on ``cn_ashare_240``,
   horizon-1 forward returns, the default skeleton) at populations 512 for
   6 generations, 2048 for 4 and 8192 for 2, each warmed first: candidates/s,
   generation walls p50/p99, one host sync a generation, nothing built in
   the loop, no second-moment launch, peak memory; one pop-512 generation
   under ``torch.profiler`` and through a dispatch counter (device ops and
   bytes a candidate). Held: two same-seed evolves bitwise, the device
   top-k against the host argsort, ``generation_stats`` on a 512-candidate
   population of bounded ops card against CPU (NaN positions identical,
   fitness/IC within the CPU tests' tolerance, rank IC and spread likewise
   where the card and the CPU order every date's exposures alike), the
   rolling std/corr card against CPU off their degenerate edge with the
   edge lanes counted. Then a research server over phase 11's source (all
   58, ``rolling_impl='cuda'``, a temporary ``research_dir``): one
   discovery job (one sync a generation, nothing built in the loop, its
   record written, the name listed), the next query's rebuild (one tiled
   launch) equal to ``make_kernel`` on the block's decoded bars, ``GET
   /v1/factors`` and ``POST /v1/discover`` over the edge as in process,
   and a second server on the same directory reloading the record and
   answering the same bits.
13. the resident year and a profiled ``compute``. 13a: a year of
   ``bench.make_batch``'s recipe, 8 batches x 32 days x 5000 tickers on
   ``cn_ashare_240`` (256 days, bench.py's headline loop shape), made and
   encoded one batch at a time under one shared floor
   (``tests/torch_cases.encode_year``; only the packed buffers are kept),
   copied to the card pinned and non-blocking, and run by ONE
   ``compute_packed_resident`` call for all 58 factors with
   ``rolling_impl='cuda'`` under ``torch.cuda.set_sync_debug_mode
   ('error')``, then fetched once. Held: 8 tiled launches (counts reset
   just before, read just after), no host sync inside the call, batches 0
   and 7 bitwise ``compute_packed_prepared`` on fresh copies of their
   buffers, the donated handles raising ``DonatedBufferError`` on use
   (naming the contract under ``debug_validate``), and the same year with
   ``result_spec`` (spill floor grown until nothing overflows) and
   ``factor_stats``: each payload byte-identical to ``encode_block`` of
   its raw slice, each stats row bitwise ``factor_stats_block``. Timed:
   the enqueue and the fetch apart, days/s, peak memory, and the tiled
   kernel at the year's ``[160000, 240]`` in turns with its plain
   version. 13b, inside phase 8's temporary directory (it runs right
   after 9b): the CLI's ``compute --profile-dir --telemetry-dir`` in this
   process over 16 of phase 8's day files (two tiled launches): the
   trace has device events (``device_time_block`` available), names the
   tiled kernel among its ops, and annotates the stages ``io``, ``grid``,
   ``launch`` and ``device``; the cache is bitwise a run without the
   profiler; the device time by op class and the device's busy share of
   the wall are printed.
14. the sharded resident year and the sharded driver, on ranks that are
   spawned processes sharing the one card (``parallel.launch``; their
   times are four ranks on one card, not multi-card scaling). 14d's probe
   first: a two-rank NCCL group's all-reduce (NCCL refuses two ranks on
   one GPU; if it takes them, 14a/14b run on NCCL and the log says so,
   else on gloo, each collective staged through pinned host buffers).
   Batches 0-1 of phase 13a's year are split from their packed buffers
   (no encode) into 4 ticker shards and a (2, 2) grid of tiles, written
   to a temporary directory that each rank reads its part of. 14a:
   ``compute_packed_resident_sharded`` on a (1, 4) mesh, all 58 factors,
   ``[32, 1250]`` a rank a step, under ``set_sync_debug_mode('error')``
   (the transport's staging waits counted apart): one tiled launch a rank
   a step, donated handles raising, the outputs held against phase 13a's
   (bitwise, the JAX package's ulp pair at 16 eps; a factor off that bar
   is named with its largest gap and held to the parity tolerances), then
   with ``result_spec`` and ``factor_stats``: each rank's payload the
   single-device payload's arrays on its lanes byte for byte, the stats
   counts/min/max bitwise and moments within 32 eps of their value
   (the sums are f64, rounded once). 14b:
   ``compute_packed_resident_2d`` on (2, 2), one batch a call with the
   carry threaded: the tiles held as in 14a, one ``carry_handoff``
   dispatch a call, the year-end carry on every rank bitwise the
   single-device span fold. 14c, inside phase 8's directory right after
   13b: the CLI's ``compute --mesh-tickers 2`` over 16 of phase 8's day
   files, its cache bitwise phase 8's rows of those days. 14d: a one-rank
   NCCL mesh whose tickers axis is the WORLD group (so the loop's
   collectives are NCCL's, not the one-rank identity): its collectives on
   the card's tensors under the sync check with no staging, the sharded
   loop over both batches bitwise 13a, and with the side outputs the
   payload and stats the single-device ones bit for bit.
   Timed: each rank's enqueue and completion, peak memory per rank and
   summed, and the tiled kernel at a rank's ``[40000, 240]`` step in
   turns with its plain version.
15. the fleet. 15a: ``FactorFleet`` of 2 replicas over phase 11's source
   (5000 tickers, all 58 factors, ``rolling_impl='cuda'``, ``stream=True``)
   with ``devices=[cuda:0, cuda:0]`` passed explicitly: the two replicas
   share the one card, so their times are not multi-card scaling, and
   both HBM samples read the same card (``cache_bytes`` is sized so that
   the card's whole allocation stays under the demotion line, and no
   replica may be demoted for HBM). With the launch counts set to 0 just
   before and read after each step: 16 queries on ``[0, 8)`` submitted
   before ``start()`` (one dispatch, on the owner ``route_order`` names,
   one tiled launch; every answer bitwise phase 11's standalone answer on
   all 58, the wire payload byte-identical), two distinct ranges on their
   rendezvous owners (one launch each), the degrade ladder on a fresh
   range with an injected raiser (demoted, answered through the other
   replica with one launch, restored after the cooldowns with one launch,
   the two answers bitwise), a cold block build on each replica (one
   launch each), and an ingest fan-out with one leg broken (failed, then
   skipped) followed by an intraday query (one launch), its answer bitwise
   phase 11's (a standalone ``StreamEngine`` snapshot); no kernel library
   built in the loop, the rolling impl resolved ``cuda`` on every replica.
   Then the pod counters equal to the sums over the replicas, ``/healthz``
   and ``/v1/metrics?format=prometheus`` through the edge and the legacy
   doors naming ``cuda:0`` for each replica with JSON answers bitwise in
   process and wire bodies byte-identical, and the replicas' bundles
   aggregated with every counter exact. Timed: a cache-hit request routed
   against the same request sent straight to the owning server (the
   router hop), in turns; each replica's cold block build; the tiled
   kernel at a replica block's ``[40000, 240]`` in turns with its plain
   version. 15b: the CLI's ``serve --fleet 1 --demo 12`` in process on the
   default device list (every visible card): one live replica, 12 routed,
   the rolling impl resolved ``cuda``.
16. the in-server placements, every shard on ``cuda:0`` (so the times are
   the placement's price on one card, not multi-card scaling). 16a:
   ``StreamEngine(5000, mesh=resident_mesh(2, devices=[cuda:0] * 2))``
   folds phase 10's day in 16-minute micro-batches beside an unsharded
   engine: the exact snapshots at minutes 60, 120 and 240 bitwise the
   unsharded ones (NaN lanes apart), each launching the tiled kernel once
   a shard (counts set to 0 just before, read just after), resolved
   ``cuda``; ``snapshot_wire_stats`` byte-identical with bitwise stats;
   the day as 240 cohorts plus ``advance`` on the shards leaving every
   carry leaf bitwise the scan path's; a save at minute 120 on either
   placement restored onto the other finishing bitwise; no callable built
   after warmup; the carry restored onto 4 shards snapshotting bitwise.
   Timed with CUDA events: fold, cohort and snapshot on both placements,
   and the tiled kernel at a shard's ``[2500, 240]`` and ``[1250, 240]``
   (minute-60 prefix) in turns with its plain version. 16b:
   ``DiscoveryEngine(mesh=)`` over two shards on phase 12's slab at
   population 2048 (chunk 16): a warm generation under
   ``set_sync_debug_mode("error")`` bitwise the single-device one, then 3
   generations of both with the same genome and history, one sync a
   generation, no build, candidates/s of both. 16c: a ``FactorServer``
   over phase 11's source with ``devices=[cuda:0] * 2``, ``stream=True``,
   ``research=True`` and both placements on: both gauges read 2, the
   intraday answer bitwise phase 11's standalone one (the tiled kernel
   once a shard), a discover job on 2 shards, no kernel build in the loop.
   16d: ``FactorFleet`` of 2 replicas over ``[cuda:0] * 4`` with both
   knobs: each replica's carry on 2 shards, the routed intraday answer
   bitwise 16c's.

The second-to-last line of stdout is a JSON object with one entry per
kernel and path (the tiled kernel on the host driver's batches, on the
streaming snapshots, on the server's block builds, on the resident
year's batches, on a rank's step of the sharded year, on the fleet
replicas' block builds and on a shard's snapshot of the placed carry at 2
and 4 shards, the rowwise kernel on the window-20 path); the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

#: the crafted inputs the port's tests share (tests/torch_cases.py), loaded
#: by path: tests/ is not a package
_CASES = importlib.util.spec_from_file_location(
    "torch_cases", REPO / "tests" / "torch_cases.py")
cases = importlib.util.module_from_spec(_CASES)
_CASES.loader.exec_module(cases)
# phase 14's ranks are spawned processes that import this module by name
sys.modules.setdefault("torch_cases", cases)
sys.path.append(str(REPO / "tests"))
WINDOW = 50
TICKERS, DAYS = 5000, 8
#: H100 SXM peaks (NVIDIA data sheet) used for the kernels' bound_ms
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
#: the generic-window path's window (any window but 50 runs the rowwise
#: kernel)
OTHER_WINDOW = 20
#: CUDA-event samples per turn, launches per sample
TURN_SAMPLES, SAMPLE_LAUNCHES = 5, 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def parity_tables():
    """The CPU parity suite's tolerance tables, read from
    tests/test_parity.py's source: the suite imports JAX, which this
    script must not."""
    want = {"RTOL", "ATOL", "RTOL_OVERRIDE", "NOISE_FACTORS", "NOISE_ATOL",
            "DEGENERATE_BETA_Z", "DEGENERATE_BETA_STD", "BETA_EPS_REL",
            "DEGENERATE_KURT", "PDF_EDGE_EPS", "_PDF_THRESHOLDS"}
    tree = ast.parse((REPO / "tests" / "test_parity.py").read_text())
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in want):
            expr = compile(ast.Expression(node.value), "test_parity", "eval")
            out[node.targets[0].id] = eval(expr, {"np": np})
    missing = want - set(out)
    if missing:
        fail(f"tests/test_parity.py lacks {sorted(missing)}")
    return out


def cuda_times_ms(fn, iters: int = 10, warmup: int = 3):
    """Per-call device times of ``fn`` in ms, each between its own pair of
    CUDA events."""
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for start, stop in pairs:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(stop) for start, stop in pairs]


def batched_times_ms(fn, samples: int = TURN_SAMPLES,
                     launches: int = SAMPLE_LAUNCHES):
    """Per-launch device times of ``fn`` in ms: each sample is one pair of
    CUDA events around ``launches`` back-to-back calls, divided by
    ``launches``."""
    fn()
    out = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / launches)
    return out


def moment_bound(rows: int, L: int, window: int = WINDOW):
    """(bound_ms, bound_by, MB moved, G FP32 instructions) of one
    second-moment call: each input plane read once and each output written
    once, at the HBM rate; 5 FP32 instructions per term (2 FSUB, 3 FFMA;
    an FSUB takes an FFMA's issue slot) at half the FLOP rate."""
    n_bytes = 7 * rows * L * 4
    n_instr = 5 * window * rows * L
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_instr / (F32_FLOPS_PER_S / 2) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", n_bytes / 1e6, n_instr / 1e9)


def wall_times_ms(fn, iters: int):
    """Per-call host wall times of ``fn`` in ms, each ending in a device
    synchronise."""
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def spread(samples) -> str:
    return (f"median {np.median(samples):.4f} ms (min {min(samples):.4f}, "
            f"max {max(samples):.4f}, n={len(samples)})")


def moment_case(rows: int, L: int, seed: int, window: int = WINDOW,
                pad=None):
    """Second-moment inputs at ``[rows, L]`` on the card, made the way the
    main path makes them: a close random walk, low/high at -/+0.1%, 5%
    missing bars, row 0 full and row 1 full and constant (where there are
    two rows). With ``pad = (Tp, n)`` the rows are days of ``Tp`` tickers
    whose lanes from ``n`` on are the host driver's bucket pads: no bar,
    zero prices."""
    from replication_of_minute_frequency_factor_tpu_torch.ops import rolling

    g = torch.Generator(device="cuda").manual_seed(seed)
    steps = torch.randn(rows, L, generator=g, device="cuda") * 1e-3
    close = 10.0 * torch.exp(torch.cumsum(steps, dim=-1))
    low, high = close * 0.999, close * 1.001
    mask = torch.rand(rows, L, generator=g, device="cuda") > 0.05
    mask[:2] = True
    low[1], high[1] = low[1, 0], high[1, 0]
    if pad is not None:
        tp, n = pad
        for t in (mask, low, high):
            t.view(-1, tp, L)[:, n:] = 0
    valid = rolling._windowed_sum(mask, window) > window - 0.5
    return rolling.second_moment_inputs(low, high, mask, window), valid


def launched(before):
    """Kernel launches per kernel since the ``before`` snapshot."""
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling_cuda)

    return {k: n - before[k] for k, n in rolling_cuda.launches.items()}


def hold_to_plain(label, got, want, valid, rtol, atol,
                  constant_row: bool = True):
    """Finite values within rtol/atol of the plain version on valid lanes
    and, on :func:`moment_case`'s inputs (``constant_row``), exactly-zero
    moments on the constant row 1; returns max |diff|."""
    err = 0.0
    for name, a, b in zip(("s_xx", "s_yy", "s_xy"), got, want):
        a, b = a[valid], b[valid]
        if not bool(torch.isfinite(a).all()):
            fail(f"{label}: non-finite {name}")
        diff = (a - b).abs()
        bad = diff > atol + rtol * b.abs()
        if bool(bad.any()):
            fail(f"{label}: {name} disagrees with the plain version at "
                 f"{int(bad.sum())} lanes (max |diff| "
                 f"{float(diff.max()):.3e})")
        if diff.numel():
            err = max(err, float(diff.max()))
    if constant_row and valid.shape[0] > 1 and bool(valid[1].any()) and any(
            float(s[1][valid[1]].abs().max()) != 0.0 for s in got):
        fail(f"{label}: the constant row's moments are not exactly zero")
    return err


def check_moments(rows: int, L: int, seed: int, rtol=1e-5, atol=1e-9,
                  pad=None):
    """The tiled kernel (through the wrapper) vs the plain version on
    valid lanes, and bit for bit vs the rowwise kernel on every lane (so
    the two share one max_abs_err); ``pad`` as in :func:`moment_case`.
    Returns (inputs, max_abs_err)."""
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling_cuda)

    args, valid = moment_case(rows, L, seed, pad=pad)
    before = dict(rolling_cuda.launches)
    got = rolling_cuda.second_moments(*args, WINDOW)
    base = rolling_cuda._second_moments_rowwise(*args, WINDOW)
    torch.cuda.synchronize()
    if launched(before) != {"tiled": 1, "rowwise": 1}:
        fail(f"second_moments {rows}x{L}: launches {launched(before)}, "
             "expected one tiled (wrapper) and one rowwise")
    for name, a, b in zip(("s_xx", "s_yy", "s_xy"), got, base):
        neq = a.view(torch.int32) != b.view(torch.int32)
        if bool(neq.any()):
            fail(f"second_moments {rows}x{L}: tiled {name} differs from "
                 f"the rowwise kernel's bits at {int(neq.sum())} of "
                 f"{neq.numel()} lanes")
    want = rolling_cuda.second_moments_plain(*args, WINDOW)
    label = f"second_moments {rows}x{L}"
    err = hold_to_plain(label, got, want, valid, rtol, atol)
    if pad is not None:
        tp, n = pad
        for name, a, b in zip(("s_xx", "s_yy", "s_xy"), got, want):
            if not torch.equal(a.view(-1, tp, L)[:, n:],
                               b.view(-1, tp, L)[:, n:]):
                fail(f"{label}: {name} on the pad rows differs from the "
                     "plain version")
    pads = f" ({rows // pad[0] * (pad[0] - pad[1])} pad rows)" if pad else ""
    log(f"kernel second_moments rows={rows}{pads} L={L}: tiled bitwise equal"
        f" to rowwise on all {3 * rows * L} lanes; max_abs_err={err:.3e} vs "
        f"plain (rtol {rtol}, atol {atol} on {int(valid.sum())} valid "
        "lanes) ok")
    return args, err


def check_other_window(rows: int, L: int, seed: int, rtol=1e-5,
                       atol=1e-9):
    """A window other than 50 through the wrapper: one rowwise launch, no
    tiled one, within rtol/atol of the plain version on valid lanes.
    Returns (inputs, max_abs_err)."""
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling_cuda)

    args, valid = moment_case(rows, L, seed, OTHER_WINDOW)
    before = dict(rolling_cuda.launches)
    got = rolling_cuda.second_moments(*args, OTHER_WINDOW)
    torch.cuda.synchronize()
    if launched(before) != {"tiled": 0, "rowwise": 1}:
        fail(f"window {OTHER_WINDOW}: launches {launched(before)}, expected "
             "one rowwise")
    want = rolling_cuda.second_moments_plain(*args, OTHER_WINDOW)
    err = hold_to_plain(f"second_moments window={OTHER_WINDOW} {rows}x{L}",
                        got, want, valid, rtol, atol)
    log(f"kernel second_moments window={OTHER_WINDOW} rows={rows} L={L}: "
        f"one rowwise launch; max_abs_err={err:.3e} vs plain ok")
    return args, err


def time_moments(rows: int, L: int, card: str, pad=None):
    """The rowwise and tiled kernels at ``[rows, L]`` in turns (rowwise,
    tiled, tiled, rowwise); ``pad`` as in :func:`moment_case`; returns
    {kernel: per-launch ms samples}."""
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling_cuda)

    args, _ = moment_case(rows, L, seed=rows + L + 1, pad=pad)
    fns = {"tiled": lambda: rolling_cuda.second_moments(*args, WINDOW),
           "rowwise": lambda: rolling_cuda._second_moments_rowwise(
               *args, WINDOW)}
    out = {"tiled": [], "rowwise": []}
    for k in ("rowwise", "tiled", "tiled", "rowwise"):
        out[k] += batched_times_ms(fns[k])
    bound, by, mb, gi = moment_bound(rows, L)
    log(f"second_moments [{rows}, {L}] on {card}: tiled "
        f"{spread(out['tiled'])} ({bound / np.median(out['tiled']):.0%} of "
        f"bound); rowwise {spread(out['rowwise'])} "
        f"({bound / np.median(out['rowwise']):.0%} of bound); bound "
        f"{bound:.4f} ms by {by} ({mb:.1f} MB moved, {gi:.2f} G FP32 "
        "instructions)")
    return out


def synth_batch(n_tickers: int, n_days: int, seed: int, session=None,
                **kw):
    from replication_of_minute_frequency_factor_tpu_torch.data import (
        grid_day, synth_day)

    rng = np.random.default_rng(seed)
    days = [synth_day(rng, n_codes=n_tickers, date=f"2024-01-{2 + i:02d}",
                      session=session, **kw) for i in range(n_days)]
    codes = np.unique(np.concatenate([d["code"] for d in days]))
    grids = [grid_day(d["code"], d["time"], d["open"], d["high"], d["low"],
                      d["close"], d["volume"], codes=codes, session=session)
             for d in days]
    return (np.stack([g.bars for g in grids]),
            np.stack([g.mask for g in grids]))


def zero_volume_batch():
    """One day, two tickers: ticker 0 trades 4 bars and no volume (every
    share 0/0; fewer valid lanes than k), ticker 1 a full ordinary day."""
    bars = np.zeros((1, 2, 240, 5), np.float32)
    mask = np.zeros((1, 2, 240), bool)
    bars[..., :4] = 10.0
    bars[:, 1, :, 4] = 100.0
    mask[:, 0, :4] = True
    mask[:, 1] = True
    return bars, mask


def pdf_edge_lanes(ctx, threshold: float, eps: float):
    """Lanes ``[*lead, T]`` of ``ctx``'s batch whose cumulative share at the
    ``doc_pdf`` crossing lies within ``eps`` of ``threshold``: the first
    segment end past it, or the last one at or below it. Only there may
    another device's f32 cumsum cross one tie group earlier or later."""
    from replication_of_minute_frequency_factor_tpu_torch.ops.segments import (
        _sorted_segments)

    seg = _sorted_segments(ctx.eod_ret_global_rank, ctx.vol_share, ctx.mask)
    ends = torch.where(seg.is_end, seg.cumw, float("nan"))
    above = torch.where(ends > threshold, ends, float("inf")).amin(dim=-1)
    below = torch.where(ends <= threshold, ends, float("-inf")).amax(dim=-1)
    edge = (((above - threshold).abs() <= eps)
            | ((threshold - below).abs() <= eps))
    return edge.cpu().numpy()


def compare_blocks(label, names, got, ref, tables, beta, noisy=False,
                   kurt=None, pdf_ctx=None):
    """Per factor: identical NaN and inf positions (and inf signs), and
    finite values within the CPU parity suite's tolerances. ``beta`` is
    the reference run's ``(mean, std, last)`` beta moments: the beta
    z-score factors skip sub-noise numerators and widen rtol as
    tests/test_parity.py does. With ``pdf_ctx`` (the reference run's
    ``DayContext``) ``doc_pdf*`` must be exactly equal, except on the
    lanes :func:`pdf_edge_lanes` finds within ``PDF_EDGE_EPS`` of the
    threshold. Returns the largest share of its tolerance any compared
    value used, how many factors are bitwise equal, and how many
    ``doc_pdf*`` lanes differ at the edge."""
    got = got.double().cpu().numpy()
    ref = ref.double().cpu().numpy()
    if got.shape != ref.shape:
        fail(f"{label}: shapes {got.shape} and {ref.shape} differ")
    b_mean, b_std, b_last = (t.double().cpu().numpy() for t in beta)
    with np.errstate(invalid="ignore", divide="ignore"):
        num = np.abs(b_last - b_mean)
        scale = np.maximum(np.maximum(np.abs(b_mean), np.abs(b_last)), 1e-30)
        beta_skip = (~np.isfinite(num)
                     | (num < tables["DEGENERATE_BETA_Z"] * scale)
                     | (b_std < tables["DEGENERATE_BETA_STD"] * scale))
        beta_rtol = tables["BETA_EPS_REL"] / (num / scale)
    worst, n_bitwise, n_edge = 0.0, 0, 0
    for i, name in enumerate(names):
        a, b = got[i], ref[i]
        n_bitwise += int(np.array_equal(a, b, equal_nan=True))
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            fail(f"{label}/{name}: NaN positions differ "
                 f"({int((np.isnan(a) != np.isnan(b)).sum())} lanes)")
        if not np.array_equal(np.where(np.isinf(a), np.sign(a), 0),
                              np.where(np.isinf(b), np.sign(b), 0)):
            fail(f"{label}/{name}: inf positions or signs differ")
        if pdf_ctx is not None and name in tables["_PDF_THRESHOLDS"]:
            differ = ~((a == b) | (np.isnan(a) & np.isnan(b)))
            edge = pdf_edge_lanes(pdf_ctx, tables["_PDF_THRESHOLDS"][name],
                                  tables["PDF_EDGE_EPS"])
            if (differ & ~edge).any():
                j = np.flatnonzero(differ & ~edge)[0]
                fail(f"{label}/{name}: {int((differ & ~edge).sum())} lanes "
                     "differ away from the threshold's PDF_EDGE_EPS band "
                     f"(first: {a.flat[j]!r} vs {b.flat[j]!r})")
            n_edge += int(differ.sum())
            continue
        fin = np.isfinite(b)
        rtol = np.full(b.shape, tables["RTOL_OVERRIDE"].get(
            name, tables["RTOL"]["default"]))
        atol = tables["ATOL"].get(name, tables["ATOL"]["default"])
        if noisy and name in tables["NOISE_FACTORS"]:
            atol = max(atol, tables["NOISE_ATOL"])
        if name in ("mmt_ols_qrs", "mmt_ols_beta_zscore_last"):
            fin &= ~beta_skip
            rtol = rtol + np.where(fin, beta_rtol, 0.0)
        if kurt is not None and name in ("shape_skratio", "shape_skratioVol"):
            k = kurt["shape_kurt" if name == "shape_skratio"
                     else "shape_kurtVol"]
            fin &= ~(np.isfinite(k) & (np.abs(k) < tables["DEGENERATE_KURT"]))
        with np.errstate(invalid="ignore"):
            used = np.abs(a - b) / (atol + rtol * np.abs(b))
        bad = fin & ~(used <= 1.0)
        if bad.any():
            j = np.flatnonzero(bad)[0]
            fail(f"{label}/{name}: {int(bad.sum())} values out of "
                 f"tolerance (first: {a.flat[j]!r} vs {b.flat[j]!r})")
        if fin.any():
            worst = max(worst, float(used[fin].max()))
    return worst, n_bitwise, n_edge


def wire_path(bars, mask, card: str) -> None:
    """Phase 4c: the batch through the ingest wire and the packed path on
    the card; see the module docstring."""
    from replication_of_minute_frequency_factor_tpu_torch import (
        compute_batch)
    from replication_of_minute_frequency_factor_tpu_torch.data import wire
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling_cuda)
    from replication_of_minute_frequency_factor_tpu_torch.pipeline import (
        compute_packed_prepared)

    t0 = time.perf_counter()
    enc = wire.encode(bars, mask, use_native=False)
    enc_s = time.perf_counter() - t0
    if enc is None:
        fail("the main path's batch does not fit the wire")
    raw_bytes = bars.nbytes + mask.nbytes
    log(f"wire.encode {bars.shape[:-1]}: modes {enc.modes}, vol_scale "
        f"{enc.vol_scale}; {enc.nbytes / mask.size:.4f} wire bytes a bar "
        f"against {raw_bytes / mask.size:.4f} raw; {enc_s:.3f} s (host, "
        "numpy)")
    t0 = time.perf_counter()
    packed = {"wire": wire.pack_arrays(enc.arrays)}
    pack_w = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed["raw"] = wire.pack_arrays((bars, mask.astype(np.uint8)))
    pack_r = time.perf_counter() - t0
    log(f"pack_arrays: wire {packed['wire'][0].nbytes} B in {pack_w:.3f} s, "
        f"raw {packed['raw'][0].nbytes} B in {pack_r:.3f} s (host)")

    buf, spec = packed["wire"]
    dec = wire.decode(*wire.unpack(torch.from_numpy(buf).cuda(), spec))
    host = wire.decode(*wire.unpack(torch.from_numpy(buf), spec))
    torch.cuda.synchronize()
    for name, a, b in zip(("bars", "mask"), dec, host):
        if not cases.same_bits(a, b):
            fail(f"wire.decode {name}: the card's bits differ from the CPU's")
    if not np.array_equal(host[1].numpy(), mask):
        fail("wire.decode: the mask does not round-trip")
    log(f"wire.decode {tuple(dec[0].shape)}: card bitwise equal to CPU "
        f"({card})")

    def run(kind):
        b, sp = packed[kind]
        return compute_packed_prepared(b, sp, kind, device="cuda",
                                       rolling_impl="cuda")

    refs = {"wire": lambda: compute_batch(dec[0], dec[1], device="cuda",
                                          rolling_impl="cuda"),
            "raw": lambda: compute_batch(bars, mask, device="cuda",
                                         rolling_impl="cuda")}
    for kind in ("wire", "raw"):
        torch.cuda.synchronize()
        rolling_cuda.reset_launches()
        out = run(kind)
        torch.cuda.synchronize()
        n = dict(rolling_cuda.launches)
        if n != {"tiled": 1, "rowwise": 0}:
            fail(f"compute_packed kind={kind} launched {n}; expected the "
                 "tiled kernel once")
        if not cases.same_bits(out, refs[kind]()):
            fail(f"compute_packed kind={kind}: {tuple(out.shape)} differs "
                 "from compute_batch on the same bars")
        log(f"compute_packed kind={kind} {tuple(out.shape)}: launches {n}; "
            "bitwise equal to compute_batch on the "
            f"{'decoded' if kind == 'wire' else 'raw'} bars")
        del out
    del dec, host
    walls = {"raw": [], "wire": []}
    copies = {"raw": [], "wire": []}
    for kind in ("raw", "wire", "wire", "raw"):
        walls[kind] += wall_times_ms(lambda: run(kind), 5)
        host_buf = torch.from_numpy(packed[kind][0])
        copies[kind] += wall_times_ms(lambda: host_buf.to("cuda"), 5)
    for kind in ("raw", "wire"):
        log(f"compute_packed_prepared kind={kind}: wall {spread(walls[kind])}"
            f"; host->device copy of {packed[kind][0].nbytes} B (one "
            f"pageable buffer) {spread(copies[kind])} ({card})")


def sort_ops_full_width(bars, mask, card: str) -> None:
    """Phase 6: the sort-based ops at full width, card against CPU."""
    from replication_of_minute_frequency_factor_tpu_torch import (
        compute_batch)
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        DayContext)
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        masked_order, rank_average, topk_sum)
    from replication_of_minute_frequency_factor_tpu_torch.ops.segments import (
        _sorted_segments)

    ctx = DayContext(torch.from_numpy(bars).cuda(),
                     torch.from_numpy(mask).cuda())
    frame = (ctx.eod_ret.reshape(DAYS, -1), ctx.mask.reshape(DAYS, -1))
    host = tuple(t.cpu() for t in frame)
    for fn in (rank_average, masked_order):
        got = fn(*frame)
        want = fn(*host)
        if not cases.same_bits(got, want):
            fail(f"{fn.__name__} {tuple(frame[0].shape)}: the card's result "
                 "differs from the CPU's")
        ms = cuda_times_ms(lambda: fn(*frame), iters=5, warmup=1)
        log(f"{fn.__name__} {tuple(frame[0].shape)} (the eod_ret day "
            f"frames): card bitwise equal to CPU; {spread(ms)} ({card})")
    if not cases.same_bits(ctx.eod_ret_global_rank.reshape(DAYS, -1),
                           rank_average(*host)):
        fail("DayContext.eod_ret_global_rank differs from rank_average")

    rows = (-1, bars.shape[-2])
    for label, values in (("eod_ret", ctx.eod_ret),
                          ("global rank", ctx.eod_ret_global_rank)):
        args = (values.reshape(rows), ctx.vol_share.reshape(rows),
                ctx.mask.reshape(rows))
        seg = _sorted_segments(*args)
        ref = _sorted_segments(*(t.cpu() for t in args))
        for name in ("sv", "is_end"):
            if not cases.same_bits(getattr(seg, name), getattr(ref, name)):
                fail(f"_sorted_segments({label}) {name}: the card's result "
                     "differs from the CPU's")
        ends = ref.is_end
        diff = (seg.cumw.cpu() - ref.cumw)[ends].abs()
        diff = diff[torch.isfinite(diff)]
        ms = cuda_times_ms(lambda: _sorted_segments(*args), iters=5,
                           warmup=1)
        log(f"_sorted_segments({label}) {tuple(args[0].shape)}: sorted "
            "values and segment ends bitwise equal card vs CPU; cumulative "
            f"shares at segment ends max |diff| {float(diff.max()):.3e} (f32 "
            f"scans in two orders); {spread(ms)} ({card})")
    del ctx, frame, host, seg, ref

    x, m = cases.crafted_rows()
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    for fn in (rank_average, masked_order):
        if not cases.same_bits(fn(xt.cuda(), mt.cuda()), fn(xt, mt)):
            fail(f"{fn.__name__} on the crafted rows: card differs from CPU")
    zb, zm = zero_volume_batch()
    names = ("doc_vol5_ratio", "doc_vol10_ratio", "doc_vol50_ratio")
    for dev in ("cuda", "cpu"):
        out = compute_batch(zb, zm, names=names, device=dev)
        share = torch.zeros(4, device=dev) / torch.zeros(4, device=dev).sum()
        ones = torch.ones(4, dtype=torch.bool, device=dev)
        nans = [bool(torch.isnan(v)) for v in (
            *out[:, 0, 0], topk_sum(share, ones, 5),
            topk_sum(-share, ones, 5))]
        if not all(nans) or not bool(torch.isfinite(out[:, 0, 1]).all()):
            fail(f"topk_sum on the zero-volume day ({dev}): {out[:, 0]}")
    log("crafted rows (signed zeros, valid +-inf, +NaN and -NaN lanes, an "
        "all-invalid row): rank_average and masked_order bitwise equal card "
        "vs CPU; a zero-volume day with fewer valid bars than k: topk_sum "
        "and doc_vol*_ratio NaN on both devices, whatever the NaN's sign")


def card_vs_cpu(tables, names, card: str) -> int:
    """Phase 7: small batches at three sessions through ``compute_batch``
    and through the wire, card against CPU; the wire decode of crafted
    batches at every rung of every ladder. Returns the ``doc_pdf*`` lanes
    that differed at the threshold's edge."""
    from replication_of_minute_frequency_factor_tpu_torch import (
        compute_batch, compute_packed)
    from replication_of_minute_frequency_factor_tpu_torch.data import wire
    from replication_of_minute_frequency_factor_tpu_torch.markets import (
        get_session)
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        DayContext)

    n_edge = 0
    for sess, seed in (("cn_ashare_240", 7), ("us_390", 8),
                       ("crypto_1440", 9)):
        spec = get_session(sess)
        sb, sm = synth_batch(16, 2, seed=seed, session=sess,
                             missing_prob=0.05, zero_volume_prob=0.05,
                             constant_price_codes=2, short_day_codes=2)
        enc = wire.encode(sb, sm)
        if enc is None:
            fail(f"{sess}: the small batch does not fit the wire")
        buf, wspec = wire.pack_arrays(enc.arrays)
        dec = wire.decode(*wire.unpack(torch.from_numpy(buf), wspec))
        for path, inputs, run in (
                ("compute_batch", (torch.from_numpy(sb), torch.from_numpy(sm)),
                 lambda dev: compute_batch(sb, sm, session=sess, device=dev,
                                           rolling_impl="cuda")),
                ("compute_packed(wire)", dec,
                 lambda dev: compute_packed(enc.arrays, "wire", session=sess,
                                            device=dev,
                                            rolling_impl="cuda"))):
            got, want = run("cuda"), run("cpu")
            cctx = DayContext(*inputs, rolling_impl="torch", session=spec)
            kurt = {n: want[names.index(n)].double().numpy()
                    for n in ("shape_kurt", "shape_kurtVol")}
            worst, n_bitwise, edge = compare_blocks(
                f"card-vs-cpu/{sess}/{path}", names, got, want, tables,
                cctx.beta_moments()[:3], noisy=True, kurt=kurt, pdf_ctx=cctx)
            n_edge += edge
            log(f"card vs CPU {sess} {path} {tuple(got.shape)}: agree "
                f"({n_bitwise} bitwise equal; worst value used {worst:.2e} "
                f"of its tolerance; {edge} doc_pdf lanes differ inside the "
                "PDF_EDGE_EPS band)")
        seen = []
        for i, case in enumerate(cases.WIRE_MODE_CASES):
            cb, cm = cases.wire_mode_case(seed * 10 + i, spec.n_slots, *case)
            enc = wire.encode(cb, cm)
            want_modes = cases.expected_wire_modes(spec.n_slots, *case)
            if enc is None or enc.modes != want_modes:
                fail(f"{sess}: crafted batch {case} encoded at "
                     f"{enc and enc.modes}, expected {want_modes}")
            buf, wspec = wire.pack_arrays(enc.arrays)
            got = wire.decode(*wire.unpack(torch.from_numpy(buf).cuda(),
                                           wspec))
            want = wire.decode(*wire.unpack(torch.from_numpy(buf), wspec))
            if not (cases.same_bits(got[0], want[0])
                    and cases.same_bits(got[1], want[1])
                    and np.array_equal(want[1].numpy(), cm)):
                fail(f"{sess}: wire.decode at modes {enc.modes} differs "
                     "card vs CPU")
            seen.append(tuple(enc.modes.values()))
        log(f"wire.decode {sess} at (dclose, ohl, volume) modes {seen}: card "
            "bitwise equal to CPU")
    return n_edge


#: substrings of the ATen ops the profile sums as the sort-based ops
SORT_OPS = ("sort", "topk", "searchsorted", "cumsum", "cummax")


def profile_main_path(label: str, fn, card: str) -> None:
    """One full-width main-path call, ``fn()``, under ``torch.profiler``:
    device time by kernel (and copy) name and by ATen op, the sort-based
    ops' share, and the device's busy share of the call's wall time (the
    profiler's own overhead is in that wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only; CUPTI's own buffer bookkeeping is no work
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not e.name.startswith("Activity Buffer")]
    if not events:
        fail("the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s_, e_ in spans[1:]:  # union of intervals
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    log(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({busy / wall_us:.1%}), idle "
        f"{1 - busy / wall_us:.1%}, {len(events)} device events ({card})")
    # by device kernel/copy name, then by the torch op that launched it
    by_kernel = {}
    for e in events:
        t, n = by_kernel.get(e.name[:96], (0.0, 0))
        by_kernel[e.name[:96]] = (t + e.time_range.elapsed_us(), n + 1)
    by_op = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.key.startswith("aten::") and us > 0:
            by_op[e.key] = (us, e.count)
    for kind, table in (("kernel", by_kernel), ("op", by_op)):
        for key, (us, n) in sorted(table.items(),
                                   key=lambda kv: -kv[1][0])[:12]:
            log(f"profile {label} {kind}: {us / 1e3:8.3f} ms {us / busy:6.1%}"
                f" x{n:<4d} {key}")
    sorts = {k: v for k, v in by_op.items()
             if any(p in k for p in SORT_OPS)}
    for key, (us, n) in sorted(sorts.items(), key=lambda kv: -kv[1][0]):
        log(f"profile {label} sort-based op: {us / 1e3:8.3f} ms "
            f"{us / busy:6.1%} x{n:<4d} {key}")
    total = sum(us for us, _ in sorts.values())
    log(f"profile {label}: sort-based ops ({', '.join(SORT_OPS)}) "
        f"{total / 1e3:.3f} ms, {total / busy:.1%} of device busy time")


#: phase 8: trading days of the timed run, days the resume adds
DRIVER_DAYS, RESUME_DAYS = 40, 8
DAYS_PER_BATCH = 8


def trading_dates(n: int):
    """``n`` weekdays from 2024-01-02."""
    days = np.arange(np.datetime64("2024-01-02"),
                     np.datetime64("2024-01-02") + 3 * n)
    weekday = (days.astype("datetime64[D]").view("int64") - 4) % 7
    return [str(d) for d in days[weekday < 5][:n]]


def write_day_file(path: Path, date: str, n_tickers: int, seed: int,
                   synth: dict) -> None:
    """One int-coded minute-bar parquet: ``synth_day`` from ``seed``."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from replication_of_minute_frequency_factor_tpu_torch.data import (
        synth_day)

    d = synth_day(np.random.default_rng(seed), n_codes=n_tickers, date=date,
                  **synth)
    cols = {"code": pa.array(d["code"].astype(np.int64))}
    for k in ("time", "open", "high", "low", "close", "volume"):
        cols[k] = pa.array(d[k])
    pq.write_table(pa.table(cols), path)


def write_day_files(days, n_tickers: int, **synth) -> float:
    """One int-coded minute-bar parquet per ``(directory, date, seed)`` of
    ``days``, at ``directory/YYYYMMDD.parquet``; written by a pool of
    spawned processes, since synthesis holds the GIL. Returns the seconds
    it took."""
    import concurrent.futures as cf
    import multiprocessing as mp

    for directory in {d for d, _, _ in days}:
        directory.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    workers = max(1, min(len(days), os.cpu_count() or 1, 8))
    with cf.ProcessPoolExecutor(workers,
                                mp_context=mp.get_context("spawn")) as ex:
        list(ex.map(write_day_file,
                    [d / (date.replace("-", "") + ".parquet")
                     for d, date, _ in days], [date for _, date, _ in days],
                    [n_tickers] * len(days), [s for _, _, s in days],
                    [synth] * len(days)))
    return time.perf_counter() - t0


def driver_batches(minute_dir, days_per_batch: int, dates=None):
    """The batches ``compute_exposures`` makes of a directory, rebuilt as
    it builds them: ``(dates, bars, mask, codes, present)`` per batch of
    ``days_per_batch`` day files (only those in ``dates`` when given)."""
    from replication_of_minute_frequency_factor_tpu_torch import pipeline
    from replication_of_minute_frequency_factor_tpu_torch.data import io

    files = [(d, p) for d, p in io.list_day_files(str(minute_dir))
             if dates is None or str(d) in dates]
    for i in range(0, len(files), days_per_batch):
        days = [(d, io.read_minute_day_raw(p))
                for d, p in files[i:i + days_per_batch]]
        bars, mask, codes, present = pipeline._grid_batch(days)
        yield [d for d, _ in days], bars, mask, codes, present


def table_block(table, dates, codes, present, names):
    """The rows of ``table`` for one batch as ``[F, D, Tp]`` f32, zero on
    the lanes ``present`` leaves out; fails unless the batch's rows are
    exactly its present codes in the axis order."""
    block = np.zeros((len(names),) + present.shape, np.float32)
    tdate = table.columns["date"]
    for i, date in enumerate(dates):
        rows = np.flatnonzero(tdate == date)
        want = codes[present[i]]
        if not np.array_equal(table.columns["code"][rows].astype(str),
                              want.astype(str)):
            fail(f"{date}: the table's codes are not the batch's present "
                 "codes in axis order")
        for j, n in enumerate(names):
            block[j, i, present[i]] = table.columns[n][rows]
    return block


def busy_share(events, window):
    """Busy microseconds of the device events' union inside ``window``
    (start, end), and the window's length."""
    lo, hi = window
    spans = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                   for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s_, e_ in spans:
        if e_ <= s_:
            continue
        if cur_e is None or s_ > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, hi - lo


def copy_times(nbytes: int, card: str):
    """One ``nbytes`` buffer copied host->device from pinned and from
    pageable memory, in turns, CUDA events around each; {kind: ms}."""
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    pageable = torch.empty(nbytes, dtype=torch.uint8)
    pageable.fill_(7)
    pinned.fill_(7)
    out = {"pinned": [], "pageable": []}
    for kind in ("pageable", "pinned", "pinned", "pageable"):
        src = pinned if kind == "pinned" else pageable
        out[kind] += cuda_times_ms(lambda: src.to("cuda", non_blocking=True),
                                   iters=5, warmup=1)
    rate = {k: nbytes / np.median(v) / 1e6 for k, v in out.items()}
    log(f"host->device copy of {nbytes} B alone (CUDA events, in turns): "
        f"pinned {spread(out['pinned'])} ({rate['pinned']:.2f} GB/s), "
        f"pageable {spread(out['pageable'])} ({rate['pageable']:.2f} GB/s) "
        f"({card})")
    return out


def check_driver_launches(label: str, launches: dict, impl: dict,
                          n_batches: int) -> None:
    """Fail unless a driver run launched the tiled kernel once a batch and
    resolved ``rolling_impl`` to ``cuda`` each time."""
    if launches != {"tiled": n_batches, "rowwise": 0}:
        fail(f"{label} launched {launches}; expected the tiled kernel once "
             f"per batch ({n_batches})")
    if impl != {("cuda", "cuda"): n_batches}:
        fail(f"{label}: rolling impl resolved as {impl}")


def host_driver(names, tables, card: str) -> dict:
    """Phase 8: ``compute_exposures`` at full width; see the module
    docstring. Returns the run's tiled and rowwise launch counts."""
    import tempfile

    try:
        # the reader's modules, imported before the timed run as a
        # long-lived process holds them; the day files are written elsewhere
        import pyarrow.dataset  # noqa: F401
        import pyarrow.parquet  # noqa: F401
    except ImportError:
        fail("phase 8 writes and reads parquet day files and needs pyarrow")
    from replication_of_minute_frequency_factor_tpu_torch import (
        compute_batch, native, pipeline)
    from replication_of_minute_frequency_factor_tpu_torch.config import (
        Config)
    from replication_of_minute_frequency_factor_tpu_torch.data import wire
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        DayContext)
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling, rolling_cuda)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        Telemetry)

    dates = trading_dates(DRIVER_DAYS + RESUME_DAYS)
    n_batches = -(-DRIVER_DAYS // DAYS_PER_BATCH)
    cfg = Config(days_per_batch=DAYS_PER_BATCH)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_driver_") as tmp:
        tmp = Path(tmp)
        minute_dir, staged = tmp / "kline", tmp / "staged"
        days = ([(minute_dir, d, 8000 + i)
                 for i, d in enumerate(dates[:DRIVER_DAYS])]
                + [(staged, d, 9000 + i)
                   for i, d in enumerate(dates[DRIVER_DAYS:])])
        secs = write_day_files(days, TICKERS, missing_prob=0.02,
                               zero_volume_prob=0.01,
                               constant_price_codes=10, short_day_codes=10)
        log(f"phase 8 input: {TICKERS} tickers x {DRIVER_DAYS} + "
            f"{RESUME_DAYS} days of int-coded parquet ({dates[0]} to "
            f"{dates[-1]}) written in {secs:.2f} s (host, process pool)")

        # the timed run: every count at 0 just before, read just after
        tel = Telemetry()
        cache = str(tmp / "exposures.parquet")
        torch.cuda.synchronize()
        rolling_cuda.reset_launches()
        rolling.IMPL_COUNTS.clear()
        native.reset_counts()
        t0 = time.perf_counter()
        table = pipeline.compute_exposures(str(minute_dir), cache_path=cache,
                                           cfg=cfg, progress=False,
                                           telemetry=tel)
        wall = time.perf_counter() - t0
        launches = dict(rolling_cuda.launches)
        impl = dict(rolling.IMPL_COUNTS)
        native_counts = dict(native.IMPL_COUNTS)
        grid_res, wire_res = (native.resolved_counts(op)
                              for op in ("grid", "wire"))
        reg = tel.registry
        log(f"compute_exposures {TICKERS} tickers x {DRIVER_DAYS} days "
            f"({n_batches} batches of {DAYS_PER_BATCH}), 58 factors: wall "
            f"{wall:.3f} s, {DRIVER_DAYS / wall:.2f} days/s, "
            f"{wall / n_batches * 1e3:.1f} ms a batch; {len(table)} rows; "
            f"second_moments launches {launches}; rolling impl {impl}; "
            f"native (op, requested, resolved): {native_counts}; encode kinds "
            f"wire={reg.counter_value('pipeline.encode_kind', kind='wire'):g}"
            f" raw={reg.counter_value('pipeline.encode_kind', kind='raw'):g}"
            f" ({card})")
        check_driver_launches("compute_exposures", launches, impl,
                              n_batches)
        if wire_res != {"native": n_batches} \
                or grid_res != {"native": DRIVER_DAYS}:
            fail(f"the native encoder did not take every batch: grid "
                 f"{grid_res}, wire {wire_res}")
        if reg.counter_value("pipeline.encode_kind", kind="wire") \
                != n_batches or table.failures:
            fail("not every batch shipped through the wire, or a day "
                 f"failed: {table.failures.summary()}")
        stages = ("io", "grid", "wire_encode", "pack", "launch", "device",
                  "save")
        log("compute_exposures stages (s, summed over both threads): "
            + ", ".join(f"{k} {table.timings.get(k, 0.0):.3f}"
                        for k in stages)
            + f"; reconciliation {json.dumps(table.reconciliation)}")
        h2d = reg.histogram_stats("pipeline.h2d_ms")
        n_bytes = reg.counter_value("pipeline.h2d_bytes")
        depth = reg.histogram_stats("pipeline.queue_depth")
        log(f"pinned host->device copies on the copy stream: {h2d['count']}"
            f" of {n_bytes / h2d['count']:.0f} B on average, "
            f"{h2d['min']:.4f} / {h2d['p50']:.4f} / {h2d['max']:.4f} ms "
            f"(min / p50 / max; the pageable copy of 68,560,004 B took "
            f"10.846 ms in the 8-day packed path); producer queue depth "
            f"p50 {depth['p50']:g}, p95 {depth['p95']:g}, n={depth['count']}"
            f" ({card})")
        copy_times(int(n_bytes / h2d["count"]), card)

        # every row bit for bit compute_batch on its batch's decoded bars
        order = np.lexsort((table.columns["code"], table.columns["date"]))
        if not (order == np.arange(len(table))).all():
            fail("the table is not sorted by (date, code)")
        n_rows = 0
        for b, (bdates, bars, mask, codes, present) in enumerate(
                driver_batches(minute_dir, DAYS_PER_BATCH)):
            t0 = time.perf_counter()
            enc = wire.encode(bars, mask, use_native=True)
            t_native = time.perf_counter() - t0
            buf, spec = wire.pack_arrays(enc.arrays)
            if b == 0:
                t0 = time.perf_counter()
                ref_enc = wire.encode(bars, mask, use_native=False)
                t_numpy = time.perf_counter() - t0
                same = all(np.asarray(x).dtype == np.asarray(y).dtype
                           and np.asarray(x).tobytes()
                           == np.asarray(y).tobytes()
                           for x, y in zip(enc.arrays, ref_enc.arrays))
                if not same or enc.modes != ref_enc.modes:
                    fail("the native wire encoding differs from numpy's")
                log(f"wire.encode {bars.shape[:-1]}: native {t_native:.4f}"
                    f" s, numpy {t_numpy:.4f} s, byte-identical (modes "
                    f"{enc.modes}) (host)")
            dec = wire.decode(*wire.unpack(torch.from_numpy(buf).cuda(),
                                           spec))
            out = compute_batch(*dec, device="cuda", rolling_impl="cuda")
            ref = out.cpu().numpy()
            block = table_block(table, bdates, codes, present, names)
            sel = np.broadcast_to(present, ref.shape)
            if not np.array_equal(block[sel].view(np.int32),
                                  ref[sel].view(np.int32)):
                fail(f"batch {b} ({bdates[0]}..): table rows differ from "
                     "compute_batch on the decoded bars")
            # the tiled kernel at the driver's shape, pad lanes included,
            # against the plain version on the same decoded bars
            plain = compute_batch(*dec, device="cuda", rolling_impl="torch")
            beta = DayContext(*dec, rolling_impl="torch").beta_moments()[:3]
            worst, n_bitwise, _ = compare_blocks(
                f"driver batch {b} cuda-vs-torch", names, out, plain, tables,
                beta)
            log(f"driver batch {b} {tuple(out.shape)}: rolling_impl=cuda "
                f"against rolling_impl=torch on every lane, pads included: "
                f"NaN/inf positions identical, {n_bitwise} factors bitwise "
                f"equal, worst value used {worst:.2e} of its tolerance")
            del out, plain, beta, dec
            n_rows += int(present.sum())
        if n_rows != len(table):
            fail(f"{n_rows} present lanes against {len(table)} table rows")
        log(f"all {len(table)} rows x {len(names)} factors bitwise equal to "
            "compute_batch on each batch's decoded bars; codes and dates "
            "sorted by (date, code)")

        # resume: 8 more days; only they pass fault_hook
        for f in sorted(staged.iterdir()):
            os.replace(f, minute_dir / f.name)
        seen = []
        rolling_cuda.reset_launches()
        t0 = time.perf_counter()
        resumed = pipeline.compute_exposures(
            str(minute_dir), cache_path=cache, cfg=cfg, progress=False,
            fault_hook=seen.append)
        wall_r = time.perf_counter() - t0
        if [str(d) for d in seen] != dates[DRIVER_DAYS:]:
            fail(f"the resume read {seen}, expected only the new days")
        old = resumed.columns["date"] <= np.datetime64(dates[DRIVER_DAYS - 1])
        if int(old.sum()) != len(table) or not all(
                np.array_equal(np.asarray(resumed.columns[k])[old],
                               np.asarray(table.columns[k]))
                for k in ("code", "date")) or not all(
                np.array_equal(resumed.columns[n][old].view(np.int32),
                               table.columns[n].view(np.int32))
                for n in names):
            fail("the resume changed the cached rows")
        log(f"resume: {len(seen)} new days computed in {wall_r:.3f} s "
            f"({dict(rolling_cuda.launches)} launches), {len(table)} "
            "cached rows unchanged bit for bit; "
            f"{len(resumed) - len(table)} new rows")

        # retry: one injected launch failure, the whole run profiled
        real = pipeline.compute_packed_prepared
        calls = [0]

        def flaky(*a, **kw):
            calls[0] += 1
            if calls[0] == 1:
                raise RuntimeError("injected launch failure")
            return real(*a, **kw)

        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        tel_r = Telemetry()
        pipeline.compute_packed_prepared = flaky
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                again = pipeline.compute_exposures(
                    str(minute_dir), cache_path=str(tmp / "retry.parquet"),
                    cfg=cfg, progress=False, telemetry=tel_r)
                torch.cuda.synchronize()
                wall_p = time.perf_counter() - t0
        finally:
            pipeline.compute_packed_prepared = real
        retries = tel_r.registry.counter_total("pipeline.retries")
        if again.failures or retries != 1 or len(again) != len(resumed) \
                or not all(np.array_equal(again.columns[n].view(np.int32),
                                          resumed.columns[n].view(np.int32))
                           for n in names):
            fail(f"the injected failure cost rows or bits: retries "
                 f"{retries}, failures {again.failures.summary()}")
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("Activity Buffer")]
        pinned = sorted((e.time_range.start, e.time_range.elapsed_us())
                        for e in events
                        if "HtoD" in e.name and "Pinned" in e.name)
        copies = [start for start, _ in pinned]
        if not events or len(copies) < 2:
            fail(f"the profile shows {len(events)} device events and "
                 f"{len(copies)} pinned host->device copies")
        end = max(e.time_range.end for e in events)
        busy, span = busy_share(events, (copies[1], end))
        busy_all, span_all = busy_share(
            events, (min(e.time_range.start for e in events), end))
        log(f"retry run under torch.profiler, all {len(dates)} days from "
            f"an empty cache: 1 injected launch failure, retries "
            f"{retries:g}, 0 days lost, rows bitwise the resumed cache's; "
            f"wall {wall_p:.3f} s profiled; device busy "
            f"{busy / 1e3:.1f} of {span / 1e3:.1f} ms from the second "
            f"batch's copy on: idle share {1 - busy / span:.1%} (whole run "
            f"{1 - busy_all / span_all:.1%}); {len(copies)} pinned copies of "
            f"{n_bytes / h2d['count']:.0f} B each, in ms (profiled): "
            + ", ".join(f"{us / 1e3:.4f}" for _, us in pinned)
            + f" ({card})")

        # 9b. the user's path on these files and this cache
        user_path(tmp, minute_dir, cache, table, dates, card)

        # 13b. the CLI's compute --profile-dir on some of these files
        profiled_driver(tmp, minute_dir, names, card)

        # 14c. the CLI's compute --mesh-tickers 2 on some of these files
        mesh_driver(tmp, minute_dir, table, names, card)
    return launches


#: phase 9a: a year of an A-share universe
EVAL_CODES, EVAL_DATES = 5000, 244
#: per-date IC: tests/test_torch_masked.py's corr tolerance; the summary
#: statistics and the CLI's (printed to 6 decimals)
IC_RTOL, IC_ATOL = 2e-5, 4 * float(np.finfo(np.float32).eps)
STAT_RTOL, STAT_ATOL = 1e-4, 1e-6
#: the factor phase 9b computes through MinFreqFactor: an mmt_ols_* one,
#: so the path runs the tiled kernel
USER_FACTOR = "mmt_ols_qrs"


def hold_ic(label, got, want, rtol=IC_RTOL, atol=IC_ATOL) -> float:
    """NaN positions identical and finite values within rtol/atol; returns
    the largest |diff|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.array_equal(np.isnan(got),
                                                     np.isnan(want)):
        fail(f"{label}: shapes {got.shape}/{want.shape} or NaN positions "
             "differ between the card and the CPU")
    ok = ~np.isnan(want)
    diff = np.abs(got[ok] - want[ok])
    if (diff > atol + rtol * np.abs(want[ok])).any():
        fail(f"{label}: the card is out of tolerance of the CPU (max |diff| "
             f"{diff.max():.3e})")
    return float(diff.max()) if diff.size else 0.0


def eval_ops_full_width(tables, card: str, dev: str = "cuda") -> None:
    """Phase 9a: the evaluation ops on a year of 5000 codes, ``dev``
    against the CPU; see the module docstring."""
    from replication_of_minute_frequency_factor_tpu_torch import (
        eval_ops, frames)

    t0 = time.perf_counter()
    codes = np.array([f"{600000 + i:06d}" for i in range(EVAL_CODES)])
    dates = cases.weekdays(EVAL_DATES)
    exp = cases.eval_exposure(91, codes, dates)
    pv = cases.eval_pv(92, codes, dates)
    log(f"phase 9a input: exposure of {len(exp['code'])} rows and PV of "
        f"{len(pv['code'])} rows over {EVAL_CODES} codes x {EVAL_DATES} "
        f"days, made in {time.perf_counter() - t0:.2f} s (host)")
    # the host half of ic_test: the exposure pivot, the forward returns,
    # their pivot onto the exposure's axes
    host = {}
    t0 = time.perf_counter()
    mat, present, d_axis, c_axis = frames.long_to_matrix(
        exp["code"], exp["date"], exp["value"])
    host["exposure pivot"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fwd = frames.forward_returns(pv["code"], pv["date"], pv["pct_change"], 5)
    host["forward returns"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fwd_mat, fwd_present, _, _ = frames.long_to_matrix(
        pv["code"], pv["date"], fwd, codes=c_axis, dates=d_axis)
    host["forward pivot"] = time.perf_counter() - t0
    valid = present & np.isfinite(mat)
    both = valid & fwd_present & np.isfinite(fwd_mat)
    cpu = {k: torch.from_numpy(a) for k, a in (
        ("x", np.nan_to_num(mat)), ("y", np.nan_to_num(fwd_mat)),
        ("valid", valid), ("both", both))}
    t0 = time.perf_counter()
    on = {k: v.to(dev) for k, v in cpu.items()}
    torch.cuda.synchronize()
    host["copy to the device"] = time.perf_counter() - t0
    log(f"phase 9a host (s): " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in host.items())
        + f"; [{mat.shape[0]}, {mat.shape[1]}] f32, {int(valid.sum())} valid"
        f" lanes, {int(both.sum())} with a 5-day forward return")

    ops = {
        "ic_series": lambda t: eval_ops.ic_series(t["x"], t["y"], t["both"]),
        "_qcut_labels g=5": lambda t: eval_ops._qcut_labels(
            t["x"], t["valid"], 5),
        "_qcut_labels g=10": lambda t: eval_ops._qcut_labels(
            t["x"], t["valid"], 10),
        "coverage_counts": lambda t: eval_ops.coverage_counts(t["valid"]),
        "decile_spread g=10": lambda t: eval_ops.decile_spread(
            t["x"], t["y"], t["both"], 10),
    }
    for name, fn in ops.items():
        got = fn(on)
        t0 = time.perf_counter()
        want = fn(cpu)
        cpu_s = time.perf_counter() - t0
        if name == "ic_series":
            err = max(hold_ic(f"9a {name}[{i}]", g.cpu().numpy(),
                              w.numpy()) for i, (g, w) in
                      enumerate(zip(got, want)))
            verdict = f"within rtol {IC_RTOL}, atol {IC_ATOL:.2e}; max " \
                      f"|diff| {err:.3e}"
        elif name.startswith("decile"):
            err = hold_ic(f"9a {name}", got.cpu().numpy(), want.numpy(),
                          tables["RTOL"]["default"],
                          tables["ATOL"]["default"])
            verdict = f"within test_parity's default tolerance; max |diff| " \
                      f"{err:.3e}"
        else:
            if not cases.same_bits(got, want) or got.dtype != torch.int32:
                fail(f"9a {name}: the card's {got.dtype} result is not "
                     "bitwise the CPU's")
            verdict = "bitwise equal, int32"
        ms = cuda_times_ms(lambda: fn(on), iters=10, warmup=3)
        log(f"phase 9a {name} [{EVAL_DATES}, {EVAL_CODES}]: card vs CPU "
            f"{verdict}; card {spread(ms)}; CPU {cpu_s * 1e3:.1f} ms (one "
            f"call, host clock) ({card})")
    del on


def run_cli(argv):
    """The port's CLI in this process: (exit code, last stdout line as
    JSON, seconds)."""
    import contextlib
    import io

    from replication_of_minute_frequency_factor_tpu_torch.__main__ import (
        main as cli)

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), secs


def timed(fn):
    """(fn(), seconds), the device synchronised before the clock stops."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def user_path(tmp: Path, minute_dir: Path, cache: str, table, dates,
              card: str, dev: str = "cuda") -> None:
    """Phase 9b: the evaluation a user runs on phase 8's files and cache,
    on ``dev`` and on the CPU; see the module docstring."""
    from replication_of_minute_frequency_factor_tpu_torch import Config
    from replication_of_minute_frequency_factor_tpu_torch.minfreq import (
        MinFreqFactor)
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        factor_names)
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling, rolling_cuda)

    # phase 8's first 40 day files (its directory holds the resume's too)
    kline = tmp / "kline40"
    kline.mkdir()
    for date in dates[:DRIVER_DAYS]:
        name = date.replace("-", "") + ".parquet"
        os.symlink(minute_dir / name, kline / name)
    codes = np.unique(table.columns["code"].astype(str))
    pv_path = str(tmp / "daily_pv.parquet")
    t0 = time.perf_counter()
    cases.write_pv(cases.eval_pv(93, codes, np.array(dates,
                                                     "datetime64[D]")),
                   pv_path)
    log(f"phase 9b input: daily PV for {len(codes)} codes x {len(dates)} "
        f"dates written in {time.perf_counter() - t0:.2f} s (host)")

    torch.cuda.synchronize()
    rolling_cuda.reset_launches()
    rolling.IMPL_COUNTS.clear()
    f, secs = timed(lambda: MinFreqFactor(USER_FACTOR, device=dev)
                    .cal_exposure_by_min_data(
                        minute_dir=str(kline), path=str(tmp / "factors"),
                        cfg=Config(days_per_batch=DAYS_PER_BATCH),
                        progress=False))
    launches, impl = dict(rolling_cuda.launches), dict(rolling.IMPL_COUNTS)
    n_batches = -(-DRIVER_DAYS // DAYS_PER_BATCH)
    check_driver_launches("MinFreqFactor.cal_exposure_by_min_data",
                          launches, impl, n_batches)
    exp = f.factor_exposure
    if not (np.array_equal(exp["code"].astype(str),
                           table.columns["code"].astype(str))
            and np.array_equal(exp["date"], table.columns["date"])
            and np.array_equal(exp[USER_FACTOR].view(np.int32),
                               table.columns[USER_FACTOR].view(np.int32))):
        fail(f"MinFreqFactor({USER_FACTOR!r}): the column differs from "
             "phase 8's")
    log(f"phase 9b MinFreqFactor({USER_FACTOR!r}).cal_exposure_by_min_data "
        f"over {DRIVER_DAYS} day files: wall {secs:.3f} s, launches "
        f"{launches}, rolling impl {impl}; {len(exp['code'])} rows bitwise "
        f"phase 8's column ({card})")
    weekly, secs = timed(lambda: f.cal_final_exposure("week", method="z"))
    log(f"phase 9b cal_final_exposure(week, z): "
        f"{len(weekly.factor_exposure['code'])} rows in {secs:.3f} s (host)")

    def on_cpu(fac):
        return MinFreqFactor(fac.factor_name, device="cpu").set_exposure(
            *(fac.factor_exposure[k] for k in ("code", "date",
                                               fac.factor_name)))

    for fac in (f, weekly):
        twin = on_cpu(fac)
        (got, want), walls = zip(*(timed(lambda g=g: g.coverage(
            plot=False, return_df=True)) for g in (fac, twin)))
        if not np.array_equal(got["coverage"], want["coverage"]):
            fail(f"9b {fac.factor_name} coverage differs card vs CPU")
        (got, want), walls_ic = zip(*(timed(lambda g=g: g.ic_test(
            future_days=5, plot=False, return_df=True,
            daily_pv_path=pv_path)) for g in (fac, twin)))
        if not np.array_equal(got["date"], want["date"]) or not len(
                got["date"]):
            fail(f"9b {fac.factor_name} ic_test: kept dates differ or none")
        err = max(hold_ic(f"9b {fac.factor_name} {k}", got[k], want[k])
                  for k in ("IC", "rank_IC"))
        for k in ("IC", "ICIR", "rank_IC", "rank_ICIR"):
            hold_ic(f"9b {fac.factor_name} {k}", getattr(fac, k),
                    getattr(twin, k), STAT_RTOL, STAT_ATOL)
        log(f"phase 9b {fac.factor_name}: coverage bitwise card vs CPU "
            f"(wall {walls[0]:.3f} / {walls[1]:.3f} s); ic_test "
            f"{len(got['date'])} dates, IC {fac.IC:.6f} ICIR {fac.ICIR:.6f} "
            f"rank_IC {fac.rank_IC:.6f} rank_ICIR {fac.rank_ICIR:.6f}, "
            f"within tolerance of the CPU (per-date max |diff| {err:.3e}); "
            f"wall card {walls_ic[0]:.3f} s, CPU {walls_ic[1]:.3f} s "
            f"({card})")
    kw = dict(frequency="week", weight_param="tmc", group_num=5, plot=False,
              return_df=True, daily_pv_path=pv_path)
    (got, want), walls = zip(*(timed(lambda g=g: g.group_test(**kw))
                               for g in (f, on_cpu(f))))
    for k in ("period", "group_return", "cum_return"):
        if not np.array_equal(got[k], want[k], equal_nan=k != "period"):
            fail(f"9b group_test {k} differs card vs CPU")
    if not np.isfinite(got["group_return"]).any():
        fail("9b group_test: no finite group return")
    log(f"phase 9b group_test(week, 5 groups, tmc): {len(got['period'])} "
        f"periods, group returns and cumulative returns bitwise card vs "
        f"CPU; top-minus-bottom cumulative "
        f"{got['cum_return'][-1, -1] - got['cum_return'][-1, 0]:+.6f}; wall "
        f"card {walls[0]:.3f} s, CPU {walls[1]:.3f} s ({card})")

    # the CLI's evaluate on phase 8's cache, one factor of each family
    first = {}
    for name in factor_names():
        first.setdefault(name.split("_", 1)[0], name)
    card_args = [] if dev == "cuda" else ["--device", dev]
    for name in first.values():
        argv = ["evaluate", "--factor", name, "--cache", cache,
                "--daily-pv", pv_path, "--frequency", "week"]
        (rc, got, secs), (rc_c, want, secs_c) = (
            run_cli(argv + card_args), run_cli(argv + ["--device", "cpu"]))
        if rc or rc_c or got is None or want is None \
                or got.keys() != want.keys():
            fail(f"9b evaluate {name}: rc {rc}/{rc_c}, {got} vs {want}")
        for k in ("IC", "ICIR", "rank_IC", "rank_ICIR"):
            if got[k] is None or want[k] is None:
                fail(f"9b evaluate {name}: {k} is null")
            hold_ic(f"9b evaluate {name} {k}", got[k], want[k], STAT_RTOL,
                    2 * STAT_ATOL)
        log(f"phase 9b CLI evaluate --factor {name}: {json.dumps(got)}; "
            f"within tolerance of --device cpu; wall card {secs:.3f} s, CPU "
            f"{secs_c:.3f} s ({card})")


#: phase 10: the streaming day's micro-batch, the exact snapshots' minutes
#: (the micro-batches are cut there, so the load also runs 12- and 8-minute
#: ones: 60 = 3 x 16 + 12, 120 - 60 likewise, 240 - 120 = 7 x 16 + 8), the
#: minutes of the timed snapshots, the stream wire's spill floor (the
#: default 4 rows overflow on this day: 10 one-day slices widen at minute
#: 60 in a CPU check)
STREAM_MICRO = 16
STREAM_SNAPSHOTS = (60, 120, 240)
#: stat_fold factors whose STAT_FOLD_BOUNDS pin the JAX package's own fast
#: formula misses on this day: vol_range1min on synth_day's tight
#: high/low spreads (the std of high/low sits near f32's resolution at
#: 1.0; tests/test_torch_fastpath.py::test_range_pin_misses_on_tight_
#: spreads_as_the_jax_formula_does), and the two skew/kurtosis ratios on
#: any ticker whose excess kurtosis is about 0, which 5000 tickers hold
#: (test_skratio_pin_misses_where_the_kurtosis_crosses_zero_as_jax_does).
#: They are held to the formula itself, evaluated on the CPU from the
#: card's carry, instead of to the pin
FAST_PIN_REFERENCE_MISSES = ("vol_range1min", "shape_skratio",
                             "shape_skratioVol")
#: the card's fast values against that CPU evaluation (sqrt and pow may
#: round differently on the two devices)
FAST_FORMULA_RTOL = 1e-6
STREAM_TIMED = (60, 240)
STREAM_SPILL_ROWS = 16


def carry_leaves_equal(a: dict, b: dict) -> list:
    """The keys of two saved carries whose arrays differ (NaN equal to
    NaN)."""
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or a[k].dtype != b[k].dtype
                  or not np.array_equal(a[k], b[k],
                                        equal_nan=a[k].dtype.kind == "f"))


def hold_wire_and_stats(label, names, raw, payload, stats, spec,
                        days: int) -> dict:
    """The payload decodes within RESULT_BOUNDS of the raw block with exact
    NaN status (no slice past the spill budget), and the stats' counts,
    min and max are bitwise ``factor_stats_host`` of the fetched raw
    block. Returns the decode's verdict."""
    from replication_of_minute_frequency_factor_tpu_torch.data import (
        result_wire as rw)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        Telemetry, factorplane)

    raw = raw.cpu().numpy().reshape(len(names), days, -1)
    dec, verdict = rw.decode_block(payload.cpu().numpy(), len(names), days,
                                   raw.shape[-1], spec.spill_rows,
                                   strict=False, telemetry=Telemetry())
    if verdict["overflow"]:
        fail(f"{label}: {verdict['overflow']} widened slices overflow the "
             f"{spec.spill_rows}-row spill budget")
    if not np.array_equal(np.isnan(dec), np.isnan(raw)):
        fail(f"{label}: the decode's NaN status differs from the raw block")
    chk = rw.check_bounds(raw, dec, names, sidx=verdict["sidx"])
    if not chk["ok"]:
        fail(f"{label}: the decode misses RESULT_BOUNDS for "
             f"{chk['bad_factors']}")
    host = factorplane.factor_stats_host(raw)
    got = stats.cpu().numpy()
    for col, field in ((0, "lanes"), (1, "finite"), (2, "nan"),
                       (3, "posinf"), (4, "neginf"), (7, "min"), (8, "max")):
        if not np.array_equal(got[:, col], host[:, col], equal_nan=True):
            fail(f"{label}: stats {field} differ from factor_stats_host")
    with np.errstate(invalid="ignore"):
        rel = np.nanmax(np.abs(got[:, 5:7] - host[:, 5:7])
                        / np.maximum(np.abs(host[:, 5:7]), 1e-30))
    verdict["stats_moment_rel"] = float(rel)
    verdict["max_rel_err"] = chk["max_rel_err"]
    return verdict


def streaming_path(bars, mask, tables, card: str) -> dict:
    """Phase 10: the intraday streaming engine at full width on phase 4's
    first day, and the packed path's side outputs on phase 4's batch; see
    the module docstring. Returns the kernels line's entry for the
    snapshot path's tiled kernel."""
    from replication_of_minute_frequency_factor_tpu_torch import (
        StreamEngine, compute_batch, pipeline)
    from replication_of_minute_frequency_factor_tpu_torch.data import (
        result_wire as rw)
    from replication_of_minute_frequency_factor_tpu_torch.data import wire
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        DayContext, factor_names)
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling, rolling_cuda)
    from replication_of_minute_frequency_factor_tpu_torch.stream import (
        carry as sc)
    from replication_of_minute_frequency_factor_tpu_torch.stream import (
        fastpath)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        Telemetry)

    names = factor_names()
    day_bars, day_mask = bars[0], mask[0]
    n, s = day_mask.shape
    log(f"phase 10 input: phase 4's first day, {n} tickers x {s} slots, "
        f"{int(day_mask.sum())} bars; all {len(names)} factors, "
        f"micro-batches of {STREAM_MICRO} minutes")

    def prefix(t_stop):
        return cases.prefix_day(day_bars, day_mask, t_stop)

    def micro(lo, hi):
        return cases.minutes_of(day_bars, day_mask, lo, hi)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tel = Telemetry()
    engines = {}
    for label, kw in (("exact", {}),
                      ("fast", {"finalize_impl": "fast"}),
                      ("torch", {"rolling_impl": "torch"})):
        kw.setdefault("rolling_impl", "cuda")
        eng = StreamEngine(n, names=names, telemetry=tel, device="cuda",
                           **kw)
        eng.result_spec = rw.ResultWireSpec.for_names(
            names, spill_rows=STREAM_SPILL_ROWS, days=1)
        eng.warmup(micro_batches=(STREAM_MICRO, 12, 8), cohorts=(n,))
        engines[label] = eng
    exact, fast, plain = engines["exact"], engines["fast"], engines["torch"]
    if fast.finalize_impl_resolved != "fast":
        fail("phase 10: the fast engine resolved "
             f"{fast.finalize_impl_resolved!r}")
    reg = tel.registry
    built = reg.counter_value("serve.executables", outcome="miss")
    log(f"phase 10 warmup: {int(built)} callables built for 3 engines "
        f"(exact, fast, torch); kernel library loaded")

    update_ms, update_wall = [], []
    snap_ms = {"exact": {}, "fast": {}}
    stream_launches = {"tiled": 0, "rowwise": 0}
    saved_120 = None
    snaps = {}
    lo = 0
    for stop in STREAM_SNAPSHOTS:
        while lo < stop:
            hi = min(lo + STREAM_MICRO, stop)
            b, p = micro(lo, hi)
            for label, eng in engines.items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                eng.ingest_minutes(b, p)
                end.record()
                torch.cuda.synchronize()
                if label == "exact" and hi - lo == STREAM_MICRO:
                    update_wall.append((time.perf_counter() - t0) * 1e3)
                    update_ms.append(start.elapsed_time(end))
            lo = hi
        # the exact snapshot: one tiled launch, resolved cuda
        torch.cuda.synchronize()
        rolling_cuda.reset_launches()
        rolling.IMPL_COUNTS.clear()
        exp, ready = exact.snapshot()
        torch.cuda.synchronize()
        launches, impl = dict(rolling_cuda.launches), dict(rolling.IMPL_COUNTS)
        if launches != {"tiled": 1, "rowwise": 0}:
            fail(f"phase 10 exact snapshot at minute {stop} launched "
                 f"{launches}; expected the tiled kernel once")
        if impl != {("cuda", "cuda"): 1}:
            fail(f"phase 10 snapshot at minute {stop}: rolling impl {impl}")
        stream_launches["tiled"] += launches["tiled"]
        pb, pm = prefix(stop)
        want = compute_batch(pb, pm, device="cuda", rolling_impl="cuda")
        if not cases.same_bits(exp, want):
            fail(f"phase 10 exact snapshot at minute {stop} differs from "
                 "compute_batch on the card for the same prefix")
        snaps[stop] = (exp, ready)
        # the fast snapshot: the foldable factors from the carry's
        # statistics, the batch_only residual (mmt_ols_* among it) over
        # the prefix: one tiled launch
        rolling_cuda.reset_launches()
        f_exp, f_ready = fast.snapshot()
        torch.cuda.synchronize()
        stream_launches["tiled"] += rolling_cuda.launches["tiled"]
        if dict(rolling_cuda.launches) != {"tiled": 1, "rowwise": 0}:
            fail(f"phase 10 fast snapshot at minute {stop} launched "
                 f"{dict(rolling_cuda.launches)}")
        if not torch.equal(f_ready, ready):
            fail(f"phase 10 fast snapshot at minute {stop}: readiness "
                 "differs from the exact engine's")
        e_host, f_host = exp.cpu().numpy(), f_exp.cpu().numpy()
        reports = [fastpath.parity_report(nm, e_host[j], f_host[j])
                   for j, nm in enumerate(names)]
        bad = [r["name"] for r in reports if not r["ok"]
               and r["name"] not in FAST_PIN_REFERENCE_MISSES]
        if bad:
            fail(f"phase 10 fast finalize at minute {stop}: {bad} miss "
                 "their pins against the exact engine")
        # the formula on the CPU over the card's own carry leaves
        fold = fast.fold_names
        cpu_fast = fastpath.stream_finalize_fast(
            {k: v.cpu() for k, v in fast.carry["inc"].items()},
            fold).numpy()
        on_card = f_host[[names.index(nm) for nm in fold]]
        if not (np.array_equal(np.isnan(on_card), np.isnan(cpu_fast))
                and np.allclose(on_card, cpu_fast, rtol=FAST_FORMULA_RTOL,
                                atol=0, equal_nan=True)):
            fail(f"phase 10 fast finalize at minute {stop}: the card's "
                 "values differ from the formula evaluated on the CPU")
        n_formula_bitwise = sum(
            np.array_equal(on_card[i], cpu_fast[i], equal_nan=True)
            for i in range(len(fold)))
        missed = {r["name"]: r["max_excess"] for r in reports
                  if not r["ok"]}
        log(f"phase 10 minute {stop}: exact snapshot {tuple(exp.shape)} "
            f"bitwise compute_batch on the card for the prefix; one tiled "
            f"launch each for the exact and the fast snapshot; fast finalize"
            f": {sum(r['ok'] for r in reports)}/{len(names)} factors within "
            f"their pins (exact_fold and batch_only bitwise); outside, as "
            f"the JAX formula is on this data: {missed}; the {len(fold)} "
            f"foldable factors within rtol {FAST_FORMULA_RTOL} of the formula"
            f" on the CPU over the card's carry ({n_formula_bitwise} "
            "bitwise)")
        if stop in STREAM_TIMED:
            for label, eng in (("exact", exact), ("fast", fast)):
                snap_ms[label][stop] = cuda_times_ms(
                    lambda: eng.snapshot(), iters=10, warmup=2)
            # the kernel through the plain version: the torch engine
            t_exp = plain.snapshot()[0]
            ctx = DayContext(torch.from_numpy(pb).cuda(),
                             torch.from_numpy(pm).cuda(),
                             rolling_impl="torch")
            kurt = {k: t_exp[names.index(k)].double().cpu().numpy()
                    for k in ("shape_kurt", "shape_kurtVol")}
            worst_used, n_bitwise, _ = compare_blocks(
                f"phase 10 cuda-vs-torch minute {stop}", names, exp, t_exp,
                tables, ctx.beta_moments()[:3], kurt=kurt)
            log(f"phase 10 minute {stop}: the snapshot through the kernel "
                f"agrees with the rolling_impl='torch' engine ({n_bitwise} "
                f"factors bitwise; worst value used {worst_used:.2e} of its "
                f"tolerance)")
        if stop == 120:
            saved_120 = exact.save()
    # the side outputs on the last snapshot
    rolling_cuda.reset_launches()
    exp, ready = snaps[240]
    e2, r2, stats = exact.snapshot_stats()
    payload, r3, stats_w = exact.snapshot_wire_stats()
    torch.cuda.synchronize()
    stream_launches["tiled"] += rolling_cuda.launches["tiled"]
    if not (cases.same_bits(e2, exp) and torch.equal(r2, ready)
            and torch.equal(r3, ready)):
        fail("phase 10: the exposures or readiness change with the side "
             "outputs")
    v = hold_wire_and_stats("phase 10 snapshot_wire_stats", names, exp,
                            payload, stats_w, exact.result_spec, 1)
    hold_wire_and_stats("phase 10 snapshot_stats", names, exp, payload,
                        stats, exact.result_spec, 1)
    log(f"phase 10 snapshot_wire_stats at minute 240: payload "
        f"{payload.numel()} B ({v['quantized']} slices quantized, "
        f"{v['widened']} widened into {exact.result_spec.spill_rows} spill "
        f"rows, ratio {v['ratio']}); decode within RESULT_BOUNDS (max "
        f"rel err {v['max_rel_err']:.2e}), NaN status exact; stats counts/"
        f"min/max bitwise factor_stats_host (mean/std rel "
        f"{v['stats_moment_rel']:.2e}); exposures bitwise with and without "
        "the side outputs")
    misses = reg.counter_value("serve.executables", outcome="miss") - built
    log(f"phase 10 load: serve.executables misses after warmup {int(misses)}"
        f"; hits {int(reg.counter_value('serve.executables', outcome='hit'))}")
    if misses:
        fail(f"phase 10: {int(misses)} callables built during load")

    # the cohort path: every minute as one 5000-row cohort plus advance
    cohort = StreamEngine(n, names=names, telemetry=tel, device="cuda",
                          rolling_impl="cuda", executables=exact.executables)
    cohort.warmup(cohorts=(n,), snapshot=False)
    cohort_ms = []
    idx_all = np.arange(n, dtype=np.int32)
    for t in range(s):
        idx = np.where(day_mask[:, t], idx_all, n).astype(np.int32)
        rows = np.ascontiguousarray(day_bars[:, t])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cohort.ingest_cohort(rows, idx)
        cohort.advance()
        end.record()
        torch.cuda.synchronize()
        cohort_ms.append(start.elapsed_time(end))
    full = exact.save()
    differ = carry_leaves_equal(full, cohort.save())
    if differ:
        fail(f"phase 10: the cohort path's carry differs from the scan "
             f"path's at {differ}")
    log(f"phase 10 cohort path: {s} cohorts of {n} rows + advance; every "
        f"carry leaf ({len(full)}) bitwise the scan path's")

    # restart: save at 120, restore into a fresh engine, finish the day
    restored = StreamEngine(n, names=names, telemetry=tel, device="cuda",
                            rolling_impl="cuda",
                            executables=exact.executables)
    restored.restore(saved_120)
    for lo in range(120, s, STREAM_MICRO):
        restored.ingest_minutes(*micro(lo, min(lo + STREAM_MICRO, s)))
    if carry_leaves_equal(full, restored.save()) or not cases.same_bits(
            restored.snapshot()[0], exp):
        fail("phase 10: the day restored at minute 120 finished differently")
    log("phase 10 restart: saved at minute 120, restored into a fresh "
        "engine, the finished day's carry and snapshot bitwise the "
        "uninterrupted engine's")

    # the kernel on the partial-day mask, against its plain version
    pb, pm = prefix(60)
    low = torch.from_numpy(pb[..., 2]).cuda().contiguous()
    high = torch.from_numpy(pb[..., 1]).cuda().contiguous()
    pmask = torch.from_numpy(pm).cuda()
    args = rolling.second_moment_inputs(low, high, pmask, WINDOW)
    valid = rolling._windowed_sum(pmask, WINDOW) > WINDOW - 0.5
    got = rolling_cuda.second_moments(*args, WINDOW)
    base = rolling_cuda._second_moments_rowwise(*args, WINDOW)
    for a, b in zip(got, base):
        if not cases.same_bits(a, b):
            fail("phase 10: the tiled kernel differs from the rowwise one on "
                 "the partial-day mask")
    want = rolling_cuda.second_moments_plain(*args, WINDOW)
    err = hold_to_plain("second_moments partial day", got, want, valid,
                        1e-5, 1e-9)
    if bool(valid[:, 60:].any()):
        fail("phase 10: windows past the cursor are valid")
    kernel_ms, plain_ms = [], []
    for dest, fn, clock in (
            (kernel_ms, rolling_cuda.second_moments, batched_times_ms),
            (plain_ms, rolling_cuda.second_moments_plain, cuda_times_ms),
            (plain_ms, rolling_cuda.second_moments_plain, cuda_times_ms),
            (kernel_ms, rolling_cuda.second_moments, batched_times_ms)):
        dest += clock(lambda: fn(*args, WINDOW))
    bound, by, _, _ = moment_bound(n, s)
    log(f"phase 10 second_moments [{n}, {s}] on the minute-60 prefix mask "
        f"({int(valid.sum())} valid windows): tiled bitwise rowwise, "
        f"max_abs_err={err:.3e} vs plain; tiled {spread(kernel_ms)} "
        f"({bound / np.median(kernel_ms):.0%} of the {bound:.4f} ms bound by "
        f"{by}); plain {spread(plain_ms)} ({card})")
    del args, got, base, want, low, high, pmask, valid

    peak = torch.cuda.max_memory_allocated()
    log(f"phase 10 times ({card}): update per {STREAM_MICRO}-minute "
        f"micro-batch {spread(update_ms)} device events, host wall "
        f"{spread(update_wall)}; cohort of {n} + advance {spread(cohort_ms)}"
        "; " + "; ".join(
            f"{label} snapshot at minute {m} {spread(snap_ms[label][m])}"
            for label in ("exact", "fast") for m in STREAM_TIMED)
        + f"; carry {sc.carry_nbytes(exact.carry)} B per engine; peak "
        f"{peak / 2**30:.3f} GiB allocated (five engines)")
    del engines, exact, fast, plain, cohort, restored, snaps, exp, e2
    del payload, stats, stats_w

    # the packed path's side outputs on phase 4's batch
    enc = wire.encode(bars, mask)
    buf, spec = wire.pack_arrays(enc.arrays)
    rspec = rw.ResultWireSpec.for_names(names, days=bars.shape[0])
    raw = pipeline.compute_packed_prepared(buf, spec, "wire", device="cuda",
                                           rolling_impl="cuda")
    raw_s, stats = pipeline.compute_packed_prepared(
        buf, spec, "wire", factor_stats=True, device="cuda",
        rolling_impl="cuda")
    if not cases.same_bits(raw_s, raw):
        fail("phase 10: compute_packed_prepared's result changes with "
             "factor_stats")
    grown = []
    while True:
        rolling_cuda.reset_launches()
        payload, stats_w = pipeline.compute_packed_prepared(
            buf, spec, "wire", result_spec=rspec, factor_stats=True,
            device="cuda", rolling_impl="cuda")
        torch.cuda.synchronize()
        if dict(rolling_cuda.launches) != {"tiled": 1, "rowwise": 0}:
            fail(f"phase 10 packed side outputs launched "
                 f"{dict(rolling_cuda.launches)}")
        _, probe = rw.decode_block(payload.cpu().numpy(), len(names),
                                   bars.shape[0], bars.shape[1],
                                   rspec.spill_rows, strict=False,
                                   telemetry=Telemetry())
        if not probe["overflow"] or len(grown) == 3:
            break
        grown.append(rspec.spill_rows)
        rspec = rspec.grow(probe["widened"] + probe["overflow"])
    if not torch.equal(stats_w, stats):
        fail("phase 10: the packed stats change with the result wire")
    v = hold_wire_and_stats("phase 10 packed", names, raw, payload, stats,
                            rspec, bars.shape[0])
    log(f"phase 10 compute_packed_prepared(wire, result_spec, factor_stats="
        f"True) {tuple(raw.shape)}: one tiled launch; spill floor grown "
        f"{grown} -> {rspec.spill_rows} rows; payload {payload.numel()} B "
        f"against {raw.numel() * 4} B raw (ratio "
        f"{raw.numel() * 4 / payload.numel():.3f}); {v['widened']} of "
        f"{v['widened'] + v['quantized']} slices widened; decode within "
        f"RESULT_BOUNDS (max rel err {v['max_rel_err']:.2e}), NaN status "
        "exact; stats counts/min/max bitwise factor_stats_host; result "
        "bitwise with and without the stats")
    return {"launches": stream_launches["tiled"], "max_abs_err": err,
            "ms": float(np.median(kernel_ms)),
            "plain_ms": float(np.median(plain_ms)), "bound_ms": bound,
            "bound_by": by}


#: phase 11: the served source (days x tickers), the block's day range,
#: the concurrent identical queries, the HTTP timing rounds per kind
SERVE_DAYS, SERVE_BLOCK, SERVE_COALESCE, SERVE_ROUNDS = 16, 8, 16, 20
#: the phase's ingest micro-batch and the minutes it ingests
SERVE_MICRO, SERVE_MINUTES = 16, 32


def same_values(a: np.ndarray, b: np.ndarray) -> bool:
    """Bitwise f32 equality outside NaN lanes, NaN lanes identical (a NaN
    that went through a Python float may change its sign bit)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if a.shape != b.shape:
        return False
    na, nb = np.isnan(a), np.isnan(b)
    return bool(np.array_equal(na, nb) and np.array_equal(
        a[~na].view(np.uint32), b[~nb].view(np.uint32)))


def fwd_returns_ref(close, valid, horizon: int):
    """The forward close returns and their validity, written apart from
    the server's ``serve.engine._fwd_returns``, with the same ops."""
    fwd = torch.full_like(close, float("nan"))
    fwd[:-horizon] = close[horizon:]
    ok = torch.zeros_like(valid)
    ok[:-horizon] = valid[horizon:]
    return fwd / close - 1.0, ok & valid


def serve_path(tables, card: str):
    """Phase 11: the factor server at full width on the card; see the
    module docstring. Returns the kernels line's entry for the block
    build's tiled kernel, and the standalone answers phase 15 holds the
    fleet to: the whole block ``[0, 8)``, its wire payload and the
    intraday snapshot after the two ingests."""
    import threading
    import urllib.request

    from replication_of_minute_frequency_factor_tpu_torch import (
        StreamEngine, compute_batch, eval_ops, kernels)
    from replication_of_minute_frequency_factor_tpu_torch.data import (
        result_wire as rw)
    from replication_of_minute_frequency_factor_tpu_torch.data import wire
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        factor_names)
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling, rolling_cuda)
    from replication_of_minute_frequency_factor_tpu_torch.serve import (
        FactorServer, Query, ServeConfig, SyntheticSource, WireClient,
        serve_frontdoor)
    from replication_of_minute_frequency_factor_tpu_torch.serve.http import (
        WIRE_CONTENT_TYPE)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        Telemetry)

    names = factor_names()
    d0, d1, d2 = 0, SERVE_BLOCK, 2 * SERVE_BLOCK
    t0 = time.perf_counter()
    src = SyntheticSource(n_days=SERVE_DAYS, n_tickers=TICKERS, seed=0)
    log(f"phase 11 input: SyntheticSource({SERVE_DAYS} days x {TICKERS} "
        f"tickers, seed 0, {src.session.name}) in "
        f"{time.perf_counter() - t0:.2f} s (host); all {len(names)} "
        f"factors, rolling_impl=cuda, stream=True, stream_batches="
        f"({SERVE_MICRO},)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tel = Telemetry()
    # a latency objective a cold build cannot trip; the sampler threads on
    scfg = ServeConfig(slo_latency_ms=60_000.0)
    t0 = time.perf_counter()
    srv = FactorServer(src, names=names, telemetry=tel, serve_cfg=scfg,
                       rolling_impl="cuda", stream=True,
                       stream_batches=(SERVE_MICRO,), device="cuda")
    reg = tel.registry
    log(f"phase 11 server up in {time.perf_counter() - t0:.2f} s on "
        f"{srv.device} (stream engine warmed: "
        f"{int(reg.counter_value('serve.executables', outcome='miss'))} "
        "callables built)")
    client = srv.client(timeout=600)
    doors = []
    try:
        def misses():
            return reg.counter_value("serve.executables", outcome="miss")

        def wall_ms(fn):
            t = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t) * 1e3

        # --- the main path: counts to 0 just before, read just after ---
        rolling_cuda.reset_launches()
        rolling.IMPL_COUNTS.clear()
        lib_builds0 = kernels.build_count()
        steps = {}

        def step(label):
            steps[label] = dict(rolling_cuda.launches)

        # cold: the first block builds its callable
        _, cold_ms = wall_ms(lambda: client.factors(d0, d1,
                                                    names=("mmt_am",)))
        step("cold")
        # warm repeat: the whole block from the cache
        m0, hits0 = misses(), reg.counter_value("serve.cache",
                                                outcome="hit")
        full, _ = wall_ms(lambda: client.factors(d0, d1))
        step("repeat")
        repeat_built = misses() - m0
        repeat_hit = reg.counter_value("serve.cache", outcome="hit") - hits0
        hit_ms = [wall_ms(lambda: client.factors(
            d0, d1, names=("mmt_am",)))[1] for _ in range(SERVE_ROUNDS)]
        ic_names = ("mmt_ols_qrs", "vol_return1min")
        ics = {n: client.ic(n, d0, d1, horizon=1) for n in ic_names}
        deciles = {n: client.decile(n, d0, d1, horizon=1, group_num=5)
                   for n in ic_names}
        wire_ans = srv.submit(Query("factors", d0, d1, encoding="wire")
                              ).result(600)
        step("queries")
        # 16 concurrent identical queries over a fresh range: one dispatch
        srv.scfg.batch_window_s = 0.25
        dis0 = reg.counter_total("serve.dispatches")
        co0 = reg.counter_value("serve.coalesced_requests")
        rolling.IMPL_COUNTS.clear()
        answers, errors = [], []

        def ask():
            try:
                answers.append(client.factors(d1, d2, names=("mmt_am",)))
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=ask)
                   for _ in range(SERVE_COALESCE)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        coalesce_ms = (time.perf_counter() - t) * 1e3
        srv.scfg.batch_window_s = 0.002
        step("coalesce")
        impl_counts = dict(rolling.IMPL_COUNTS)
        coalesced = (reg.counter_total("serve.dispatches") - dis0,
                     reg.counter_value("serve.coalesced_requests") - co0)
        # the first build of another new range, callables warm, alone
        m0 = misses()
        _, warm_new_ms = wall_ms(lambda: client.factors(
            d1 // 2, d1 // 2 + SERVE_BLOCK, names=("mmt_am",)))
        step("new range")
        new_built = misses() - m0
        # intraday: two ingests, then a snapshot
        day_bars, day_mask = src.slab(0, 1)
        micro = [cases.minutes_of(day_bars[0], day_mask[0], lo,
                                  lo + SERVE_MICRO)
                 for lo in range(0, SERVE_MINUTES, SERVE_MICRO)]
        for b, p in micro:
            client.ingest(b, p)
        intraday = client.intraday()
        step("intraday")
        # --- end of the main path ---

        launches = {}
        prev = {"tiled": 0, "rowwise": 0}
        for label, now in steps.items():
            launches[label] = {k: now[k] - prev[k] for k in now}
            prev = now
        log(f"phase 11 launches by step: {launches}; rolling impl on the "
            f"coalesced build {impl_counts}")
        want = {"cold": 1, "repeat": 0, "queries": 0, "coalesce": 1,
                "new range": 1, "intraday": 1}
        for label, n in want.items():
            if launches[label] != {"tiled": n, "rowwise": 0}:
                fail(f"phase 11 {label}: launched {launches[label]}, "
                     f"expected the tiled kernel {n} time(s)")
        if repeat_built != 0 or repeat_hit != 1:
            fail(f"phase 11 warm repeat: {repeat_built} callables built, "
                 f"{repeat_hit} cache hits (want 0 and 1)")
        if new_built != 0:
            fail(f"phase 11: a new range of the same extent built "
                 f"{new_built} callables")
        lib_builds = kernels.build_count() - lib_builds0
        if lib_builds != 0:
            fail(f"phase 11: {lib_builds} kernel-library builds or loads "
                 "in the request loop (the engine loads it at construction)")
        if errors or len(answers) != SERVE_COALESCE:
            fail(f"phase 11 coalescing: {errors[:3]}")
        if coalesced != (1, SERVE_COALESCE):
            fail(f"phase 11 coalescing: {SERVE_COALESCE} identical queries "
                 f"gave {coalesced[0]} dispatches for {coalesced[1]} "
                 "coalesced requests")
        if impl_counts != {("cuda", "cuda"): 1}:
            fail(f"phase 11: rolling impl resolved {impl_counts}")
        log(f"phase 11 cold first block [{d0}, {d1}) (builds the callable, "
            f"one factor's answer): {cold_ms:.2f} ms wall; warm repeat of "
            f"the whole block: 0 built, 1 cache hit, 0 launches; cache-hit "
            f"answer (one factor) {spread(hit_ms)} wall; {SERVE_COALESCE} "
            f"concurrent queries on the new range [{d1}, {d2}) with warm "
            f"callables: 1 dispatch, 1 tiled launch, {coalesce_ms:.2f} ms "
            f"wall for all (the 0.25 s collection window included); the "
            f"first block of another new range [{d1 // 2}, "
            f"{d1 // 2 + SERVE_BLOCK}), callables warm, alone: "
            f"{warm_new_ms:.2f} ms wall, nothing built; no kernel-library "
            f"build or load in the loop ({card})")

        # 1. the block against compute_batch on its decoded bars
        bars, mask = src.slab(d0, d1)
        w = wire.encode(bars, mask, floor={})
        buf, spec = wire.pack_arrays(w.arrays)
        dbars, dmask = wire.decode(*wire.unpack(
            torch.from_numpy(buf).cuda(), spec))
        ref = compute_batch(dbars, dmask, device="cuda",
                            rolling_impl="cuda").cpu().numpy()
        for i, n in enumerate(names):
            if not same_values(full["exposures"][n], ref[i]):
                fail(f"phase 11: served {n} differs from compute_batch on "
                     "the block's decoded bars")
        block = srv.cache.get((d0, d1))
        if block is None:
            fail("phase 11: the block is not in the exposure cache")
        m = dmask.cpu().numpy()
        last = np.where(m, np.arange(m.shape[-1]), -1).max(axis=-1)
        valid = last >= 0
        close = np.take_along_axis(dbars[..., 3].cpu().numpy(),
                                   np.maximum(last, 0)[..., None],
                                   axis=-1)[..., 0]
        close = np.where(valid, close, np.float32(np.nan))
        if not (same_values(block["close"].cpu().numpy(), close)
                and np.array_equal(block["valid"].cpu().numpy(), valid)):
            fail("phase 11: the block's close/valid planes differ")
        log(f"phase 11 block [{d0}, {d1}): all {len(names)} served "
            "exposures bitwise compute_batch on the block's decoded bars "
            "(NaN positions identical); close and valid bitwise")

        # 2. IC and decile against eval_ops on the fetched block
        exposures = block["exposures"]
        ret, ok = fwd_returns_ref(block["close"], block["valid"], 1)
        for n in ic_names:
            exp = exposures[names.index(n)]
            v = ok & torch.isfinite(exp) & torch.isfinite(ret)
            ic, ric = eval_ops.ic_series(torch.where(v, exp, 0.0),
                                         torch.where(v, ret, 0.0), v)
            for key, want_ in (("ic", ic), ("rank_ic", ric)):
                if not same_values(ics[n][key], want_.cpu().numpy()):
                    fail(f"phase 11: served {key} of {n} differs from "
                         "eval_ops.ic_series on the block")
            vv = block["valid"] & torch.isfinite(exp)
            lab = eval_ops._qcut_labels(exp, vv, 5)
            counts = torch.stack([((lab == g) & vv).sum(dim=1)
                                  for g in range(5)], dim=1)
            if deciles[n]["counts"] != counts.cpu().tolist():
                fail(f"phase 11: served decile counts of {n} differ")
        log(f"phase 11 IC/rank-IC of {ic_names} bitwise "
            "eval_ops.ic_series on the block; decile counts bitwise "
            "eval_ops._qcut_labels")

        # 3. the wire answer against encode_block on the block
        spec_r = srv.engine.result_spec(SERVE_BLOCK)
        payload = rw.encode_block(exposures, spec_r).cpu().numpy()
        if wire_ans["payload"].tobytes() != payload.tobytes():
            fail("phase 11: the wire payload is not encode_block's")
        dec, verdict = rw.decode_block(payload, len(names), SERVE_BLOCK,
                                       TICKERS, spec_r.spill_rows,
                                       strict=False)
        log(f"phase 11 wire answer: {payload.nbytes} B byte-identical to "
            f"result_wire.encode_block on the block ({verdict['widened']} "
            f"widened slices, {verdict['overflow']} over the "
            f"{spec_r.spill_rows}-row spill budget)")

        # 6. intraday against a standalone engine on the same minutes
        eng = StreamEngine(TICKERS, names=names, rolling_impl="cuda",
                           telemetry=Telemetry(), device="cuda")
        for b, p in micro:
            eng.ingest_minutes(b, p)
        s_exp, s_ready = eng.snapshot()
        s_exp, s_ready = s_exp.cpu().numpy(), s_ready.cpu().numpy()
        if intraday["minute"] != SERVE_MINUTES:
            fail(f"phase 11 intraday at minute {intraday['minute']}")
        for i, n in enumerate(names):
            if not (same_values(intraday["exposures"][n], s_exp[i])
                    and intraday["ready"][n] == s_ready[i].tolist()):
                fail(f"phase 11 intraday {n} differs from a standalone "
                     "StreamEngine snapshot")
        del eng
        log(f"phase 11 intraday after ingesting minutes 0-{SERVE_MICRO} and "
            f"{SERVE_MICRO}-{SERVE_MINUTES} of day 0: every exposure and "
            "readiness lane bitwise a standalone StreamEngine snapshot")

        # 7. HTTP: the edge and the legacy binding
        edge = serve_frontdoor(srv, port=0, transport="edge")
        doors.append(edge)
        legacy = serve_frontdoor(srv, port=0, transport="legacy")
        doors.append(legacy)
        sub = ["mmt_am", "mmt_ols_qrs", "liq_openvol"]
        in_proc = client.factors(d0, d1, names=sub)
        bodies = {}
        for label, door in (("edge", edge), ("legacy", legacy)):
            cli = WireClient(*door.server_address[:2], timeout=600)
            try:
                st, doc = cli.query_json({"kind": "factors", "start": d0,
                                          "end": d1, "names": sub})
                if st != 200 or any(
                        not same_values(doc["exposures"][n],
                                        in_proc["exposures"][n])
                        for n in sub):
                    fail(f"phase 11 {label}: JSON factors differ from the "
                         "in-process answer")
                st, doc = cli.query_json({"kind": "ic", "start": d0,
                                          "end": d1,
                                          "factor": "mmt_ols_qrs"})
                if st != 200 or not same_values(
                        doc["ic"], ics["mmt_ols_qrs"]["ic"]):
                    fail(f"phase 11 {label}: IC differs from in-process")
                st, hdrs, body = cli.post_json(
                    "/v1/query", {"kind": "factors", "start": d0,
                                  "end": d1},
                    headers={"Accept": WIRE_CONTENT_TYPE})
                if st != 200:
                    fail(f"phase 11 {label}: wire query answered {st}")
                bodies[label] = body
                # the frame's payload (not its decode: at this width the
                # default spill budget overflows, and a strict decode
                # refuses it as the JAX package's does)
                _meta, framed, _ = rw.unpack_frame(body)
                if np.asarray(framed).tobytes() != \
                        wire_ans["payload"].tobytes():
                    fail(f"phase 11 {label}: the wire frame's payload is "
                         "not the in-process answer's")
            finally:
                cli.close()
        if bodies["edge"] != bodies["legacy"]:
            fail("phase 11: edge and legacy wire bodies differ")
        # request latency by kind, in process and over the edge
        cli = WireClient(*edge.server_address[:2], timeout=600)
        lat = {"in-process": {}, "edge": {}}
        try:
            for kind_, doc in (
                    ("factors", {"kind": "factors", "start": d0, "end": d1,
                                 "names": ["mmt_am"]}),
                    ("ic", {"kind": "ic", "start": d0, "end": d1,
                            "factor": "mmt_am"}),
                    ("decile", {"kind": "decile", "start": d0, "end": d1,
                                "factor": "mmt_am"})):
                q = Query(kind_, d0, d1, names=tuple(doc.get("names", ()))
                          or None, factor=doc.get("factor"))
                lat["in-process"][kind_] = [wall_ms(lambda: srv.submit(
                    q).result(600))[1] for _ in range(SERVE_ROUNDS)]
                lat["edge"][kind_] = [wall_ms(lambda: cli.query_json(doc)
                                              )[1]
                                      for _ in range(SERVE_ROUNDS)]
        finally:
            cli.close()
        for where, by_kind in lat.items():
            log(f"phase 11 request wall ms {where} ({card}): " + "; ".join(
                f"{k} p50 {np.percentile(v, 50):.3f} p95 "
                f"{np.percentile(v, 95):.3f}" for k, v in by_kind.items()))
        log("phase 11 serve.request_seconds (server side, all requests) ms: "
            + "; ".join(
                f"{k} p50 {st['p50'] * 1e3:.3f} p95 {st['p95'] * 1e3:.3f} "
                f"n={st['count']}" for k in ("factors", "ic", "decile",
                                             "ingest", "intraday")
                if (st := reg.histogram_stats("serve.request_seconds",
                                              kind=k))))
        log(f"phase 11 HTTP on 127.0.0.1 (edge and legacy): JSON factors "
            f"and IC bitwise the in-process answers; wire bodies "
            f"byte-identical between the doors, their payload the "
            f"in-process wire answer's")

        # 8. health: the card's name and a measured memory watermark
        with urllib.request.urlopen(
                f"http://127.0.0.1:{edge.server_address[1]}/healthz",
                timeout=60) as resp:
            health = json.loads(resp.read())
        if kind_name(card) not in " ".join(health["replica"]["devices"]):
            fail(f"phase 11 /healthz names {health['replica']['devices']}")
        if not health["hbm_available"]:
            fail("phase 11 /healthz: the HBM sampler is unavailable")
        # the sampler reads the caching allocator's counters, the ones
        # max_memory_allocated returns, so it is held against readings
        # of its own: from below, the bytes of the tensors the server
        # holds (cached blocks plus the stream carry); from above, the
        # bytes the driver counts in use on the card
        from replication_of_minute_frequency_factor_tpu_torch.stream import (
            carry as carry_mod)
        torch.cuda.synchronize()
        hbm = tel.hbm.sample("phase11", force=True)
        free_b, total_b = torch.cuda.mem_get_info()
        held = srv.cache.nbytes + carry_mod.carry_nbytes(
            srv.stream_engine.carry)
        peak = torch.cuda.max_memory_allocated()
        if not hbm["available"] or not (
                held <= hbm["bytes_in_use"] <= total_b - free_b
                and hbm["bytes_in_use"] <= hbm["peak_bytes"]
                <= total_b - free_b):
            fail(f"phase 11 HBM sampler: {hbm} against the server's "
                 f"tensors {held} B and the driver's {total_b - free_b} B "
                 "in use")
        log(f"phase 11 /healthz: devices {health['replica']['devices']}, "
            f"hbm_available true; sampler in use {hbm['bytes_in_use']} B "
            f"between the server's tensors {held} B and the driver's "
            f"{total_b - free_b} B in use; sampler peak "
            f"{hbm['peak_bytes']} B (the counter max_memory_allocated "
            f"reads: {peak} B, {peak / 2**30:.3f} GiB) ({card})")

        # launch and fetch timed apart on a direct block build
        eng = srv.engine
        rolling_cuda.reset_launches()
        builds = []
        for _ in range(5):
            t = time.perf_counter()
            blk = eng.build_block(bars, mask)
            t_launch = time.perf_counter()
            _ = blk["exposures"].cpu()
            builds.append(((t_launch - t) * 1e3,
                           (time.perf_counter() - t_launch) * 1e3))
        log(f"phase 11 ServeEngine.build_block [{d0}, {d1}) warm ({card}): "
            f"returns after enqueue in {spread([b[0] for b in builds])}; "
            f"the fetch then waits {spread([b[1] for b in builds])}")
        del blk

        # the kernel at the block's shape, on the block's decoded bars
        low = dbars[..., 2].reshape(-1, 240).contiguous()
        high = dbars[..., 1].reshape(-1, 240).contiguous()
        pm = dmask.reshape(-1, 240)
        args = rolling.second_moment_inputs(low, high, pm, WINDOW)
        vmask = rolling._windowed_sum(pm, WINDOW) > WINDOW - 0.5
        got = rolling_cuda.second_moments(*args, WINDOW)
        err = hold_to_plain("phase 11 second_moments",
                            got, rolling_cuda.second_moments_plain(
                                *args, WINDOW), vmask, 1e-5, 1e-9,
                            constant_row=False)
        kernel_ms, plain_ms = [], []
        for dest, fn, clock in (
                (kernel_ms, rolling_cuda.second_moments, batched_times_ms),
                (plain_ms, rolling_cuda.second_moments_plain, cuda_times_ms),
                (plain_ms, rolling_cuda.second_moments_plain, cuda_times_ms),
                (kernel_ms, rolling_cuda.second_moments, batched_times_ms)):
            dest += clock(lambda: fn(*args, WINDOW))
        rows = low.shape[0]
        bound, by, _, _ = moment_bound(rows, 240)
        serve_launches = sum(launches[k]["tiled"]
                             for k in ("cold", "coalesce", "new range"))
        log(f"phase 11 second_moments [{rows}, 240] on the block's decoded "
            f"bars: max_abs_err={err:.3e} vs plain; tiled "
            f"{spread(kernel_ms)} ({bound / np.median(kernel_ms):.0%} of the "
            f"{bound:.4f} ms bound by {by}); plain {spread(plain_ms)}; "
            f"{serve_launches} launches for the 3 block builds ({card})")
    finally:
        for door in doors:
            door.shutdown()
        srv.close()
    return {"launches": serve_launches,
            "max_abs_err": err, "ms": float(np.median(kernel_ms)),
            "plain_ms": float(np.median(plain_ms)), "bound_ms": bound,
            "bound_by": by}, {"full": full,
                              "wire": wire_ans["payload"].tobytes(),
                              "intraday": intraday}


#: phase 15: the fleet's replicas (sharing the one card), the queries
#: coalesced before the start, the router-hop timing rounds, and each
#: replica's exposure-cache budget: large enough that the card's whole
#: allocation (both replicas' blocks and carries plus every earlier
#: phase's tensors, all read as one card's bytes) stays under the HBM
#: demotion line, cache_bytes x 1.5
FLEET_REPLICAS, FLEET_COALESCE, FLEET_HOP_ROUNDS = 2, 16, 4
FLEET_CACHE_BYTES = 16 << 30


def fleet_path(standalone: dict, card: str) -> dict:
    """Phase 15: the fleet on the card; see the module docstring. Returns
    the kernels line's entry for the replicas' block builds."""
    import tempfile
    import threading
    import urllib.request

    from replication_of_minute_frequency_factor_tpu_torch import kernels
    from replication_of_minute_frequency_factor_tpu_torch.data import (
        result_wire as rw)
    from replication_of_minute_frequency_factor_tpu_torch.data import wire
    from replication_of_minute_frequency_factor_tpu_torch.fleet import (
        FactorFleet, serve_fleet_frontdoor)
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        factor_names)
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling, rolling_cuda)
    from replication_of_minute_frequency_factor_tpu_torch.serve import (
        Query, ServeConfig, SyntheticSource, WireClient)
    from replication_of_minute_frequency_factor_tpu_torch.serve.http import (
        WIRE_CONTENT_TYPE)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        aggregate)

    names = factor_names()
    d0, d1, d2 = 0, SERVE_BLOCK, 2 * SERVE_BLOCK
    src = SyntheticSource(n_days=SERVE_DAYS, n_tickers=TICKERS, seed=0)
    card0 = torch.device("cuda", 0)
    scfg = ServeConfig(slo_latency_ms=60_000.0, breaker_threshold=1,
                       breaker_cooldown_s=0.4,
                       cache_bytes=FLEET_CACHE_BYTES)
    t0 = time.perf_counter()
    fleet = FactorFleet(src, FLEET_REPLICAS, names=names, serve_cfg=scfg,
                        rolling_impl="cuda", stream=True,
                        stream_batches=(SERVE_MICRO,), start=False,
                        devices=[card0] * FLEET_REPLICAS)
    fleet.policy.cooldown_s = 0.2
    log(f"phase 15 fleet up in {time.perf_counter() - t0:.2f} s: "
        f"{FLEET_REPLICAS} replicas over phase 11's source, all "
        f"{len(names)} factors, rolling_impl=cuda, stream=True, devices="
        f"{[[str(d) for d in r.devices] for r in fleet.replicas]}. The "
        "replicas share ONE card: their times are not multi-card scaling, "
        "and both HBM samples read the same card")
    for r in fleet.replicas:
        if r.server.engine.rolling_impl != "cuda" or \
                r.server.stream_engine.rolling_impl != "cuda":
            fail(f"phase 15 {r.label}: rolling_impl "
                 f"{r.server.engine.rolling_impl} requested, not cuda")
    reg = fleet.telemetry.registry
    doors = []
    try:
        def dispatches():
            return {r.label: r.telemetry.registry.counter_total(
                "serve.dispatches") for r in fleet.replicas}

        def owner_of(key):
            return fleet.router.route_order(key)[0]

        # --- the main path: counts to 0 just before, read just after ---
        rolling_cuda.reset_launches()
        rolling.IMPL_COUNTS.clear()
        built0 = kernels.build_count()
        steps = {}

        def step(label):
            steps[label] = dict(rolling_cuda.launches)

        futs = [fleet.submit(Query("factors", d0, d1))
                for _ in range(FLEET_COALESCE)]
        t = time.perf_counter()
        fleet.start()
        answers = [f.result(600) for f in futs]
        coalesce_ms = (time.perf_counter() - t) * 1e3
        step("coalesce")
        disp = dispatches()
        owner = owner_of((d0, d1))
        wire_ans = fleet.submit(Query("factors", d0, d1,
                                      encoding="wire")).result(600)
        step("wire")
        spread_keys = [(d1, d2), (d1 // 2, d1 // 2 + SERVE_BLOCK)]
        for k in spread_keys:
            fleet.submit(Query("factors", *k, names=("mmt_am",))
                         ).result(600)
        step("distinct ranges")
        # the degrade ladder on a fresh range: its owner raises, the
        # pod answers through the other replica, then restores it
        lkey = (2, 2 + SERVE_BLOCK)
        lowner = owner_of(lkey)
        lother = next(r for r in fleet.replicas if r is not lowner)

        def boom(*a, **k):
            raise RuntimeError("injected replica failure")

        lowner.server.engine.build_block = boom
        try:
            fleet.submit(Query("factors", *lkey)).result(600)
            fail("phase 15: the injected raiser did not raise")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        through_other = fleet.submit(Query("factors", *lkey)).result(600)
        health_down = fleet.health()
        step("degraded")
        del lowner.server.engine.build_block
        time.sleep(0.6)
        restored = fleet.submit(Query("factors", *lkey)).result(600)
        health_up = fleet.health()
        step("restored")
        # each replica's cold block build: a new range on each, asked of
        # the replica's own server (callables warm, one factor answered)
        cold = {}
        for i, r in enumerate(fleet.replicas):
            k = (6 + i, 6 + i + SERVE_BLOCK)
            t = time.perf_counter()
            r.server.submit(Query("factors", *k, names=("mmt_am",))
                            ).result(600)
            cold[r.label] = (time.perf_counter() - t) * 1e3
        step("cold builds")
        # ingest fan-out with one broken leg, then intraday
        fleet.policy.cooldown_s = 30.0
        for r in fleet.replicas:
            r.server.scfg.breaker_cooldown_s = 30.0
        broken, healthy = fleet.replicas
        broken.server.stream_engine.ingest_minutes = boom
        day_bars, day_mask = src.slab(0, 1)
        micro = [cases.minutes_of(day_bars[0], day_mask[0], lo,
                                  lo + SERVE_MICRO)
                 for lo in range(0, SERVE_MINUTES, SERVE_MICRO)]
        legs = [fleet.ingest(b, p_, timeout=600) for b, p_ in micro]
        intraday = fleet.submit(Query("intraday")).result(600)
        step("intraday")
        impl_counts = dict(rolling.IMPL_COUNTS)
        built = kernels.build_count() - built0
        # --- end of the main path ---

        launches = {}
        prev = {"tiled": 0, "rowwise": 0}
        for label, now in steps.items():
            launches[label] = {k: now[k] - prev[k] for k in now}
            prev = now
        log(f"phase 15 launches by step: {launches}; rolling impl "
            f"{impl_counts}; kernel-library builds in the loop {built}")
        want = {"coalesce": 1, "wire": 0, "distinct ranges": 2,
                "degraded": 1, "restored": 1,
                "cold builds": FLEET_REPLICAS, "intraday": 1}
        for label, n in want.items():
            if launches[label] != {"tiled": n, "rowwise": 0}:
                fail(f"phase 15 {label}: launched {launches[label]}, "
                     f"expected the tiled kernel {n} time(s)")
        if set(impl_counts) != {("cuda", "cuda")}:
            fail(f"phase 15: a replica resolved rolling impl {impl_counts}")
        if built != 0:
            fail(f"phase 15: {built} kernel-library builds in the loop")
        if disp != {owner.label: 1, **{r.label: 0 for r in fleet.replicas
                                       if r is not owner}}:
            fail(f"phase 15: {FLEET_COALESCE} same-range queries gave "
                 f"dispatches {disp}; expected one, on {owner.label}")
        if reg.counter_value("fleet.affinity", outcome="hit") \
                < FLEET_COALESCE - 1:
            fail("phase 15: the affinity memo missed repeat keys")
        full = standalone["full"]
        for a in answers:
            for n in names:
                if not same_values(a["exposures"][n], full["exposures"][n]):
                    fail(f"phase 15: routed {n} differs from phase 11's "
                         "standalone answer")
        if wire_ans["payload"].tobytes() != standalone["wire"]:
            fail("phase 15: the routed wire payload is not phase 11's")
        log(f"phase 15: {FLEET_COALESCE} queries on [{d0}, {d1}) submitted "
            f"before start: 1 dispatch on {owner.label} (the rendezvous "
            f"owner), 1 tiled launch, {coalesce_ms:.2f} ms wall for all; "
            f"every answer bitwise phase 11's standalone answer on all "
            f"{len(names)}, the wire payload byte-identical ({card})")
        routes = {tuple(rec["data"]["key"]): rec["data"]["replica"]
                  for rec in fleet.telemetry._requests
                  if rec["op"] == "route"}
        for k in spread_keys:
            if routes.get(k) != owner_of(k).label:
                fail(f"phase 15: range {k} went to {routes.get(k)}, its "
                     f"rendezvous owner is {owner_of(k).label}")
        log(f"phase 15 distinct ranges {spread_keys} went to their "
            f"rendezvous owners {[owner_of(k).label for k in spread_keys]}")
        if health_down["pod"]["demoted"] != [lowner.label] or \
                health_down["pod"]["reasons"][lowner.label] != "breaker":
            fail(f"phase 15 ladder: {health_down['pod']} after the "
                 f"injected failure on {lowner.label}")
        if health_up["pod"]["live"] != FLEET_REPLICAS or reg.counter_value(
                "fleet.restores", replica=lowner.label) != 1:
            fail(f"phase 15 ladder: {lowner.label} not restored "
                 f"({health_up['pod']})")
        for n in names:
            if not same_values(through_other["exposures"][n],
                               restored["exposures"][n]):
                fail(f"phase 15 ladder: {n} through {lother.label} differs "
                     f"from the restored {lowner.label}'s")
        log(f"phase 15 ladder on {lkey}: {lowner.label} raised and was "
            f"demoted (breaker), {lother.label} answered, {lowner.label} "
            "restored after the cooldowns and rebuilt the range bitwise the "
            "answer through the other replica")
        if [leg["failed"] for leg in legs] != [[broken.label]] * 2 or \
                not legs[1]["replicas"][broken.label].get("skipped"):
            fail(f"phase 15 ingest legs: {legs}")
        if intraday["minute"] != SERVE_MINUTES:
            fail(f"phase 15 intraday at minute {intraday['minute']}")
        want_i = standalone["intraday"]
        for n in names:
            if not (same_values(intraday["exposures"][n],
                                want_i["exposures"][n])
                    and intraday["ready"][n] == want_i["ready"][n]):
                fail(f"phase 15 intraday {n} differs from phase 11's "
                     "(a standalone StreamEngine snapshot's bits)")
        log(f"phase 15 ingest fan-out with {broken.label}'s leg broken: "
            f"failed {[leg['failed'] for leg in legs]}, then skipped; "
            f"{healthy.label}'s intraday answer at minute {SERVE_MINUTES} "
            "bitwise the standalone StreamEngine snapshot of phase 11")

        # pod counters: the registry-merge fold equals the sums
        merged = fleet.pod_registry()
        regs = [reg] + [r.telemetry.registry for r in fleet.replicas]
        for key, total in merged.snapshot()["counters"].items():
            per = sum(r_.snapshot()["counters"].get(key, 0.0)
                      for r_ in regs)
            if abs(per - total) > 1e-9 * max(1.0, abs(total)):
                fail(f"phase 15 pod counter {key}: {total} != {per}")
        log(f"phase 15 pod counters: every counter the sum over the control "
            f"plane and the replicas; fleet.routed "
            f"{merged.counter_total('fleet.routed'):.0f}, serve.dispatches "
            f"{merged.counter_total('serve.dispatches'):.0f}")

        # the doors: health, metrics and answers over 127.0.0.1
        sub = ["mmt_am", "mmt_ols_qrs", "liq_openvol"]
        in_proc = fleet.submit(Query("factors", d0, d1,
                                     names=tuple(sub))).result(600)
        bodies = {}
        for label in ("edge", "legacy"):
            door = serve_fleet_frontdoor(fleet, port=0, transport=label)
            doors.append(door)
            port = door.server_address[1]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                        timeout=60) as resp:
                h = json.loads(resp.read())
            for rl, rep in h["replicas"].items():
                if not rep["replica"]["devices"][0].startswith("cuda:0 "):
                    fail(f"phase 15 {label} /healthz {rl}: devices "
                         f"{rep['replica']['devices']}")
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/v1/metrics?format=prometheus",
                    timeout=60) as resp:
                text = resp.read().decode()
            if "fleet_routed_total" not in text or \
                    "serve_dispatches_total" not in text:
                fail(f"phase 15 {label}: the Prometheus scrape lacks the "
                     "pod counters")
            cli = WireClient("127.0.0.1", port, timeout=600)
            try:
                st, doc = cli.query_json({"kind": "factors", "start": d0,
                                          "end": d1, "names": sub})
                if st != 200 or any(not same_values(
                        doc["exposures"][n], in_proc["exposures"][n])
                        for n in sub):
                    fail(f"phase 15 {label}: JSON factors differ from the "
                         "in-process answer")
                st, _hdrs, body = cli.post_json(
                    "/v1/query", {"kind": "factors", "start": d0,
                                  "end": d1},
                    headers={"Accept": WIRE_CONTENT_TYPE})
                if st != 200:
                    fail(f"phase 15 {label}: wire query answered {st}")
                _meta, framed, _ = rw.unpack_frame(body)
                if np.asarray(framed).tobytes() != standalone["wire"]:
                    fail(f"phase 15 {label}: the wire frame's payload is "
                         "not phase 11's")
                bodies[label] = body
            finally:
                cli.close()
        if bodies["edge"] != bodies["legacy"]:
            fail("phase 15: edge and legacy wire bodies differ")
        log(f"phase 15 doors (edge, legacy): /healthz names "
            f"{h['replicas'][owner.label]['replica']['devices']} for each "
            "replica; the Prometheus scrape carries the pod counters; JSON "
            "answers bitwise in process, wire bodies byte-identical")

        # the bundles aggregate
        with tempfile.TemporaryDirectory(prefix="fleet_bundles_") as tmp:
            dirs = []
            for r in fleet.replicas:
                d = os.path.join(tmp, r.label)
                r.write_bundle(d)
                dirs.append(d)
            agg = aggregate.aggregate_dirs(dirs, os.path.join(tmp, "pod"))
            if not agg["ok"] or agg["counter_totals"]["mismatched"]:
                fail(f"phase 15: the replicas' bundles do not aggregate "
                     f"({agg.get('counter_totals')})")
        log(f"phase 15 bundles: {len(dirs)} replica bundles stamped and "
            "aggregated, every counter total exact")

        # no replica was demoted for HBM: both read the one card
        hbm = {}
        for r in fleet.replicas:
            r.telemetry.hbm.sample("phase15", force=True)
            hbm[r.label] = r.hbm_bytes()
            if reg.counter_value("fleet.demotions", replica=r.label,
                                 reason="hbm"):
                fail(f"phase 15: {r.label} was demoted for HBM")
            if not hbm[r.label][1]:
                fail(f"phase 15: {r.label}'s HBM reading is unavailable")
        log(f"phase 15 HBM: each replica reads the whole card's bytes in use "
            f"({ {k: int(v[0]) for k, v in hbm.items()} }), under the "
            f"demotion line {FLEET_CACHE_BYTES * 1.5 / 2**30:.1f} GiB; no "
            "HBM demotion")

        # timed: the router hop, each replica's cold build, the kernel
        q = Query("factors", d0, d1, names=("mmt_am",))
        hop = {"routed": [], "direct": []}
        for _ in range(FLEET_HOP_ROUNDS):
            for label, fn in (("routed", fleet.submit),
                              ("direct", owner.server.submit),
                              ("direct", owner.server.submit),
                              ("routed", fleet.submit)):
                for _ in range(SERVE_ROUNDS // 4):
                    t = time.perf_counter()
                    fn(q).result(600)
                    hop[label].append((time.perf_counter() - t) * 1e3)
        log(f"phase 15 request wall ms, a cache-hit factor on [{d0}, {d1}) "
            f"({card}): " + "; ".join(
                f"{k} p50 {np.percentile(v, 50):.3f} p99 "
                f"{np.percentile(v, 99):.3f} (n={len(v)})"
                for k, v in hop.items()) + "; the router hop costs "
            f"{np.percentile(hop['routed'], 50) - np.percentile(hop['direct'], 50):.3f}"
            " ms at p50")
        log(f"phase 15 cold block build (a new range, one factor's answer) "
            f"by replica, ms wall: { {k: round(v, 3) for k, v in cold.items()} }"
            f" ({card})")

        # the kernel at the block's shape, on the block's decoded bars
        bars, mask = src.slab(d0, d1)
        w = wire.encode(bars, mask, floor={})
        buf, spec = wire.pack_arrays(w.arrays)
        dbars, dmask = wire.decode(*wire.unpack(
            torch.from_numpy(buf).to(card0), spec))
        low = dbars[..., 2].reshape(-1, 240).contiguous()
        high = dbars[..., 1].reshape(-1, 240).contiguous()
        pm = dmask.reshape(-1, 240)
        args = rolling.second_moment_inputs(low, high, pm, WINDOW)
        vmask = rolling._windowed_sum(pm, WINDOW) > WINDOW - 0.5
        got = rolling_cuda.second_moments(*args, WINDOW)
        err = hold_to_plain("phase 15 second_moments", got,
                            rolling_cuda.second_moments_plain(*args, WINDOW),
                            vmask, 1e-5, 1e-9, constant_row=False)
        kernel_ms, plain_ms = [], []
        for dest, fn, clock in (
                (kernel_ms, rolling_cuda.second_moments, batched_times_ms),
                (plain_ms, rolling_cuda.second_moments_plain, cuda_times_ms),
                (plain_ms, rolling_cuda.second_moments_plain, cuda_times_ms),
                (kernel_ms, rolling_cuda.second_moments, batched_times_ms)):
            dest += clock(lambda: fn(*args, WINDOW))
        rows = low.shape[0]
        bound, by, _, _ = moment_bound(rows, 240)
        fleet_launches = sum(launches[k]["tiled"] for k in (
            "coalesce", "distinct ranges", "degraded", "restored",
            "cold builds"))
        log(f"phase 15 second_moments [{rows}, 240] on a replica block's "
            f"decoded bars: max_abs_err={err:.3e} vs plain; tiled "
            f"{spread(kernel_ms)} ({bound / np.median(kernel_ms):.0%} of the "
            f"{bound:.4f} ms bound by {by}); plain {spread(plain_ms)}; "
            f"{fleet_launches} launches for the main path's "
            f"{fleet_launches} replica block builds ({card})")
    finally:
        for door in doors:
            door.shutdown()
        fleet.close()
    return {"launches": fleet_launches, "max_abs_err": err,
            "ms": float(np.median(kernel_ms)),
            "plain_ms": float(np.median(plain_ms)), "bound_ms": bound,
            "bound_by": by}


def fleet_cli(card: str) -> None:
    """Phase 15b: the CLI's ``serve --fleet 1 --demo 12`` in this process
    on the default device list (every visible card). A replica's HBM
    signal reads the whole card's allocation, at any moment a sample
    lands (mid-build included), against ``--cache-mb`` x 1.5; this
    process holds earlier phases' tensors too, so the budget is sized to
    keep the card's allocation under the demotion line, as 15a sizes
    its own, and the peak of the run is logged beside the CLI default's
    line."""
    import gc

    from replication_of_minute_frequency_factor_tpu_torch.fleet import (
        FleetShedError)
    from replication_of_minute_frequency_factor_tpu_torch.ops import rolling
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        get_telemetry)

    gc.collect()  # phase 15a's fleet is a reference cycle
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    rolling.IMPL_COUNTS.clear()
    argv = ["serve", "--fleet", "1", "--demo", "12", "--cache-mb",
            str(FLEET_CLI_CACHE_MB)]
    try:
        rc, out, secs = run_cli(argv)
    except FleetShedError as e:
        demotes = [ev for ev in get_telemetry().events()
                   if ev.get("name") == "fleet.demote"]
        fail(f"phase 15b: {' '.join(argv)} shed ({e}); demotions "
             f"{demotes}; {held} B allocated before, peak "
             f"{torch.cuda.max_memory_allocated()} B")
    peak = torch.cuda.max_memory_allocated()
    if rc != 0 or out is None or out["live_replicas"] != 1 \
            or out["routed"] != 12:
        fail(f"phase 15b: {' '.join(argv)} gave rc {rc}: {out}")
    if set(rolling.IMPL_COUNTS) != {("cuda", "cuda")}:
        fail(f"phase 15b: rolling impl {dict(rolling.IMPL_COUNTS)}")
    log(f"phase 15b: {' '.join(argv)} on every visible card "
        f"({torch.cuda.device_count()}): {out} in {secs:.2f} s; "
        f"{held} B allocated before, peak {peak} B during the run, "
        f"against the CLI default's demotion line {int(256 * 2**20 * 1.5)}"
        f" B ({card})")


#: phase 15b's exposure-cache budget (MB): its demotion line, 1.5 x this,
#: sits above the whole card's allocation in this process
FLEET_CLI_CACHE_MB = 4096


#: phase 12: the discovery slab (tickers x days on cn_ashare_240, the JAX
#: package's own discovery slab) and its seed; the population levels with
#: the generations each runs; the fixed population held card against CPU;
#: the server's discovery job (days [0, 8) of phase 11's source)
DISC_TICKERS, DISC_DAYS, DISC_SEED = 512, 16, 2024
DISC_LEVELS = ((512, 6), (2048, 4), (8192, 2))
DISC_HOLD_POP = 512
DISC_JOB = {"generations": 4, "pop": 128, "seed": 7}
#: the interpreter tolerance the CPU tests state (tests/test_torch_search.py,
#: the JAX package's tests/test_search.py:38)
SEARCH_RTOL, SEARCH_ATOL = 2e-4, 1e-6


def same_discovery(a, b) -> bool:
    """Two ``DiscoveryResult``s name the same genome with the same history
    and stats, bit for bit."""
    return (np.array_equal(a.genome, b.genome)
            and np.array_equal(np.asarray(a.history), np.asarray(b.history))
            and same_values(np.array([a.fitness, a.mean_ic, a.mean_rank_ic,
                                      a.spread], np.float32),
                            np.array([b.fitness, b.mean_ic, b.mean_rank_ic,
                                      b.spread], np.float32)))


def stats_and_exposures(genomes, data, group_num=5):
    """``research.fitness.generation_stats``'s body chunk by chunk,
    keeping each chunk's exposures: ``([P, 4]`` stats, ``[P, D, T]``
    exposures) on the host."""
    from replication_of_minute_frequency_factor_tpu_torch import search
    from replication_of_minute_frequency_factor_tpu_torch.research import (
        fitness)

    skel = search.DEFAULT_SKELETON
    chunk = search.auto_chunk(tuple(data.mask.shape))
    stats, vals = [], []
    for a, b in search.chunk_bounds(len(genomes), chunk):
        plan, = search.upload_plans([search.slot_groups(genomes[a:b], skel)],
                                    data.feats.device)
        v = search.evaluate_plan(plan, data.feats, data.mask, skel, b - a)
        stats.append(fitness._candidate_stats(v, data.fwd_ret,
                                              data.fwd_valid, group_num))
        vals.append(v)
    return torch.cat(stats).cpu().numpy(), torch.cat(vals).cpu().numpy()


#: the rolling ops' tolerances off their degenerate edge (the JAX
#: package's tests/test_search.py:147 and :179, which tests/test_torch_search.py
#: states): std within ROLL; corr within CORR on lanes with |r| > CORR_FAR
ROLL_RTOL, ROLL_ATOL = 2e-3, 2e-3
CORR_RTOL, CORR_ATOL, CORR_FAR = 0.05, 5e-3, 1e-3


def rolling_ops_card_vs_cpu(data, cpu_data, card: str) -> None:
    """The search's rolling std (windows 5, 30) and corr (30) on the card
    against the CPU, on the slab's close and volume: the card's prefix sum
    is ``torch.cumsum``, the CPU's XLA's association, so the two differ by
    rounding, which moves only degenerate windows. NaN positions and
    empty windows (0 in both) must agree everywhere; the rest is held off
    the degenerate edge (one valid bar for the std; |r| <= CORR_FAR on the
    CPU for the corr), and the edge lanes are counted."""
    from replication_of_minute_frequency_factor_tpu_torch import search

    def on(d):
        x, v, m = d.feats[3][None], d.feats[4][None], d.mask
        return x, v, m

    (x, v, m), (cx, cv, cm) = on(data), on(cpu_data)
    counts = {w: search._windowed_sum(cm.to(torch.float32), w)[None].numpy()
              for w in (search.ROLL_FAST, search.ROLL_SLOW)}
    for label, got, want, n, far_of in (
            ("rstd5", search.rolling_std(x, m, search.ROLL_FAST),
             search.rolling_std(cx, cm, search.ROLL_FAST),
             counts[search.ROLL_FAST], lambda w, n: n > 1.5),
            ("rstd30", search.rolling_std(x, m, search.ROLL_SLOW),
             search.rolling_std(cx, cm, search.ROLL_SLOW),
             counts[search.ROLL_SLOW], lambda w, n: n > 1.5),
            ("rcorr30", search.rolling_corr(x, v, m, search.ROLL_SLOW),
             search.rolling_corr(cx, cv, cm, search.ROLL_SLOW),
             counts[search.ROLL_SLOW],
             lambda w, n: np.abs(w) > CORR_FAR)):
        got, want = got.cpu().numpy(), want.numpy()
        if not np.array_equal(np.isnan(got), np.isnan(want)):
            fail(f"phase 12 {label}: NaN positions differ card vs CPU")
        empty = n < 0.5
        if not (np.all(got[empty] == 0) and np.all(want[empty] == 0)):
            fail(f"phase 12 {label}: an empty window is not 0")
        far = far_of(want, n) & ~np.isnan(want)
        rtol, atol = ((CORR_RTOL, CORR_ATOL) if label == "rcorr30"
                      else (ROLL_RTOL, ROLL_ATOL))
        if not np.allclose(got[far], want[far], rtol=rtol, atol=atol):
            fail(f"phase 12 {label}: card vs CPU past rtol {rtol} / atol "
                 f"{atol} off the degenerate edge")
        edge = ~far & ~empty & ~np.isnan(want)
        log(f"phase 12 {label} on the slab's close{'/volume' if 'corr' in label else ''} "
            f"({card}): NaN positions identical, {int(empty.sum())} empty "
            f"windows 0 in both, {int(far.sum())} lanes within rtol {rtol} "
            f"/ atol {atol} of the CPU; {int(edge.sum())} edge lanes, "
            f"{int((got[edge] != want[edge]).sum())} of them differ")


def device_traffic(fn):
    """Run ``fn()`` counting the device ops it dispatches (views excluded)
    and the bytes they move: every device tensor an op reads or writes
    counted once per op, at the smaller of its logical size and its
    storage (an expanded tensor is read once). Returns ``(ops, bytes)``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Traffic(TorchDispatchMode):
        ops, nbytes = 0, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                seen = {}
                for t in tree_leaves((args, kwargs, out)):
                    if isinstance(t, torch.Tensor) and t.is_cuda:
                        seen[id(t)] = min(
                            t.numel() * t.element_size(),
                            t.untyped_storage().nbytes())
                if seen:
                    Traffic.ops += 1
                    Traffic.nbytes += sum(seen.values())
            return out

    with Traffic():
        fn()
    return Traffic.ops, Traffic.nbytes


def discovery_path(card: str) -> None:
    """Phase 12: factor discovery at full width on the card — the engine
    at three population levels, its holds, and the research server; see
    the module docstring."""
    import tempfile
    import urllib.request

    from replication_of_minute_frequency_factor_tpu_torch import search
    from replication_of_minute_frequency_factor_tpu_torch.data import wire
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        DayContext, factor_names)
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling_cuda)
    from replication_of_minute_frequency_factor_tpu_torch.research import (
        DiscoveryEngine, fitness, host_forward_returns, registry)
    from replication_of_minute_frequency_factor_tpu_torch.serve import (
        FactorServer, ServeConfig, SyntheticSource, serve_frontdoor)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        Telemetry)

    log(f"phase 12 card: {card}")
    t0 = time.perf_counter()
    bars, mask = synth_batch(DISC_TICKERS, DISC_DAYS, seed=DISC_SEED)
    fwd_ret, fwd_valid = host_forward_returns(bars, mask, horizon=1)
    tel = Telemetry()
    eng = DiscoveryEngine(telemetry=tel, device="cuda")
    data = eng.prepare(bars, mask, fwd_ret, fwd_valid)
    torch.cuda.synchronize()
    chunk = search.auto_chunk(data.shape)
    log(f"phase 12 input: synth_day x {DISC_DAYS} days x {DISC_TICKERS} "
        f"tickers (seed {DISC_SEED}, cn_ashare_240) -> bars "
        f"{bars.shape}, forward returns at horizon 1, prepared in "
        f"{time.perf_counter() - t0:.2f} s; default skeleton, chunks of "
        f"{chunk} candidates")

    # 12a. the engine at each population level, each warmed first
    for pop, gens in DISC_LEVELS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rolling_cuda.reset_launches()
        t0 = time.perf_counter()
        eng.warmup(data, pop)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        res = eng.evolve(data, pop=pop, generations=gens,
                         rng=np.random.default_rng(pop))
        peak = torch.cuda.max_memory_allocated()
        walls = np.asarray(res.gen_walls_s) * 1e3
        if res.syncs_per_generation != 1.0:
            fail(f"phase 12 pop {pop}: {res.syncs_per_generation} host "
                 "syncs a generation, expected 1.0")
        if res.compiles_during_loop != 0:
            fail(f"phase 12 pop {pop}: {res.compiles_during_loop} kernel-"
                 "library builds or loads during the generation loop")
        if not (np.isfinite(res.fitness) and res.fitness > 0):
            fail(f"phase 12 pop {pop}: best fitness {res.fitness}")
        if dict(rolling_cuda.launches) != {"tiled": 0, "rowwise": 0}:
            fail(f"phase 12 pop {pop}: the search launched "
                 f"{dict(rolling_cuda.launches)}")
        log(f"phase 12 pop {pop} x {gens} generations ({card}): "
            f"{eng.last_candidates_per_s:.1f} candidates/s, generation wall "
            f"p50 {np.percentile(walls, 50):.1f} ms p99 "
            f"{np.percentile(walls, 99):.1f} ms (walls "
            f"{[round(float(w), 1) for w in walls]}), syncs_per_generation "
            f"{res.syncs_per_generation}, compiles_during_loop "
            f"{res.compiles_during_loop}, peak {peak / 2**30:.3f} GiB "
            f"({peak} B) allocated, warmup {warm_s:.2f} s; best "
            f"{search.describe(res.genome)} |IC| {res.fitness:.6f} "
            f"rank IC {res.mean_rank_ic:.6f} spread {res.spread:.6g}")

    # where one generation's wall goes (pop 512, warm)
    exe = eng._generation_exe(data, 512, eng._n_elite(512, 0.1))
    g = search.random_population(np.random.default_rng(14), 512)
    profile_main_path("discovery generation pop 512", lambda: exe(
        g, *data.device_args)[0].cpu(), card)
    ops, nbytes = device_traffic(lambda: exe(g, *data.device_args))
    torch.cuda.synchronize()
    log(f"phase 12 per candidate at pop 512 (chunks of {chunk}): "
        f"{ops / 512:.1f} device ops and {nbytes / 512 / 1e6:.1f} MB read or "
        f"written (each tensor once per op), against "
        f"{data.feats[0].numel() * 4 / 1e6:.2f} MB of one f32 series "
        f"[{', '.join(map(str, data.shape))}]; the bytes alone bound a "
        f"candidate at {nbytes / 512 / HBM_BYTES_PER_S * 1e3:.3f} ms on the "
        f"card's {HBM_BYTES_PER_S / 1e12:.2f} TB/s")

    # 12b. holds on the card: same-seed determinism, the device top-k
    pop = DISC_HOLD_POP
    a = eng.evolve(data, pop=pop, generations=2, rng=np.random.default_rng(11))
    b = eng.evolve(data, pop=pop, generations=2, rng=np.random.default_rng(11))
    if not same_discovery(a, b):
        fail("phase 12: two evolve runs with the same seed differ")
    n_elite = eng._n_elite(pop, 0.1)
    exe = eng._generation_exe(data, pop, n_elite)
    g = search.random_population(np.random.default_rng(12), pop)
    stats, top_vals, top_idx = exe(g, *data.device_args)
    fits = np.nan_to_num(stats.cpu().numpy()[:, 0], nan=-1.0)
    host = np.argsort(-fits, kind="stable")[:n_elite]
    if not (np.array_equal(top_idx.cpu().numpy(), host)
            and np.array_equal(top_vals.cpu().numpy(), fits[host])):
        fail("phase 12: the device top-k is not the host argsort's first "
             f"{n_elite}")
    log(f"phase 12 holds: two pop-{pop} evolves with seed 11 give the same "
        f"genome, history and stats bitwise; the device top-k of a pop-{pop} "
        f"generation is the host argsort's first {n_elite}")

    # 12c. the card's generation_stats against the port on the CPU
    g = cases.bounded_population(13, DISC_HOLD_POP, search.DEFAULT_SKELETON)
    card_stats = fitness.generation_stats(g, *data.device_args,
                                          search.DEFAULT_SKELETON).cpu().numpy()
    _, card_vals = stats_and_exposures(g, data)
    t0 = time.perf_counter()
    cpu_eng = DiscoveryEngine(telemetry=Telemetry(), device="cpu")
    cpu_data = cpu_eng.prepare(bars, mask, fwd_ret, fwd_valid)
    cpu_stats, cpu_vals = stats_and_exposures(g, cpu_data)
    cpu_s = time.perf_counter() - t0
    order = cases.same_order(card_vals, cpu_vals,
                             np.isfinite(cpu_vals) & fwd_valid)
    if not np.array_equal(np.isnan(card_stats), np.isnan(cpu_stats)):
        fail("phase 12: generation_stats NaN positions differ card vs CPU")
    if order.sum() <= DISC_HOLD_POP // 2:
        fail(f"phase 12: only {int(order.sum())} candidates order their "
             "exposures alike card vs CPU")
    for cols, rows in (((0, 1), slice(None)), ((2, 3), order)):
        c, w = card_stats[rows][:, cols], cpu_stats[rows][:, cols]
        ok = np.isnan(w) | (np.abs(c - w)
                            <= SEARCH_ATOL + SEARCH_RTOL * np.abs(w))
        if not ok.all():
            fail(f"phase 12: generation_stats columns {cols} differ card vs "
                 f"CPU past rtol {SEARCH_RTOL} / atol {SEARCH_ATOL}: "
                 f"{int((~ok).sum())} values")
    err = np.nanmax(np.abs(card_stats - cpu_stats))
    log(f"phase 12 generation_stats, {DISC_HOLD_POP} candidates over the "
        f"ops of bounded conditioning: card vs CPU NaN positions identical, "
        f"fitness/IC within rtol {SEARCH_RTOL} / atol {SEARCH_ATOL}, rank IC "
        f"and spread likewise on the {int(order.sum())} candidates whose card "
        f"and CPU exposures order every date alike ({int((~order).sum())} "
        f"do not); max abs diff {err:.3g}; the CPU took {cpu_s:.1f} s")
    del card_vals, cpu_vals
    rolling_ops_card_vs_cpu(data, cpu_data, card)
    del cpu_data
    del data, eng

    # 12d. the research server over phase 11's source
    names = factor_names()
    src = SyntheticSource(n_days=SERVE_DAYS, n_tickers=TICKERS, seed=0)
    d1 = SERVE_BLOCK
    with tempfile.TemporaryDirectory(prefix="chip_smoke_research_") as rdir:
        scfg = ServeConfig(research_dir=rdir, slo_latency_ms=600_000.0)
        tel = Telemetry()
        srv = FactorServer(src, names=names, telemetry=tel, serve_cfg=scfg,
                           rolling_impl="cuda", research=True, device="cuda")
        door = None
        try:
            client = srv.client(timeout=1200)
            t0 = time.perf_counter()
            ans = client.discover(0, d1, **DISC_JOB)
            job_s = time.perf_counter() - t0
            name = ans["name"]
            if ans["syncs_per_generation"] != 1.0 \
                    or ans["compiles_during_loop"] != 0:
                fail(f"phase 12 server job: {ans}")
            if not os.path.exists(ans["record_path"]) \
                    or srv.factor_list()["discovered"] != [name]:
                fail(f"phase 12 server job: record {ans['record_path']} or "
                     f"factor list {srv.factor_list()['discovered']}")
            torch.cuda.synchronize()
            rolling_cuda.reset_launches()
            t0 = time.perf_counter()
            got = client.factors(0, d1, names=(name,))
            rebuild_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = dict(rolling_cuda.launches)
            if launches != {"tiled": 1, "rowwise": 0}:
                fail(f"phase 12: the rebuild after the registration launched "
                     f"{launches}; expected one tiled launch")
            rec = registry.load_record(ans["record_path"])
            sbars, smask = src.slab(0, d1)
            buf, spec = wire.pack_arrays(wire.encode(sbars, smask).arrays)
            dbars, dmask = wire.decode(*wire.unpack(
                torch.from_numpy(buf).cuda(), spec))
            want = registry.make_kernel(rec.genome, rec.skeleton)(
                DayContext(dbars, dmask.to(torch.bool))).cpu().numpy()
            served = np.asarray(got["exposures"][name], np.float32)
            if not np.array_equal(np.isnan(served), np.isnan(want)):
                fail("phase 12: served NaN positions differ from make_kernel")
            ok = ~np.isnan(want)
            if not np.allclose(served[ok], want[ok], rtol=1e-5, atol=1e-6):
                fail("phase 12: served exposures differ from make_kernel")
            log(f"phase 12 server ({card}): discover(0, {d1}, {DISC_JOB}) -> "
                f"{name} = {ans['describe']} in {job_s:.2f} s (|IC| "
                f"{ans['fitness']:.6f}, syncs_per_generation "
                f"{ans['syncs_per_generation']}, compiles_during_loop "
                f"{ans['compiles_during_loop']}); the next factors query "
                f"rebuilt the block in {rebuild_s * 1e3:.1f} ms with launches "
                f"{launches}, its {served.shape} exposures equal make_kernel "
                f"on the block's decoded bars (NaN identical, rtol 1e-5 / "
                f"atol 1e-6, max abs diff "
                f"{float(np.max(np.abs(served[ok] - want[ok]))):.3g})")
            door = serve_frontdoor(srv, host="127.0.0.1", port=0,
                                   transport="edge")
            base = f"http://127.0.0.1:{door.server_address[1]}"
            with urllib.request.urlopen(f"{base}/v1/factors",
                                        timeout=60) as resp:
                listed = json.loads(resp.read())
            if listed != srv.factor_list():
                fail("phase 12: GET /v1/factors over the edge differs")
            req = urllib.request.Request(
                f"{base}/v1/discover", data=json.dumps(
                    {"start": 0, "end": d1, **DISC_JOB}).encode())
            with urllib.request.urlopen(req, timeout=1200) as resp:
                edge_ans = json.loads(resp.read())
            keys = ("name", "describe", "fitness", "mean_ic", "mean_rank_ic",
                    "spread", "history", "generations", "pop",
                    "syncs_per_generation", "compiles_during_loop")
            if json.dumps({k: edge_ans[k] for k in keys}) \
                    != json.dumps({k: ans[k] for k in keys}):
                fail(f"phase 12: POST /v1/discover over the edge answered "
                     f"{edge_ans}, in process {ans}")
            log("phase 12 edge on 127.0.0.1: GET /v1/factors and POST "
                "/v1/discover answer as in process")
        finally:
            if door is not None:
                door.shutdown()
            srv.close()
        tel2 = Telemetry()
        with FactorServer(src, names=names, telemetry=tel2, serve_cfg=scfg,
                          rolling_impl="cuda", research=True,
                          device="cuda") as again:
            reloaded = tel2.registry.counter_value("discover.reloaded")
            if reloaded != 1 or again.factor_list()["discovered"] != [name]:
                fail(f"phase 12: the second server reloaded {reloaded} "
                     f"records: {again.factor_list()['discovered']}")
            second = again.client(timeout=1200).factors(0, d1, names=(name,))
            if not same_values(np.asarray(second["exposures"][name]),
                               served):
                fail("phase 12: the reloaded factor answers other bits")
        log(f"phase 12 reload: a second server on the same research_dir "
            f"reloaded {int(reloaded)} record and answers {name} bitwise")


#: phase 13a: the resident year, bench.py's headline loop shape (8 batches
#: of 32 days x TICKERS on cn_ashare_240: 256 days), made from this seed
YEAR_BATCHES, YEAR_DAYS, YEAR_SEED = 8, 32, 2026
#: phase 13b: phase 8's first day files that the profiled compute reads
PROFILED_DAYS = 16


def resident_year(tables, card: str) -> dict:
    """Phase 13a: ``compute_packed_resident`` over a year on the card; see
    the module docstring. Returns the kernels line's entry for the tiled
    kernel on the year's batches."""
    from replication_of_minute_frequency_factor_tpu_torch import (
        config, pipeline)
    from replication_of_minute_frequency_factor_tpu_torch.data import (
        result_wire as rw)
    from replication_of_minute_frequency_factor_tpu_torch.data import wire
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        factor_names)
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling, rolling_cuda)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        factorplane)

    names = factor_names()
    n_days = YEAR_BATCHES * YEAR_DAYS
    # one batch's f32 bars at a time: the year is kept only as its packed
    # buffers (cases.Year makes each batch anew from its seed per pass)
    t0 = time.perf_counter()
    year = cases.Year(YEAR_SEED, YEAR_BATCHES, YEAR_DAYS, TICKERS)
    bufs, spec, kind = cases.encode_year(year)
    t_synth = time.perf_counter() - t0
    if kind != "wire" or len(bufs) != YEAR_BATCHES:
        fail(f"phase 13a: the year encoded as {kind!r} in {len(bufs)} "
             "buffers; expected one wire spec for every batch")
    nbytes = sum(b.nbytes for b in bufs)
    log(f"phase 13a input: {YEAR_BATCHES} batches x {YEAR_DAYS} days x "
        f"{TICKERS} tickers ({n_days} days, cn_ashare_240, "
        f"bench.make_batch's recipe, seed {YEAR_SEED}) made and encoded "
        f"under one floor in {t_synth:.2f} s (host): {bufs[0].nbytes} B a "
        f"buffer, {nbytes / 1e6:.1f} MB the year")
    host = [torch.from_numpy(b).pin_memory() for b in bufs]
    del bufs

    def to_card():
        return [h.to("cuda", non_blocking=True) for h in host]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dbufs = to_card()
    torch.cuda.synchronize()
    t_copy = time.perf_counter() - t0
    rolling_cuda.reset_launches()
    rolling.IMPL_COUNTS.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        ys = pipeline.compute_packed_resident(
            dbufs, spec, kind, names, rolling_impl="cuda", device="cuda")
        t_enqueue = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = dict(rolling_cuda.launches)
    impl_counts = dict(rolling.IMPL_COUNTS)
    t0 = time.perf_counter()
    fetched = ys.cpu()
    t_fetch = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if launches != {"tiled": YEAR_BATCHES, "rowwise": 0}:
        fail(f"phase 13a: the resident year launched {launches}; expected "
             f"the tiled kernel once a batch, {YEAR_BATCHES} in all")
    if impl_counts != {("cuda", "cuda"): YEAR_BATCHES}:
        fail(f"phase 13a: rolling impl resolved as {impl_counts}")
    want_shape = (YEAR_BATCHES, len(names), YEAR_DAYS, TICKERS)
    if tuple(fetched.shape) != want_shape:
        fail(f"phase 13a: result {tuple(fetched.shape)}, not {want_shape}")
    for i, name in enumerate(names):
        if not bool(torch.isfinite(fetched[:, i]).any()):
            fail(f"phase 13a: {name} has no finite value in the year")
    wall = t_enqueue + t_fetch
    log(f"phase 13a compute_packed_resident (all {len(names)}, "
        f"rolling_impl=cuda) under set_sync_debug_mode('error'): no host "
        f"sync inside the call; launches {launches}; enqueue "
        f"{t_enqueue:.3f} s, one fetch of {fetched.numel() * 4 / 1e6:.1f} "
        f"MB {t_fetch:.3f} s: {n_days / wall:.1f} days/s over {n_days} "
        f"days; the year's copy in (pinned, non-blocking) {t_copy:.3f} s; "
        f"peak {peak / 2**30:.3f} GiB allocated ({card})")

    # the donated handles are dead, and say so under debug_validate
    if not all(type(b).__name__ == "_DonatedTensor" for b in dbufs):
        fail("phase 13a: a donated buffer was not released")
    try:
        dbufs[0].sum()
        fail("phase 13a: a donated buffer was usable after the call")
    except pipeline.DonatedBufferError:
        pass
    prev = config.get_config()
    config.set_config(config.Config(debug_validate=True))
    try:
        pipeline.compute_packed_resident(dbufs, spec, kind, names,
                                         device="cuda")
        fail("phase 13a: reusing donated buffers did not raise")
    except pipeline.DonatedBufferError as e:
        if "argument 0 is a dead buffer" not in str(e):
            fail(f"phase 13a: the guard's message does not name the "
                 f"contract: {e}")
    finally:
        config.set_config(prev)
    del dbufs

    # batches 0 and 7 against the per-batch call on fresh copies
    for i in (0, YEAR_BATCHES - 1):
        one = pipeline.compute_packed_prepared(
            host[i].to("cuda", non_blocking=True), spec, kind, names,
            rolling_impl="cuda", device="cuda")
        if not cases.same_bits(one.cpu(), fetched[i]):
            fail(f"phase 13a: resident batch {i} differs from "
                 "compute_packed_prepared on the same buffer")
    log(f"phase 13a: batches 0 and {YEAR_BATCHES - 1} bitwise "
        "compute_packed_prepared on fresh copies of their buffers; the "
        "donated handles raise DonatedBufferError on use (with "
        "debug_validate: 'argument 0 is a dead buffer')")

    # the side outputs: the spill floor grown until no batch overflows
    ys_card = fetched.to("cuda")
    rspec = rw.ResultWireSpec.for_names(names, days=YEAR_DAYS)
    grown = []
    while True:
        need = 0
        for i in range(YEAR_BATCHES):
            _, v = rw.decode_block(
                rw.encode_block(ys_card[i], rspec).cpu().numpy(),
                len(names), YEAR_DAYS, TICKERS, rspec.spill_rows,
                strict=False)
            if v["overflow"]:
                need = max(need, v["widened"] + v["overflow"])
        if not need or len(grown) == 3:
            break
        grown.append(rspec.spill_rows)
        rspec = rspec.grow(need)
    rolling_cuda.reset_launches()
    payload, stats = pipeline.compute_packed_resident(
        to_card(), spec, kind, names, rolling_impl="cuda",
        result_spec=rspec, factor_stats=True, device="cuda")
    side_launches = dict(rolling_cuda.launches)
    if side_launches["tiled"] != YEAR_BATCHES:
        fail(f"phase 13a side outputs launched {side_launches}")
    for i in range(YEAR_BATCHES):
        if not torch.equal(payload[i],
                           rw.encode_block(ys_card[i], rspec)):
            fail(f"phase 13a: batch {i}'s payload is not encode_block of "
                 "its raw slice")
        if not cases.same_bits(stats[i].cpu(), factorplane.factor_stats_block(
                ys_card[i]).cpu()):
            fail(f"phase 13a: batch {i}'s stats are not "
                 "factor_stats_block of its raw slice")
    v = hold_wire_and_stats("phase 13a batch 0", names, ys_card[0],
                            payload[0], stats[0], rspec, YEAR_DAYS)
    log(f"phase 13a compute_packed_resident(result_spec, factor_stats="
        f"True): {YEAR_BATCHES} tiled launches; spill floor grown {grown} "
        f"-> {rspec.spill_rows} rows; each batch's payload "
        f"({payload.shape[1]} B, {fetched[0].numel() * 4 / payload.shape[1]:.3f}x "
        f"fewer bytes than its raw block) byte-identical to encode_block of "
        f"the raw slice, each batch's stats bitwise factor_stats_block; "
        f"batch 0 decodes within RESULT_BOUNDS ({v['widened']} slices "
        f"widened, max rel err {v['max_rel_err']:.2e})")
    # phase 14 holds its sharded runs against these batches
    year_ctx = {"host": host[:SHARDED_BATCHES], "spec": spec, "kind": kind,
                "ref": fetched[:SHARDED_BATCHES].clone(), "rspec": rspec}
    del payload, stats, fetched

    # the kernel at the year's batch shape, on batch 0's decoded bars
    bars, mask = wire.decode(*wire.unpack(host[0].to("cuda"), spec))
    low = bars[..., 2].reshape(-1, 240).contiguous()
    high = bars[..., 1].reshape(-1, 240).contiguous()
    pm = mask.reshape(-1, 240)
    del bars, mask, ys_card
    args = rolling.second_moment_inputs(low, high, pm, WINDOW)
    vmask = rolling._windowed_sum(pm, WINDOW) > WINDOW - 0.5
    err = hold_to_plain("phase 13a second_moments",
                        rolling_cuda.second_moments(*args, WINDOW),
                        rolling_cuda.second_moments_plain(*args, WINDOW),
                        vmask, 1e-5, 1e-9, constant_row=False)
    kernel_ms, plain_ms = [], []
    for dest, fn, clock in (
            (kernel_ms, rolling_cuda.second_moments, batched_times_ms),
            (plain_ms, rolling_cuda.second_moments_plain, cuda_times_ms),
            (plain_ms, rolling_cuda.second_moments_plain, cuda_times_ms),
            (kernel_ms, rolling_cuda.second_moments, batched_times_ms)):
        dest += clock(lambda: fn(*args, WINDOW))
    rows = low.shape[0]
    bound, by, mb, _ = moment_bound(rows, 240)
    log(f"phase 13a second_moments [{rows}, 240] on batch 0's decoded bars: "
        f"max_abs_err={err:.3e} vs plain; tiled {spread(kernel_ms)} "
        f"({bound / np.median(kernel_ms):.0%} of the {bound:.4f} ms bound by "
        f"{by}, {mb:.1f} MB); plain {spread(plain_ms)}; {launches['tiled']} "
        f"launches for the year ({card})")
    return {"launches": launches["tiled"], "max_abs_err": err,
            "ms": float(np.median(kernel_ms)),
            "plain_ms": float(np.median(plain_ms)), "bound_ms": bound,
            "bound_by": by}, year_ctx


def device_busy(events):
    """(summed, union) microseconds of a torch trace's device work
    (kernels, copies, fills), and the span from the first to the last."""
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        attribution)

    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in attribution.DEVICE_EVENT_CATS)
    total = sum(b - a for a, b in spans)
    union, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    return total, union, (spans[-1][1] - spans[0][0]) if spans else 0.0


def profiled_driver(tmp: Path, minute_dir: Path, names, card: str) -> None:
    """Phase 13b: the CLI's ``compute --profile-dir`` in this process over
    phase 8's first day files; see the module docstring."""
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling_cuda)
    from replication_of_minute_frequency_factor_tpu_torch.pipeline import (
        ExposureTable)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        attribution)

    files = sorted(minute_dir.glob("*.parquet"))[:PROFILED_DAYS]
    days = tmp / "kline13"
    days.mkdir()
    for f in files:
        (days / f.name).symlink_to(f)
    argv = ["compute", "--minute-dir", str(days), "--days-per-batch",
            str(DAYS_PER_BATCH), "--quiet"]
    prof, tel = tmp / "prof13", tmp / "tel13"
    rc, plain, secs_plain = run_cli(
        argv + ["--cache", str(tmp / "plain13.parquet")])
    if rc != 0 or plain["days"] != PROFILED_DAYS:
        fail(f"phase 13b: compute without the profiler gave {rc}, {plain}")
    rolling_cuda.reset_launches()
    rc, out, secs = run_cli(argv + ["--cache", str(tmp / "prof13.parquet"),
                                    "--profile-dir", str(prof),
                                    "--telemetry-dir", str(tel)])
    launches = dict(rolling_cuda.launches)
    n_batches = -(-PROFILED_DAYS // DAYS_PER_BATCH)
    if rc != 0 or out["days"] != PROFILED_DAYS:
        fail(f"phase 13b: compute --profile-dir gave {rc}, {out}")
    if launches != {"tiled": n_batches, "rowwise": 0}:
        fail(f"phase 13b: the profiled compute launched {launches}")
    a = ExposureTable.load(str(tmp / "prof13.parquet"))
    b = ExposureTable.load(str(tmp / "plain13.parquet"))
    if list(a.columns) != list(b.columns) or len(a) != len(b) or not all(
            np.array_equal(a.columns[n].view(np.int32),
                           b.columns[n].view(np.int32)) for n in names) \
            or not np.array_equal(a.columns["code"], b.columns["code"]):
        fail("phase 13b: the profiled run's exposures differ from the run "
             "without the profiler")
    trace_files = attribution.find_trace_files(str(prof))
    s = attribution.summarize_trace_dir(str(prof), top_n=None)
    block = attribution.device_time_block(str(prof))
    db = s["device_breakdown"]
    if len(trace_files) != 1 or not block["available"] \
            or db["device_events"] == 0:
        fail(f"phase 13b: {len(trace_files)} trace files, "
             f"{db['device_events']} device events, available "
             f"{block['available']}")
    ops = [r["op"] for r in db["top_ops_us"]]
    rank = next((i for i, op in enumerate(ops)
                 if "second_moments_tiled_kernel" in op), None)
    if rank is None:
        fail("phase 13b: the tiled kernel is not among the trace's ops")
    missing = {"io", "grid", "launch", "device"} \
        - set(s["stage_annotations_us"])
    if missing:
        fail(f"phase 13b: stages {sorted(missing)} are not annotated in "
             f"the trace ({sorted(s['stage_annotations_us'])})")
    with open(tel / "attribution.json") as fh:
        report = json.load(fh)
    if report["trace"]["files"] != 1:
        fail("phase 13b: attribution.json carries no trace summary")
    events, _ = attribution.load_trace_events(trace_files[0])
    total_us, union_us, span_us = device_busy(events)
    wall_s = report["reconciliation"]["wall_s"]
    capture_s = report["reconciliation"]["stages"].get("trace_capture", 0)
    kernel = ops[rank]
    log(f"phase 13b compute --profile-dir over {PROFILED_DAYS} of phase 8's "
        f"days ({n_batches} batches, {launches['tiled']} tiled launches): "
        f"{secs:.3f} s profiled against {secs_plain:.3f} s without, the "
        f"same bits; {os.path.getsize(trace_files[0]) / 1e6:.1f} MB trace, "
        f"{db['device_events']} device events; device time by class (ms): "
        + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in db["by_class_us"].items())
        + f"; busy {union_us / 1e3:.3f} ms (union; {total_us / 1e3:.3f} "
        f"summed) of the run's {wall_s:.3f} s wall: "
        f"{union_us / 1e6 / wall_s:.1%}; of the wall less the capture's own "
        f"{capture_s:.3f} s: {union_us / 1e6 / (wall_s - capture_s):.1%}; "
        f"of the span from the first device event to the last: "
        f"{union_us / span_us:.1%}; {kernel[:60]}... ranks {rank + 1} of "
        f"{len(ops)} ops at {db['top_ops_us'][rank]['us'] / 1e3:.3f} ms; "
        f"stages annotated (ms): "
        + ", ".join(f"{k} {v / 1e3:.1f}"
                    for k, v in s["stage_annotations_us"].items())
        + f"; reconciliation ok {report['reconciliation']['ok']} ({card})")


#: phase 14: the batches of phase 13a's year the sharded loops take, the
#: ranks of 14a/14b (all on the one card), the 2-D mesh, and the day files
#: of phase 8 that 14c's ``compute --mesh-tickers 2`` reads
SHARDED_BATCHES, SHARDED_RANKS, MESH_2D, MESH_DRIVER_DAYS = 2, 4, (2, 2), 16


def host_unpack(buf: np.ndarray, spec):
    """The arrays of a packed host buffer (``wire.pack_arrays``' spec)."""
    return tuple(np.frombuffer(buf, np.dtype(dt),
                               count=int(np.prod(shape, dtype=np.int64)),
                               offset=off).reshape(shape)
                 for dt, shape, off in spec)


def hold_sharded(label, names, got, ref, host, spec, kind, tables):
    """The sharded-vs-single-device bar on ``[N, F, D, T]`` blocks
    (bitwise, the JAX package's ulp pair at 16 eps): the factors that
    miss it are named with their largest gap, and every block is then
    held to the parity suite's tolerances (a miss is a reduction order,
    never a wrong value). Returns the misses."""
    from replication_of_minute_frequency_factor_tpu_torch import pipeline
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        DayContext)

    misses = cases.sharded_misses(names, got, ref)
    if not misses:
        return misses
    log(f"{label}: {len(misses)} factors miss the bitwise sharded bar; "
        "largest gaps: " + ", ".join(f"{n} {g:.3e}"
                                     for n, g in misses.items()))
    for i in range(got.shape[0]):
        dec = pipeline._decode(host[i].to("cuda"), spec, kind)
        ctx = DayContext(*dec, rolling_impl="cuda")
        kurt = {k: ref[i, names.index(k)] for k in ("shape_kurt",
                                                     "shape_kurtVol")}
        compare_blocks(f"{label} batch {i}", names,
                       torch.from_numpy(got[i]), torch.from_numpy(ref[i]),
                       tables, ctx.beta_moments()[:3], kurt=kurt,
                       pdf_ctx=ctx)
    return misses


def sharded_year(ctx, names, card: str, tables) -> dict:
    """Phase 14a/14b/14d: the sharded resident loops on ranks sharing the
    card, held against phase 13a's single-device outputs; see the module
    docstring. Returns the kernels line's entry for the tiled kernel at
    a rank's shape."""
    import tempfile

    from replication_of_minute_frequency_factor_tpu_torch.data import (
        result_wire as rw)
    from replication_of_minute_frequency_factor_tpu_torch.data import wire
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling, rolling_cuda)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        factorplane)

    spec, kind, ref, rspec = ctx["spec"], ctx["kind"], ctx["ref"].numpy(), \
        ctx["rspec"]
    n = SHARDED_BATCHES
    arrays = [host_unpack(h.numpy(), spec) for h in ctx["host"]]
    # 14d's probe first: does NCCL take two ranks on one card? (14a uses it
    # if it does)
    t0 = time.perf_counter()
    try:
        probe = cases.run_on_ranks([("p", "nccl_probe", {})], 2,
                                   device="cuda", backend="nccl",
                                   timeout_s=90)
        backend = "nccl"
        log(f"phase 14d probe: NCCL took two ranks on one card "
            f"(all-reduce {probe[0]['p']['sum']}); 14a and 14b run on NCCL")
    except (RuntimeError, TimeoutError) as e:
        backend = "gloo"
        why = [ln.strip() for ln in str(e).splitlines() if ln.strip()][-1]
        log(f"phase 14d probe: NCCL refused two ranks on one card in "
            f"{time.perf_counter() - t0:.1f} s ({why[:160]}); 14a and 14b "
            "run on gloo, staged through pinned host buffers")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        p1 = [wire.pack_sharded(a, SHARDED_RANKS) for a in arrays]
        p2 = [wire.pack_sharded_2d(a, *MESH_2D) for a in arrays]
        if len({sp for _, sp in p1}) != 1 or len({sp for _, sp in p2}) != 1:
            fail("phase 14: the shards of the year's batches differ in spec")
        np.save(tmp / "year1d.npy", np.stack([b for b, _ in p1]))
        np.save(tmp / "year.npy",
                np.stack([h.numpy() for h in ctx["host"]])[:, None])
        np.save(tmp / "year2d.npy", np.stack([b for b, _ in p2]))
        log(f"phase 14 input: batches 0-{n - 1} of phase 13a's year "
            f"({n} x {YEAR_DAYS} days x {TICKERS} tickers), their wire "
            f"arrays split into {SHARDED_RANKS} ticker shards and {MESH_2D} "
            f"tiles from the packed buffers (no encode), written for the "
            f"ranks in {time.perf_counter() - t0:.2f} s (host)")
        t0 = time.perf_counter()
        res = cases.run_on_ranks(
            [("a", "year_1d", dict(path=str(tmp / "year1d.npy"),
                                   spec=p1[0][1], kind=kind, names=names,
                                   n_logical=TICKERS, rspec=rspec)),
             ("b", "resident_2d", dict(stacks=str(tmp / "year2d.npy"),
                                       spec=p2[0][1], kind=kind,
                                       names=names, shape=MESH_2D, group=1,
                                       t_pad=TICKERS, device="cuda"))],
            SHARDED_RANKS, workdir=tmp, device="cuda", backend=backend,
            timeout_s=600)
        wall = time.perf_counter() - t0
        nccl = cases.run_on_ranks(
            [("d", "nccl_year", dict(path=str(tmp / "year.npy"), spec=spec,
                                     kind=kind, names=names, rspec=rspec,
                                     n_logical=TICKERS))],
            1, workdir=tmp, device="cuda", backend="nccl", timeout_s=300)[0]
    res = sorted(res, key=lambda r: r["a"]["coord"])
    t_local = TICKERS // SHARDED_RANKS

    # 14a: the 1-D loop
    a = [r["a"] for r in res]
    got = np.concatenate([x["ys"] for x in a], axis=-1)
    if got.shape != ref.shape:
        fail(f"phase 14a: assembled {got.shape}, not {ref.shape}")
    misses_a = hold_sharded("phase 14a", names, got, ref, ctx["host"], spec,
                            kind, tables)
    for x in a:
        if x["launches"] != {"tiled": n, "rowwise": 0}:
            fail(f"phase 14a rank {x['coord']}: launched {x['launches']}, "
                 f"not the tiled kernel once a step")
        if not x["dead"] or "donated" not in x["reuse"]:
            fail(f"phase 14a rank {x['coord']}: the donated buffers are "
                 f"usable ({x['reuse']})")
        if x["backends"]["tickers"] != backend:
            fail(f"phase 14a: the tickers group runs {x['backends']}")
        side = x["side"]
        if side["launches"]["tiled"] != n:
            fail(f"phase 14a side outputs launched {side['launches']}")
    # each rank's payload: the single-device payload's arrays, its lanes
    sizes = {x["side"]["payload"].shape for x in a}
    eps = float(np.finfo(np.float32).eps)
    stat_gap = 0.0  # the stats moments' largest gap, in eps of the value
    for i in range(n):
        one = rw.encode_block(torch.from_numpy(ref[i]).cuda(), rspec)
        full = host_unpack(one.cpu().numpy(),
                           rw.payload_spec(len(names), YEAR_DAYS, TICKERS,
                                           rspec.spill_rows))
        want_stats = factorplane.factor_stats_block(
            torch.from_numpy(ref[i]).cuda()).cpu().numpy()
        for j, x in enumerate(a):
            sl = slice(j * t_local, (j + 1) * t_local)
            mine = wire.pack_arrays((full[0][..., sl], *full[1:4],
                                     full[4][:, sl]))[0]
            if not np.array_equal(x["side"]["payload"][i], mine):
                fail(f"phase 14a batch {i} rank {j}: the payload is not the "
                     "single-device payload's arrays on its lanes")
            st = x["side"]["stats"][i]
            if not (np.array_equal(st[:, :5], want_stats[:, :5])
                    and np.array_equal(st[:, 7:], want_stats[:, 7:],
                                       equal_nan=True)):
                fail(f"phase 14a batch {i} rank {j}: stats counts/min/max "
                     "differ from the single-device sketch")
            # the moments are f64 sums over 160,000 lanes, taken in
            # another order and rounded once: held to the JAX package's
            # pin, 32 eps of the value
            with np.errstate(invalid="ignore"):
                gap = np.abs(st[:, 5:7] - want_stats[:, 5:7])
                by_value = gap / np.maximum(np.abs(want_stats[:, 5:7]),
                                            1e-6)
            fin = np.isfinite(want_stats[:, 5:7])
            if (np.isfinite(st[:, 5:7]) != fin).any():
                fail(f"phase 14a batch {i} rank {j}: stats moments' NaN "
                     "status differs from the single-device sketch")
            if (fin & ~(by_value <= 32 * eps)).any():
                f = np.flatnonzero((fin & ~(by_value <= 32 * eps)).any(1))
                fail(f"phase 14a batch {i} rank {j}: stats moments of "
                     f"{[names[k] for k in f]} past 32 eps of their value "
                     f"(largest {float(np.nanmax(by_value[f])) / eps:.1f} "
                     "eps)")
            stat_gap = max(stat_gap, float(np.nanmax(
                np.where(fin, by_value, 0.0))) / eps)
    enq = [x["enqueue_s"] for x in a]
    done = [x["done_s"] for x in a]
    waits = [x["staged_waits"] for x in a]
    peak = sum(x["peak"] for x in a)
    log(f"phase 14a compute_packed_resident_sharded on a (1, "
        f"{SHARDED_RANKS}) mesh of {SHARDED_RANKS} ranks sharing the card "
        f"(groups {a[0]['backends']}), all {len(names)} factors, {n} "
        f"batches of [{YEAR_DAYS}, {t_local}] a rank: "
        + ("bitwise phase 13a's single-device outputs on every factor"
           if not misses_a else f"{len(misses_a)} factors off the bitwise "
           "bar, all within the parity tolerances")
        + f"; tiled launches {[x['launches']['tiled'] for x in a]} (once a "
        f"step a rank); under set_sync_debug_mode('error') no host sync but "
        f"the transport's staging waits {waits}; enqueue s "
        f"{[round(v, 3) for v in enq]}, done s {[round(v, 3) for v in done]}"
        f" (four ranks sharing one card: not multi-card scaling); peak "
        f"allocated {[round(x['peak'] / 2**30, 3) for x in a]} GiB, "
        f"{peak / 2**30:.3f} GiB summed; donated handles raise; payloads "
        f"{sorted(sizes)} B each the single-device payload's arrays on the "
        f"rank's lanes, stats counts/min/max bitwise and moments within "
        f"32 eps of their value (largest {stat_gap:.2f} eps); the group's "
        f"wall with rank start-up {wall:.1f} s ({card})")
    mesh_a = a[0]["mesh"]
    log(f"phase 14a mesh block: {mesh_a['n_shards']} ranks, skew "
        f"{mesh_a['shard_skew_ratio']}, watermarks (s) "
        f"{mesh_a['shard_time_s']}")

    # 14b: the 2-D loop
    b = [r["b"] for r in res]
    rows = {}
    for x in b:
        rows.setdefault(x["coord"][0], {})[x["coord"][1]] = x["ys"]
    got2 = np.concatenate(
        [np.concatenate([rows[i][j] for j in sorted(rows[i])], axis=-1)
         for i in sorted(rows)], axis=-2)
    misses_b = hold_sharded("phase 14b", names, got2, ref, ctx["host"],
                            spec, kind, tables)
    from replication_of_minute_frequency_factor_tpu_torch import pipeline
    from replication_of_minute_frequency_factor_tpu_torch.stream import (
        carry as scarry)
    state = {k: torch.from_numpy(v).cuda()
             for k, v in scarry.init_span_state(TICKERS).items()}
    state["day"] = torch.full((TICKERS,), -1, dtype=torch.int32,
                              device="cuda")
    for i in range(n):
        state = scarry.combine_span_state(state, scarry.span_prefix_state(
            *pipeline._decode(ctx["host"][i].to("cuda"), spec, kind),
            i * YEAR_DAYS))
    t2 = TICKERS // MESH_2D[1]
    for x in b:
        j = x["coord"][1]
        for k in ("last_close", "n_bars", "has"):
            want = state[k][j * t2:(j + 1) * t2].cpu().numpy()
            if not np.array_equal(np.asarray(x["carry"][k]).view(np.uint8),
                                  want.view(np.uint8)):
                fail(f"phase 14b rank {x['coord']}: carry {k} differs from "
                     "the single-device span fold")
        if x["handoffs"] != n:
            fail(f"phase 14b rank {x['coord']}: {x['handoffs']} carry "
                 f"handoffs counted, expected one a call ({n})")
        if x["launches"] != {"tiled": n, "rowwise": 0}:
            fail(f"phase 14b rank {x['coord']}: launched {x['launches']}")
    log(f"phase 14b compute_packed_resident_2d on a {MESH_2D} mesh, one "
        f"batch a call with the carry threaded: tiles of [{YEAR_DAYS // 2}, "
        f"{t2}] "
        + ("bitwise phase 13a's outputs" if not misses_b else
           f"{len(misses_b)} factors off the bitwise bar within tolerance")
        + f"; carry_handoff dispatches {[x['handoffs'] for x in b]} a rank; "
        f"the year-end carry on every rank bitwise the single-device span "
        f"fold of the same days; mesh block axes "
        f"{b[0]['mesh']['axes'].get('days', {}).get('shard_time_s')} ({card})")

    # 14d: one NCCL rank, its tickers axis the WORLD group
    d = nccl["d"]
    if d["backend"] != "nccl" or not d["gather_ok"] \
            or d["staged_waits"] != 0:
        fail(f"phase 14d: the NCCL rank: "
             f"{dict((k, v) for k, v in d.items() if k in ('backend', 'gather_ok', 'staged_waits'))}")
    if d["loop_collectives"]["all_gather"] < 2 * n \
            or d["collectives"]["all_reduce"] < n:
        fail(f"phase 14d: the sharded loop ran {d['loop_collectives']} "
             f"collectives raw and {d['collectives']} in all; the doc_pdf "
             "gather and the side outputs' reductions did not go through "
             "the NCCL group")
    if cases.sharded_misses(names, d["ys"], ref):
        fail("phase 14d: the one-rank NCCL mesh differs from phase 13a")
    for i in range(n):
        one = torch.from_numpy(ref[i]).cuda()
        if not np.array_equal(d["payload"][i],
                              rw.encode_block(one, rspec).cpu().numpy()):
            fail(f"phase 14d batch {i}: the payload is not the "
                 "single-device payload")
        if not np.array_equal(
                d["stats"][i].view(np.int32),
                factorplane.factor_stats_block(one).cpu().numpy().view(
                    np.int32)):
            fail(f"phase 14d batch {i}: the stats are not the "
                 "single-device sketch bit for bit")
    log(f"phase 14d: a one-rank NCCL mesh whose tickers axis is the WORLD "
        f"group: all_gather (f32 and bool) and a MIN all_reduce on the "
        f"card's tensors under set_sync_debug_mode('error') with no "
        f"staging; the sharded loop's {d['loop_collectives']['all_gather']}"
        f" all_gathers (all_gather_into_tensor, the doc_pdf rank) over the "
        f"year's whole batches bitwise phase 13a, and with the side outputs"
        f" ({d['collectives']} in all, the f64 stats sums and the wire's "
        f"extremes all-reduced on NCCL) the payload byte for byte and the "
        f"stats bit for bit the single-device ones")

    # the kernel at a rank's shape, on rank 0's decoded tile of batch 0
    bars, mask = pipeline._decode(torch.from_numpy(p1[0][0][0]).cuda(),
                                  p1[0][1], kind)
    low = bars[..., 2].reshape(-1, 240).contiguous()
    high = bars[..., 1].reshape(-1, 240).contiguous()
    pm = mask.reshape(-1, 240)
    args = rolling.second_moment_inputs(low, high, pm, WINDOW)
    vmask = rolling._windowed_sum(pm, WINDOW) > WINDOW - 0.5
    err = hold_to_plain("phase 14a second_moments",
                        rolling_cuda.second_moments(*args, WINDOW),
                        rolling_cuda.second_moments_plain(*args, WINDOW),
                        vmask, 1e-5, 1e-9, constant_row=False)
    kernel_ms, plain_ms = [], []
    for dest, fn, clock in (
            (kernel_ms, rolling_cuda.second_moments, batched_times_ms),
            (plain_ms, rolling_cuda.second_moments_plain, cuda_times_ms),
            (plain_ms, rolling_cuda.second_moments_plain, cuda_times_ms),
            (kernel_ms, rolling_cuda.second_moments, batched_times_ms)):
        dest += clock(lambda: fn(*args, WINDOW))
    rows_ = low.shape[0]
    bound, by, mb, _ = moment_bound(rows_, 240)
    total = sum(x["launches"]["tiled"] for x in a)
    log(f"phase 14a second_moments [{rows_}, 240] (a rank's step) on rank "
        f"0's decoded tile: max_abs_err={err:.3e} vs plain; tiled "
        f"{spread(kernel_ms)} ({bound / np.median(kernel_ms):.0%} of the "
        f"{bound:.4f} ms bound by {by}, {mb:.1f} MB); plain "
        f"{spread(plain_ms)}; {total} launches over the {SHARDED_RANKS} "
        f"ranks' run ({card})")
    return {"launches": total, "max_abs_err": err,
            "ms": float(np.median(kernel_ms)),
            "plain_ms": float(np.median(plain_ms)), "bound_ms": bound,
            "bound_by": by}


def mesh_driver(tmp: Path, minute_dir: Path, table, names, card: str
                ) -> None:
    """Phase 14c: the CLI's ``compute --mesh-tickers 2`` in this process
    over phase 8's first day files: two spawned ranks share the card, and
    the cache is bitwise phase 8's rows of the same days."""
    from replication_of_minute_frequency_factor_tpu_torch.pipeline import (
        ExposureTable)

    files = sorted(minute_dir.glob("*.parquet"))[:MESH_DRIVER_DAYS]
    days = tmp / "kline14"
    days.mkdir()
    for f in files:
        (days / f.name).symlink_to(f)
    cache = tmp / "mesh14.parquet"
    rc, out, secs = run_cli(["compute", "--minute-dir", str(days),
                             "--days-per-batch", str(DAYS_PER_BATCH),
                             "--quiet", "--mesh-tickers", "2",
                             "--cache", str(cache)])
    if rc != 0 or out["days"] != MESH_DRIVER_DAYS or out["failed_days"]:
        fail(f"phase 14c: compute --mesh-tickers 2 gave {rc}, {out}")
    got = ExposureTable.load(str(cache))
    dates = np.unique(got.columns["date"])
    sel = np.isin(table.columns["date"], dates)
    if len(dates) != MESH_DRIVER_DAYS or int(sel.sum()) != len(got):
        fail(f"phase 14c: {len(got)} rows over {len(dates)} days against "
             f"{int(sel.sum())} rows of phase 8's cache")
    for k in ("code", "date"):
        if not np.array_equal(np.asarray(got.columns[k]),
                              np.asarray(table.columns[k])[sel]):
            fail(f"phase 14c: the {k} column differs from phase 8's")
    bad = [n for n in names
           if not np.array_equal(got.columns[n].view(np.int32),
                                 table.columns[n][sel].view(np.int32))]
    if bad:
        fail(f"phase 14c: {bad} differ from phase 8's cache")
    log(f"phase 14c compute --mesh-tickers 2 over {MESH_DRIVER_DAYS} of phase "
        f"8's day files (two spawned ranks sharing the card, gloo; rank 0 "
        f"reads, grids, encodes and scatters the shards, both compute, rank "
        f"0 gathers and writes): {len(got)} rows x {len(names)} factors "
        f"bitwise phase 8's cache of the same days; {secs:.2f} s with the "
        f"ranks' start-up ({card})")


#: phase 16: the shards of the placements (every one on cuda:0: the price of
#: the placement on one card, not scaling), the wider snapshot hold's
#: shards, the discovery population and generations, and the discovery
#: engines' device batch (a chunk that divides a shard's block, so the
#: sharded and the single-device generations cut the population alike)
PLACE_SHARDS, PLACE_SHARDS_WIDE = 2, 4
PLACE_POP, PLACE_GENS = 2048, 3
PLACE_DEVICE_BATCH = 16


def shard_kernel(day, rows: int, card: str, label: str) -> dict:
    """The tiled kernel at a shard's ``[rows, S]`` of the minute-60 prefix
    of phase 10's day (the first ``rows`` tickers): bitwise the rowwise
    kernel, within the parity suite's tolerances of its plain version,
    and the two timed in turns."""
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling, rolling_cuda)

    pb, pm = cases.prefix_day(day[0][:rows], day[1][:rows], 60)
    low = torch.from_numpy(pb[..., 2]).cuda().contiguous()
    high = torch.from_numpy(pb[..., 1]).cuda().contiguous()
    pmask = torch.from_numpy(pm).cuda()
    args = rolling.second_moment_inputs(low, high, pmask, WINDOW)
    valid = rolling._windowed_sum(pmask, WINDOW) > WINDOW - 0.5
    got = rolling_cuda.second_moments(*args, WINDOW)
    for a, b in zip(got, rolling_cuda._second_moments_rowwise(*args,
                                                              WINDOW)):
        if not cases.same_bits(a, b):
            fail(f"{label}: the tiled kernel differs from the rowwise one")
    err = hold_to_plain(label, got, rolling_cuda.second_moments_plain(
        *args, WINDOW), valid, 1e-5, 1e-9)
    kernel_ms, plain_ms = [], []
    for dest, fn, clock in (
            (kernel_ms, rolling_cuda.second_moments, batched_times_ms),
            (plain_ms, rolling_cuda.second_moments_plain, cuda_times_ms),
            (plain_ms, rolling_cuda.second_moments_plain, cuda_times_ms),
            (kernel_ms, rolling_cuda.second_moments, batched_times_ms)):
        dest += clock(lambda: fn(*args, WINDOW))
    n, s = pm.shape
    bound, by, mb, _ = moment_bound(n, s)
    log(f"{label} second_moments [{n}, {s}] on a shard's minute-60 prefix "
        f"({int(valid.sum())} valid windows): tiled bitwise rowwise, "
        f"max_abs_err={err:.3e} vs plain; tiled {spread(kernel_ms)} "
        f"({bound / np.median(kernel_ms):.0%} of the {bound:.4f} ms bound by "
        f"{by}, {mb:.1f} MB); plain {spread(plain_ms)} ({card})")
    return {"max_abs_err": err, "ms": float(np.median(kernel_ms)),
            "plain_ms": float(np.median(plain_ms)), "bound_ms": bound,
            "bound_by": by}


def snapshot_launches(engine, label: str, shards: int):
    """One exact snapshot with the launch and impl counts set to 0 just
    before and read just after: the tiled kernel once a shard, resolved
    cuda. Returns the snapshot, fetched."""
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling, rolling_cuda)

    torch.cuda.synchronize()
    rolling_cuda.reset_launches()
    rolling.IMPL_COUNTS.clear()
    exp, ready = engine.snapshot()
    torch.cuda.synchronize()
    launches, impl = dict(rolling_cuda.launches), dict(rolling.IMPL_COUNTS)
    if launches != {"tiled": shards, "rowwise": 0}:
        fail(f"{label}: launched {launches}; expected the tiled kernel "
             f"{shards} times (once a shard)")
    if impl != {("cuda", "cuda"): shards}:
        fail(f"{label}: rolling impl resolved {impl}")
    return exp.cpu().numpy(), ready.cpu().numpy()


def turn_walls(full: dict, names, n: int, tel, cache) -> dict:
    """Host walls of ``k`` unsharded engines of ``n/k`` tickers each (the
    shards' blocks of the saved day ``full``) snapshotting in turn on this
    thread and at once on ``k`` threads, a stream each: what the in-process
    mesh's turn lock avoids (``parallel/local.py``)."""
    import threading

    from replication_of_minute_frequency_factor_tpu_torch import (
        StreamEngine)

    out = {}
    for k in (PLACE_SHARDS, PLACE_SHARDS_WIDE):
        h = n // k
        engs = [StreamEngine(h, names=names, telemetry=tel,
                             rolling_impl="cuda", device="cuda",
                             executables=cache).restore(
            {key: (v if np.ndim(v) == 0 else v[i * h:(i + 1) * h])
             for key, v in full.items()}) for i in range(k)]
        streams = [torch.cuda.Stream() for _ in range(k)]

        def at_once():
            def one(e, st):
                with torch.cuda.stream(st):
                    e.snapshot()
            ts = [threading.Thread(target=one, args=a)
                  for a in zip(engs, streams)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()

        in_turn, together = [], []
        for dest, fn in ((in_turn, lambda: [e.snapshot() for e in engs]),
                         (together, at_once), (together, at_once),
                         (in_turn, lambda: [e.snapshot() for e in engs])):
            dest += wall_times_ms(fn, 3)
        out[k] = (in_turn, together)
    return out


def placements_path(day, standalone: dict, card: str):
    """Phase 16: the in-server placements on the card; see the module
    docstring. Returns the kernels line's entries for the tiled kernel at
    a shard's snapshot, 2 and 4 shards."""
    import tempfile

    from replication_of_minute_frequency_factor_tpu_torch import (
        StreamEngine, kernels, search)
    from replication_of_minute_frequency_factor_tpu_torch.data import (
        result_wire as rw)
    from replication_of_minute_frequency_factor_tpu_torch.fleet import (
        FactorFleet)
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        factor_names)
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling_cuda)
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        resident_mesh)
    from replication_of_minute_frequency_factor_tpu_torch.research import (
        DiscoveryEngine, host_forward_returns)
    from replication_of_minute_frequency_factor_tpu_torch.serve import (
        FactorServer, Query, ServeConfig, SyntheticSource)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        Telemetry)

    names = factor_names()
    day_bars, day_mask = day
    n, s = day_mask.shape
    card0 = torch.device("cuda", 0)
    log(f"phase 16 input: phase 10's day, {n} tickers x {s} slots, all "
        f"{len(names)} factors, rolling_impl=cuda; every shard on {card0}: "
        f"the times below are the price of the placement on one card, not "
        f"multi-card scaling ({card})")

    # 16a. the stream: 2 shards against the unsharded engine
    mesh = resident_mesh(PLACE_SHARDS, devices=[card0] * PLACE_SHARDS)
    mesh4 = resident_mesh(PLACE_SHARDS_WIDE,
                          devices=[card0] * PLACE_SHARDS_WIDE)
    tel = Telemetry()
    plain = StreamEngine(n, names=names, telemetry=tel, rolling_impl="cuda",
                         device="cuda")
    cache = plain.executables
    engines = {"unsharded": plain}
    engines["sharded"] = StreamEngine(n, names=names, telemetry=tel,
                                      rolling_impl="cuda", mesh=mesh,
                                      executables=cache)
    for eng in engines.values():
        eng.result_spec = rw.ResultWireSpec.for_names(
            names, spill_rows=STREAM_SPILL_ROWS, days=1)
        eng.warmup(micro_batches=(STREAM_MICRO, 12, 8), cohorts=(n,))
    sharded = engines["sharded"]
    reg = tel.registry

    def misses():
        return reg.counter_value("serve.executables", outcome="miss")

    built = misses()
    fold_ms = {k: [] for k in engines}
    snap_ms = {k: [] for k in engines}
    launches_2 = 0
    saved = {}
    lo = 0
    for stop in STREAM_SNAPSHOTS:
        while lo < stop:
            hi = min(lo + STREAM_MICRO, stop)
            b, p = cases.minutes_of(day_bars, day_mask, lo, hi)
            for label, eng in engines.items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                eng.ingest_minutes(b, p)
                end.record()
                torch.cuda.synchronize()
                if hi - lo == STREAM_MICRO:
                    fold_ms[label].append(start.elapsed_time(end))
            lo = hi
        got = snapshot_launches(sharded, f"phase 16a sharded snapshot at "
                                f"minute {stop}", PLACE_SHARDS)
        launches_2 += PLACE_SHARDS
        want = tuple(x.cpu().numpy() for x in plain.snapshot())
        if not (same_values(got[0], want[0])
                and np.array_equal(got[1], want[1])):
            fail(f"phase 16a: the sharded snapshot at minute {stop} differs "
                 "from the unsharded engine's")
        if stop in STREAM_TIMED:
            for label in ("unsharded", "sharded", "sharded", "unsharded"):
                snap_ms[label] += cuda_times_ms(
                    lambda: engines[label].snapshot(), iters=5, warmup=1)
        if stop == 120:
            saved = {k: e.save() for k, e in engines.items()}
        log(f"phase 16a minute {stop}: the {PLACE_SHARDS}-shard snapshot "
            f"launched the tiled kernel once a shard and is bitwise the "
            f"unsharded engine's (NaN lanes apart), readiness equal")
    pa, ra, sa = plain.snapshot_wire_stats()
    pb_, rb, sb = sharded.snapshot_wire_stats()
    if not (torch.equal(pa.cpu(), pb_.cpu()) and torch.equal(ra.cpu(),
                                                             rb.cpu())
            and cases.same_bits(sa.cpu(), sb.cpu())):
        fail("phase 16a: snapshot_wire_stats differs between the placements")
    log(f"phase 16a snapshot_wire_stats at minute 240: the payload "
        f"({pa.numel()} B) byte-identical, the stats bitwise")
    full = plain.save()
    differ = carry_leaves_equal(full, sharded.save())
    if differ:
        fail(f"phase 16a: the sharded carry differs at {differ}")

    # the day as 240 cohorts + advance on both placements, in turns
    cohorts = {k: StreamEngine(n, names=names, telemetry=tel,
                               rolling_impl="cuda", executables=cache,
                               **({"mesh": mesh} if k == "sharded"
                                  else {"device": "cuda"}))
               for k in engines}
    cohort_ms = {k: [] for k in engines}
    idx_all = np.arange(n, dtype=np.int32)
    for t in range(s):
        idx = np.where(day_mask[:, t], idx_all, n).astype(np.int32)
        rows = np.ascontiguousarray(day_bars[:, t])
        for label, eng in cohorts.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            eng.ingest_cohort(rows, idx)
            eng.advance()
            end.record()
            torch.cuda.synchronize()
            cohort_ms[label].append(start.elapsed_time(end))
    differ = carry_leaves_equal(full, cohorts["sharded"].save())
    if differ:
        fail(f"phase 16a: the sharded cohort day's carry differs from the "
             f"scan path's at {differ}")
    log(f"phase 16a cohort path: {s} cohorts of {n} rows + advance on "
        f"{PLACE_SHARDS} shards; every carry leaf ({len(full)}) bitwise the "
        "unsharded scan path's")
    del cohorts

    # save at 120 on one placement, restore on the other, finish the day
    for src_label, dst in (("unsharded", {"mesh": mesh}),
                           ("sharded", {"device": "cuda"})):
        eng = StreamEngine(n, names=names, telemetry=tel,
                           rolling_impl="cuda", executables=cache, **dst)
        eng.restore(saved[src_label])
        for lo in range(120, s, STREAM_MICRO):
            eng.ingest_minutes(*cases.minutes_of(
                day_bars, day_mask, lo, min(lo + STREAM_MICRO, s)))
        if carry_leaves_equal(full, eng.save()) or not same_values(
                eng.snapshot()[0].cpu().numpy(), want[0]):
            fail(f"phase 16a: the {src_label} save at minute 120 restored "
                 "onto the other placement finished differently")
    log("phase 16a restart: a save at minute 120 on either placement, "
        "restored onto the other, finished the day bitwise")
    if misses() != built:
        fail(f"phase 16a: {int(misses() - built)} callables built after "
             "warmup")

    # the 4-shard snapshot hold on the finished day
    wide = StreamEngine(n, names=names, telemetry=tel, rolling_impl="cuda",
                        mesh=mesh4, executables=cache).restore(full)
    got4 = snapshot_launches(wide, "phase 16a 4-shard snapshot",
                             PLACE_SHARDS_WIDE)
    if not (same_values(got4[0], want[0]) and np.array_equal(got4[1],
                                                             want[1])):
        fail("phase 16a: the 4-shard snapshot differs from the unsharded")
    snap4_ms = cuda_times_ms(lambda: wide.snapshot(), iters=5, warmup=1)
    turns = turn_walls(full, names, n, tel, cache)
    log(f"phase 16a {PLACE_SHARDS_WIDE} shards: a carry restored from the "
        "finished day snapshots bitwise the unsharded engine, the tiled "
        "kernel once a shard")
    log(f"phase 16a times ({card}; CUDA events on the caller's stream, "
        f"which waits for every shard's): {STREAM_MICRO}-minute fold "
        + "; ".join(f"{k} {spread(v)}" for k, v in fold_ms.items())
        + "; cohort of " + f"{n} + advance "
        + "; ".join(f"{k} {spread(v)}" for k, v in cohort_ms.items())
        + "; exact snapshot at minutes 60 and 240 "
        + "; ".join(f"{k} {spread(v)}" for k, v in snap_ms.items())
        + f"; {PLACE_SHARDS_WIDE}-shard snapshot at 240 {spread(snap4_ms)}")
    log(f"phase 16a why the shards take turns ({card}; host walls to a "
        "synchronize): k unsharded engines of n/k tickers each, restored "
        "from the finished day, snapshot in turn on one thread, and at once "
        "on k threads with a stream each: " + "; ".join(
            f"k={k}: in turn {spread(a)}, at once {spread(b)}"
            for k, (a, b) in turns.items()))
    entry2 = shard_kernel(day, n // PLACE_SHARDS, card, "phase 16a")
    entry4 = shard_kernel(day, n // PLACE_SHARDS_WIDE, card, "phase 16a")
    entry4["launches"] = PLACE_SHARDS_WIDE
    del engines, plain, sharded, wide, saved, full

    # 16b. discovery: the population over 2 shards against one device
    bars, mask = synth_batch(DISC_TICKERS, DISC_DAYS, seed=DISC_SEED)
    fwd_ret, fwd_valid = host_forward_returns(bars, mask, horizon=1)
    dmesh = resident_mesh(PLACE_SHARDS, devices=[card0] * PLACE_SHARDS)
    disc = {}
    for label, kw in (("sharded", {"mesh": dmesh}),
                      ("single", {"device": "cuda"})):
        dtel = Telemetry()
        eng = DiscoveryEngine(telemetry=dtel,
                              device_batch=PLACE_DEVICE_BATCH, **kw)
        data = eng.prepare(bars, mask, fwd_ret, fwd_valid)
        eng.warmup(data, PLACE_POP)
        disc[label] = (eng, data, dtel)
    n_elite = disc["sharded"][0]._n_elite(PLACE_POP, 0.1)
    g = search.random_population(np.random.default_rng(11), PLACE_POP)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = {k: e._generation_exe(d, PLACE_POP, n_elite)(
            g, *d.device_args) for k, (e, d, _) in disc.items()}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(outs["sharded"], outs["single"]):
        if not cases.same_bits(a.cpu(), b.cpu()):
            fail("phase 16b: the sharded generation's stats or top-k differ "
                 "from the single-device generation's at the matched chunk")
    res = {}
    for k, (e, d, _) in disc.items():
        res[k] = e.evolve(d, pop=PLACE_POP, generations=PLACE_GENS,
                          rng=np.random.default_rng(12))
    rs = res["sharded"]
    if not same_discovery(rs, res["single"]):
        fail("phase 16b: the sharded search differs from the single-device "
             "one under the same rng")
    if rs.n_shards != PLACE_SHARDS or rs.syncs_per_generation != 1.0 \
            or rs.compiles_during_loop != 0:
        fail(f"phase 16b: n_shards {rs.n_shards}, syncs a generation "
             f"{rs.syncs_per_generation}, builds {rs.compiles_during_loop}")
    topk = disc["sharded"][2].registry.counter_value(
        "mesh.collective_dispatches", label="discover_topk")
    if topk != PLACE_GENS:
        fail(f"phase 16b: {topk} top-k collectives for {PLACE_GENS} "
             "generations")
    cps = {k: PLACE_POP * PLACE_GENS / sum(r.gen_walls_s)
           for k, r in res.items()}
    log(f"phase 16b population {PLACE_POP} over {PLACE_SHARDS} shards of "
        f"{card0} (chunk {PLACE_DEVICE_BATCH}): a warm generation enqueued "
        "under set_sync_debug_mode('error'), its stats and top-k bitwise the"
        f" single-device generation's; {PLACE_GENS} generations: the same "
        f"genome and history, 1.0 sync a generation, 0 builds, "
        f"{int(topk)} top-k collectives; candidates/s sharded "
        f"{cps['sharded']:.1f} against single-device {cps['single']:.1f}; "
        "generation walls (s) " + "; ".join(
            f"{k} {r.gen_walls_s}" for k, r in res.items()) + f" ({card})")
    del disc, outs, res

    # 16c. the server over [cuda:0, cuda:0] with both placements
    src = SyntheticSource(n_days=SERVE_DAYS, n_tickers=TICKERS, seed=0)
    sbars, smask = src.slab(0, 1)
    micro = [cases.minutes_of(sbars[0], smask[0], lo, lo + SERVE_MICRO)
             for lo in range(0, SERVE_MINUTES, SERVE_MICRO)]
    want_i = standalone["intraday"]

    def hold_intraday(label, got):
        if got["minute"] != SERVE_MINUTES:
            fail(f"{label}: intraday at minute {got['minute']}")
        for nm in names:
            if not (same_values(got["exposures"][nm],
                                want_i["exposures"][nm])
                    and got["ready"][nm] == want_i["ready"][nm]):
                fail(f"{label}: intraday {nm} differs from phase 11's "
                     "standalone answer")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_place_") as rdir:
        stel = Telemetry()
        scfg = ServeConfig(slo_latency_ms=600_000.0, stream_sharded=True,
                           discover_sharded=True, research_dir=rdir)
        t0 = time.perf_counter()
        srv = FactorServer(src, names=names, telemetry=stel,
                           serve_cfg=scfg, rolling_impl="cuda", stream=True,
                           stream_batches=(SERVE_MICRO,), research=True,
                           devices=[card0] * PLACE_SHARDS)
        up_s = time.perf_counter() - t0
        try:
            gauges = {k: stel.registry.gauge_value(k) for k in
                      ("stream.carry_sharded", "discover.n_shards")}
            if gauges != {"stream.carry_sharded": PLACE_SHARDS,
                          "discover.n_shards": PLACE_SHARDS}:
                fail(f"phase 16c: gauges {gauges}")
            builds = kernels.build_count()
            torch.cuda.synchronize()
            rolling_cuda.reset_launches()
            for b, p in micro:
                srv.ingest(b, p).result(600)
            intraday = srv.submit(Query("intraday")).result(600)
            torch.cuda.synchronize()
            served = dict(rolling_cuda.launches)
            job = srv.discover(0, SERVE_BLOCK, **DISC_JOB).result(1200)
            built_loop = kernels.build_count() - builds
        finally:
            srv.close()
    if served != {"tiled": PLACE_SHARDS, "rowwise": 0}:
        fail(f"phase 16c: the intraday snapshot launched {served}")
    launches_2 += served["tiled"]
    hold_intraday("phase 16c", intraday)
    if job["n_shards"] != PLACE_SHARDS or job["syncs_per_generation"] != 1.0 \
            or job["compiles_during_loop"] != 0:
        fail(f"phase 16c discover job: {job}")
    if built_loop:
        fail(f"phase 16c: {built_loop} kernel builds or loads in the loop")
    log(f"phase 16c FactorServer(devices=[{card0}] * {PLACE_SHARDS}, "
        f"stream_sharded, discover_sharded) up in {up_s:.2f} s: gauges "
        f"{gauges}; intraday at minute {SERVE_MINUTES} bitwise phase 11's "
        f"standalone answer, the tiled kernel once a shard; a discover job "
        f"({DISC_JOB}) on {job['n_shards']} shards named {job['name']} "
        f"with {job['syncs_per_generation']} sync a generation; "
        f"kernels.build_count() in the loop {built_loop}")

    # 16d. the fleet: 2 replicas over [cuda:0] * 4, both knobs on
    fcfg = ServeConfig(slo_latency_ms=600_000.0, stream_sharded=True,
                       discover_sharded=True, cache_bytes=FLEET_CACHE_BYTES)
    fleet = FactorFleet(src, 2, names=names, serve_cfg=fcfg,
                        rolling_impl="cuda", stream=True,
                        stream_batches=(SERVE_MICRO,),
                        devices=[card0] * (2 * PLACE_SHARDS))
    try:
        for r in fleet.replicas:
            got_g = r.telemetry.registry.gauge_value("stream.carry_sharded")
            if got_g != PLACE_SHARDS or \
                    r.server.stream_engine.mesh.size != PLACE_SHARDS:
                fail(f"phase 16d {r.label}: stream.carry_sharded {got_g}")
        torch.cuda.synchronize()
        rolling_cuda.reset_launches()
        for b, p in micro:
            fleet.ingest(b, p, timeout=600)
        f_intraday = fleet.submit(Query("intraday")).result(600)
        torch.cuda.synchronize()
        routed = dict(rolling_cuda.launches)
    finally:
        fleet.close()
    if routed != {"tiled": PLACE_SHARDS, "rowwise": 0}:
        fail(f"phase 16d: the routed intraday snapshot launched {routed}")
    launches_2 += routed["tiled"]
    hold_intraday("phase 16d", f_intraday)
    log(f"phase 16d FactorFleet(2 replicas over [{card0}] * "
        f"{2 * PLACE_SHARDS}, both knobs): each replica's carry on "
        f"{PLACE_SHARDS} shards; the routed intraday answer bitwise 16c's "
        "(phase 11's), the tiled kernel once a shard")
    mesh.close()
    mesh4.close()
    dmesh.close()
    entry2["launches"] = launches_2
    return entry2, entry4


def kind_name(card: str) -> str:
    """The card's name from nvidia-smi's ``name, power.limit`` line."""
    return card.split(",")[0].strip()


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available; this smoke needs an NVIDIA GPU")
    from replication_of_minute_frequency_factor_tpu_torch import (
        compute_batch, kernels, pipeline, wire)
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        DayContext, factor_names)
    from replication_of_minute_frequency_factor_tpu_torch.pipeline import (
        compute_packed_prepared)
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling, rolling_cuda)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0].strip()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}; count {torch.cuda.device_count()}; torch "
        f"{torch.__version__}; CUDA {torch.version.cuda}; python "
        f"{sys.version.split()[0]}")
    tables = parity_tables()

    # 2. build
    t0 = time.perf_counter()
    paths = kernels.build()
    log(f"build: {time.perf_counter() - t0:.3f} s for {len(paths)} "
        f"kernel source(s) into {kernels.BUILD_DIR}")
    for name, text in kernels.BUILD_LOGS.items():
        for line in text.strip().splitlines():
            log(f"nvcc[{name}]: {line.strip()}")
        spills = [m.group(0) for m in re.finditer(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
            if m.group(1) != "0" or m.group(2) != "0"]
        if spills:
            fail(f"ptxas reports register spills in {name}: {spills}")
    if set(kernels.BUILD_LOGS) != set(paths):
        log(f"build: {sorted(set(paths) - set(kernels.BUILD_LOGS))} were "
            "already built; no ptxas report for them in this run")

    # 3. kernels vs plain version on the card; tiled vs rowwise bit for bit.
    # The kernels line holds each kernel at the shape and window of the path
    # its launches are counted on: the tiled one at the host driver's batch
    # (phase 8: DAYS_PER_BATCH days of TICKERS padded to the ticker bucket),
    # the rowwise one at phase 4b's [DAYS * TICKERS, 240], window 20.
    rows = DAYS * TICKERS
    tp = pipeline._pad_bucket(TICKERS)
    drv_rows, drv_pad = DAYS_PER_BATCH * tp, (tp, TICKERS)
    args, max_err = check_moments(drv_rows, 240, seed=1, pad=drv_pad)
    for r_, L in ((rows, 240), (rows, 390), (8000, 1440), (12347, 240),
                  (4001, 150), (3, 240), (5, 40)):
        check_moments(r_, L, seed=L + r_)
    check_other_window(4001, 240, seed=20)
    args20, max_err_rows = check_other_window(rows, 240, seed=21)
    for L in (240, 390, 150, 1440):
        before = dict(rolling_cuda.launches)
        res = rolling._smoke(device="cuda", length=L)
        if launched(before) != {"tiled": res["checks"] // 2, "rowwise": 0}:
            fail(f"rolling._smoke L={L}: launches {launched(before)}, "
                 "expected the tiled kernel once per seed")
        log(f"rolling._smoke L={L} impls={res['impls']}: "
            f"{res['checks']} checks ok, through the tiled kernel")
    # the kernels line's times: each kernel through the wrapper (20 launches
    # per event pair) in turns with its plain version (one call per pair)
    line = {}
    for variant, r_, a_, w in (("tiled", drv_rows, args, WINDOW),
                               ("rowwise", rows, args20, OTHER_WINDOW)):
        kernel_ms, plain_ms = [], []
        for dest, fn, clock in (
                (kernel_ms, rolling_cuda.second_moments, batched_times_ms),
                (plain_ms, rolling_cuda.second_moments_plain, cuda_times_ms),
                (plain_ms, rolling_cuda.second_moments_plain, cuda_times_ms),
                (kernel_ms, rolling_cuda.second_moments, batched_times_ms)):
            dest += clock(lambda: fn(*a_, w))
        bound, by, _, _ = moment_bound(r_, 240, w)
        line[variant] = {"ms": float(np.median(kernel_ms)),
                         "plain_ms": float(np.median(plain_ms)),
                         "bound_ms": bound, "bound_by": by}
        log(f"second_moments [{r_}, 240] window {w} on {card}: {variant} "
            f"kernel {spread(kernel_ms)} ({bound / np.median(kernel_ms):.0%}"
            f" of the {bound:.4f} ms bound by {by}); plain {spread(plain_ms)}")
    del args, args20, a_
    # the two kernels in turns at window 50, 20 launches per event pair
    for r_, L in ((drv_rows, 240), (rows, 240), (rows, 390), (8000, 1440)):
        time_moments(r_, L, card, pad=drv_pad if r_ == drv_rows else None)

    # 4. the main path at full width
    t0 = time.perf_counter()
    bars, mask = synth_batch(TICKERS, DAYS, seed=2024, missing_prob=0.02,
                             zero_volume_prob=0.01, constant_price_codes=10,
                             short_day_codes=10)
    log(f"synth_day + grid_day: bars {bars.shape} in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    names = factor_names()
    compute_batch(bars[:1], mask[:1], device="cuda", rolling_impl="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rolling_cuda.reset_launches()
    rolling.IMPL_COUNTS.clear()
    t0 = time.perf_counter()
    out = compute_batch(bars, mask, device="cuda", rolling_impl="cuda")
    torch.cuda.synchronize()
    walls = [(time.perf_counter() - t0) * 1e3]
    launches = dict(rolling_cuda.launches)
    impl_counts = dict(rolling.IMPL_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    walls += wall_times_ms(lambda: compute_batch(
        bars, mask, device="cuda", rolling_impl="cuda"), 9)
    resolved = ", ".join(f"{req}->{res}: {n}"
                         for (req, res), n in impl_counts.items())
    log(f"compute_batch {tuple(out.shape)} rolling_impl=cuda: wall "
        f"{spread(walls)}, peak {peak / 2**30:.3f} GiB allocated, "
        f"second_moments launches {launches} (first call), rolling impl "
        f"{resolved} ({card})")
    if tuple(out.shape) != (len(names), DAYS, TICKERS):
        fail(f"compute_batch returned {tuple(out.shape)}")
    if launches != {"tiled": 1, "rowwise": 0}:
        fail(f"the main path launched {launches}; expected the tiled "
             "second_moments kernel once")
    if impl_counts != {("cuda", "cuda"): 1}:
        fail(f"rolling impl resolved as {impl_counts}, expected cuda once")
    for i, name in enumerate(names):
        if not bool(torch.isfinite(out[i]).any()):
            fail(f"{name}: no finite value in the whole batch")

    ref = compute_batch(bars, mask, device="cuda", rolling_impl="torch")
    walls_plain = wall_times_ms(lambda: compute_batch(
        bars, mask, device="cuda", rolling_impl="torch"), 10)
    ctx = DayContext(torch.from_numpy(bars).cuda(),
                     torch.from_numpy(mask).cuda(), rolling_impl="torch")
    beta = ctx.beta_moments()[:3]
    worst, n_bitwise, _ = compare_blocks("cuda-vs-torch", names, out, ref,
                                         tables, beta)
    log(f"compute_batch rolling_impl=torch: wall {spread(walls_plain)}; "
        f"all {len(names)} factors agree with the kernel run (NaN/inf "
        f"positions identical; {n_bitwise} bitwise equal; worst value used "
        f"{worst:.2e} of its tolerance) ({card})")
    del out, ref, ctx, beta

    # 4b. the generic-window path through the rowwise kernel
    low = torch.from_numpy(bars[..., 2]).cuda().float().contiguous()
    high = torch.from_numpy(bars[..., 1]).cuda().float().contiguous()
    present = torch.from_numpy(mask).cuda()
    torch.cuda.synchronize()
    rolling_cuda.reset_launches()
    st = rolling.rolling_window_stats(low, high, present, OTHER_WINDOW,
                                      impl="cuda")
    torch.cuda.synchronize()
    other_launches = dict(rolling_cuda.launches)
    if other_launches != {"tiled": 0, "rowwise": 1}:
        fail(f"rolling_window_stats window={OTHER_WINDOW} launched "
             f"{other_launches}; expected the rowwise kernel once")
    ref_st = rolling.rolling_window_stats(low, high, present, OTHER_WINDOW,
                                          impl="torch")
    v = st["valid"]
    if not bool(v.any()) or not torch.equal(v, ref_st["valid"]):
        fail(f"rolling_window_stats window={OTHER_WINDOW}: validity differs "
             "from the plain run or is empty")
    for k in ("cov", "var_x", "var_y"):
        torch.testing.assert_close(st[k][v], ref_st[k][v], rtol=1e-5,
                                   atol=1e-9)
    log(f"rolling_window_stats {tuple(low.shape)} window={OTHER_WINDOW}: "
        f"launches {other_launches}; cov/var agree with the plain run on "
        f"{int(v.sum())} valid lanes ({card})")
    del low, high, present, st, ref_st, v

    # 4c. the packed path: the ingest wire and the raw buffer
    wire_path(bars, mask, card)

    # 5. where the main path's device time goes, raw bars and the wire
    profile_main_path("compute_batch", lambda: compute_batch(
        bars, mask, device="cuda", rolling_impl="cuda"), card)
    buf, spec = wire.pack_arrays(wire.encode(bars, mask).arrays)
    profile_main_path("compute_packed_prepared(wire)", lambda:
                      compute_packed_prepared(buf, spec, "wire",
                                              device="cuda",
                                              rolling_impl="cuda"), card)
    del buf, spec

    # 6. the sort-based ops at full width, card against CPU
    sort_ops_full_width(bars, mask, card)

    # 7. the card against the CPU on small batches at three sessions
    n_edge = card_vs_cpu(tables, names, card)
    log(f"card vs CPU: {n_edge} doc_pdf lanes in all differed, each inside "
        f"the PDF_EDGE_EPS = {tables['PDF_EDGE_EPS']} band")

    # 8. the host driver at full width (and 9b, on its files and cache)
    driver_launches = host_driver(names, tables, card)

    # 9a. the evaluation ops at full width
    eval_ops_full_width(tables, card)

    # 10. the intraday streaming engine at full width, and the packed
    # path's side outputs
    stream_line = streaming_path(bars, mask, tables, card)
    stream_day = (bars[0].copy(), mask[0].copy())
    del bars, mask

    # 11. the factor server at full width
    serve_line, standalone = serve_path(tables, card)

    # 12. factor discovery at full width
    discovery_path(card)

    # 13a. the resident year (13b ran inside phase 8's directory)
    year_line, year_ctx = resident_year(tables, card)

    # 14. the sharded resident year on ranks (14c ran inside phase 8's
    # directory)
    t0 = time.perf_counter()
    sharded_line = sharded_year(year_ctx, names, card, tables)
    log(f"phase 14a/b/d wall (ranks' start-up included): "
        f"{time.perf_counter() - t0:.1f} s")
    del year_ctx

    # 15. the fleet: two replicas sharing the card, and the CLI's fleet
    t0 = time.perf_counter()
    fleet_line = fleet_path(standalone, card)
    fleet_cli(card)
    log(f"phase 15 wall: {time.perf_counter() - t0:.1f} s")

    # 16. the in-server placements: shards sharing the card
    t0 = time.perf_counter()
    place_line, place_wide_line = placements_path(stream_day, standalone,
                                                  card)
    del standalone, stream_day
    log(f"phase 16 wall: {time.perf_counter() - t0:.1f} s")

    src = "replication_of_minute_frequency_factor_tpu_torch/csrc/" \
          "rolling_moments.cu"
    tpu = "replication_of_minute_frequency_factor_tpu/ops/rolling_pallas.py:113"
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": src,
        "replaces": tpu,
        "launches": n,
        "max_abs_err": err,
        **line[variant],
        "library_ms": None,
    } for name, variant, n, err in (
        ("second_moments", "tiled", driver_launches["tiled"], max_err),
        ("second_moments_rowwise", "rowwise", other_launches["rowwise"],
         max_err_rows))] + [{
        "name": name,
        "route": "cuda",
        "source": src,
        "replaces": tpu,
        **entry,
        "library_ms": None,
    } for name, entry in (("second_moments_stream_snapshot", stream_line),
                          ("second_moments_serve_block", serve_line),
                          ("second_moments_resident_year", year_line),
                          ("second_moments_sharded_year", sharded_line),
                          ("second_moments_fleet_replica_block_build",
                           fleet_line),
                          ("second_moments_sharded_stream_snapshot",
                           place_line),
                          ("second_moments_sharded_stream_snapshot_4",
                           place_wide_line))]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
