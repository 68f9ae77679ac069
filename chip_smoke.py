#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It imports
nothing of JAX or of the JAX package, builds the port's CUDA kernels from
the checkout's sources, and runs in phases; any failure exits non-zero:

1. device — requires CUDA; prints the card's name and power limit
   (nvidia-smi) and the torch and CUDA versions;
2. build — every kernel from ``csrc/`` (one nvcc per source, started
   together), with ptxas' register/shared-memory report;
3. kernels vs their plain torch versions on the card, at the main path's
   shapes and at every registered slot count (timed with CUDA events);
4. the main path at full width — ``synth_day`` → ``grid_day`` →
   ``compute_batch`` for 5000 tickers x 8 days on ``cn_ashare_240`` —
   through the kernel (launch counts reset just before, read just after)
   and held against the same batch through the plain version;
5. where one main-path call spends its device time (``torch.profiler``);
6. the card against the CPU on a small batch (the CPU path is the one
   the tests hold against the JAX package).

The second-to-last line of stdout is a JSON object with one entry per
kernel; the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
WINDOW = 50
TICKERS, DAYS = 5000, 8
#: H100 SXM peaks (NVIDIA data sheet) used for the kernels' bound_ms
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


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
            "DEGENERATE_KURT"}
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


def moment_case(rows: int, L: int, seed: int):
    """Second-moment inputs at ``[rows, L]`` on the card, made the way the
    main path makes them: a close random walk, low/high at -/+0.1%, 5%
    missing bars, row 0 full and row 1 full and constant."""
    from replication_of_minute_frequency_factor_tpu_torch.ops import rolling

    g = torch.Generator(device="cuda").manual_seed(seed)
    steps = torch.randn(rows, L, generator=g, device="cuda") * 1e-3
    close = 10.0 * torch.exp(torch.cumsum(steps, dim=-1))
    low, high = close * 0.999, close * 1.001
    mask = torch.rand(rows, L, generator=g, device="cuda") > 0.05
    mask[:2] = True
    low[1], high[1] = low[1, 0], high[1, 0]
    valid = rolling._windowed_sum(mask, WINDOW) > WINDOW - 0.5
    return rolling.second_moment_inputs(low, high, mask, WINDOW), valid


def check_moments(rows: int, L: int, seed: int, rtol=1e-5, atol=1e-9):
    """Kernel vs plain version on valid lanes; exactly-zero variance on
    the constant row. Returns (inputs, max_abs_err)."""
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling_cuda)

    args, valid = moment_case(rows, L, seed)
    got = rolling_cuda.second_moments(*args, WINDOW)
    torch.cuda.synchronize()
    want = rolling_cuda.second_moments_plain(*args, WINDOW)
    err = 0.0
    for name, a, b in zip(("s_xx", "s_yy", "s_xy"), got, want):
        a, b = a[valid], b[valid]
        if not bool(torch.isfinite(a).all()):
            fail(f"second_moments {rows}x{L}: non-finite {name}")
        diff = (a - b).abs()
        bad = diff > atol + rtol * b.abs()
        if bool(bad.any()):
            fail(f"second_moments {rows}x{L}: {name} disagrees with the "
                 f"plain version at {int(bad.sum())} lanes (max |diff| "
                 f"{float(diff.max()):.3e})")
        err = max(err, float(diff.max()))
    if any(float(s[1][valid[1]].abs().max()) != 0.0 for s in got):
        fail(f"second_moments {rows}x{L}: the constant row's moments are "
             "not exactly zero")
    log(f"kernel second_moments rows={rows} L={L}: max_abs_err={err:.3e} "
        f"(rtol {rtol}, atol {atol} on valid lanes) ok")
    return args, err


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


def compare_blocks(label, names, got, ref, tables, beta, noisy=False,
                   kurt=None):
    """Per factor: identical NaN and inf positions (and inf signs), and
    finite values within the CPU parity suite's tolerances. ``beta`` is
    the reference run's ``(mean, std, last)`` beta moments: the beta
    z-score factors skip sub-noise numerators and widen rtol as
    tests/test_parity.py does. Returns the largest share of its
    tolerance any compared value used, and how many factors are bitwise
    equal."""
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
    worst, n_bitwise = 0.0, 0
    for i, name in enumerate(names):
        a, b = got[i], ref[i]
        n_bitwise += int(np.array_equal(a, b, equal_nan=True))
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            fail(f"{label}/{name}: NaN positions differ "
                 f"({int((np.isnan(a) != np.isnan(b)).sum())} lanes)")
        if not np.array_equal(np.where(np.isinf(a), np.sign(a), 0),
                              np.where(np.isinf(b), np.sign(b), 0)):
            fail(f"{label}/{name}: inf positions or signs differ")
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
    return worst, n_bitwise


def profile_main_path(compute_batch, bars, mask, card: str) -> None:
    """One full-width ``compute_batch`` call under ``torch.profiler``:
    device time by kernel (and copy) name, and the device's busy share of
    the call's wall time (the profiler's own overhead is in that wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        compute_batch(bars, mask, device="cuda", rolling_impl="cuda")
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
    log(f"profile: wall {wall_us / 1e3:.3f} ms, device busy "
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
            log(f"profile {kind}: {us / 1e3:8.3f} ms {us / busy:6.1%} "
                f"x{n:<4d} {key}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available; this smoke needs an NVIDIA GPU")
    from replication_of_minute_frequency_factor_tpu_torch import (
        compute_batch, kernels)
    from replication_of_minute_frequency_factor_tpu_torch.markets import (
        get_session)
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        DayContext, factor_names)
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

    # 3. kernel vs plain version on the card
    rows = DAYS * TICKERS
    args, max_err = check_moments(rows, 240, seed=1)
    for r_, L in ((rows, 390), (8000, 1440), (12347, 240), (3, 240)):
        check_moments(r_, L, seed=L + r_)
    for L in (240, 390, 150, 1440):
        res = rolling._smoke(device="cuda", length=L)
        log(f"rolling._smoke L={L} impls={res['impls']}: "
            f"{res['checks']} checks ok")
    # in turns (kernel, plain, plain, kernel), per-call CUDA events
    kernel_ms, plain_ms = [], []
    for dest, fn in ((kernel_ms, rolling_cuda.second_moments),
                     (plain_ms, rolling_cuda.second_moments_plain),
                     (plain_ms, rolling_cuda.second_moments_plain),
                     (kernel_ms, rolling_cuda.second_moments)):
        dest += cuda_times_ms(lambda: fn(*args, WINDOW))
    ms, plain = float(np.median(kernel_ms)), float(np.median(plain_ms))
    n_bytes = 7 * rows * 240 * 4
    n_flops = 8 * WINDOW * rows * 240
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    log(f"second_moments [{rows}, 240] on {card}: kernel "
        f"{spread(kernel_ms)}; plain {spread(plain_ms)}; bound "
        f"{max(t_bytes, t_ops):.4f} ms ({n_bytes / 1e6:.1f} MB moved, "
        f"{n_flops / 1e9:.2f} GFLOP f32)")
    del args

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
    launches = rolling_cuda.launches
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
    if launches < 1:
        fail("the main path never launched the second_moments kernel")
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
    worst, n_bitwise = compare_blocks("cuda-vs-torch", names, out, ref,
                                      tables, beta)
    log(f"compute_batch rolling_impl=torch: wall {spread(walls_plain)}; "
        f"all {len(names)} factors agree with the kernel run (NaN/inf "
        f"positions identical; {n_bitwise} bitwise equal; worst value used "
        f"{worst:.2e} of its tolerance) ({card})")
    del out, ref, ctx, beta

    # 5. where the main path's device time goes
    profile_main_path(compute_batch, bars, mask, card)

    # 6. the card against the CPU on a small batch, both sessions' shapes
    for sess, seed in (("cn_ashare_240", 7), ("us_390", 8)):
        sb, sm = synth_batch(16, 2, seed=seed, session=sess,
                             missing_prob=0.05, zero_volume_prob=0.05,
                             constant_price_codes=2, short_day_codes=2)
        got = compute_batch(sb, sm, session=sess, device="cuda",
                            rolling_impl="cuda")
        want = compute_batch(sb, sm, session=sess, device="cpu")
        cctx = DayContext(torch.from_numpy(sb), torch.from_numpy(sm),
                          rolling_impl="torch", session=get_session(sess))
        kurt = {n: want[names.index(n)].double().numpy()
                for n in ("shape_kurt", "shape_kurtVol")}
        worst, n_bitwise = compare_blocks(
            f"card-vs-cpu/{sess}", names, got, want, tables,
            cctx.beta_moments()[:3], noisy=True, kurt=kurt)
        log(f"card vs CPU {sess} {tuple(got.shape)}: agree ({n_bitwise} "
            f"bitwise equal; worst value used {worst:.2e} of its "
            "tolerance)")

    print(json.dumps({"kernels": [{
        "name": "second_moments",
        "route": "cuda",
        "source": "replication_of_minute_frequency_factor_tpu_torch/csrc/"
                  "rolling_moments.cu",
        "replaces": "replication_of_minute_frequency_factor_tpu/ops/"
                    "rolling_pallas.py:113",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
