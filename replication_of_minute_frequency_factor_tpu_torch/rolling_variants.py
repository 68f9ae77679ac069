"""Design variants of the tiled rolling second-moment kernel, timed on the
card.

Run on a machine with an NVIDIA GPU, from the root of a checkout::

    python3 -m replication_of_minute_frequency_factor_tpu_torch.rolling_variants

Each variant is ``csrc/rolling_moments.cu`` with one edit (:data:`VARIANTS`),
built with ``kernels.NVCC_FLAGS`` into ``build/kernels/variants/``, one
``nvcc`` per variant, all started together. At each timed shape the rowwise
kernel, the shipped tiled kernel and every variant are timed in turns
(forward, then backward), each sample one pair of CUDA events around 20
launches divided by 20, and printed beside the bound. Variants that still
compute the function are first held bit for bit to the shipped kernel. The
two diagnostic variants give wrong outputs by design and are only timed:
``compute_only`` stages a block's first group and no other, so it shows
the compute alone; ``memory_only`` drops the FP32 term loop, so it shows
the copies, mean reads and stores alone. The script also prints the
shipped kernel's SASS instruction census (``cuobjdump``) and the card's SM
clock and power draw while the kernel runs back to back. It exits
non-zero without a card.
"""

from __future__ import annotations

import collections
import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import kernels
from .ops import rolling, rolling_cuda

W = rolling_cuda.TILED_WINDOW
SHAPES = ((40000, 240), (40000, 390), (8000, 1440))
SAMPLES, LAUNCHES = 4, 20
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12

#: variant name -> (exact source text, replacement) edits of the shipped
#: source; each text must occur exactly once
VARIANTS = {
    "k8": [("constexpr int kSlots = 4;", "constexpr int kSlots = 8;")],
    "threads256": [
        ("constexpr int kTiledThreads = 128;",
         "constexpr int kTiledThreads = 256;"),
        ("constexpr int kTiledMinBlocks = 6;",
         "constexpr int kTiledMinBlocks = 3;")],
    "compute_only": [("    if (next < a.groups) {\n      stage_rows<V>",
                      "    if (next < 0) {\n      stage_rows<V>")],
    "memory_only": [
        ("  accumulate_span<W, K>(st, st + plane, m0, mx, my, sxx, syy, "
         "sxy);",
         "  for (int k = 0; k < K; ++k) {\n"
         "    sxx[k] = st[m0 + k] + mx[k];\n"
         "    syy[k] = st[plane + m0 + k] + my[k];\n"
         "  }")],
}
DIAGNOSTIC = ("compute_only", "memory_only")
VARIANT_DIR = kernels.BUILD_DIR / "variants"


def variant_source(name: str) -> str:
    src = (kernels.CSRC_DIR / kernels.SOURCES["rolling_moments"]).read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: the edit's text occurs "
                               f"{src.count(old)} times in the source")
        src = src.replace(old, new)
    return src


def build_variants():
    """{name: ctypes tiled entry} for every variant, built in parallel."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        cu = VARIANT_DIR / f"rolling_moments_{name}.cu"
        cu.write_text(variant_source(name))
        so = VARIANT_DIR / f"librolling_moments_{name}.so"
        procs[name] = (subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    entries = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        regs = sorted(set(re.findall(r"Used (\d+) registers", log)))
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
        print(f"variant {name}: built; registers {regs}, spill-store bytes "
              f"{spills}", flush=True)
        fn = ctypes.CDLL(str(so)).rolling_second_moments_tiled
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def moment_inputs(rows: int, L: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    close = 10 * torch.exp(torch.cumsum(
        torch.randn(rows, L, generator=g, device="cuda") * 1e-3, -1))
    mask = torch.rand(rows, L, generator=g, device="cuda") > 0.05
    return rolling.second_moment_inputs(close * 0.999, close * 1.001, mask, W)


def call_entry(fn, args):
    outs = [torch.empty_like(args[0]) for _ in range(3)]
    L = args[0].shape[-1]
    rc = fn(*(t.data_ptr() for t in args), *(o.data_ptr() for o in outs),
            args[0].numel() // L, L, W,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant launch failed: cudaError {rc}")
    return outs


def batched_ms(fn):
    fn()
    out = []
    for _ in range(SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LAUNCHES):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / LAUNCHES)
    return out


def sass_census():
    """Per kernel of the shipped library: SASS instructions by opcode."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("sass: cuobjdump not found; census not measured")
        return
    lib = kernels.library_path("rolling_moments")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = collections.defaultdict(collections.Counter), None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+"
                     r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if m and cur:
            counts[cur][m.group(1)] += 1
    for fn, c in counts.items():
        kind = "tiled" if "tiled" in fn else "rowwise"
        vec = re.search(r"ILi50ELi(\d+)ELi(\d+)E", fn)
        tag = f"{kind} K={vec.group(1)} V={vec.group(2)}" if vec else kind
        top = ", ".join(f"{k} {n}" for k, n in c.most_common(8))
        print(f"sass {tag}: {sum(c.values())} instructions; FP32 "
              f"{c['FFMA'] + c['FADD']} (FFMA {c['FFMA']}, FADD "
              f"{c['FADD']}); shared loads {c['LDS']}; top: {top}")


def clocks_under_load(args, seconds: float = 3.0):
    """SM clock (MHz) and power draw (W) sampled by nvidia-smi while the
    shipped kernel runs back to back."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, text=True)
    t0, n = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        for _ in range(100):
            rolling_cuda.second_moments(*args, W)
        torch.cuda.synchronize()
        n += 100
    smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines()
            if line.strip()]
    clk = [float(r[0]) for r in rows[2:]]  # the first samples are ramp-up
    pwr = [float(r[1]) for r in rows[2:]]
    if not clk:
        print("clocks: no nvidia-smi samples; not measured")
        return
    print(f"clocks under load ({n} launches in {seconds} s): SM "
          f"{min(clk):.0f}-{max(clk):.0f} MHz (median {np.median(clk):.0f}), "
          f"power {min(pwr):.1f}-{max(pwr):.1f} W (median "
          f"{np.median(pwr):.1f})")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("rolling_variants: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernels.build()
    entries = build_variants()
    sass_census()
    for rows, L in SHAPES:
        args = moment_inputs(rows, L, rows + L)
        shipped = rolling_cuda.second_moments(*args, W)
        for name, fn in entries.items():
            if name in DIAGNOSTIC:
                continue
            got = call_entry(fn, args)
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(got, shipped)):
                sys.exit(f"variant {name} [{rows}, {L}] differs from the "
                         "shipped kernel")
        fns = {"rowwise": lambda: rolling_cuda._second_moments_rowwise(
                   *args, W),
               "tiled": lambda: rolling_cuda.second_moments(*args, W)}
        fns.update({n: (lambda f=f: call_entry(f, args))
                    for n, f in entries.items()})
        times = {n: [] for n in fns}
        for n in list(fns) + list(fns)[::-1]:
            times[n] += batched_ms(fns[n])
        bound = max(7 * rows * L * 4 / HBM_BYTES_PER_S,
                    5 * W * rows * L / (F32_FLOPS_PER_S / 2)) * 1e3
        print(f"[{rows}, {L}] bound {bound:.4f} ms ({card}):", flush=True)
        for n, t in times.items():
            med = float(np.median(t))
            print(f"  {n:13s} median {med:.4f} ms (min {min(t):.4f}, max "
                  f"{max(t):.4f}, n={len(t)}), {bound / med:.0%} of bound",
                  flush=True)
    clocks_under_load(moment_inputs(*SHAPES[0], 1))


if __name__ == "__main__":
    main()
