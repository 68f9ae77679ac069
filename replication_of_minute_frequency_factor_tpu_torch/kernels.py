"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``csrc/`` compiles with ``nvcc`` for Hopper
(``sm_90a``) into a shared library of its own with a plain C interface,
loaded here with ctypes: no PyTorch headers, so a build takes seconds.
Libraries go to ``build/kernels/`` at the checkout root, named by a hash
of the source and the flags, so an edited source builds anew. A library
builds on first use, or up front through :func:`build`, which starts one
``nvcc`` per source, all at once.

:data:`LIBRARIES` declares each library once: its source, its C entries
and their argument types (set once, when the library loads), the key
under which the trace tier counts its launches, and whether a
``DayContext`` on a card launches it. Every entry returns a
``cudaError_t`` as an int and takes the stream last; every library
exports :data:`ERROR_STRING`. :func:`launch` is the one way a wrapper
reaches an entry, and :data:`LAUNCHES` counts what it launched.
:func:`device_path` is the one rule that sends a wrapper's tensors to its
plain version or to a kernel.

:data:`COUNTS` counts what this process really builds: each ``nvcc`` run
(``build``) and each ``dlopen`` of a library (``load``).
:func:`build_count` is their sum, the count the serving layer's warm
gates and discovery's ``compiles_during_loop`` read (the JAX package
reads ``xla.compiles`` there). Torch itself compiles nothing.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@dataclass(frozen=True)
class Library:
    """One kernel library: ``source`` under ``csrc/``; ``entries``, each C
    entry's argument types, the stream last; ``trace_key``, the
    fingerprint key the trace tier counts its launches under; and
    ``rolling_impl``, the ``Config.rolling_impl`` under which a
    ``DayContext`` on a card launches it (None: whatever it says)."""

    source: str
    entries: Dict[str, Tuple[type, ...]]
    trace_key: str
    rolling_impl: Optional[str] = None


#: kernel library name -> its declaration
LIBRARIES = {
    "rolling_moments": Library(
        "rolling_moments.cu",
        {entry: (_PTR,) * 7 + (_LONG, _INT, _INT, _PTR)
         for entry in ("rolling_second_moments_tiled",
                       "rolling_second_moments_rowwise")},
        "kernel:second_moments", rolling_impl="cuda"),
    "pv_corr": Library(
        "pv_corr.cu", {"pv_corr_six": (_PTR,) * 3 + (_LONG, _INT, _INT, _PTR)},
        "kernel:pv_corr"),
    "chip_segments": Library(
        "chip_segments.cu",
        {"chip_segments": (_PTR,) * 5 + (_LONG, _INT, _INT, _PTR, _PTR)},
        "kernel:chip_segments"),
    "volume_select": Library(
        "volume_select.cu",
        {"volume_select": (_PTR,) * 4 + (_LONG, _INT, _PTR, _INT, _PTR)},
        "kernel:volume_select"),
}

#: the export of every library that names a ``cudaError_t`` code
ERROR_STRING = "kernel_error_string"

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC_DIR.parent.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: name -> nvcc's output from this process's build of it (ptxas -v
#: reports each kernel's registers, shared memory and spills)
BUILD_LOGS: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

#: ``nvcc`` runs and library ``dlopen`` calls made by this process
COUNTS = {"build": 0, "load": 0}

#: ``(library, entry) -> successful launches`` since the last
#: :func:`reset_launches`; a refused launch and the plain versions never
#: count. Shards of an in-process mesh launch from threads of their own,
#: so each count is taken under a lock
LAUNCHES: collections.Counter = collections.Counter()
_COUNT_LOCK = threading.Lock()


def build_count() -> int:
    """The kernel-library builds and loads this process has made."""
    return COUNTS["build"] + COUNTS["load"]


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand is not None and cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / LIBRARIES[name].source).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile each named source (default: all) whose library is missing,
    every ``nvcc`` started before any is waited on; returns ``{name:
    library path}``. Raises with nvcc's output if a compile fails."""
    names = tuple(LIBRARIES) if names is None else tuple(names)
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / LIBRARIES[n].source)]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
        COUNTS["build"] += 1
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[n] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out[n])  # atomic: readers never see a partial .so
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built if needed and loaded once per
    process, with its entries' and :data:`ERROR_STRING`'s types set."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            COUNTS["load"] += 1
            for entry, argtypes in LIBRARIES[name].entries.items():
                fn = getattr(lib, entry)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            err = getattr(lib, ERROR_STRING)
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def load_for(device, rolling_impl: str) -> None:
    """Load the libraries a ``DayContext`` on ``device`` launches: on a
    card each library whose ``rolling_impl`` is None or ``rolling_impl``;
    nothing elsewhere. The serve and stream engines call it before their
    first request, so a warm engine builds nothing on one."""
    if device.type != "cuda":
        return
    for name, lib in LIBRARIES.items():
        if lib.rolling_impl in (None, rolling_impl):
            load(name)


def device_path(who: str, **tensors) -> str:
    """Where ``who`` computes its named ``tensors``: ``"plain"`` when all
    lie on the CPU, ``"kernel"`` when all lie on one CUDA device; raises
    ValueError naming each tensor's device otherwise."""
    devices = {t.device for t in tensors.values()}
    if all(d.type == "cpu" for d in devices):
        return "plain"
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return "kernel"
    on = ", ".join(f"{n} on {t.device}" for n, t in tensors.items())
    raise ValueError(f"{who}: {on}; all must be on the CPU or on one CUDA "
                     "device")


@contextlib.contextmanager
def _current_stream(device):
    """``device`` made current; yields its current stream's handle."""
    import torch

    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def launch(name: str, entry: str, device, *args) -> None:
    """Run ``entry`` of library ``name`` on ``device``'s current stream,
    with ``args`` and the stream last. Raises RuntimeError with the
    library's message for a nonzero code; counts the launch in
    :data:`LAUNCHES` otherwise."""
    lib = load(name)
    with _current_stream(device) as stream:
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        msg = getattr(lib, ERROR_STRING)(rc).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} (cudaError {rc})")
    with _COUNT_LOCK:
        LAUNCHES[(name, entry)] += 1


def launch_count(name: str, entry: Optional[str] = None) -> int:
    """Launches of ``entry`` of library ``name`` (None: of all its
    entries) since the last :func:`reset_launches`."""
    entries = LIBRARIES[name].entries if entry is None else (entry,)
    return sum(LAUNCHES[(name, e)] for e in entries)


def reset_launches(name: Optional[str] = None) -> None:
    """Zero the launch counts of library ``name`` (None: of every
    library)."""
    with _COUNT_LOCK:
        for key in [k for k in LAUNCHES if name in (None, k[0])]:
            del LAUNCHES[key]


def unload(name: str) -> bool:
    """Close the named library if this process loaded it (``dlclose``:
    ``dlopen`` hands back the object it already holds for a path); the
    next :func:`load` opens it again. Returns whether one was loaded."""
    import _ctypes

    with _LOCK:
        lib = _LIBS.pop(name, None)
        if lib is not None:
            _ctypes.dlclose(lib._handle)
    return lib is not None
