"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` compiles with ``nvcc`` for Hopper
(``sm_90a``) into a shared library of its own with a plain C interface,
which the kernel's wrapper loads with ctypes: no PyTorch headers, so a
build takes seconds. Libraries go to ``build/kernels/`` at the checkout
root, named by a hash of the source and the flags, so an edited source
builds anew. A library builds on first use, or up front through
:func:`build`, which starts one ``nvcc`` per source, all at once.

:data:`COUNTS` counts what this process really builds: each ``nvcc`` run
(``build``) and each ``dlopen`` of a library (``load``).
:func:`build_count` is their sum, the count the serving layer's warm
gates and discovery's ``compiles_during_loop`` read (the JAX package
reads ``xla.compiles`` there). Torch itself compiles nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

#: kernel library name -> its source under csrc/
SOURCES = {"rolling_moments": "rolling_moments.cu", "pv_corr": "pv_corr.cu"}

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
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile each named source (default: all) whose library is missing,
    every ``nvcc`` started before any is waited on; returns ``{name:
    library path}``. Raises with nvcc's output if a compile fails."""
    names = tuple(SOURCES) if names is None else tuple(names)
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[n])]
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
    process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            COUNTS["load"] += 1
            _LIBS[name] = lib
        return lib


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
