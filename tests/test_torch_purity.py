"""The port stands alone: no module of it imports jax or the JAX package,
it never runs quietly on the CPU when the card was asked for, and the
kernel wrapper takes its plain version only for CPU tensors."""

import ast
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import replication_of_minute_frequency_factor_tpu_torch as port
from replication_of_minute_frequency_factor_tpu_torch import compute_batch
from replication_of_minute_frequency_factor_tpu_torch.ops import rolling
from replication_of_minute_frequency_factor_tpu_torch.ops import rolling_cuda

PORT_DIR = Path(port.__file__).parent
REPO = PORT_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "replication_of_minute_frequency_factor_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    return sorted([*PORT_DIR.rglob("*.py"), REPO / "chip_smoke.py"])


def test_no_module_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno}: {m}"
                    for m in mods if _forbidden(m)]
    assert not bad, bad
    assert len(_port_files()) > 20


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import replication_of_minute_frequency_factor_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout.split()
    assert "replication_of_minute_frequency_factor_tpu_torch.ops.rolling_cuda" \
        in out
    assert [m for m in out if _forbidden(m)] == []


def test_every_port_module_imports_here():
    names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                   port.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    assert len(names) >= 20


def test_compute_batch_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bars = np.ones((1, 2, 240, 5), np.float32)
    mask = np.ones((1, 2, 240), bool)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compute_batch(bars, mask)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compute_batch(bars, mask, device="cuda")
    assert compute_batch(bars, mask, device="cpu").shape == (47, 1, 2)


def test_wrapper_takes_the_plain_version_on_cpu_and_counts_no_launch():
    low, high, mask = rolling._smoke_case(0)
    args = rolling.second_moment_inputs(
        torch.from_numpy(low), torch.from_numpy(high),
        torch.from_numpy(mask), 50)
    rolling_cuda.reset_launches()
    got = rolling_cuda.second_moments(*args, 50)
    want = rolling._second_moments_conv(*args, 50)
    assert rolling_cuda.launches == 0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert rolling_cuda.second_moments_plain is rolling._second_moments_conv


def test_kernel_source_ships_and_builds_into_an_ignored_directory():
    from replication_of_minute_frequency_factor_tpu_torch import kernels

    for src in kernels.SOURCES.values():
        text = (kernels.CSRC_DIR / src).read_text()
        assert "rolling_pallas.py::second_moments" in text
        assert "__global__" in text and 'extern "C"' in text
    assert "-gencode=arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert kernels.library_path("rolling_moments").parent == \
        REPO / "build" / "kernels"
    assert "/build/" in (REPO / ".gitignore").read_text().splitlines()
