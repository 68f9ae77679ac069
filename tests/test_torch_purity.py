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
    return sorted([*PORT_DIR.rglob("*.py"), REPO / "chip_smoke.py",
                   REPO / "tests" / "torch_cases.py"])


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
    fleet = {p.name for p in _port_files() if p.parent.name == "fleet"}
    assert fleet == {"__init__.py", "replica.py", "policy.py", "router.py",
                     "http.py"}


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
    for mod in ("pipeline", "data.io", "native", "utils.debug",
                "telemetry.registry", "telemetry.attribution", "config",
                "frames", "eval_ops", "plotting", "factor", "minfreq",
                "__main__", "data.result_wire", "telemetry.factorplane",
                "ops.incremental", "stream.carry", "stream.fastpath",
                "stream.engine", "serve.executables", "sessions",
                "serve", "serve.engine", "serve.expcache", "serve.service",
                "serve.source", "serve.http", "serve.edge",
                "serve.wireclient", "telemetry.lockcheck", "telemetry.spans",
                "telemetry.sink", "telemetry.manifest", "telemetry.opsplane",
                "telemetry.slo", "telemetry.timeline",
                "telemetry.meshplane", "telemetry.validate",
                "telemetry.aggregate", "oracle", "oracle.kernels",
                "oracle.stats", "utils.upload", "parallel",
                "parallel.mesh", "parallel.collectives",
                "parallel.transport", "parallel.multihost",
                "parallel.launch", "fleet", "fleet.replica",
                "fleet.policy", "fleet.router", "fleet.http"):
        assert f"replication_of_minute_frequency_factor_tpu_torch.{mod}" in out
    assert [m for m in out if _forbidden(m)] == []
    # pyarrow loads only inside the functions that read and write files,
    # matplotlib only inside the ones that draw
    assert "pyarrow" not in out
    assert [m for m in out if m.split(".")[0] == "matplotlib"] == []


def test_the_native_path_loads_the_ports_library_only():
    """Gridding and encoding through the native path maps the port's own
    build of gridpack.cpp, never the JAX package's libgridpack.so."""
    code = (
        "import numpy as np\n"
        "from replication_of_minute_frequency_factor_tpu_torch import native\n"
        "from replication_of_minute_frequency_factor_tpu_torch.data import (\n"
        "    grid_day, synth_day, wire)\n"
        "d = synth_day(np.random.default_rng(0), n_codes=3)\n"
        "g = grid_day(d['code'], d['time'], d['open'], d['high'], d['low'],\n"
        "             d['close'], d['volume'], use_native=True)\n"
        "wire.encode(g.bars[None], g.mask[None], use_native=True)\n"
        "print(native.library_path())\n"
        "print(open('/proc/self/maps').read())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    lib, maps = out.split("\n", 1)
    assert lib in maps
    assert Path(lib).parent == REPO / "build" / "native"
    jax_lib = REPO / "replication_of_minute_frequency_factor_tpu" / "native"
    assert str(jax_lib) not in maps


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
    assert compute_batch(bars, mask, device="cpu").shape == (58, 1, 2)


def test_compute_packed_refuses_the_cpu_unless_asked(monkeypatch):
    from replication_of_minute_frequency_factor_tpu_torch import (
        compute_packed, wire)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bars = np.full((1, 2, 240, 5), 10.0, np.float32)
    mask = np.ones((1, 2, 240), bool)
    arrays = wire.encode(bars, mask).arrays
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compute_packed(arrays, "wire")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compute_packed((bars, mask.astype(np.uint8)), "raw", device="cuda")
    assert compute_packed(arrays, "wire", device="cpu").shape == (58, 1, 2)


def test_packed_side_outputs_and_streaming_refuse_the_cpu_unless_asked(
        monkeypatch):
    from replication_of_minute_frequency_factor_tpu_torch import (
        StreamEngine, compute_exposures_streamed, compute_packed)
    from replication_of_minute_frequency_factor_tpu_torch.data import (
        result_wire as rw)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bars = np.full((1, 2, 240, 5), 10.0, np.float32)
    mask = np.ones((1, 2, 240), bool)
    names = ("mmt_am", "vol_return1min")
    spec = rw.ResultWireSpec.for_names(names, days=1)
    arrays = (bars, mask.astype(np.uint8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compute_packed(arrays, "raw", names, result_spec=spec,
                       factor_stats=True)
    payload, stats = compute_packed(arrays, "raw", names, result_spec=spec,
                                    factor_stats=True, device="cpu")
    assert payload.device.type == stats.device.type == "cpu"
    for make in (lambda: StreamEngine(2, names=names),
                 lambda: compute_exposures_streamed(bars[0], mask[0],
                                                    names=names)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamEngine(2, names=names, device="cuda")
    eng = StreamEngine(2, names=names, device="cpu")
    assert eng.device.type == "cpu"
    assert eng.carry["bars"].device.type == "cpu"


def test_wrapper_takes_the_plain_version_on_cpu_and_counts_no_launch():
    low, high, mask = rolling._smoke_case(0)
    args = rolling.second_moment_inputs(
        torch.from_numpy(low), torch.from_numpy(high),
        torch.from_numpy(mask), 50)
    rolling_cuda.reset_launches()
    got = rolling_cuda.second_moments(*args, 50)
    want = rolling._second_moments_conv(*args, 50)
    assert rolling_cuda.launches == {"tiled": 0, "rowwise": 0}
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


def test_kernel_builds_and_loads_are_counted(monkeypatch, tmp_path):
    """``kernels.build_count`` counts each compiler run of ``build`` and
    each library ``load``; a loaded library is loaded once, and
    ``unload`` closes it so the next load opens it again. Here a stand-in
    compiler (the host's C compiler under nvcc's command line) builds a
    real shared library, which is really opened and closed."""
    import shutil
    import stat

    from replication_of_minute_frequency_factor_tpu_torch import kernels

    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("needs a host C compiler to build a stand-in library")
    src = tmp_path / "stand_in.c"
    src.write_text("int rolling_error_string(int c) { return c; }\n")
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do\n"
        '  if [ "$1" = "-o" ]; then out="$2"; fi; shift\n'
        "done\n"
        f'exec {cc} -shared -fPIC -o "$out" {src}\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    (tmp_path / "cuda" / "bin").mkdir(parents=True)
    (tmp_path / "cuda" / "bin" / "nvcc").symlink_to(fake)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "COUNTS", {"build": 0, "load": 0})
    kernels.unload("rolling_moments")
    try:
        assert kernels.build_count() == 0
        lib = kernels.load("rolling_moments")
        assert lib.rolling_error_string(7) == 7
        assert kernels.COUNTS == {"build": 1, "load": 1}
        assert kernels.load("rolling_moments") is lib
        assert kernels.build_count() == 2
        assert kernels.unload("rolling_moments")
        assert not kernels.unload("rolling_moments")
        kernels.load("rolling_moments")  # built already: a load alone
        assert kernels.COUNTS == {"build": 1, "load": 2}
    finally:
        kernels.unload("rolling_moments")


def test_the_server_refuses_the_cpu_unless_asked(monkeypatch):
    """``FactorServer``, ``ServeEngine`` and the CLI's ``serve`` run on
    the card unless ``device='cpu'`` is passed: without a card they
    raise, never fall back."""
    from replication_of_minute_frequency_factor_tpu_torch.__main__ import (
        main)
    from replication_of_minute_frequency_factor_tpu_torch.serve import (
        FactorServer, SyntheticSource)
    from replication_of_minute_frequency_factor_tpu_torch.serve.engine import (
        ServeEngine)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = SyntheticSource(n_days=2, n_tickers=4, seed=0)
    names = ("mmt_am",)
    for make in (lambda: FactorServer(src, names=names, start=False),
                 lambda: ServeEngine(names)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FactorServer(src, names=names, start=False, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["serve", "--demo", "1", "--synthetic-days", "2",
              "--synthetic-tickers", "4", "--factors", "mmt_am"])
    eng = ServeEngine(names, device="cpu")
    block = eng.build_block(*src.slab(0, 2))
    assert {t.device.type for t in block.values()} == {"cpu"}
    with FactorServer(src, names=names, device="cpu") as srv:
        assert srv.device.type == "cpu"
        assert srv.stream_engine is None
        assert srv.health()["replica"]["devices"] == ["cpu"]


def test_discovery_modules_load_no_jax():
    """The port's search, research and research-mode server import
    neither jax nor the JAX package (nor pyarrow)."""
    code = (
        "import sys\n"
        "import replication_of_minute_frequency_factor_tpu_torch.search\n"
        "import replication_of_minute_frequency_factor_tpu_torch.research\n"
        "from replication_of_minute_frequency_factor_tpu_torch.research "
        "import evolve, fitness, registry\n"
        "from replication_of_minute_frequency_factor_tpu_torch.serve "
        "import Discover, FactorServer\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout.split()
    for mod in ("search", "research", "research.evolve",
                "research.fitness", "research.registry", "serve.service"):
        assert f"replication_of_minute_frequency_factor_tpu_torch.{mod}" in out
    assert [m for m in out if _forbidden(m)] == []
    assert "pyarrow" not in out


def test_discovery_refuses_the_cpu_unless_asked(monkeypatch, tmp_path):
    """``DiscoveryEngine``, ``search.eval_programs`` on host arrays and
    ``FactorServer(research=True)`` run on the card unless
    ``device='cpu'`` is passed: without a card they raise, never fall
    back."""
    from replication_of_minute_frequency_factor_tpu_torch import search
    from replication_of_minute_frequency_factor_tpu_torch.research import (
        DiscoveryEngine)
    from replication_of_minute_frequency_factor_tpu_torch.serve import (
        FactorServer, ServeConfig, SyntheticSource)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = SyntheticSource(n_days=3, n_tickers=4, seed=0)
    bars, mask = src.slab(0, 3)
    g = search.random_population(np.random.default_rng(0), 2)
    for make in (lambda: DiscoveryEngine(),
                 lambda: search.eval_programs(g, bars, mask),
                 lambda: FactorServer(src, names=("mmt_am",), start=False,
                                      research=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiscoveryEngine(device="cuda")
    assert DiscoveryEngine(device="cpu").device.type == "cpu"
    assert search.eval_programs(g, bars, mask, device="cpu").shape == \
        (2, 3, 4)
    with FactorServer(src, names=("mmt_am",), research=True, device="cpu",
                      serve_cfg=ServeConfig(research_dir=str(tmp_path),
                                            hbm_sample_period_s=0)) as srv:
        assert srv.research_engine.device.type == "cpu"
