"""Nothing the benchmark loads is JAX or the JAX package, by whole
top-level module names (the port's name begins with the JAX package's),
and the plain reference loads nothing of the port."""

import ast
import subprocess
import sys

import pytest

from perfbench import harness

from conftest import BENCH, ROOT

JAX_PACKAGE = "replication_of_minute_frequency_factor_tpu"
PORT = JAX_PACKAGE + "_torch"


def top_level(names):
    return {n.split(".", 1)[0] for n in names}


def test_whole_name_comparison():
    assert harness.FORBIDDEN_MODULES == {"jax", "jaxlib", "flax",
                                         JAX_PACKAGE}
    assert top_level([PORT + ".pipeline", "jaxtyping"]).isdisjoint(
        harness.FORBIDDEN_MODULES)
    assert JAX_PACKAGE in top_level([JAX_PACKAGE + ".models"])


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.', 1)[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole run of every cell at the tiny size, in one fresh process:
    the program's path, the traced window and the check."""
    mods = loaded_after(
        "import sys; sys.path.insert(0, 'perfbench/tests')\n"
        "import pathlib, conftest\n"
        "from perfbench import harness\n"
        f"root = conftest.tiny_root(pathlib.Path({str(tmp_path)!r}))\n"
        "for w in ('cn_ashare_5000.year_resident',\n"
        "          'cn_ashare_5000.backfill_files'):\n"
        "    c = harness.resolve(w, root)\n"
        "    for t in (False, True):\n"
        "        assert harness.run_cell(c, 3, 0.05, t, 'cpu')['correct']\n"
        "assert not harness.forbidden_loaded()")
    assert PORT in mods
    assert mods.isdisjoint(harness.FORBIDDEN_MODULES)


def test_the_reference_loads_nothing_of_the_port():
    mods = loaded_after(
        "import perfbench.reference.compare, perfbench.recipes\n"
        "import perfbench.control")
    assert PORT not in mods
    assert mods.isdisjoint(harness.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", sorted(
    p.relative_to(BENCH).as_posix()
    for p in (BENCH / "reference").glob("*.py")) + ["recipes.py",
                                                     "roofline.py"])
def test_reference_sources_import_nothing_of_the_program(path):
    tree = ast.parse((BENCH / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert top_level(names).isdisjoint(
            {PORT, JAX_PACKAGE, "jax", "jaxlib", "flax", "torch"}), names
