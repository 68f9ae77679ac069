"""The one seam between the port and its hand-written kernels,
``kernels.py``: the table of libraries, the launch, its count and the
device rule, held on the CPU for every library of the table.

A stand-in library (``torch_cases.stand_in_kernels``: the host's C
compiler behind nvcc's command line, building the table's own entries) is
really loaded and launched: a zero code counts one launch under its
library and entry, a nonzero one raises with the library's message and
counts nothing. Each wrapper takes its plain version for CPU tensors and
counts no launch, and refuses, before any launch, tensors that are
neither all on the CPU nor all on one CUDA device. The trace tier counts
each library's launches under its key; the engines load what a
``DayContext`` on a card launches.

The module imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q
"""

import collections
import contextlib
import ctypes
from types import SimpleNamespace

import pytest
import torch

from replication_of_minute_frequency_factor_tpu_torch import kernels
from replication_of_minute_frequency_factor_tpu_torch.analysis import (
    trace_tier)
from replication_of_minute_frequency_factor_tpu_torch.models import registry
from replication_of_minute_frequency_factor_tpu_torch.ops import (
    chip_segments_cuda, pv_corr_cuda, rolling, rolling_cuda,
    volume_select_cuda)
from torch_cases import (
    VOLUME_ANSWERS, pv_corr_rows, same_bits, segment_tensors,
    stand_in_kernels, volume_tensors)

LIBRARIES = tuple(kernels.LIBRARIES)
ENTRIES = tuple((name, entry) for name, lib in kernels.LIBRARIES.items()
                for entry in lib.entries)
#: the factors whose traces reach each row kernel's wrapper
FAMILIES = {"pv_corr": pv_corr_cuda.NAMES,
            "chip_segments": ("doc_skew", "doc_kurt", "doc_std", "doc_pdf60",
                              "doc_pdf70", "doc_pdf80", "doc_pdf90",
                              "doc_pdf95"),
            "volume_select": ("mmt_top50VolumeRet", "mmt_bottom50VolumeRet",
                              "mmt_top20VolumeRet", "mmt_bottom20VolumeRet",
                              "doc_vol10_ratio", "doc_vol5_ratio",
                              "doc_vol50_ratio")}


def _calls(name):
    """Each wrapper call of library ``name`` on crafted CPU inputs:
    ``(kernel path, plain version, inputs)``."""
    if name == "rolling_moments":
        low, high, mask = rolling._smoke_case(0)
        args = rolling.second_moment_inputs(
            torch.from_numpy(low), torch.from_numpy(high),
            torch.from_numpy(mask), 50)
        return [(lambda *a: rolling_cuda.second_moments(*a, 50),
                 lambda *a: rolling._second_moments_conv(*a, 50), args)]
    if name == "pv_corr":
        bars, mask = (torch.from_numpy(a) for a in pv_corr_rows(5, 240))
        return [(pv_corr_cuda.pv_corr,
                 lambda b, m: pv_corr_cuda.pv_corr_plain(b[..., 3],
                                                         b[..., 4], m),
                 (bars, mask))]
    if name == "volume_select":
        return [(lambda *a: volume_select_cuda.volume_selections(*a, answers),
                 lambda *a: volume_select_cuda.volume_selections_plain(
                     *a, answers), volume_tensors(1, 64, rows=12))
                for answers in VOLUME_ANSWERS]
    assert name == "chip_segments"
    x, w, m, r = segment_tensors(1, 64, rows=12)
    return [(chip_segments_cuda.segment_moments,
             chip_segments_cuda.moments_plain, (x, w, m)),
            (chip_segments_cuda.pdf_ranks,
             lambda x_, w_, m_, r_: chip_segments_cuda.pdf_plain(r_, w_, m_),
             (x, w, m, r))]


@pytest.fixture
def stand_in(monkeypatch, tmp_path):
    """The stand-in libraries, launched on a stream handle of 0."""
    stand_in_kernels(monkeypatch, tmp_path)
    monkeypatch.setattr(kernels, "_current_stream",
                        lambda device: contextlib.nullcontext(0))
    try:
        yield
    finally:
        for name in kernels.LIBRARIES:
            kernels.unload(name)


def _args(name, entry, code):
    """``code`` as the entry's first argument, zeros after it, the stream
    left to the launch."""
    n = len(kernels.LIBRARIES[name].entries[entry]) - 1
    return (code,) + (0,) * (n - 1)


# --- the launch and its count --------------------------------------------------

def test_every_library_is_declared_once():
    assert set(FAMILIES) < set(LIBRARIES)
    assert len({lib.trace_key for lib in kernels.LIBRARIES.values()}) == \
        len(LIBRARIES)


@pytest.mark.parametrize("name", LIBRARIES)
def test_the_argument_types_are_set_once_at_load(stand_in, name):
    lib = kernels.load(name)
    for entry, argtypes in kernels.LIBRARIES[name].entries.items():
        fn = getattr(lib, entry)
        assert fn.argtypes == list(argtypes) and fn.restype is ctypes.c_int
    err = getattr(lib, kernels.ERROR_STRING)
    assert err.restype is ctypes.c_char_p
    assert kernels.load(name) is lib and kernels.COUNTS["load"] == 1


@pytest.mark.parametrize("name,entry", ENTRIES)
def test_a_zero_code_counts_one_launch_under_its_library_and_entry(
        stand_in, name, entry):
    kernels.launch(name, entry, torch.device("cuda", 0),
                   *_args(name, entry, 0))
    assert dict(kernels.LAUNCHES) == {(name, entry): 1}
    assert kernels.launch_count(name, entry) == kernels.launch_count(name) \
        == 1
    assert trace_tier._kernel_launches() == {
        lib.trace_key: int(n == name)
        for n, lib in kernels.LIBRARIES.items()}
    if name == "rolling_moments":
        variant = {e: v for v, e in rolling_cuda._ENTRIES.items()}[entry]
        assert rolling_cuda.launches[variant] == 1
        assert sum(rolling_cuda.launches.values()) == 1
        rolling_cuda.reset_launches()
        assert rolling_cuda.launches == {"tiled": 0, "rowwise": 0}
    kernels.reset_launches()
    assert not kernels.LAUNCHES


@pytest.mark.parametrize("name,entry", ENTRIES)
def test_a_nonzero_code_raises_with_the_librarys_message_and_counts_nothing(
        stand_in, name, entry):
    with pytest.raises(RuntimeError) as err:
        kernels.launch(name, entry, torch.device("cuda", 0),
                       *_args(name, entry, 7))
    assert str(err.value) == (f"{entry} launch failed: stand-in error 7 "
                              "(cudaError 7)")
    assert not kernels.LAUNCHES and kernels.launch_count(name) == 0


# --- the device rule -------------------------------------------------------------

def test_the_device_rule_sends_all_cpu_to_plain_and_one_card_to_the_kernel():
    on = {d: SimpleNamespace(device=torch.device(d))
          for d in ("cpu", "cuda:0", "cuda:1", "meta")}
    assert kernels.device_path("f", a=on["cpu"], b=on["cpu"]) == "plain"
    assert kernels.device_path("f", a=on["cuda:0"], b=on["cuda:0"]) == \
        "kernel"
    for a, b in (("cpu", "cuda:0"), ("cuda:0", "cuda:1"), ("meta", "meta"),
                 ("cpu", "meta")):
        with pytest.raises(ValueError) as err:
            kernels.device_path("f", a=on[a], b=on[b])
        assert str(err.value) == (
            f"f: a on {torch.device(a)}, b on {torch.device(b)}; all must "
            "be on the CPU or on one CUDA device")


@pytest.mark.parametrize("name", LIBRARIES)
def test_wrapper_takes_the_plain_version_on_cpu_and_counts_no_launch(name):
    before = dict(kernels.LAUNCHES)
    for call, plain, args in _calls(name):
        got, want = call(*args), plain(*args)
        if isinstance(got, tuple):
            got, want = torch.stack(got), torch.stack(want)
        assert same_bits(got, want)
    assert dict(kernels.LAUNCHES) == before
    if name == "rolling_moments":
        assert rolling_cuda.second_moments_plain is \
            rolling._second_moments_conv


@pytest.mark.parametrize("name", LIBRARIES)
def test_wrapper_refuses_tensors_off_the_cpu_and_the_card(name):
    """A tensor that is neither on the CPU with the others nor with them on
    one CUDA device raises by the one rule, before any launch."""
    before = dict(kernels.LAUNCHES)
    for call, _, args in _calls(name):
        with pytest.raises(ValueError, match="one CUDA device"):
            call(*(a.to("meta") for a in args))
        with pytest.raises(ValueError, match="one CUDA device"):
            call(*args[:-1], args[-1].to("meta"))
    assert dict(kernels.LAUNCHES) == before


# --- the trace tier and the engines ------------------------------------------------

@pytest.mark.parametrize("name", LIBRARIES)
def test_the_trace_tier_counts_each_librarys_launches(monkeypatch, name):
    """The kernels are ctypes calls the op recorder cannot see: their
    launches come from the one counter, under each library's key."""
    monkeypatch.setattr(kernels, "LAUNCHES", collections.Counter())
    key = kernels.LIBRARIES[name].trace_key
    entry = next(iter(kernels.LIBRARIES[name].entries))
    other = next(n for n in LIBRARIES if n != name)
    other_entry = next(iter(kernels.LIBRARIES[other].entries))

    def fake_launch(n=1, also=False):
        kernels.LAUNCHES[(name, entry)] += n
        if also:
            kernels.LAUNCHES[(other, other_entry)] += 1
        return torch.ones(3) * 2.0

    _, t = trace_tier.trace(lambda: fake_launch(2))
    assert t.launches == 2
    ops = t.fingerprint()["ops"]
    assert ops[key] == 2
    assert kernels.LIBRARIES[other].trace_key not in ops
    _, t = trace_tier.trace(lambda: fake_launch(also=True))
    assert t.launches == 2
    assert t.kernel_launches == {key: 1,
                                 kernels.LIBRARIES[other].trace_key: 1}
    assert t.fingerprint()["n_ops"] == sum(t.ops.values())


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_on_the_cpu_no_trace_counts_a_launch(name):
    """Every traced kernel of the family computes the plain version on
    the CPU: its ops, stacked, and no launch key."""
    bars, mask = trace_tier.canonical_inputs()
    for factor in FAMILIES[name]:
        _, t = trace_tier.trace_kernel(registry.resolve(factor), bars, mask)
        assert t.launches == 0 and not t.syncs
        assert kernels.LIBRARIES[name].trace_key not in t.counts()
        assert t.ops.get("aten.stack.default") == 1, factor


@pytest.mark.parametrize("name", LIBRARIES)
def test_engines_load_each_library_they_launch(monkeypatch, name):
    """``kernels.load_for``, which the serve and stream engines call before
    their first request: on a card the row kernels whatever the
    engine's ``rolling_impl``, and the rolling one only under "cuda";
    nothing on the CPU."""
    loads = {"torch": {"pv_corr", "chip_segments", "volume_select"},
             "cuda": {"rolling_moments", "pv_corr", "chip_segments",
                      "volume_select"}}
    loaded = []
    monkeypatch.setattr(kernels, "load", loaded.append)
    kernels.load_for(torch.device("cpu"), "cuda")
    assert loaded == []
    for impl, want in loads.items():
        loaded.clear()
        kernels.load_for(torch.device("cuda", 0), impl)
        assert set(loaded) == want and len(loaded) == len(want)
        assert (name in loaded) == (name in want)
