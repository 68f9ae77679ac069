"""The port's rolling engine vs the JAX package's.

* The plain second-moment pass (the Hopper kernel's plain version) vs the
  JAX Pallas kernel in interpret mode and vs its fused conv formulation,
  at rtol 1e-5 / atol 1e-9 on valid lanes — the bar the JAX package sets
  between its own backends (ops/rolling.py ``_smoke``).
* ``rolling_window_stats`` through the ``_smoke`` protocol (seeds 0 and
  739, f64 reference at rtol 5e-4 / atol 1e-6, validity exactly equal,
  exactly-zero variance on the constant row) at 240, 390 and 1440 slots.
* The wrapper's CPU and refusal paths; the kernel itself runs only on the
  card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replication_of_minute_frequency_factor_tpu.ops import rolling as jrolling
from replication_of_minute_frequency_factor_tpu.ops import rolling_pallas
from replication_of_minute_frequency_factor_tpu_torch.ops import rolling
from replication_of_minute_frequency_factor_tpu_torch.ops import rolling_cuda

LENGTHS = (240, 390, 1440)
W = 50


@pytest.fixture(scope="module", params=LENGTHS)
def case(request):
    """The ``_smoke`` recipe at one slot count: f32 low/high/mask and the
    second-moment inputs the port derives from them."""
    low, high, mask = rolling._smoke_case(739, request.param)
    t = [torch.from_numpy(a) for a in (low, high, mask)]
    inputs = [v.numpy() for v in rolling.second_moment_inputs(*t, W)]
    valid = rolling._f64_reference(low, high, mask, W)["valid"]
    return low, high, mask, inputs, valid


def test_plain_second_moments_vs_jax_pallas_and_conv(case):
    _, _, _, inputs, valid = case
    got = rolling_cuda.second_moments(
        *(torch.from_numpy(a) for a in inputs), W)
    refs = {
        "pallas_interpret": rolling_pallas.second_moments(
            *(jnp.asarray(a) for a in inputs), W, interpret=True),
        "conv": jrolling._second_moments_conv(
            *(jnp.asarray(a) for a in inputs), W),
    }
    for label, ref in refs.items():
        for name, a, b in zip(("s_xx", "s_yy", "s_xy"), got, ref):
            np.testing.assert_allclose(a.numpy()[valid], np.asarray(b)[valid],
                                       rtol=1e-5, atol=1e-9,
                                       err_msg=f"{label} {name}")


@pytest.mark.parametrize("length", LENGTHS)
def test_smoke_protocol(length):
    res = rolling._smoke(seeds=(0, 739), length=length, device="cpu")
    assert res["ok"] and res["checks"] == 2 and res["impls"] == ["torch"]


@pytest.mark.parametrize("impl", ["conv", "pallas_interpret"])
def test_rolling_window_stats_vs_jax(case, impl):
    low, high, mask, _, valid = case
    t = {k: v.numpy() for k, v in rolling.rolling_window_stats(
        torch.from_numpy(low), torch.from_numpy(high),
        torch.from_numpy(mask), W, impl="cuda").items()}
    j = {k: np.asarray(v) for k, v in jrolling.rolling_window_stats(
        jnp.asarray(low), jnp.asarray(high), jnp.asarray(mask), W,
        impl=impl).items()}
    np.testing.assert_array_equal(t["valid"], j["valid"])
    np.testing.assert_array_equal(t["valid"], valid)
    for k in ("mean_x", "mean_y", "cov", "var_x", "var_y"):
        np.testing.assert_allclose(t[k][valid], j[k][valid], rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    # the constant row: exactly-zero moments on both sides
    for k in ("cov", "var_x", "var_y"):
        assert not t[k][2][valid[2]].any() and not j[k][2][valid[2]].any()


def test_constant_window_pin_both_readings():
    from replication_of_minute_frequency_factor_tpu_torch import pins

    x = torch.full((1, 240), 0.1)
    m = torch.ones((1, 240), dtype=torch.bool)
    st = rolling.rolling_window_stats(x, x, m, W, impl="torch")
    assert float(st["var_x"][st["valid"]].max()) == 0.0
    with pins.pinned(constant_window="noise"):
        st = rolling.rolling_window_stats(x, x, m, W, impl="torch")
        assert float(st["var_x"][st["valid"]].max()) > 0.0


def test_beta_std_snap():
    """Windows whose betas are equal in exact arithmetic report beta std
    exactly 0 (the sub-resolution snap of ``DayContext.beta_moments``)."""
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        DayContext)

    bars = torch.zeros((1, 240, 5))
    bars[..., 0], bars[..., 1], bars[..., 2] = 10.0, 10.02, 9.98
    bars[..., 3], bars[..., 4] = 10.0, 100.0
    mask = torch.ones((1, 240), dtype=torch.bool)
    for impl in ("cuda", "torch"):
        _, std, _, n = DayContext(bars, mask,
                                  rolling_impl=impl).beta_moments()
        assert int(n[0]) > 0 and float(std[0]) == 0.0


def test_impl_resolution_is_counted():
    x = torch.ones((2, 240))
    m = torch.ones((2, 240), dtype=torch.bool)
    before = dict(rolling.IMPL_COUNTS)
    rolling.rolling_window_stats(x, x, m, W, impl="cuda")
    rolling.rolling_window_stats(x, x, m, W, impl="torch")
    after = rolling.IMPL_COUNTS
    assert after[("cuda", "torch")] == before.get(("cuda", "torch"), 0) + 1
    assert after[("torch", "torch")] == before.get(("torch", "torch"), 0) + 1
    assert ("cuda", "cuda") not in after or \
        after[("cuda", "cuda")] == before[("cuda", "cuda")]
    with pytest.raises(ValueError, match="rolling_impl"):
        rolling.rolling_window_stats(x, x, m, W, impl="cumsum")


def test_windowed_sum_is_exact_on_counts():
    m = torch.from_numpy(np.random.default_rng(1).random((4, 1440)) > 0.3)
    got = rolling._windowed_sum(m, W).numpy()
    c = np.concatenate([np.zeros((4, 1)), np.cumsum(m.numpy(), -1)], -1)
    want = c[:, 1:] - c[:, np.maximum(np.arange(1440) + 1 - W, 0)]
    np.testing.assert_array_equal(got, want)


def test_wrapper_refuses_tensors_off_the_cpu_and_the_card():
    xs = [torch.zeros((2, 240))] * 3 + [torch.zeros((2, 240), device="meta")]
    before = dict(rolling_cuda.launches)
    with pytest.raises(ValueError, match="one CUDA device"):
        rolling_cuda.second_moments(*xs, W)
    assert rolling_cuda.launches == before


def test_window_50_is_the_tiled_kernels_and_the_source_agrees():
    """The wrapper sends window 50 to the tiled kernel and every other
    window to the rowwise one; the tiled kernel's compiled window is the
    wrapper's."""
    import re

    from replication_of_minute_frequency_factor_tpu_torch import kernels

    assert rolling_cuda.kernel_for(W) == "tiled"
    assert {rolling_cuda.kernel_for(w) for w in (1, 20, 49, 51, 240)} == {
        "rowwise"}
    src = (kernels.CSRC_DIR / "rolling_moments.cu").read_text()
    assert re.search(r"constexpr int kTiledWindow = (\d+);", src).group(1) \
        == str(rolling_cuda.TILED_WINDOW) == str(W)
    for entry in ("rolling_second_moments_tiled",
                  "rolling_second_moments_rowwise"):
        assert f'extern "C" int {entry}(' in src
