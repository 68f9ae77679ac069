"""The port's hand-written kernels on the card (``cuda`` marker).

Every test here skips without a CUDA device: the kernels have no CPU mode.
The module imports neither jax nor the JAX package, so on a machine with
the card and without jax the tests run alone, past the jax set-up in
conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import pytest
import torch

from replication_of_minute_frequency_factor_tpu_torch.ops import rolling
from replication_of_minute_frequency_factor_tpu_torch.ops import rolling_cuda

W = 50


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _moment_inputs(rows, length, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    close = 10 * torch.exp(torch.cumsum(
        torch.randn(rows, length, generator=g, device="cuda") * 1e-3, -1))
    mask = torch.rand(rows, length, generator=g, device="cuda") > 0.05
    args = rolling.second_moment_inputs(close * 0.999, close * 1.001, mask, W)
    return args, rolling._windowed_sum(mask, W) > W - 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("rows,length", [(8 * 5000, 240), (4001, 390),
                                         (3, 1440)])
def test_kernel_matches_plain_on_the_card(rows, length):
    """The Hopper kernel vs its plain version (``python3 chip_smoke.py``
    runs the same check at the main path's shapes)."""
    _card()
    args, valid = _moment_inputs(rows, length, rows + length)
    before = rolling_cuda.launches
    got = rolling_cuda.second_moments(*args, W)
    torch.cuda.synchronize()
    assert rolling_cuda.launches == before + 1
    for a, b in zip(got, rolling_cuda.second_moments_plain(*args, W)):
        torch.testing.assert_close(a[valid], b[valid], rtol=1e-5, atol=1e-9)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take():
    _card()
    args, _ = _moment_inputs(8, 240, 0)
    before = rolling_cuda.launches
    with pytest.raises(TypeError, match="float32"):
        rolling_cuda.second_moments(args[0].double(), *args[1:], W)
    with pytest.raises(ValueError, match="contiguous"):
        rolling_cuda.second_moments(
            *(a.t().contiguous().t() for a in args), W)
    with pytest.raises(ValueError, match="shape"):
        rolling_cuda.second_moments(args[0][:4], *args[1:], W)
    with pytest.raises(ValueError, match="one CUDA device"):
        rolling_cuda.second_moments(args[0].cpu(), *args[1:], W)
    assert rolling_cuda.launches == before
