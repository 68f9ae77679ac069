"""Crafted inputs shared by the port's tests and ``chip_smoke.py``.

numpy and torch only (no jax): ``chip_smoke.py`` loads this file by path
on the card, and the CPU tests import it as a sibling module. Nothing
here is collected as a test.
"""

import numpy as np
import torch

#: (dclose, ohl, volume) rungs of the wire's ladders that batches are
#: crafted for: every rung of every ladder
WIRE_MODE_CASES = ((0, 0, 0), (1, 1, 1), (2, 2, 2), (1, 3, 3), (0, 1, 4))


def wire_mode_case(seed: int, n_slots: int, dclose_mode: int, ohl_mode: int,
                   vol_mode: int, lead=(2, 6)):
    """Tick-aligned bars ``[*lead, S, 5]`` (zero on absent bars) and mask
    whose wire encoding lands on the given rung of each ladder
    (``native.DCLOSE_SHAPES``, ``OHL_SHAPES``, ``VOL_SHAPES``). One lane of
    the first row holds each field's extreme, so no narrower rung fits; a
    rung the slot count cannot pack (vol10 needs S % 4 == 0) lands on the
    next that it can, as :func:`expected_wire_modes` says."""
    rng = np.random.default_rng(seed)
    shape = tuple(lead) + (n_slots,)
    mask = rng.random(shape) > 0.1
    first = (0,) * len(lead)
    mask[first][:8] = True
    step = (7, 127, 2000)[dclose_mode]
    steps = rng.integers(-step, step + 1, shape)
    steps[first + (5,)] = step
    ct = (rng.integers(500_000, 1_000_000, tuple(lead))[..., None]
          + np.cumsum(np.where(mask, steps, 0), axis=-1))
    lo, hi, wick = ((-8, 7, 3), (-127, 127, 15), (-50, 50, 40),
                    (-50, 50, 40))[ohl_mode]
    dop = rng.integers(lo, hi + 1, shape)
    up = rng.integers(0, wick + 1, shape)
    down = rng.integers(0, wick + 1, shape)
    if ohl_mode == 1:
        dop[first + (6,)] = 100  # past the tight packing's int4
    elif ohl_mode == 2:
        up[first + (6,)] = 40    # past the wick packing's nibble
    elif ohl_mode == 3:
        up[first + (6,)] = 500   # past int8
    ot = ct + dop
    ht = np.maximum(ct, ot) + up
    lt = np.minimum(ct, ot) - down
    top, lots = ((1023, 1), (1023, 100), (65535, 1), (65535, 100),
                 (10_000_000, 1))[vol_mode]
    vol = rng.integers(0, top + 1, shape) * lots
    vol[first + (7,)] = top * lots
    if lots == 1 and vol_mode:
        vol[first + (6,)] = 7    # not a board lot
    bars = np.stack([t / 100.0 for t in (ot, ht, lt, ct)] + [vol], axis=-1)
    bars = np.where(mask[..., None], bars, 0.0).astype(np.float32)
    return bars, mask


def expected_wire_modes(n_slots: int, dclose_mode: int, ohl_mode: int,
                        vol_mode: int) -> dict:
    """The modes :func:`wire_mode_case`'s batch encodes at."""
    if n_slots % 2:
        dclose_mode = max(dclose_mode, 1)
    if n_slots % 4 and vol_mode < 2:
        vol_mode += 2
    return {"dclose_mode": dclose_mode, "ohl_mode": ohl_mode,
            "vol_mode": vol_mode}


def crafted_rows(seed: int = 64, rows: int = 8, lanes: int = 64):
    """``[rows, lanes]`` rows of heavy ties (quarter steps) with garbage in
    the invalid lanes, the first seven crafted as a sort must place them
    exactly: -0.0 next to +0.0, a valid ``+inf`` and ``-inf``, +NaN and
    -NaN valid lanes, an all-invalid row, a NaN in an invalid lane, one
    tie group of signed zeros, one value with invalid lanes, all valid."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-8, 9, (rows, lanes)) / 4).astype(np.float32)
    mask = rng.random((rows, lanes)) < 0.8
    x[~mask] = rng.normal(0, 1e3, int((~mask).sum()))
    x[0, :6] = [-0.0, 0.0, np.inf, np.nan, -np.nan, -np.inf]
    mask[0, :6] = True
    x[1, :8] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, np.nan, 0.0]
    mask[1] = True
    mask[2] = False
    x[3, 3], mask[3, 3] = np.nan, False
    x[4] = np.where(np.arange(lanes) % 2, -0.0, 0.0)
    x[5] = 1.5
    mask[6] = True
    return x, mask


def same_bits(a, b) -> bool:
    """Bitwise equality of two float32 (or integer/bool) tensors."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b.to(a.device))
