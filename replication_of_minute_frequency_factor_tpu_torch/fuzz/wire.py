"""Wire fuzz: the port's native (C++) ingest-wire encoder against its
numpy encoder, byte for byte, over random batch shapes, price scales and
pathologies (``tools/fuzz/fuzz_wire.py``); then the packed buffer decoded
on the device, bit for bit the CPU's decode, and within 3e-7 relative of
the bars on every present lane.
"""

from __future__ import annotations

import numpy as np
import torch

from . import scenarios

_FIELDS = "base dclose dohl volume mask vs".split()


def check_case(seed: int, dev) -> None:
    from ..data import wire

    bars, mask = scenarios.wire_case(seed)
    fa, fb = {}, {}
    with np.errstate(invalid="ignore"):  # garbage on dead lanes
        a = wire.encode(bars, mask, use_native=True, floor=fa)
        b = wire.encode(bars, mask, use_native=False, floor=fb)
    assert (a is None) == (b is None), (a is None, b is None)
    if a is None:
        return
    assert fa == fb, (fa, fb)
    assert a.modes == b.modes, (a.modes, b.modes)
    for x, y, nm in zip(a.arrays, b.arrays, _FIELDS):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, (nm, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=nm)
    buf, spec = wire.pack_arrays(a.arrays)
    host = wire.decode(*wire.unpack(torch.from_numpy(buf), spec))
    got = wire.decode(*wire.unpack(torch.from_numpy(buf).to(dev), spec))
    db, dm = (t.cpu() for t in got)
    assert torch.equal(dm, host[1]), "mask: device decode != CPU decode"
    assert torch.equal(db.view(torch.int32), host[0].view(torch.int32)), \
        "bars: device decode != CPU decode"
    assert np.array_equal(dm.numpy(), mask), "decoded mask != mask"
    d = db.numpy()
    err = np.abs(d[mask] - bars[mask]) / np.maximum(np.abs(bars[mask]), 1e-6)
    assert err.max(initial=0.0) < 3e-7, err.max()


def run(lo: int, hi: int, device="cuda"):
    from . import device_of, sweep

    dev = device_of(device)
    return sweep("wire", range(lo, hi), lambda s: check_case(s, dev),
                 every=100)
