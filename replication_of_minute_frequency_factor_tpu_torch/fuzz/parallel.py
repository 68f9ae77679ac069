"""Sharded-against-local fuzz (``tools/fuzz/fuzz_parallel.py``) on the
in-process mesh (``parallel.resident_mesh(n, devices=[device] * n)``: a
worker thread a shard, every shard on ``device``).

* The cross-sectional collectives (``xs_masked_mean``, ``xs_masked_std``,
  ``xs_pearson``, ``xs_rank``, ``xs_qcut``) over the sharded tickers
  axis, zero-padded to a shard multiple, against the single-device ops
  on the whole frame: all-masked dates, single valid lanes, inexact
  constant cross-sections, ties across shard boundaries, inf/NaN poison
  on masked lanes. The NaN pattern of the correlation must match both
  ways (a finite sharded value where the local one is NaN is never
  excused); the qcut labels bit for bit.
* The sharded factor graph (``shard_day_batch`` +
  ``sharded_compute_factors``) against ``compute_factors`` on one
  device: the same finite pattern and values within rtol 5e-5.

The JAX harness's mesh pool is ``(days, tickers)``; the in-process mesh
is tickers-only, so a case runs on its draw's tickers extent.
"""

from __future__ import annotations

import numpy as np
import torch

from . import scenarios


def pad_xs(x, m, mult):
    """Zero-pad the tickers axis to a shard multiple, mask=False lanes."""
    rem = x.shape[-1] % mult
    if rem == 0:
        return x, m
    pad = mult - rem
    return np.pad(x, [(0, 0), (0, pad)]), np.pad(m, [(0, 0), (0, pad)])


class Meshes:
    """In-process meshes of ``n`` shards on one device, built once."""

    def __init__(self, dev):
        self.dev = dev
        self._meshes = {}

    def __call__(self, n: int):
        from ..parallel import resident_mesh

        if n not in self._meshes:
            self._meshes[n] = resident_mesh(n, devices=[self.dev] * n)
        return self._meshes[n]

    def close(self) -> None:
        for mesh in self._meshes.values():
            mesh.close()
        self._meshes.clear()


def xs_case(c, meshes, seed) -> None:
    from .. import eval_ops, ops
    from ..parallel import collectives as xc
    from ..parallel.mesh import local_slice

    n = c["shards"]
    mesh = meshes(n)
    x, y, m, k = c["x"], c["y"], c["m"], c["k"]
    n_t = x.shape[1]
    xp, mp = pad_xs(x, m, n)
    yp, _ = pad_xs(y, m, n)

    def body(view):
        spec = (None, "tickers")
        lx, ly, lm = (torch.from_numpy(np.ascontiguousarray(
            local_slice(a, spec, view))).to(view.device)
            for a in (xp, yp, mp))
        # masked-out lanes may hold poison: the collectives never read
        # them, so they go as they are
        return (xc.xs_masked_mean(view, lx, lm),
                xc.xs_masked_std(view, lx, lm),
                xc.xs_pearson(view, lx, ly, lm),
                xc.xs_rank(view, lx, lm),
                xc.xs_qcut(view, lx, lm, group_num=k))

    outs = mesh.run(body)
    host = lambda t: t.cpu().numpy()  # noqa: E731
    mean, std, ic = (host(outs[0][i]) for i in range(3))
    rk = np.concatenate([host(o[3]) for o in outs], -1)[:, :n_t]
    qc = np.concatenate([host(o[4]) for o in outs], -1)[:, :n_t]
    dev = meshes.dev

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    xcl = np.where(m, x, 0.0).astype(np.float32)
    ycl = np.where(m, y, 0.0).astype(np.float32)
    ref_mean = host(ops.masked_mean(on(xcl), on(m)))
    ref_std = host(ops.masked_std(on(xcl), on(m)))
    ref_ic = host(ops.masked_corr(on(xcl), on(ycl), on(m)))
    ref_rk = host(ops.rank_average(on(xcl), on(m)))
    # on the same padded matrix the sharded call saw: what is fuzzed is
    # the gather/slice round trip, not the qcut core
    ref_qc = host(eval_ops._qcut_labels(on(xp), on(mp), k))[:, :n_t]
    np.testing.assert_allclose(mean, ref_mean, rtol=2e-4, atol=1e-5,
                               equal_nan=True, err_msg=f"{seed} mean")
    np.testing.assert_allclose(std, ref_std, rtol=2e-4, atol=1e-5,
                               equal_nan=True, err_msg=f"{seed} std")
    fin, ref_fin = np.isfinite(ic), np.isfinite(ref_ic)
    assert not (fin & ~ref_fin).any(), \
        (seed, "sharded finite where local NaN", ic, ref_ic)
    lost = ~fin & ref_fin
    assert np.abs(ref_ic[lost]).max(initial=0) < 2e-3, \
        (seed, "sharded NaN where local finite", ic, ref_ic)
    both = fin & ref_fin
    np.testing.assert_allclose(ic[both], ref_ic[both], rtol=2e-3, atol=2e-3,
                               err_msg=f"{seed} ic")
    np.testing.assert_allclose(rk[m], ref_rk[m], rtol=1e-6,
                               err_msg=f"{seed} rank")
    np.testing.assert_array_equal(qc, ref_qc, err_msg=f"{seed} qcut k={k}")


def factor_case(c, meshes, seed) -> None:
    from ..models import factor_names
    from ..models.registry import compute_factors
    from ..parallel import shard_day_batch, sharded_compute_factors

    n = c["shards"]
    mesh = meshes(n)
    bars, mask = c["bars"], c["mask"]
    names = factor_names() if c["names"] is None else c["names"]
    n_d, n_t = mask.shape[:2]

    def body(view):
        b, m, nt = shard_day_batch(bars, mask, view)
        assert nt == n_t
        return sharded_compute_factors(b, m, view, names=names)

    outs = mesh.run(body)
    dev = meshes.dev
    local = compute_factors(torch.from_numpy(bars).to(dev),
                            torch.from_numpy(mask).to(dev), names=names)
    for k in names:
        a = local[k].cpu().numpy()
        b = np.concatenate([o[k].cpu().numpy() for o in outs],
                           -1)[:n_d, :n_t]
        assert a.shape == b.shape, (seed, k, a.shape, b.shape)
        same = np.isfinite(a) == np.isfinite(b)
        assert same.all(), (seed, k, "finite pattern",
                            np.argwhere(~same)[:4])
        f = np.isfinite(a)
        np.testing.assert_allclose(a[f], b[f], rtol=5e-5, atol=1e-7,
                                   err_msg=f"{seed} {k}")
        assert (np.isnan(a) == np.isnan(b)).all(), (seed, k, "nan pattern")


def check_case(seed: int, meshes) -> None:
    xs, fac = scenarios.parallel_case(seed)
    xs_case(xs, meshes, seed)
    if fac is not None:
        factor_case(fac, meshes, seed)


def run(lo: int, hi: int, device="cuda"):
    from . import device_of, sweep

    meshes = Meshes(device_of(device))
    try:
        return sweep("parallel", range(lo, hi),
                     lambda s: check_case(s, meshes), every=25)
    finally:
        meshes.close()
