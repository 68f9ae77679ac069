"""Distributed execution: the ``(days, tickers)`` mesh of ranks, its
layouts, and the collectives.

The port of the JAX package's ``parallel/``. JAX shards one program over
a device mesh from one controller (``shard_map``); here each mesh
coordinate is a process of its own on ``torch.distributed`` (one rank a
card, or several ranks sharing one), and the per-rank bodies call the
collectives on the mesh axis's process group:

* :mod:`.mesh` — the :class:`Mesh` over ``init_device_mesh``, the layout
  descriptions, and each rank's block of a host array;
* :mod:`.collectives` — the only cross-ticker operations (moment
  statistics as all-reduces, ranks and quantile cuts as all-gathers of
  the cross-section) and the 2-D loop's cross-day carry handoff;
* :mod:`.transport` — the collectives' NCCL/gloo transport, and the
  in-process one;
* :mod:`.local` — the in-process mesh (:class:`.local.LocalMesh`, from
  ``resident_mesh(n, devices=[...])``): one process drives a device
  list, a worker thread a shard, and the same per-rank bodies run on
  each shard (the server's placements: a ticker-sharded stream carry, a
  population-sharded discovery generation);
* :mod:`.multihost` — the process group (``init_process_group``) and the
  global mesh over hosts;
* :mod:`.launch` — N ranks on this host in spawned processes.
"""

from .collectives import (
    sharded_compute_factors,
    xs_carry_handoff_local,
    xs_global_rank_local,
    xs_masked_mean,
    xs_masked_std,
    xs_pearson,
    xs_qcut,
    xs_rank,
)
from .local import LocalMesh
from .mesh import (
    DAYS_AXIS,
    TICKERS_AXIS,
    Mesh,
    day_batch_spec,
    make_mesh,
    mask_spec,
    packed_year_2d_spec,
    packed_year_spec,
    put_packed_year,
    put_packed_year_2d,
    put_span_carry,
    resident_mesh,
    scan_output_2d_spec,
    scan_output_spec,
    shard_day_batch,
    span_carry_spec,
)

__all__ = [
    "DAYS_AXIS",
    "TICKERS_AXIS",
    "LocalMesh",
    "Mesh",
    "make_mesh",
    "day_batch_spec",
    "mask_spec",
    "packed_year_spec",
    "packed_year_2d_spec",
    "put_packed_year",
    "put_packed_year_2d",
    "put_span_carry",
    "resident_mesh",
    "scan_output_spec",
    "scan_output_2d_spec",
    "span_carry_spec",
    "shard_day_batch",
    "xs_carry_handoff_local",
    "xs_global_rank_local",
    "sharded_compute_factors",
    "xs_masked_mean",
    "xs_masked_std",
    "xs_pearson",
    "xs_qcut",
    "xs_rank",
]
