"""PyTorch/CUDA port of the minute-frequency factor framework.

A package of its own beside the JAX package
(``replication_of_minute_frequency_factor_tpu``), which stays the
reference: the same module layout and names, written in torch, with the
JAX package's Pallas TPU kernel rewritten by hand for Hopper (``csrc/``).
It imports neither jax nor the JAX package.

Ported so far: session specs, pins and config, gridding and synthetic
days (numpy and the native C++ packer), the ingest wire (:mod:`.data.wire`:
native and numpy encoders, device decode), the masked/rank/top-k/segment/
rolling ops, ``DayContext`` and all 58 factors; two batch entry points,
:func:`compute_batch` (bars and mask) and :func:`compute_packed` (one
packed wire or raw buffer, decoded on the device); the host driver,
:func:`compute_exposures` (day files in, the :class:`ExposureTable` cache
out); the evaluation, :class:`Factor` and :class:`MinFreqFactor`
(coverage, IC/rank-IC, the quantile group test, ``cal_final_exposure``);
the command line (``python -m replication_of_minute_frequency_factor_tpu_torch``);
and the intraday streaming engine (:class:`StreamEngine`: a day's carry on
the device, folded minute by minute, with exact and fast snapshots), with
the packed path's result wire and factor-stats side outputs; the resident
year loop, :func:`compute_packed_resident` (N device-resident buffers, no
host round trip, one fetch; the inputs donated on the card); the factor
server and discovery; the profiler capture and trace attribution, the f64
oracle as ``backend='numpy'``, and the bundle tools; multi-GPU runs on
``torch.distributed`` (:mod:`.parallel`: a ``(days, tickers)`` mesh of
ranks, the collectives, the sharded and 2-D resident loops, and the
driver sharded over ranks with ``Config(mesh_shape=(1, n))``).
Entry points run on the card unless the caller passes ``device='cpu'``.
"""

from .config import Config, get_config, set_config  # noqa: F401
from .data import wire  # noqa: F401
from .factor import Factor  # noqa: F401
from .minfreq import MinFreqFactor  # noqa: F401
from .pipeline import (  # noqa: F401
    ExposureTable, compute_batch, compute_exposures,
    compute_exposures_streamed, compute_packed, compute_packed_resident)
from .stream import StreamEngine  # noqa: F401
