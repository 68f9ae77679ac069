"""Host values onto a device without a host wait.

A copy from pageable host memory to the card waits for the stream to
drain (``torch.tensor(values, device='cuda')`` does one), which would put
a host sync inside a loop that must enqueue without one
(``pipeline.compute_packed_resident``). On the card the values go up
from pinned memory, not waited for, on the current stream; on the CPU
this is ``torch.tensor`` as before, the same bits either way.
"""

from __future__ import annotations

import torch


def to_device(values, device, dtype=None) -> torch.Tensor:
    """``values`` (a numpy array, a list or a scalar, copied) as a tensor on
    ``device``, copied without a host wait when ``device`` is the card."""
    host = torch.tensor(values, dtype=dtype)
    device = torch.device(device)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)
