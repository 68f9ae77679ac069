"""The table of peaks and the operations and bytes of the kernels whose
roofline share the benchmark reports, worked out from the cell's shapes
so that the share reads the same work whatever implements it."""

from __future__ import annotations

#: one NVIDIA H100 SXM's HBM3 bandwidth (NVIDIA's data sheet), at the
#: card's full power limit of 700 W
HBM_BYTES_PER_S = 3.35e12


def moment_bytes(rows: int, slots: int) -> int:
    """Bytes one rolling second-moment call must move over ``[rows,
    slots]``: four f32 inputs (the centred x and y, their window means)
    read once and three f32 outputs (s_xx, s_yy, s_xy) written once."""
    return 7 * 4 * rows * slots


def moment_least_s(rows: int, slots: int) -> float:
    """The least time of one call on the card: its bytes at the HBM
    rate (its 5 FP32 instructions a window term stay under that bound at
    window 50)."""
    return moment_bytes(rows, slots) / HBM_BYTES_PER_S
