"""L0 data plane: long-format minute bars -> dense day arrays."""

from .minute import (  # noqa: F401
    DayGrid, FIELDS, grid_day, F_OPEN, F_HIGH, F_LOW, F_CLOSE, F_VOLUME)
from .synthetic import synth_day  # noqa: F401
