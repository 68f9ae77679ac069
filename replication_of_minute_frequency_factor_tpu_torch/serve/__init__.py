"""The serving layer's pieces the port has: the keyed callable cache the
streaming engine builds through (:class:`ExecutableCache`)."""

from .executables import ExecutableCache  # noqa: F401
