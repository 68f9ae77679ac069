"""Market session specs: the factor kernels beyond the 240-minute
A-share day."""

from .spec import SessionSpec  # noqa: F401
from .registry import (  # noqa: F401
    CN_ASHARE_240,
    CRYPTO_1440,
    DEFAULT_SESSION,
    HK_HALFDAY,
    SESSIONS,
    US_390,
    get_session,
    is_default,
    register_session,
    session_names,
)
