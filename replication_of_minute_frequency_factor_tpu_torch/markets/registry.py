"""Registered market sessions (the port's copy of the JAX package's
``markets/registry.py``).

Ships four specs out of the box:

* ``cn_ashare_240`` — the canonical A-share day (the default
  everywhere);
* ``us_390`` — the US cash session, 09:30-16:00 continuous, 390 slots;
* ``hk_halfday`` — the HK half-day session (09:30-12:00 morning only,
  150 slots; typhoon / holiday-eve days);
* ``crypto_1440`` — a 24x7 venue's 1440-slot day (00:00-24:00): six
  times the canonical day depth.

``register_session`` admits new markets; tests/test_torch_markets.py
holds every registered spec equal to the JAX package's.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple, Union

from .spec import SessionSpec

_LOCK = threading.Lock()

#: name -> spec of every registered session
SESSIONS: Dict[str, SessionSpec] = {}


def register_session(spec: SessionSpec) -> SessionSpec:
    """Register a spec under its name. Re-registering the SAME spec is
    idempotent; a different spec under an existing name fails loudly
    (silently swapping a name's meaning would poison every result
    keyed by name)."""
    with _LOCK:
        have = SESSIONS.get(spec.name)
        if have is not None and have != spec:
            raise ValueError(
                f"session {spec.name!r} is already registered with a "
                "different layout — pick a new name")
        SESSIONS[spec.name] = spec
    return spec


#: the canonical A-share spec. T_NOON carries the historical 11:30
#: constant (the derived rule lands on 11:29, the last AM slot; both
#: bound identical on-grid masks, but byte-for-byte means byte-for-byte)
CN_ASHARE_240 = register_session(SessionSpec(
    name="cn_ashare_240",
    segments=((9 * 60 + 30, 120), (13 * 60, 120)),
    calendar="cn_ashare",
    sentinel_overrides=(("T_NOON", 113000000),),
))

US_390 = register_session(SessionSpec(
    name="us_390",
    segments=((9 * 60 + 30, 390),),
    calendar="us_equities",
))

HK_HALFDAY = register_session(SessionSpec(
    name="hk_halfday",
    segments=((9 * 60 + 30, 150),),
    calendar="hk_sehk",
))

CRYPTO_1440 = register_session(SessionSpec(
    name="crypto_1440",
    segments=((0, 1440),),
    calendar="24x7",
))

#: the default session everywhere a caller passes None
DEFAULT_SESSION = CN_ASHARE_240


def get_session(session: Union[None, str, SessionSpec]) -> SessionSpec:
    """Resolve ``None`` (the default), a registry name, or a spec."""
    if session is None:
        return DEFAULT_SESSION
    if isinstance(session, SessionSpec):
        return session
    with _LOCK:
        try:
            return SESSIONS[session]
        except KeyError:
            raise KeyError(
                f"unknown session {session!r}; registered: "
                f"{sorted(SESSIONS)}") from None


def session_names() -> Tuple[str, ...]:
    with _LOCK:
        return tuple(sorted(SESSIONS))


def is_default(session: Union[None, str, SessionSpec]) -> bool:
    """Whether ``session`` resolves to the canonical default spec (the
    regress/bench series discriminator)."""
    return get_session(session) == DEFAULT_SESSION
