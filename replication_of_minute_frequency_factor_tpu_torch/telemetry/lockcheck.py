"""Runtime lock assertions: assert the owning lock is held.

Opt-in debug mode (``Config.debug_lock_assert`` / ``MFF_LOCK_ASSERT=1``)
that arms the same ``GLC_CONTRACT`` declarations the static tier
checks (analysis/concurrency_tier.py). Where the static tier proves
lexical lock scope at review time, this twin checks the *dynamic*
fact — the declared lock is held by the current thread at the moment a
guarded attribute or container is mutated — so a discipline regression
fails deterministically with a named attribute instead of flaking
under load. The tier-1 registry/serve/fleet hammer tests run with it
armed.

Mechanics: ``maybe_install(instance)`` (a no-op unless armed, called
at the end of a contract class's ``__init__``) (1) wraps the declared
lock in an owner-tracking proxy, (2) swaps the instance's class for a
cached subclass whose ``__setattr__`` checks guarded rebinds, and
(3) replaces guarded list/dict/set/deque values with checking proxies
that assert on every in-place mutator. A violation counts
``lockcheck.violations`` and raises ``LockAssertionError`` with the
diagnostic::

    lockcheck: <Class>.<attr> mutated without holding <Class>.<lock>

Counters (docs/observability.md): ``lockcheck.installs`` — instances
armed; ``lockcheck.violations`` — unguarded mutations caught (labels:
``cls``, ``attr``).
"""

from __future__ import annotations

import collections
import os
import sys
import threading
from typing import Dict, Optional

ENV_FLAG = "MFF_LOCK_ASSERT"


class LockAssertionError(AssertionError):
    """A guarded mutation ran without the declared lock held."""


def enabled() -> bool:
    """Armed? Env var wins; else the Config field."""
    raw = os.environ.get(ENV_FLAG)
    if raw is not None:
        return raw not in ("", "0", "false", "False")
    try:
        from ..config import get_config
        return bool(getattr(get_config(), "debug_lock_assert", False))
    except Exception:  # noqa: BLE001 — debug mode must never break init
        return False


def _count(name: str, **labels) -> None:
    # Peek at the already-created global telemetry instead of calling
    # get_telemetry(): forcing creation here would re-enter
    # get_telemetry()'s init lock when the GLOBAL Telemetry's own
    # registry arms during construction — a self-deadlock.
    try:
        mod = sys.modules.get(__package__ or "")
        tel = getattr(mod, "_current", None)
        if tel is not None:
            tel.counter(name, **labels)
    except Exception:  # noqa: BLE001 — diagnostics, not control flow
        pass


class OwnedLock:
    """A lock proxy that remembers which thread holds it.

    Wraps the contract class's real lock so ``with self._lock:`` keeps
    working unchanged; ``held_by_current_thread()`` is the question the
    checking mutators ask."""

    __slots__ = ("_lock", "_owner")

    def __init__(self, lock=None):
        self._lock = lock if lock is not None else threading.Lock()
        self._owner: Optional[int] = None

    def acquire(self, *args, **kwargs) -> bool:
        got = self._lock.acquire(*args, **kwargs)
        if got:
            self._owner = threading.get_ident()
        return got

    def release(self) -> None:
        self._owner = None
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def held_by_current_thread(self) -> bool:
        return self._owner == threading.get_ident()

    def __enter__(self) -> "OwnedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


def _violation(cls_name: str, attr: str, lock_name: str) -> None:
    _count("lockcheck.violations", cls=cls_name, attr=attr)
    thread = threading.current_thread().name
    raise LockAssertionError(
        f"lockcheck: {cls_name}.{attr} mutated without holding "
        f"{cls_name}.{lock_name} (thread={thread})")


class _Guard:
    """Everything a checking mutator needs to decide and report."""

    __slots__ = ("cls_name", "attr", "lock_name", "lock")

    def __init__(self, cls_name: str, attr: str, lock_name: str,
                 lock: OwnedLock):
        self.cls_name = cls_name
        self.attr = attr
        self.lock_name = lock_name
        self.lock = lock

    def check(self) -> None:
        if not self.lock.held_by_current_thread():
            _violation(self.cls_name, self.attr, self.lock_name)


def _checked_container(value, guard: _Guard):
    """A checking proxy for a mutable container, or ``value`` as-is."""
    if isinstance(value, _CHECKED_TYPES):
        value.__dict__["_lockcheck_guard"] = guard  # re-point on rebind
        return value
    if isinstance(value, collections.deque):
        return _CheckedDeque(value, guard)
    if type(value) is list:
        return _CheckedList(value, guard)
    if type(value) is dict:
        return _CheckedDict(value, guard)
    if type(value) is set:
        return _CheckedSet(value, guard)
    return value


def _checked_method(name):
    def method(self, *args, **kwargs):
        self._lockcheck_guard.check()
        return getattr(super(type(self), self), name)(*args, **kwargs)
    method.__name__ = name
    return method


def _make_checked(base, mutators):
    ns = {name: _checked_method(name) for name in mutators}

    def __init__(self, value, guard):
        base.__init__(self, value)
        self.__dict__["_lockcheck_guard"] = guard

    ns["__init__"] = __init__
    ns["__reduce__"] = lambda self: (base, (base(self),))
    return type("Checked" + base.__name__.capitalize(), (base,), ns)


_LIST_MUTATORS = ("append", "extend", "insert", "remove", "pop",
                  "clear", "sort", "reverse", "__setitem__",
                  "__delitem__", "__iadd__")
_DICT_MUTATORS = ("__setitem__", "__delitem__", "update", "pop",
                  "popitem", "clear", "setdefault")
_SET_MUTATORS = ("add", "remove", "discard", "pop", "clear", "update",
                 "difference_update", "intersection_update",
                 "symmetric_difference_update", "__iand__", "__ior__",
                 "__ixor__", "__isub__")
_DEQUE_MUTATORS = ("append", "appendleft", "extend", "extendleft",
                   "insert", "remove", "pop", "popleft", "clear",
                   "rotate", "__setitem__", "__delitem__", "__iadd__")

_CheckedList = _make_checked(list, _LIST_MUTATORS)
_CheckedDict = _make_checked(dict, _DICT_MUTATORS)
_CheckedSet = _make_checked(set, _SET_MUTATORS)


class _CheckedDeque(collections.deque):
    def __init__(self, value: collections.deque, guard: _Guard):
        super().__init__(value, value.maxlen)
        self.__dict__["_lockcheck_guard"] = guard

    def __reduce__(self):
        return (collections.deque, (list(self), self.maxlen))


for _name in _DEQUE_MUTATORS:
    setattr(_CheckedDeque, _name, _checked_method(_name))

_CHECKED_TYPES = (_CheckedList, _CheckedDict, _CheckedSet,
                  _CheckedDeque)


def _find_contract(cls) -> Optional[dict]:
    """The class's GLC_CONTRACT entry, searching the MRO so already-
    swapped (lock-checked) subclasses resolve to their base."""
    for klass in cls.__mro__:
        mod = sys.modules.get(klass.__module__)
        contract = getattr(mod, "GLC_CONTRACT", None)
        if isinstance(contract, dict) and klass.__name__ in contract:
            return contract[klass.__name__]
    return None


_subclass_cache: Dict[type, type] = {}


def _checked_class(cls, lock_name: str, guards: frozenset) -> type:
    sub = _subclass_cache.get(cls)
    if sub is not None:
        return sub

    def __setattr__(self, name, value,
                    _guards=guards, _lock_name=lock_name, _base=cls):
        if name in _guards:
            lock = self.__dict__.get(_lock_name)
            if isinstance(lock, OwnedLock) \
                    and not lock.held_by_current_thread():
                _violation(_base.__name__, name, _lock_name)
            if isinstance(lock, OwnedLock):
                value = _checked_container(
                    value, _Guard(_base.__name__, name, _lock_name,
                                  lock))
        object.__setattr__(self, name, value)

    sub = type("LockChecked" + cls.__name__, (cls,),
               {"__setattr__": __setattr__,
                "__lockcheck_armed__": True})
    _subclass_cache[cls] = sub
    return sub


def install(instance) -> None:
    """Arm one instance: wrap its lock, swap in the checking subclass,
    proxy its guarded containers. Call at the END of ``__init__`` —
    every guarded attribute must already exist."""
    cls = type(instance)
    if getattr(cls, "__lockcheck_armed__", False):
        return
    contract = _find_contract(cls)
    if contract is None:
        return
    lock_name = contract["lock"]
    guards = frozenset(contract.get("guards", ()))
    lock = getattr(instance, lock_name, None)
    if lock is None:
        return
    if not isinstance(lock, OwnedLock):
        lock = OwnedLock(lock)
        object.__setattr__(instance, lock_name, lock)
    instance.__class__ = _checked_class(cls, lock_name, guards)
    for attr in guards:
        value = instance.__dict__.get(attr)
        if value is not None:
            guard = _Guard(cls.__name__, attr, lock_name, lock)
            object.__setattr__(instance, attr,
                               _checked_container(value, guard))
    _count("lockcheck.installs", cls=cls.__name__)


def maybe_install(instance) -> None:
    """``install`` iff the debug mode is armed; free when it is not."""
    if enabled():
        install(instance)
