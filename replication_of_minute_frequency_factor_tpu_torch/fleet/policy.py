"""Shed/degrade policy: which replicas are routing candidates NOW.

The port of the JAX package's ``fleet/policy.py``, host code only.
Driven by the EXISTING signals only — nothing here invents a health
model:

* **breaker state** — :meth:`..serve.service.FactorServer.breaker_state`
  (``open`` demotes; the replica's own half-open probe logic stays the
  per-replica arbiter);
* **HBM headroom** — the replica telemetry's ``device.hbm_bytes_in_use``
  watermarks (:meth:`..fleet.replica.Replica.hbm_bytes`) against the
  exposure-cache byte budget scaled by ``hbm_headroom_frac``: a replica
  whose device bytes blow past what its cache budget explains is
  demoted before it runs out of memory mid-request. Only MEASURED
  watermarks demote (``available`` true) — the CPU, which has no
  reading, never drains a replica. Replicas that share a card read the
  same card's bytes, so each is held against the whole card's use.

The ladder per replica: ``candidate`` → (breaker open / HBM over) →
``demoted`` (drained: no routing, ingest fan-out skips it, the flight
recorder dumps naming it) → cooldown lapse → ``probing`` (re-admitted
to candidacy; the replica's own breaker arbitrates the half-open probe)
→ first completed request restores (``candidate``) or re-demotes.

Pod-level shed: :meth:`ShedPolicy.candidates` empty means EVERY replica
is out — the router raises a pod shed (503 + ``Retry-After`` derived
from the shortest remaining demotion cooldown).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

CANDIDATE = "candidate"
DEMOTED = "demoted"
PROBING = "probing"

#: the lock contract the runtime lock-assertion twin
#: (telemetry/lockcheck.py) checks: the candidacy ladder is read by
#: every routed request and flipped by refresh/note_result from
#: whichever thread routes. ``_demote`` is the documented
#: caller-holds-lock helper — refresh() takes the lock for the state
#: flip and runs the dump outside it — so it is declared ``locked``.
GLC_CONTRACT = {
    "ShedPolicy": {
        "lock": "_lock",
        "guards": ("_state", "_until", "_reason"),
        "init": (),
        "locked": ("_demote",),
    },
}


class ShedPolicy:
    """Per-replica routing-candidacy state machine over the breaker +
    HBM signals. All transitions are counter/event-instrumented under
    ``fleet.*`` and a demotion force-dumps the replica's flight
    recorder with the replica named in the trigger extra."""

    def __init__(self, replicas, telemetry=None,
                 cooldown_s: float = 1.0,
                 hbm_headroom_frac: float = 1.5):
        from ..telemetry import get_telemetry
        self.replicas = list(replicas)
        self.telemetry = (telemetry if telemetry is not None
                          else get_telemetry())
        self.cooldown_s = float(cooldown_s)
        self.hbm_headroom_frac = float(hbm_headroom_frac)
        self._lock = threading.Lock()
        self._state: Dict[str, str] = {r.label: CANDIDATE
                                       for r in self.replicas}
        self._until: Dict[str, float] = {}
        self._reason: Dict[str, str] = {}
        from ..telemetry.lockcheck import maybe_install
        maybe_install(self)

    # --- signal reads ---------------------------------------------------
    def _hbm_over(self, replica) -> bool:
        in_use, available = replica.hbm_bytes()
        if not available:
            return False  # no measured reading never demotes
        budget = (replica.server.scfg.cache_bytes
                  * self.hbm_headroom_frac)
        return budget > 0 and in_use > budget

    # --- transitions ----------------------------------------------------
    def _factor_health_audit(self, replica) -> dict:
        """The replica's factor-health snapshot at demote time: MEASURED
        data quality joins the demote-signal audit trail — the event and
        the flight dump record what the factors looked like when the
        machine-level signal fired — but it is NOT a demote signal
        itself: only the breaker and measured HBM demote. Never raises
        (an audit read must not block a state flip)."""
        try:
            block = replica.telemetry.factorplane.summary()
            return {"available": bool(block.get("available")),
                    "worst_coverage": block.get("worst_coverage"),
                    "widen_rate": block.get("widen_rate"),
                    "drift_bursts": (block.get("drift")
                                     or {}).get("bursts")}
        except Exception:  # noqa: BLE001 — audit only
            return {"available": False}

    def _demote(self, replica, reason: str) -> None:
        """candidate/probing -> demoted (caller holds the lock for the
        state flip; the dump runs outside it)."""
        self._state[replica.label] = DEMOTED
        self._until[replica.label] = time.monotonic() + self.cooldown_s
        self._reason[replica.label] = reason
        self.telemetry.counter("fleet.demotions",
                               replica=replica.label, reason=reason)
        self.telemetry.event("fleet.demote", replica=replica.label,
                             reason=reason,
                             factor_health=self._factor_health_audit(
                                 replica))

    def refresh(self) -> None:
        """One pass over the signals: demote tripped/over-budget
        candidates, move cooled-down demoted replicas to probing."""
        dumps = []
        with self._lock:
            now = time.monotonic()
            for r in self.replicas:
                state = self._state[r.label]
                breaker = r.server.breaker_state()
                if state == CANDIDATE:
                    if breaker == "open":
                        self._demote(r, "breaker")
                        dumps.append((r, "breaker"))
                    elif self._hbm_over(r):
                        self._demote(r, "hbm")
                        dumps.append((r, "hbm"))
                elif state == DEMOTED:
                    if (now >= self._until.get(r.label, 0.0)
                            and breaker != "open"
                            and not self._hbm_over(r)):
                        self._state[r.label] = PROBING
                        self.telemetry.counter("fleet.probes",
                                               replica=r.label)
            self._note_gauges()
        for r, reason in dumps:
            # the anomaly evidence: the demoted replica's own flight
            # recorder dumps its recent requests with the demotion
            # naming it — forced, outside the lock. The factor-health
            # snapshot rides as audit context, never a demote signal
            r.server.flight.dump(
                "fleet_demote", force=True,
                extra={"replica": r.label, "reason": reason,
                       "factor_health": self._factor_health_audit(r)})

    def note_result(self, label: str, ok: bool) -> None:
        """A routed request's outcome: a probing replica is restored on
        success, re-demoted (fresh cooldown) on failure. Candidate
        failures are left to the replica's own breaker — the next
        refresh reads it."""
        with self._lock:
            if self._state.get(label) != PROBING:
                return
            if ok:
                self._state[label] = CANDIDATE
                self._until.pop(label, None)
                self._reason.pop(label, None)
                self.telemetry.counter("fleet.restores", replica=label)
                self.telemetry.event("fleet.restore", replica=label)
            else:
                self._state[label] = DEMOTED
                self._until[label] = time.monotonic() + self.cooldown_s
                self.telemetry.counter("fleet.demotions",
                                       replica=label,
                                       reason="probe_failed")
            self._note_gauges()

    def _note_gauges(self) -> None:
        live = sum(1 for s in self._state.values() if s != DEMOTED)
        self.telemetry.gauge("fleet.replicas_live", live)
        self.telemetry.gauge("fleet.replicas_demoted",
                             len(self._state) - live)

    # --- reads ----------------------------------------------------------
    def state(self, label: str) -> str:
        with self._lock:
            return self._state.get(label, DEMOTED)

    def candidates(self, stream_only: bool = False) -> List:
        """Routing-eligible replicas (candidate + probing) after a
        signal refresh; ``stream_only`` restricts to stream-enabled
        ones (the ingest fan-out's view). Empty means pod shed."""
        self.refresh()
        with self._lock:
            out = [r for r in self.replicas
                   if self._state[r.label] != DEMOTED
                   and (not stream_only or r.stream)]
        return out

    def retry_after_s(self, default: float = 1.0) -> float:
        """The pod shed's backoff hint: the SHORTEST remaining demotion
        cooldown (the soonest a probe could readmit a replica), else
        ``default``."""
        with self._lock:
            now = time.monotonic()
            remaining = [u - now for l_, u in self._until.items()
                         if self._state.get(l_) == DEMOTED]
        live = [r for r in remaining if r > 0]
        return min(live) if live else default

    def snapshot(self) -> dict:
        """The health rollup's view: per-replica state + demotion
        reasons."""
        with self._lock:
            return {
                "states": dict(self._state),
                "demoted": sorted(l_ for l_, s in self._state.items()
                                  if s == DEMOTED),
                "reasons": dict(self._reason),
            }
