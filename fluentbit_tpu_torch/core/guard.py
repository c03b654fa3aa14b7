"""Circuit breakers and bounded I/O awaits.

The port's own copy of the breaker half of ``fluentbit_tpu/core/guard.py``:

- :func:`io_deadline` bounds one socket await and raises the builtin
  ``TimeoutError`` (an ``OSError``), so a caller's socket error handling
  engages as it is;
- :class:`CircuitBreaker`, the closed → open → half-open state machine
  (consecutive and windowed trips, one probe after the cooldown,
  ``available()`` as the non-consuming view), whole, with a clock that
  can be injected;
- :class:`Guard`, the engine's registry of named breakers built from the
  service's ``guard.breaker_*`` keys, with the
  ``fluentbit_guard_breaker_state`` gauge and the
  ``fluentbit_guard_breaker_transitions_total`` counter.

The forward output keeps one breaker a destination here, and
``core.upstream.UpstreamNode`` one a node. The rest of the reference's
guard (flush deadlines, load shedding, the watchdog and its gauges,
``health()``, and the engine-level use of the breakers on every
output's flush) is not ported: its service keys raise by name.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

log = logging.getLogger("flb.guard")

#: Default bound for one socket await inside a flush path.
DEFAULT_IO_TIMEOUT = 30.0


async def io_deadline(awaitable, timeout: float = DEFAULT_IO_TIMEOUT):
    """Bound one I/O await with a deadline, raising the builtin
    ``TimeoutError`` (an ``OSError`` subclass) when it expires."""
    try:
        return await asyncio.wait_for(awaitable, timeout)
    except asyncio.TimeoutError:
        raise TimeoutError(
            f"I/O deadline ({timeout:g}s) expired") from None


#: Gauge encoding, severity-ordered for dashboards.
STATE_CLOSED, STATE_HALF_OPEN, STATE_OPEN = 0, 1, 2
_STATE_NAMES = {STATE_CLOSED: "closed", STATE_HALF_OPEN: "half-open",
                STATE_OPEN: "open"}
_STATE_CODES = {v: k for k, v in _STATE_NAMES.items()}


class CircuitBreaker:
    """Closed → open → half-open state machine over outcomes.

    - CLOSED: everything flows; ``failures`` consecutive failures OR a
      full ``window`` of outcomes at ≥ ``error_rate`` opens it.
    - OPEN: :meth:`allow` refuses until ``cooldown`` elapses, then the
      breaker goes HALF_OPEN and admits the caller as the probe.
    - HALF_OPEN: one probe in flight; ``probes`` successes close, any
      failure re-opens with a fresh cooldown.

    ``available()`` is the non-consuming view (HA ``pick``): True
    whenever a request could be admitted. Thread-safe; transition
    callbacks fire outside the lock.
    """

    def __init__(self, name: str, failures: int = 5,
                 error_rate: float = 0.5, window: int = 20,
                 cooldown: float = 5.0, probes: int = 1,
                 on_transition: Optional[Callable] = None,
                 clock=time.monotonic):
        self.name = name
        self.failures = max(1, int(failures))
        self.error_rate = float(error_rate)
        self.window = max(1, int(window))
        self.cooldown = float(cooldown)
        self.probes = max(1, int(probes))
        self.on_transition = on_transition
        self.clock = clock
        self._lock = threading.Lock()
        self._state = STATE_CLOSED
        self._consecutive = 0
        self._outcomes: deque = deque(maxlen=self.window)
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0
        self._probe_ok = 0

    # -- internal (call with self._lock held) --------------------------

    def _transition(self, new: int) -> Optional[Tuple[str, str]]:
        old = self._state
        if old == new:
            return None
        self._state = new
        if new == STATE_OPEN:
            self._opened_at = self.clock()
            self._probe_inflight = False
            self._probe_ok = 0
        elif new == STATE_CLOSED:
            self._consecutive = 0
            self._outcomes.clear()
            self._probe_inflight = False
            self._probe_ok = 0
        return (_STATE_NAMES[old], _STATE_NAMES[new])

    def _notify(self, change: Optional[Tuple[str, str]]) -> None:
        if change is None or self.on_transition is None:
            return
        try:
            self.on_transition(self.name, change[0], change[1])
        except Exception:
            log.exception("breaker transition hook failed")

    def _probe_ttl(self) -> float:
        # a probe whose outcome was never recorded must not wedge
        # recovery forever
        return max(60.0, 4.0 * self.cooldown)

    def _trip_check(self) -> Optional[Tuple[str, str]]:
        if self._consecutive >= self.failures:
            return self._transition(STATE_OPEN)
        if len(self._outcomes) == self.window:
            rate = self._outcomes.count(False) / self.window
            if rate >= self.error_rate:
                return self._transition(STATE_OPEN)
        return None

    # -- state ----------------------------------------------------------

    def state_name(self) -> str:
        with self._lock:
            return _STATE_NAMES[self._state]

    def state_code(self) -> int:
        with self._lock:
            return self._state

    def is_closed(self) -> bool:
        with self._lock:
            return self._state == STATE_CLOSED

    # -- admission -------------------------------------------------------

    def allow(self) -> bool:
        """Admit one request. In HALF_OPEN this takes the probe slot:
        the first caller after the cooldown proceeds, everyone else is
        refused until the probe's outcome is recorded."""
        change = None
        with self._lock:
            now = self.clock()
            if self._state == STATE_OPEN:
                if now - self._opened_at < self.cooldown:
                    return False
                change = self._transition(STATE_HALF_OPEN)
            if self._state == STATE_HALF_OPEN:
                if self._probe_inflight and \
                        now - self._probe_started > self._probe_ttl():
                    self._probe_inflight = False  # lost probe: re-admit
                if self._probe_inflight:
                    admitted = False
                else:
                    self._probe_inflight = True
                    self._probe_started = now
                    admitted = True
            else:
                admitted = True
        self._notify(change)
        return admitted

    def available(self) -> bool:
        """Non-consuming admission view: True when a request could be
        admitted right now."""
        with self._lock:
            if self._state in (STATE_CLOSED, STATE_HALF_OPEN):
                return True
            return self.clock() - self._opened_at >= self.cooldown

    def retry_delay(self) -> float:
        """Seconds until the next admission opportunity, floored at
        0.05 so a retry timer never spins."""
        with self._lock:
            if self._state == STATE_OPEN:
                remaining = self.cooldown - (self.clock() - self._opened_at)
            else:
                remaining = min(1.0, self.cooldown / 4.0)
            return max(0.05, remaining)

    # -- outcomes -------------------------------------------------------

    def record_ok(self) -> None:
        change = None
        with self._lock:
            if self._state == STATE_HALF_OPEN:
                self._probe_inflight = False
                self._probe_ok += 1
                if self._probe_ok >= self.probes:
                    change = self._transition(STATE_CLOSED)
            elif self._state == STATE_CLOSED:
                self._consecutive = 0
                self._outcomes.append(True)
            else:
                # a late success of a request in flight when the breaker
                # opened: evidence, not recovery (the probe decides)
                self._outcomes.append(True)
        self._notify(change)

    def record_failure(self) -> None:
        change = None
        with self._lock:
            if self._state == STATE_HALF_OPEN:
                change = self._transition(STATE_OPEN)
            elif self._state == STATE_CLOSED:
                self._consecutive += 1
                self._outcomes.append(False)
                change = self._trip_check()
            else:
                # already OPEN: a failure re-arms the cooldown, so a
                # destination still failing is not re-admitted on a
                # lapsed timer
                self._opened_at = self.clock()
                self._outcomes.append(False)
        self._notify(change)

    def reset(self) -> None:
        """Force CLOSED (HA ``mark_up``: the caller has evidence the
        destination is healthy)."""
        with self._lock:
            change = self._transition(STATE_CLOSED)
        self._notify(change)


class Guard:
    """The engine's named breakers (reference ``Guard.breaker`` and
    ``_on_transition``), each built from the service's
    ``guard.breaker_*`` keys on first use."""

    def __init__(self, engine):
        self.engine = engine
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}
        m = engine.metrics
        self.m_breaker_state = m.gauge(
            "fluentbit", "guard", "breaker_state",
            "Per-output breaker state (0 closed, 1 half-open, 2 open)",
            ("name",))
        self.m_transitions = m.counter(
            "fluentbit", "guard", "breaker_transitions_total",
            "Breaker state transitions", ("name", "state"))

    def breaker(self, name: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(name)
            if br is None:
                svc = self.engine.service
                br = CircuitBreaker(
                    name,
                    failures=svc.guard_breaker_failures,
                    error_rate=svc.guard_breaker_error_rate,
                    window=svc.guard_breaker_window,
                    cooldown=svc.guard_breaker_cooldown,
                    probes=svc.guard_breaker_probes,
                    on_transition=self._on_transition,
                )
                self._breakers[name] = br
        return br

    def _on_transition(self, name: str, old: str, new: str) -> None:
        self.m_breaker_state.set(_STATE_CODES[new], (name,))
        self.m_transitions.inc(1, (name, new))
        level = logging.WARNING if new != "closed" else logging.INFO
        log.log(level, "guard: breaker %s: %s -> %s", name, old, new)
