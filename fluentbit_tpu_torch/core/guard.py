"""The guard plane: flush deadlines, a circuit breaker on every output,
the watchdog, breaker shedding and the health verdict.

The port's own copy of ``fluentbit_tpu/core/guard.py``. A hung flush
holds its task-map slot, so one stuck destination would in the end stall
dispatch for every route; the guard is what survives it. The engine owns
one :class:`Guard` and calls it from the flush paths only: the ingest
path has no guard code, and the periodic checks ride the flush timer.

- **Flush deadlines.** Every flush attempt the guard tracks carries a
  deadline: the output's ``flush_timeout``, else the service's
  ``guard.flush_timeout``, else 2 x ``grace``. The watchdog soft-kills
  an expired attempt: its future is cancelled (an attempt on a worker
  thread also gets the cooperative flag :func:`cancel_requested`, and is
  counted as abandoned when its thread stays wedged past
  ``guard.leak_grace``), and the chunk re-enters the retry scheduler as
  a RETRY.
- **A breaker on every output**: :class:`CircuitBreaker`, closed → open
  → half-open, fed by each flush's outcome. While it is open, dispatch
  short-circuits to a scheduled retry that does not count against
  ``retry_limit``; after the cooldown one probe flush decides. The
  forward output's destinations and ``core.upstream``'s nodes keep
  breakers of their own in the same registry.
- **The watchdog and breaker shedding.** The housekeeping pass (on
  ``flush_all``'s timer) stamps the heartbeat, sets the task-map,
  retry and in-flight gauges, scans the deadlines, and above
  ``guard.shed_watermark`` of the task map parks chunks whose every
  route is behind an open breaker (and reclaims the task slots their
  retry timers hold). A parked chunk goes back to the backlog, for only
  the routes it was shed from, once one of them can take a probe, and
  at stop. Delivery stays at least once. With filesystem storage, a
  shed memory chunk is written through and finalized, so a crash does
  not lose it (a write that fails is logged and the chunk stays in
  memory).
- :meth:`Guard.health` gives the verdict ``ok``, ``degraded`` or
  ``stalled``.

Not in the port: shedding graded by priority class and the storage
quota on a shed chunk's write-through (both need qos; with one tenant
the reference always admits), and the device lanes' block of the health verdict (the port has no CPU fallback to fail
over to; a device error raises).
"""

from __future__ import annotations

import asyncio
import contextvars
import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

log = logging.getLogger("flb.guard")

#: Set for the length of a guarded flush (task-local): a plugin doing
#: long synchronous work on a worker's loop can poll
#: :func:`cancel_requested` to honour a soft-kill the loop cannot deliver
#: as a CancelledError.
CANCEL_EVENT: "contextvars.ContextVar[Optional[threading.Event]]" = \
    contextvars.ContextVar("fbtpu_guard_cancel", default=None)


def cancel_requested() -> bool:
    """True when the guard has soft-killed the current flush attempt."""
    ev = CANCEL_EVENT.get()
    return ev is not None and ev.is_set()

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


class FlightRecord:
    """One flush attempt in flight under the deadline watch."""

    __slots__ = ("key", "task", "out_name", "started", "begun",
                 "deadline", "fut", "cancel_event", "worker",
                 "worker_done", "timed_out", "consumed", "abandoned_at")

    def __init__(self, key, task, out_name: str, deadline: float, fut):
        self.key = key
        self.task = task
        self.out_name = out_name
        self.started = time.time()
        # the deadline runs from when the attempt executes (the engine
        # stamps ``started`` and sets ``begun`` after the flush slot's
        # acquire): an attempt queued behind a busy output is not hung
        self.begun = False
        self.deadline = deadline
        self.fut = fut
        self.cancel_event = threading.Event()
        self.worker = False
        self.worker_done = False
        self.timed_out = False
        self.consumed = False
        self.abandoned_at = 0.0


class Guard:
    """The engine's guard plane. Inert until flushes flow: no thread and
    no timer of its own.

    ``_flights``, ``_abandoned``, ``_shed`` and ``_breakers`` are touched
    from the engine's loop, from ``flush_now`` callers and from worker
    threads; every access holds ``_lock``. The task map is read under
    the engine's ``_task_lock``; the pending retries are touched only on
    the engine's loop.
    """

    def __init__(self, engine):
        self.engine = engine
        self._lock = threading.Lock()
        self._flights: Dict[tuple, FlightRecord] = {}
        self._abandoned: List[FlightRecord] = []
        self._shed: List = []  # chunks parked off the dispatch path
        self._breakers: Dict[str, CircuitBreaker] = {}
        # breakers not closed, kept on transitions: the dispatch loop's
        # shed check reads it without the lock
        self._unhealthy = 0
        self.heartbeat = time.time()

        m = engine.metrics
        self.m_timeouts = m.counter(
            "fluentbit", "guard", "flush_timeouts_total",
            "Flush attempts soft-killed past their deadline", ("name",))
        self.m_abandoned = m.counter(
            "fluentbit", "guard", "abandoned_flushes_total",
            "Worker-thread flushes hard-abandoned (leaked) after a "
            "soft-kill could not land", ("name",))
        self.m_short_circuit = m.counter(
            "fluentbit", "guard", "short_circuits_total",
            "Dispatches short-circuited to a scheduled retry by an "
            "open breaker", ("name",))
        self.m_shed = m.counter(
            "fluentbit", "guard", "shed_chunks_total",
            "Chunks spilled off the dispatch path for open-breaker "
            "routes", ("name",))
        self.m_breaker_state = m.gauge(
            "fluentbit", "guard", "breaker_state",
            "Per-output breaker state (0 closed, 1 half-open, 2 open)",
            ("name",))
        self.m_transitions = m.counter(
            "fluentbit", "guard", "breaker_transitions_total",
            "Breaker state transitions", ("name", "state"))
        self.m_occupancy = m.gauge(
            "fluentbit", "guard", "task_map_occupancy",
            "Task-map slots in use")
        self.m_highwater = m.gauge(
            "fluentbit", "guard", "task_map_highwater",
            "Task-map occupancy high-water mark")
        self.m_retry_backlog = m.gauge(
            "fluentbit", "guard", "retry_backlog",
            "Pending retry timers")
        self.m_inflight = m.gauge(
            "fluentbit", "guard", "inflight_flushes",
            "Flush attempts currently tracked by the guard")
        self.m_heartbeat_age = m.gauge(
            "fluentbit", "guard", "heartbeat_age_seconds",
            "Age of the last housekeeping pass at the time it ran")
        self.m_worker_start_fail = m.counter(
            "fluentbit", "guard", "worker_start_failures_total",
            "Output worker pools that failed to start (failed over to "
            "inline flush)", ("name",))

    # -- configuration (read live: keys may be set up to start()) ------

    @property
    def enabled(self) -> bool:
        return bool(self.engine.service.guard_enable)

    def deadline_for(self, out) -> float:
        """The output's ``flush_timeout``, else the service's
        ``guard.flush_timeout``, else 2 x ``grace``."""
        ft = getattr(out, "flush_timeout", None)
        if ft:
            return ft
        svc = self.engine.service
        if svc.guard_flush_timeout:
            return svc.guard_flush_timeout
        return 2.0 * svc.grace

    # -- breakers -------------------------------------------------------

    def breaker(self, name: str) -> CircuitBreaker:
        """The breaker of ``name`` (an output's display name, or a named
        destination), built from the ``guard.breaker_*`` keys on first
        use."""
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
        with self._lock:
            if old == "closed" and new != "closed":
                self._unhealthy += 1
            elif old != "closed" and new == "closed":
                self._unhealthy -= 1
        level = logging.WARNING if new != "closed" else logging.INFO
        log.log(level, "guard: breaker %s: %s -> %s", name, old, new)

    def short_circuit_delay(self, out) -> Optional[float]:
        """None: the flush may go (closed, or this caller is the
        half-open probe). A delay: the breaker is open, so a retry is
        scheduled for then instead."""
        if not self.enabled:
            return None
        br = self.breaker(out.display_name)
        if br.allow():
            return None
        return br.retry_delay()

    def on_result(self, out, ok: bool) -> None:
        """Feed one flush outcome (OK, or ERROR / RETRY / timeout) to the
        output's breaker."""
        if not self.enabled:
            return
        br = self.breaker(out.display_name)
        if ok:
            br.record_ok()
        else:
            br.record_failure()

    # -- flight tracking ------------------------------------------------

    def track(self, task, out, fut) -> Optional[FlightRecord]:
        """Watch the attempt ``fut`` of ``task`` to ``out``."""
        if not self.enabled:
            return None
        key = (task.id, out.name)
        rec = FlightRecord(key, task, out.display_name,
                           self.deadline_for(out), fut)
        with self._lock:
            self._flights[key] = rec
        fut.add_done_callback(lambda _f, k=key: self._untrack(k))
        return rec

    def _untrack(self, key) -> None:
        with self._lock:
            self._flights.pop(key, None)

    def flight(self, task, out) -> Optional[FlightRecord]:
        with self._lock:
            return self._flights.get((task.id, out.name))

    def consume_timeout(self, task, out) -> bool:
        """True once for a flush the watchdog soft-killed: the engine's
        CancelledError handler tells a deadline from a stop by it."""
        with self._lock:
            rec = self._flights.get((task.id, out.name))
            if rec is not None and rec.timed_out and not rec.consumed:
                rec.consumed = True
                return True
        return False

    # -- the watchdog (on flush_all's timer) ----------------------------

    def housekeeping(self) -> None:
        """The heartbeat, the gauges, the deadline scan, the
        abandoned-worker scan and the shedding pass."""
        if not self.enabled:
            return
        now = time.time()
        engine = self.engine
        try:
            on_loop = asyncio.get_running_loop() is engine.loop
        except RuntimeError:
            on_loop = False
        if on_loop:
            # the heartbeat says the engine's loop is alive: a pass run
            # by another thread must not stamp it
            self.m_heartbeat_age.set(now - self.heartbeat)
            self.heartbeat = now
        with engine._task_lock:
            occupancy = len(engine._task_map)
        self.m_occupancy.set(occupancy)
        self.m_highwater.set_max(occupancy)
        self.m_retry_backlog.set(len(engine._pending_retries))

        expired: List[FlightRecord] = []
        with self._lock:
            self.m_inflight.set(len(self._flights))
            for rec in self._flights.values():
                if rec.begun and not rec.timed_out \
                        and now - rec.started >= rec.deadline:
                    rec.timed_out = True
                    expired.append(rec)
        for rec in expired:
            self.m_timeouts.inc(1, (rec.out_name,))
            log.warning(
                "guard: flush to %s exceeded its %.1fs deadline; "
                "soft-killing, the chunk re-enters the retry scheduler",
                rec.out_name, rec.deadline)
            rec.cancel_event.set()  # the worker side's cooperative flag
            loop = engine.loop
            if loop is not None:
                try:
                    loop.call_soon_threadsafe(rec.fut.cancel)
                except RuntimeError:
                    pass  # the loop has closed: stop accounts for it
            if rec.worker:
                rec.abandoned_at = now
                with self._lock:
                    self._abandoned.append(rec)

        # worker flushes whose soft-kill never landed (the thread is
        # wedged in sync code) are counted once
        leaked: List[FlightRecord] = []
        grace = engine.service.guard_leak_grace
        with self._lock:
            keep = []
            for rec in self._abandoned:
                if rec.worker_done:
                    continue  # the cancel landed late
                if now - rec.abandoned_at >= grace:
                    leaked.append(rec)
                else:
                    keep.append(rec)
            self._abandoned = keep
        for rec in leaked:
            self.m_abandoned.inc(1, (rec.out_name,))
            log.error(
                "guard: worker flush to %s ignored its soft-kill for "
                "%.1fs; hard-abandoning (its thread is leaked until it "
                "returns)", rec.out_name, grace)

        self._shed_pass(occupancy, on_loop)

    # -- breaker shedding -----------------------------------------------

    def _watermark_slots(self) -> int:
        svc = self.engine.service
        return int(svc.guard_shed_watermark * svc.task_map_size)

    def _route_breakers(self, names) -> List[Optional[CircuitBreaker]]:
        with self._lock:
            return [self._breakers.get(n) for n in names]

    def maybe_shed(self, chunk, routes) -> bool:
        """At or above the watermark, park a chunk whose every route is
        behind an open breaker that cannot take a probe yet. True when
        the chunk was parked."""
        if not self.enabled or not routes or not self._unhealthy:
            return False
        # a relaxed read: the count is stale as soon as a lock is let go
        # anyway, and a lock here would put dispatch in contention with
        # every flush result
        occupancy = len(self.engine._task_map)
        if occupancy < self._watermark_slots():
            return False
        names = [o.display_name for o in routes]
        brs = self._route_breakers(names)
        if any(br is None or br.available() for br in brs):
            return False
        self._shed_chunk(chunk, names)
        return True

    def _shed_chunk(self, chunk, route_names) -> None:
        # readmitted, the chunk goes only to the routes it was shed from
        # (a sibling that delivered must not see it twice): dispatch
        # resolves names first, and the mask is cleared
        chunk.route_names = tuple(route_names)
        chunk.routes_mask = 0
        storage = self.engine.storage
        if storage is not None and not storage.is_tracked(chunk):
            try:  # durability: the memory chunk spills to disk
                storage.write_through(chunk, chunk.get_bytes())
                storage.finalize(chunk)
            except Exception:
                log.exception("guard: shed write-through failed; chunk "
                              "parked in memory only")
        with self._lock:
            self._shed.append(chunk)
        for name in route_names:
            self.m_shed.inc(1, (name,))
        log.warning("guard: shed chunk %s (routes %s): open breaker and "
                    "task-map pressure", chunk.tag, ",".join(route_names))

    def _shed_pass(self, occupancy: int, on_loop: bool) -> None:
        """Readmit the parked chunks one of whose routes can take a
        probe; at or above the watermark, on the engine's loop, reclaim
        the task slots held by retry timers of open-breaker routes."""
        engine = self.engine
        with self._lock:
            shed = list(self._shed)
        readmit = []
        for chunk in shed:
            brs = self._route_breakers(chunk.route_names or ())
            if any(br is None or br.available() for br in brs):
                readmit.append(chunk)
        if readmit:
            gone = {id(c) for c in readmit}
            with self._lock:
                self._shed = [c for c in self._shed if id(c) not in gone]
            with engine._ingest_lock:
                engine._backlog.extend(readmit)
            log.info("guard: readmitted %d shed chunk(s)", len(readmit))
        if not on_loop or occupancy < self._watermark_slots():
            return
        for key, (task, out, handle) in list(
                engine._pending_retries.items()):
            if task.users != 1:
                continue  # sibling routes still hold the slot
            br = self._route_breakers([out.display_name])[0]
            if br is None or br.available():
                continue
            handle.cancel()
            engine._pending_retries.pop(key, None)
            self._shed_chunk(task.chunk, [out.display_name])
            engine._task_unref(task)

    def readmit_all(self) -> None:
        """At stop: every parked chunk goes back to the backlog, so the
        shutdown drain sees it."""
        with self._lock:
            shed, self._shed = self._shed, []
        if shed:
            with self.engine._ingest_lock:
                self.engine._backlog.extend(shed)

    def shed_count(self) -> int:
        with self._lock:
            return len(self._shed)

    # -- health ---------------------------------------------------------

    def health(self) -> dict:
        """The readiness verdict: ``ok`` (every breaker closed, the loop
        beating), ``degraded`` (a breaker not closed, chunks parked, or
        the task map at the watermark: healthy routes still flow) or
        ``stalled`` (the heartbeat is older than ``guard.stall_after``
        and 5 flush intervals: the engine's loop is wedged or starved).
        The heartbeat's age is taken at the call."""
        engine = self.engine
        if not self.enabled:
            return {"status": "ok", "guard": "disabled"}
        now = time.time()
        with self._lock:
            breakers = {name: _STATE_NAMES[br.state_code()]
                        for name, br in self._breakers.items()}
            shed = len(self._shed)
            inflight = len(self._flights)
        with engine._task_lock:
            occupancy = len(engine._task_map)
        svc = engine.service
        running = engine.running
        hb_age = max(0.0, now - self.heartbeat) if running else 0.0
        verdict = "ok"
        if (any(s != "closed" for s in breakers.values()) or shed
                or occupancy >= self._watermark_slots()):
            verdict = "degraded"
        if running and hb_age > max(svc.guard_stall_after,
                                    5.0 * svc.flush):
            verdict = "stalled"
        forward_block = {}
        for inst in list(engine.inputs) + list(engine.outputs):
            plugin = getattr(inst, "plugin", None)
            hb = getattr(plugin, "health_block", None)
            if getattr(plugin, "name", "") != "forward" or hb is None:
                continue
            try:
                forward_block[inst.display_name] = hb()
            except Exception:
                log.exception("forward health block failed")
                forward_block[inst.display_name] = {
                    "error": "unavailable"}
        return {
            "status": verdict,
            "heartbeat_age": round(hb_age, 3),
            "task_map": {"occupancy": occupancy,
                         "size": svc.task_map_size},
            "inflight_flushes": inflight,
            "shed_chunks": shed,
            "breakers": breakers,
            "forward": forward_block,
        }
