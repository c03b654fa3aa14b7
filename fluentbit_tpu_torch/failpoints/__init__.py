"""The failpoint plane: deterministic fault injection at named sites.

The port's own copy of ``fluentbit_tpu/failpoints/__init__.py``. The
data plane carries named *failpoints* (storage writes, finalizes, CRC
checks and backlog loads, flush dispatch, retry scheduling, the stop's
quarantine, output flushes and worker starts, upstream dials, the
forward hop, the parser's batch decline, the kernels' dispatch
boundary), and each can be
armed at run time with a small action DSL. Unarmed, a site costs one
module attribute read (``ACTIVE``).

DSL (one spec per failpoint)::

    spec   := term ( "->" term )*        terms consumed left to right
    term   := [pct "%"] [cnt "*"] action [ "(" arg ")" ]
    action := off | return | delay | hang | partial | panic | crash

- ``off``          no-op (with ``cnt*`` it skips the first cnt hits)
- ``return(err)``  raise :class:`FailpointError` (an ``OSError``, so a
  site's socket and file error handling engages as for a real fault)
- ``delay(ms)``    sleep ``ms`` milliseconds, then continue
- ``hang(ms)``     ``delay`` with a 10-minute default; at
  :func:`fire_async` sites the sleep is an ``asyncio.sleep`` (one hung
  coroutine, which the guard's flush deadline can cancel)
- ``partial(n)``   hand the site a ``("partial", n)`` directive (a write
  site truncates its payload to ``n`` bytes)
- ``panic``        raise ``RuntimeError`` (a plugin bug, not an I/O error)
- ``crash``        kill the process at once (SIGKILL semantics; the
  crash-recovery soak, ``failpoints.soak``, arms it in a child process)

A term with ``cnt*`` fires at most ``cnt`` times, then control moves to
the next term: ``2*off->1*crash`` crashes on the third hit. A term with
``pct%`` fires with that probability per hit, drawn from an RNG of the
site's own, seeded from ``FBTPU_FAILPOINTS_SEED`` and the site's name:
equal runs replay equal fault schedules.

Control: ``FBTPU_FAILPOINTS="engine.flush_dispatch=1*return;
output.flush=25%return(reset)"`` at import, or :func:`enable` /
:func:`disable` / :func:`reset` / :func:`snapshot`. Every trigger calls
the listeners (:func:`add_listener`): the engine counts
``fluentbit_failpoint_triggered_total{name}`` through one.
"""

from __future__ import annotations

import logging
import os
import random
import re
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

log = logging.getLogger("flb.failpoints")

#: The one cost of the plane at a site: ``if failpoints.ACTIVE:`` before
#: :func:`fire`. False whenever no failpoint is armed.
ACTIVE = False

ENV_VAR = "FBTPU_FAILPOINTS"
SEED_VAR = "FBTPU_FAILPOINTS_SEED"

#: The sites threaded through the port. :func:`fire` takes any name
#: (tests and the soak's sink add their own); the reference's sites of
#: modules the port lacks (qos, reload, s3, the upstream pool's send and
#: recv, the device lanes) arrive with those modules.
SITES: Tuple[str, ...] = (
    "storage.append",            # Storage.write_through, before the write
                                 # (partial(n) tears it after n bytes)
    "storage.flush",             # Storage.write_through, written, not yet
                                 # flushed
    "storage.finalize",          # Storage.finalize, before the CRC stamp
    "storage.crc_verify",        # Storage._read_chunk_file, before the CRC
                                 # check
    "storage.backlog_load",      # Storage.scan_backlog, before the walk
    "engine.flush_dispatch",     # Engine.flush_all, chunks drained and
                                 # finalized, tasks not yet made
    "engine.retry_schedule",     # Engine._schedule_retry, before the timer
    "engine.shutdown_quarantine",  # Engine._flush_one / _drop_retry,
                                   # before the stop's quarantine
    "upstream.connect",          # core.tls.open_connection, before the dial
    "output.flush",              # Engine._flush_body, before the plugin's
                                 # flush (async site; the instance-scoped
                                 # "output.flush.<output>" fires after it)
    "output.worker_flush",       # OutputWorkerPool.submit, before the handoff
    "output.worker_start",       # OutputWorkerPool._worker, before the
                                 # ready barrier
    "codec.fallback",            # filter_parser's json batch hook: a
                                 # forced decline
    "flux.snapshot",             # FluxState.write_snapshot, written and
                                 # synced, before the rename
    "device.dispatch",           # ops.device.dispatch_point, after a grep
                                 # or sketch launch: return() raises
                                 # DeviceError, as a failed launch does
    "forward.handshake",         # out_forward._handshake, before HELO read
    "forward.conn_reset",        # out_forward._send_chunk, before the write
    "forward.partial_write",     # out_forward._send_chunk: partial(n) cuts
                                 # the frame after n bytes, then the link
    "forward.dup_delivery",      # out_forward._send_chunk, after the ack:
                                 # the same frame written again
    "forward.ack_drop",          # in_forward, absorbed, before the ack
)


class FailpointError(OSError):
    """The injected failure of ``return(err)`` terms: an ``OSError``, so
    I/O sites take it through their real error handling."""


_ACTIONS = ("off", "return", "delay", "hang", "partial", "panic", "crash")

#: ``hang`` with no argument sleeps this long: "forever" on test
#: timescales, finite so a forgotten arm cannot wedge a process for good
HANG_DEFAULT_MS = 600000.0

_TERM_RE = re.compile(
    r"^(?:(?P<pct>\d+(?:\.\d+)?)%)?"
    r"(?:(?P<cnt>\d+)\*)?"
    r"(?P<action>[a-z]+)"
    r"(?:\((?P<arg>[^)]*)\))?$")


class _Term:
    __slots__ = ("pct", "limit", "action", "arg", "fired")

    def __init__(self, pct: Optional[float], limit: Optional[int],
                 action: str, arg: str):
        self.pct = pct        # None: always
        self.limit = limit    # None: unlimited (the last term)
        self.action = action
        self.arg = arg
        self.fired = 0


def parse_spec(spec: str) -> List[_Term]:
    """Parse a DSL spec into terms; raises ``ValueError`` on bad input."""
    terms: List[_Term] = []
    text = spec.strip()
    if not text:
        raise ValueError("empty failpoint spec")
    for part in text.split("->"):
        m = _TERM_RE.match(part.strip())
        if m is None:
            raise ValueError(f"bad failpoint term {part.strip()!r}")
        action = m.group("action")
        if action not in _ACTIONS:
            raise ValueError(
                f"unknown failpoint action {action!r} "
                f"(one of {', '.join(_ACTIONS)})")
        pct = float(m.group("pct")) if m.group("pct") else None
        cnt = int(m.group("cnt")) if m.group("cnt") else None
        arg = m.group("arg") or ""
        if action in ("delay", "hang"):
            float(arg or "0")  # checked now, not when it fires
        elif action == "partial":
            int(arg or "0")
        terms.append(_Term(pct, cnt, action, arg))
    return terms


class Failpoint:
    """One armed site: its terms, its RNG and its counts."""

    __slots__ = ("name", "spec", "terms", "rng", "evaluated", "triggered")

    def __init__(self, name: str, spec: str, seed: int):
        self.name = name
        self.spec = spec
        self.terms = parse_spec(spec)
        # a stream per site: one site's schedule never shifts when
        # another site is armed or fires
        self.rng = random.Random(f"{seed}:{name}")
        self.evaluated = 0
        self.triggered = 0


class _Plane:
    """The armed sites and the listeners, under one lock."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.sites: Dict[str, Failpoint] = {}
        self.listeners: List[Callable[[str, str], None]] = []


_plane = _Plane()


def _seed() -> int:
    try:
        return int(os.environ.get(SEED_VAR, "0"))
    except ValueError:
        return 0


def _refresh_active() -> None:
    global ACTIVE
    ACTIVE = bool(_plane.sites)


def enable(name: str, spec: str) -> Failpoint:
    """Arm (or re-arm, with fresh counts) a failpoint."""
    fp = Failpoint(name, spec, _seed())
    with _plane.lock:
        _plane.sites[name] = fp
        _refresh_active()
    log.warning("failpoint armed: %s = %s", name, spec)
    return fp


def disable(name: str) -> bool:
    """Disarm one failpoint; True when it was armed."""
    with _plane.lock:
        found = _plane.sites.pop(name, None) is not None
        _refresh_active()
    return found


def reset() -> None:
    """Disarm everything."""
    with _plane.lock:
        _plane.sites.clear()
        _refresh_active()


def snapshot() -> Dict[str, dict]:
    """Each armed site's spec and counts."""
    with _plane.lock:
        return {name: {"spec": fp.spec, "evaluated": fp.evaluated,
                       "triggered": fp.triggered}
                for name, fp in _plane.sites.items()}


def add_listener(cb: Callable[[str, str], None]) -> None:
    """Register a trigger hook ``cb(name, action)``."""
    with _plane.lock:
        if cb not in _plane.listeners:
            _plane.listeners.append(cb)


def remove_listener(cb: Callable[[str, str], None]) -> None:
    with _plane.lock:
        if cb in _plane.listeners:
            _plane.listeners.remove(cb)


def load_env(env: Optional[str] = None) -> int:
    """Arm failpoints from ``FBTPU_FAILPOINTS`` (``name=spec`` pairs,
    ``;``-separated). Returns how many were armed; a bad entry is logged
    and skipped."""
    text = os.environ.get(ENV_VAR, "") if env is None else env
    n = 0
    for pair in text.split(";"):
        pair = pair.strip()
        if not pair:
            continue
        name, sep, spec = pair.partition("=")
        if not sep or not name.strip():
            log.error("failpoints: bad env entry %r (want name=spec)", pair)
            continue
        try:
            enable(name.strip(), spec)
            n += 1
        except ValueError as e:
            log.error("failpoints: bad spec for %s: %s", name.strip(), e)
    return n


def _crash() -> None:
    # SIGKILL semantics: no atexit, no buffered write, no drain
    try:
        os.kill(os.getpid(), signal.SIGKILL)
    except OSError:
        pass
    os._exit(137)


def _decide(name: str) -> Optional[Tuple[str, str]]:
    """Take one hit of site ``name``: consume its current term, call the
    listeners and return ``(action, arg)``, or None when nothing fires.
    Sleeps, raises and crashes happen outside the lock."""
    with _plane.lock:
        fp = _plane.sites.get(name)
        if fp is None:
            return None
        fp.evaluated += 1
        term = None
        for t in fp.terms:
            if t.limit is None or t.fired < t.limit:
                term = t
                break
        if term is None:
            return None
        if term.pct is not None and fp.rng.uniform(0, 100) >= term.pct:
            return None  # the probability gate takes no count
        term.fired += 1
        action, arg = term.action, term.arg
        if action == "off":
            return None
        fp.triggered += 1
        listeners = list(_plane.listeners)
    for cb in listeners:
        try:
            cb(name, action)
        except Exception:
            log.exception("failpoint listener failed")
    log.warning("failpoint triggered: %s -> %s(%s)", name, action, arg)
    return (action, arg)


def _hang_ms(action: str, arg: str) -> float:
    if action == "hang":
        return float(arg) if arg else HANG_DEFAULT_MS
    return float(arg or "0")


def _apply(name: str, action: str, arg: str) -> Optional[Tuple[str, int]]:
    """The actions other than a sleep, shared by fire and fire_async."""
    if action == "return":
        raise FailpointError(f"failpoint {name}: injected error"
                             + (f" ({arg})" if arg else ""))
    if action == "partial":
        return ("partial", int(arg or "0"))
    if action == "panic":
        raise RuntimeError(f"failpoint {name}: injected panic")
    if action == "crash":
        _crash()
    return None


def fire(name: str) -> Optional[Tuple[str, int]]:
    """Evaluate the failpoint at site ``name``: None (not armed, term
    not taken, or a no-op), or a directive for the site (only
    ``("partial", n)``). Raises :class:`FailpointError` for ``return``
    and ``RuntimeError`` for ``panic``; ``crash`` does not return;
    ``delay`` and ``hang`` block the calling thread."""
    decided = _decide(name)
    if decided is None:
        return None
    action, arg = decided
    if action in ("delay", "hang"):
        time.sleep(_hang_ms(action, arg) / 1000.0)
        return None
    return _apply(name, action, arg)


async def fire_async(name: str) -> Optional[Tuple[str, int]]:
    """:func:`fire` for coroutine sites: ``delay`` and ``hang`` are an
    ``asyncio.sleep``, so the fault suspends one coroutine (a hung
    flush), which stays cancellable; every other action is
    :func:`fire`'s."""
    decided = _decide(name)
    if decided is None:
        return None
    action, arg = decided
    if action in ("delay", "hang"):
        import asyncio

        await asyncio.sleep(_hang_ms(action, arg) / 1000.0)
        return None
    return _apply(name, action, arg)


# armed from the environment at import: a subprocess harness sets up the
# whole plane before the engine exists
if os.environ.get(ENV_VAR):
    load_env()
