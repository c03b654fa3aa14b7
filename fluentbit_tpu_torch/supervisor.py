"""Supervisor: a parent process that restarts a crashed worker.

The port's own copy of ``fluentbit_tpu/supervisor.py`` (reference
src/flb_supervisor.c: supervisor_spawn's fork :384-415, the waitpid
monitor :314-375, restart on crash, grace propagation :268-285). The
CLI's ``--supervisor`` wraps the run in this loop: fork a worker running
the pipeline; on an abnormal exit (a signal, or a nonzero code after at
least ``MIN_UPTIME_FOR_RESTART`` seconds) restart it with exponential
backoff; SIGTERM and SIGINT are forwarded to the worker and stop the
loop; SIGHUP is forwarded (the worker reloads). A nonzero exit faster
than that is a startup error and ends the loop with its code.

The parent must not touch CUDA before it forks: a CUDA context does not
survive a fork, so the CLI calls :func:`run_supervised` before anything
resolves a device, and only the worker builds the context.
"""

from __future__ import annotations

import logging
import os
import signal
import time
from typing import Callable, Optional

log = logging.getLogger("flb.supervisor")

RESTART_BACKOFF_BASE = 1.0
RESTART_BACKOFF_CAP = 30.0
#: a nonzero exit faster than this is a startup error (bad config), not
#: a crash — restarting would loop forever on a fatal condition
MIN_UPTIME_FOR_RESTART = 2.0


def run_supervised(worker_main: Callable[[], int],
                   max_restarts: Optional[int] = None) -> int:
    """Fork/monitor loop. Returns the final worker exit code."""
    restarts = 0
    stopping = {"flag": False}
    child = {"pid": 0}

    def forward(signum, frame):
        if signum in (signal.SIGTERM, signal.SIGINT):
            stopping["flag"] = True
        if child["pid"]:
            try:
                os.kill(child["pid"], signum)
            except ProcessLookupError:
                pass

    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
        signal.signal(sig, forward)

    while True:
        started = time.time()
        pid = os.fork()
        if pid == 0:
            # worker: default signal dispositions; run the pipeline
            for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
                signal.signal(sig, signal.SIG_DFL)
            os._exit(worker_main())
        child["pid"] = pid
        log.info("supervisor: worker started (pid %d)", pid)
        while True:
            try:
                _, status = os.waitpid(pid, 0)
                break
            except InterruptedError:
                continue
        child["pid"] = 0
        if os.WIFEXITED(status):
            code = os.WEXITSTATUS(status)
            if stopping["flag"] or code == 0:
                log.info("supervisor: worker exited (%d)", code)
                return code
            if time.time() - started < MIN_UPTIME_FOR_RESTART:
                # fast nonzero exit = fatal startup error, not a crash
                log.error("supervisor: worker failed at startup "
                          "(exit %d) — not restarting", code)
                return code
            reason = f"exit code {code}"
        else:
            if stopping["flag"]:
                return 0
            reason = f"signal {os.WTERMSIG(status)}"
        restarts += 1
        if max_restarts is not None and restarts > max_restarts:
            log.error("supervisor: giving up after %d restarts", restarts - 1)
            return 1
        delay = min(RESTART_BACKOFF_CAP,
                    RESTART_BACKOFF_BASE * (2 ** min(restarts - 1, 6)))
        log.warning("supervisor: worker died (%s); restart #%d in %.1fs",
                    reason, restarts, delay)
        deadline = time.time() + delay
        while time.time() < deadline and not stopping["flag"]:
            time.sleep(0.1)
        if stopping["flag"]:
            return 1
