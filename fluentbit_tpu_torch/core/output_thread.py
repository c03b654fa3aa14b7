"""Output worker thread pools.

The port's own copy of ``fluentbit_tpu/core/output_thread.py``. An
output configured with ``workers N`` runs its flush callbacks on N
threads, each with its own asyncio loop; flushes are assigned
round-robin, and each worker runs the plugin's ``worker_init`` and
``worker_exit`` hooks. The engine awaits a flush's result from its own
loop, where the retry and the counters are handled.

A pool whose workers do not all start within ``start_timeout`` is marked
``failed``: the engine stops it, counts it in
``fluentbit_guard_worker_start_failures_total`` and flushes the output
on its own loop. The failpoint sites ``output.worker_start`` (a worker,
before the ready barrier) and ``output.worker_flush`` (``submit``, before
the handoff) inject a wedged or dead worker and a failed handoff; the
engine's ``_worker_flush`` carries the guard's cancel flag
(``guard.CANCEL_EVENT``) onto the worker's loop.

Reference: src/flb_output_thread.c (round-robin assignment :439-496,
cb_worker_init :249, cb_worker_exit :375).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import threading
from typing import List

from .. import failpoints as _fp

log = logging.getLogger("flb.output_thread")


class OutputWorkerPool:
    def __init__(self, name: str, workers: int, plugin=None,
                 start_timeout: float = 10.0):
        self.name = name
        self.plugin = plugin
        # True when the workers missed the ready barrier: the caller
        # must not submit to loops that will never run anything
        self.failed = False
        self._start_timeout = start_timeout
        self._loops: List[asyncio.AbstractEventLoop] = []
        self._threads: List[threading.Thread] = []
        self._rr = itertools.cycle(range(workers))
        ready = threading.Barrier(workers + 1)
        for i in range(workers):
            t = threading.Thread(target=self._worker, args=(i, ready),
                                 daemon=True,
                                 name=f"flb-out-{name}-w{i}")
            t.start()
            self._threads.append(t)
        try:
            ready.wait(timeout=start_timeout)
        except threading.BrokenBarrierError:
            self.failed = True
            log.error("output %s: %d worker thread(s) did not start within "
                      "%.1fs; the pool is unusable, the output flushes "
                      "inline", name, workers, start_timeout)

    def _worker(self, index: int, ready: threading.Barrier) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loops.append(loop)
        if _fp.ACTIVE:
            try:
                # a wedged start (delay or hang past the timeout) or a
                # worker that dies before serving (return)
                _fp.fire("output.worker_start")
            except OSError:
                log.error("%s worker %d start failed (injected)",
                          self.name, index)
                ready.abort()  # fail the start now, not at the timeout
                loop.close()
                return
        init = getattr(self.plugin, "worker_init", None)
        if init is not None:
            try:
                init(index)
            except Exception:
                log.exception("%s worker_init failed", self.name)
        try:
            ready.wait(timeout=self._start_timeout)
        except threading.BrokenBarrierError:
            pass
        try:
            loop.run_forever()
        finally:
            # run the callbacks scheduled right before the stop
            try:
                loop.run_until_complete(asyncio.sleep(0))
            except RuntimeError:
                pass
            exit_cb = getattr(self.plugin, "worker_exit", None)
            if exit_cb is not None:
                try:
                    exit_cb(index)
                except Exception:
                    log.exception("%s worker_exit failed", self.name)
            loop.close()

    def submit(self, coro) -> "asyncio.Future":
        """Run the coroutine on the next worker's loop (round-robin);
        returns an awaitable for the calling loop."""
        if self.failed or not self._loops:
            coro.close()
            raise RuntimeError(f"output {self.name}: worker pool never "
                               "started or stopped")
        if _fp.ACTIVE:
            try:
                _fp.fire("output.worker_flush")
            except BaseException:
                coro.close()
                raise
        loop = self._loops[next(self._rr) % len(self._loops)]
        return asyncio.wrap_future(
            asyncio.run_coroutine_threadsafe(coro, loop))

    def stop(self, timeout: float = 5.0) -> None:
        for loop in list(self._loops):
            try:
                loop.call_soon_threadsafe(loop.stop)
            except RuntimeError:
                pass  # closed already
        for t in self._threads:
            t.join(timeout=timeout)
        self._loops.clear()
        self._threads.clear()
