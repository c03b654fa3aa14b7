"""Output worker thread pools.

The port's own copy of ``fluentbit_tpu/core/output_thread.py``. An
output configured with ``workers N`` runs its flush callbacks on N
threads, each with its own asyncio loop; flushes are assigned
round-robin, and each worker runs the plugin's ``worker_init`` and
``worker_exit`` hooks. The engine awaits a flush's result from its own
loop, where the retry and the counters are handled.

One rule differs from the reference: a pool whose workers do not all
start within ``start_timeout`` raises, naming the output (the reference
fails the output over to flushes on the engine's loop and counts it in
a guard metric; the port has no guard, and no fallback of its is
silent).

Reference: src/flb_output_thread.c (round-robin assignment :439-496,
cb_worker_init :249, cb_worker_exit :375).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import threading
from typing import List

log = logging.getLogger("flb.output_thread")


class OutputWorkerPool:
    def __init__(self, name: str, workers: int, plugin=None,
                 start_timeout: float = 10.0):
        self.name = name
        self.plugin = plugin
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
            self.stop()
            raise RuntimeError(
                f"output {name}: {workers} worker thread(s) did not start "
                f"within {start_timeout:.1f}s") from None

    def _worker(self, index: int, ready: threading.Barrier) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loops.append(loop)
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
        if not self._loops:
            coro.close()
            raise RuntimeError(f"output {self.name}: worker pool stopped")
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
