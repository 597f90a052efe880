"""Tick watchdog: bound the collect tick, degrade instead of failing.

Counterpart of kmamiz_tpu/resilience/watchdog.py. The realtime loop's
contract is "a fresh graph every tick"; the watchdog weakens it to "a
graph every tick, fresh when possible". `run()` executes the tick on a
worker thread and waits at most the deadline:

- the worker finishes in time: its result or exception passes through;
- the deadline passes: `TickDeadlineExceeded` is raised and the caller
  serves the last-good payload, marked stale. A Python thread cannot be
  killed, so the straggler runs on, and its result reaches
  `on_late_result` (refreshing last-good);
- a straggler is still in flight: `TickDeadlineExceeded` with reason
  ``tick-in-flight`` at once, so stragglers never pile up (and the
  processor's tick_lock, which the straggler holds, is never waited on).

On the card, the worker thread launches on its own current stream, the
thread's default stream of the device: every kernel a tick enqueues, and
the side stream of the upload pipeline (ops/double_buffer.py, fenced by
events and record_stream), orders against it as on the caller's thread.

On with ``KMAMIZ_TICK_DEADLINE_MS`` > 0 (default 0: off). Trips count
per reason in resilience/metrics.py and surface in /health.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

from kmamiz_tpu_torch import config
from kmamiz_tpu_torch.resilience import metrics

logger = logging.getLogger("kmamiz_tpu_torch.resilience.watchdog")

REASON_DEADLINE = "deadline"
REASON_IN_FLIGHT = "tick-in-flight"
REASON_FAULT = "tick-fault"


class TickDeadlineExceeded(RuntimeError):
    def __init__(self, reason: str, deadline_ms: float) -> None:
        super().__init__(
            f"collect tick exceeded its deadline ({deadline_ms:.0f} ms): {reason}"
        )
        self.reason = reason
        self.deadline_ms = deadline_ms


class TickWatchdog:
    def __init__(
        self,
        deadline_ms: Optional[float] = None,
        on_late_result: Optional[Callable[[object], None]] = None,
    ) -> None:
        # None: read the env on every run, so a live server follows
        # KMAMIZ_TICK_DEADLINE_MS without a restart
        self._deadline_ms = deadline_ms
        # the stream engine's epoch cache: one env read per epoch of
        # micro-ticks instead of one per tick
        self._epoch_deadline_ms: Optional[float] = None
        self._on_late_result = on_late_result
        self._lock = threading.Lock()
        # in_flight: a worker is executing a tick; abandoned: the waiter
        # gave up on it (a deadline trip), and the worker hands its
        # result to on_late_result
        self._in_flight = False
        self._abandoned = False

    @property
    def deadline_ms(self) -> float:
        if self._deadline_ms is not None:  # the constructor's pin wins
            return self._deadline_ms
        epoch = self._epoch_deadline_ms
        if epoch is not None:  # inside a stream epoch: the cached read
            return epoch
        return config.tick_deadline_ms()

    def begin_stream_epoch(self) -> float:
        """Cache the KMAMIZ_TICK_DEADLINE_MS read for one stream epoch;
        returns it. Each call reads the env again: calling it is the next
        epoch."""
        with self._lock:
            self._epoch_deadline_ms = config.tick_deadline_ms()
            return self._epoch_deadline_ms

    def end_stream_epoch(self) -> None:
        """Drop the epoch cache: back to a read per run."""
        with self._lock:
            self._epoch_deadline_ms = None

    @property
    def enabled(self) -> bool:
        return self.deadline_ms > 0

    def run(self, fn: Callable[[], object], overrun_reason: Optional[str] = None) -> object:
        """fn's result, fn's exception, or TickDeadlineExceeded on an
        overrun or a straggler in flight. `overrun_reason` renames the
        overrun's trip (the stream engine's ``stream-overrun``); a
        straggler in flight is always ``tick-in-flight``."""
        deadline_ms = self.deadline_ms
        if deadline_ms <= 0:
            return fn()
        with self._lock:
            if self._in_flight:
                metrics.watchdog_tripped(REASON_IN_FLIGHT)
                raise TickDeadlineExceeded(REASON_IN_FLIGHT, deadline_ms)
            self._in_flight = True
            self._abandoned = False

        done = threading.Event()
        box = {"result": None, "error": None}

        def worker() -> None:
            try:
                box["result"] = fn()
            except BaseException as err:  # noqa: BLE001 - handed to the waiter
                box["error"] = err
            finally:
                with self._lock:
                    was_abandoned = self._abandoned
                    self._in_flight = False
                    self._abandoned = False
                done.set()
                if was_abandoned and box["error"] is None:
                    logger.info("watchdog: late tick completed, refreshing")
                    if self._on_late_result is not None:
                        try:
                            self._on_late_result(box["result"])
                        except Exception:  # noqa: BLE001 - logged
                            logger.exception("watchdog: on_late_result failed")

        threading.Thread(target=worker, name="kmamiz-tick-watchdog", daemon=True).start()
        if done.wait(deadline_ms / 1000.0):
            if box["error"] is not None:
                raise box["error"]
            return box["result"]
        with self._lock:
            # a worker that finished between the timeout and this lock
            # counts as in time; otherwise abandon it (it stays in flight,
            # so the next tick trips tick-in-flight)
            finished = not self._in_flight
            if not finished:
                self._abandoned = True
        if finished:
            if box["error"] is not None:
                raise box["error"]
            return box["result"]
        reason = overrun_reason or REASON_DEADLINE
        metrics.watchdog_tripped(reason)
        raise TickDeadlineExceeded(reason, deadline_ms)
