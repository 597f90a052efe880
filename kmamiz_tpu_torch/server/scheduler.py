"""Scheduler for the realtime / aggregation / dispatch jobs.

Equivalent of KMamiz src/services/Scheduler.ts (node-cron), which
accepts arbitrary user-configured cron expressions evaluated in the
configured timezone (GlobalSettings.ts TIMEZONE). Three kinds of schedules:

- a plain seconds interval (float);
- one of the reference's three default cron strings, which carry
  seconds-granularity quirks (docs/ENVIRONMENT.md documents "0/5 * * * *"
  as every 5 SECONDS) and are mapped to their documented cadences;
- any other cron expression, parsed by kmamiz_tpu_torch.server.cron (full 5/6
  field syntax, names, steps, tz-aware DST-safe next-fire).

Jobs run on daemon threads; exceptions are logged, not fatal, and each
job's failure streak counts in resilience/metrics.py.

A copy of kmamiz_tpu/server/scheduler.py without the
`interval_from_cron` estimate, which the port has no caller for. A job
registered for a non-default tenant is named ``<tenant>/<name>``
(tenancy/isolation.tenant_job_name), and `stop_tenant` stops one
tenant's jobs and resets their streaks. `stop`
also waits for a job that is running to finish its fire, so a caller
that stops the scheduler before a final flush (Application.tear_down)
flushes after the last tick.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional, Union

from kmamiz_tpu_torch.resilience import metrics as res_metrics
from kmamiz_tpu_torch.server.cron import CronExpr

logger = logging.getLogger("kmamiz_tpu_torch.scheduler")

# The reference's default cron expressions carry seconds-granularity quirks
# (docs/ENVIRONMENT.md documents "0/5 * * * *" as every 5 SECONDS); map them
# to their documented cadences explicitly.
_KNOWN_CRON = {
    "0/5 * * * *": 5.0,  # realtime: every 5 s
    "*/5 * * * *": 300.0,  # aggregation: every 5 min
    "0/30 * * * *": 30.0,  # dispatch: every 30 s
}


class Job:
    def __init__(self, name: str, interval_s: float, fn: Callable[[], None]) -> None:
        self.name = name
        self.interval_s = interval_s
        self.fn = fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _next_delay(self) -> float:
        return self.interval_s

    def start(self) -> None:
        def run() -> None:
            while True:
                try:
                    delay = self._next_delay()
                except Exception as err:  # noqa: BLE001 - delay errors must not kill the loop
                    logger.exception(
                        "scheduled job %s cannot compute its next fire", self.name
                    )
                    res_metrics.job_failed(self.name, err)
                    delay = 60.0
                if self._stop.wait(delay):
                    return
                try:
                    self.fn()
                except Exception as err:  # noqa: BLE001 - job errors must not kill the loop
                    # the loop survives; the streak and the last error
                    # surface in /health's resilience section
                    logger.exception("scheduled job %s failed", self.name)
                    res_metrics.job_failed(self.name, err)
                else:
                    res_metrics.job_succeeded(self.name)

        self._thread = threading.Thread(target=run, name=f"job-{self.name}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop firing, and wait for a fire in progress to finish (a job
        stopping itself from its own thread does not wait)."""
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join()


class CronJob(Job):
    """A job driven by true cron evaluation: sleeps until the expression's
    next fire time, runs, recomputes. Equivalent to node-cron's CronJob
    (KMamiz src/services/Scheduler.ts:39-47)."""

    def __init__(self, name: str, expr: CronExpr, fn: Callable[[], None]) -> None:
        super().__init__(name, 0.0, fn)
        self.cron = expr
        self._last_target = None
        # an expression with no satisfiable date (e.g. '0 0 30 2 *') parses
        # field-by-field but can never fire; fail at registration, matching
        # the reference's fatal-on-bad-cron (Scheduler.ts:35-38)
        self.cron.seconds_until_next()

    def _next_delay(self, now=None) -> float:
        import datetime as _dt

        if now is None:
            now = (
                _dt.datetime.now(self.cron.tzinfo)
                if self.cron.tzinfo is not None
                else _dt.datetime.now()
            )
        # anchor on the previously-targeted fire: if the wall clock stepped
        # backward during the wait (NTP correction, VM resume), recomputing
        # from `now` would schedule the SAME fire again and run it twice
        base = now
        if self._last_target is not None and self._last_target > now:
            base = self._last_target
        target = self.cron.next_fire(base)
        self._last_target = target
        return max((target - now).total_seconds(), 0.0)


class Scheduler:
    def __init__(self, tz: Optional[str] = None) -> None:
        self._jobs: Dict[str, Job] = {}
        self._started = False
        self._tz = tz

    def _make_job(
        self, name: str, interval: Union[float, str], fn: Callable[[], None]
    ) -> Job:
        if not isinstance(interval, str):
            return Job(name, float(interval), fn)
        if interval in _KNOWN_CRON:
            # only the three seconds-quirk reference defaults bypass cron
            # evaluation; generic expressions (incl. '*/N') get true cron
            # semantics so fires land on minute boundaries like node-cron
            return Job(name, _KNOWN_CRON[interval], fn)
        # full cron evaluation; a bad expression is fatal like the
        # reference's Logger.fatal on invalid cron (Scheduler.ts:35-38)
        return CronJob(name, CronExpr(interval, tz=self._tz), fn)

    def register(
        self, name: str, interval: "float | str", fn: Callable[[], None], tenant: Optional[str] = None
    ) -> None:
        """Register (or replace) a job; a non-default `tenant` names it
        ``<tenant>/<name>``, so it replaces, stops and streaks apart from
        every other tenant's."""
        if tenant not in (None, "", "default"):
            from kmamiz_tpu_torch.tenancy.isolation import tenant_job_name

            name = tenant_job_name(tenant, name)
        job = self._make_job(name, interval, fn)
        existing = self._jobs.get(name)
        if existing is not None:
            existing.stop()  # never leave a replaced job's thread running
        self._jobs[name] = job
        if self._started:
            self._jobs[name].start()

    def start(self) -> None:
        # a (re)started scheduler begins its jobs with clean failure
        # streaks
        res_metrics.reset_job_streaks(list(self._jobs))
        self._started = True
        for job in self._jobs.values():
            job.start()

    def stop(self) -> None:
        """Stop every job, waiting for fires in progress."""
        for job in self._jobs.values():
            job.stop()
        self._started = False

    def stop_tenant(self, tenant: str) -> None:
        """Stop and remove one tenant's ``<tenant>/`` jobs and reset their
        streaks; every other job runs on."""
        if tenant in (None, "", "default"):
            return
        prefix = f"{tenant}/"
        for name in [n for n in self._jobs if n.startswith(prefix)]:
            self._jobs.pop(name).stop()
        res_metrics.reset_job_streaks(prefix=prefix)

    @property
    def jobs(self) -> List[str]:
        return list(self._jobs)
