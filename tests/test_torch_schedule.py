"""The port's cron and scheduler against the JAX package's: next-fire times
over a seeded list of 5- and 6-field expressions (names, lists, ranges,
steps, both day fields restricted, which fire on either as vixie cron
does), across DST edges in two zones, equal to the JAX cron's; the same
expressions refused with the same errors; and the scheduler's start,
stop (a fire in progress finishes first) and re-register on real threads.
"""
from __future__ import annotations

import datetime as dt
import random
import threading
import time

import pytest

from kmamiz_tpu.server import cron as jax_cron
from kmamiz_tpu.server import scheduler as jax_scheduler
from kmamiz_tpu_torch.server import cron, scheduler


def _field(rng, lo, hi, names=None):
    kind = rng.randrange(7)
    if kind == 0:
        return "*"
    if kind == 1:
        return f"*/{rng.randrange(2, max(3, (hi - lo) // 2))}"
    a = rng.randrange(lo, hi + 1)
    if kind == 2:
        return str(a)
    if kind == 3:
        b = rng.randrange(a, hi + 1)
        return f"{a}-{b}"
    if kind == 4:
        return ",".join(str(v) for v in sorted(rng.sample(range(lo, hi + 1), 3)))
    if kind == 5:
        return f"{a}/{rng.randrange(1, 5)}"
    if names:
        return rng.choice(names)
    b = rng.randrange(a, hi + 1)
    return f"{a}-{b}/2"


def _expressions(seed, n):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        fields = [
            _field(rng, 0, 59),
            _field(rng, 0, 23),
            _field(rng, 1, 28),
            _field(rng, 1, 12, ["jan", "mar", "jun", "oct", "dec"]),
            _field(rng, 0, 7, ["mon", "tue-fri", "sun", "sat"]),
        ]
        if rng.random() < 0.4:
            fields.insert(0, _field(rng, 0, 59))
        out.append(" ".join(fields))
    return out


EXPRESSIONS = _expressions(0, 48) + [
    "0 9 13 * fri",  # both day fields restricted: the 13th OR a Friday
    "30 2 * * *",  # inside New York's spring-forward gap
    "30 1 * * *",  # New York's fall-back hour happens twice
    "*/15 * * * * *",
    "0 0 29 2 *",  # leap days only
    "0 12 * * 7",  # 7 is Sunday
]
STARTS = [
    dt.datetime(2026, 3, 8, 0, 59, 30),  # New York spring-forward day
    dt.datetime(2026, 11, 1, 0, 45, 0),  # New York fall-back day
    dt.datetime(2026, 3, 29, 0, 30, 0),  # Berlin spring-forward day
    dt.datetime(2026, 12, 31, 23, 59, 59),
    dt.datetime(2027, 2, 27, 12, 0, 0),
]


@pytest.mark.parametrize("tz", ["America/New_York", "Europe/Berlin", "Asia/Taipei", None])
@pytest.mark.parametrize("chunk", range(4))
def test_next_fire_matches_jax(tz, chunk):
    exprs = EXPRESSIONS[chunk::4]
    for expr in exprs:
        port, jax = cron.parse(expr, tz=tz), jax_cron.parse(expr, tz=tz)
        for start in STARTS:
            when = start if tz is None else start.replace(tzinfo=port.tzinfo)
            got, want = when, when
            for _ in range(4):  # a run of successive fires
                got, want = port.next_fire(got), jax.next_fire(want)
                assert got == want, (expr, tz, start)
                assert got.utcoffset() == want.utcoffset(), (expr, tz, start)


def test_dom_dow_either_matches():
    expr = cron.parse("0 9 13 * fri", tz="UTC")
    fires = []
    t = dt.datetime(2026, 2, 1, tzinfo=dt.timezone.utc)
    for _ in range(14):  # into April: the 13th falls on a Monday
        t = expr.next_fire(t)
        fires.append(t)
    assert all(f.day == 13 or f.weekday() == 4 for f in fires)
    assert any(f.day == 13 and f.weekday() != 4 for f in fires)
    assert any(f.weekday() == 4 and f.day != 13 for f in fires)


@pytest.mark.parametrize(
    "expr", ["not a cron", "61 * * * *", "* * * * * * *", "0 0 30 2 *", "* * * foo *", "*/0 * * * *"]
)
def test_refusals_match_jax(expr):
    outcomes = []
    for mod, sched in ((cron, scheduler), (jax_cron, jax_scheduler)):
        try:
            sched.Scheduler(tz="UTC").register("x", expr, lambda: None)
            outcomes.append("accepted")
        except ValueError as err:
            outcomes.append((type(err).__name__, str(err)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0] != "accepted"


def test_reference_defaults_map_to_cadences():
    for expr, seconds in (("0/5 * * * *", 5.0), ("*/5 * * * *", 300.0), ("0/30 * * * *", 30.0)):
        s = scheduler.Scheduler(tz="UTC")
        s.register("j", expr, lambda: None)
        job = s._jobs["j"]
        assert not isinstance(job, scheduler.CronJob) and job.interval_s == seconds
        jax_job = jax_scheduler.Scheduler(tz="UTC")._make_job("j", expr, lambda: None)
        assert jax_job.interval_s == seconds
    # any other step expression is true cron, as in the JAX scheduler
    s = scheduler.Scheduler(tz="UTC")
    s.register("j", "*/7 * * * *", lambda: None)
    assert isinstance(s._jobs["j"], scheduler.CronJob)


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return pred()


def test_scheduler_start_stop_and_reregister():
    s = scheduler.Scheduler(tz="UTC")
    first, second = [], []
    s.register("tick", 0.05, lambda: first.append(1))
    assert s.jobs == ["tick"] and not first
    s.start()
    assert _wait(lambda: len(first) >= 3)
    # re-register replaces the running job: the old thread stops
    old = s._jobs["tick"]
    s.register("tick", 0.05, lambda: second.append(1))
    assert not old._thread.is_alive()
    n_first = len(first)
    assert _wait(lambda: len(second) >= 3)
    assert len(first) == n_first
    s.stop()
    assert not s._jobs["tick"]._thread.is_alive()
    n_second = len(second)
    time.sleep(0.2)
    assert len(second) == n_second


def test_stop_waits_for_a_fire_in_progress():
    s = scheduler.Scheduler(tz="UTC")
    entered, done = threading.Event(), []

    def slow():
        entered.set()
        time.sleep(0.3)
        done.append(1)

    s.register("slow", 0.01, slow)
    s.start()
    assert entered.wait(5)
    s.stop()
    assert done  # the fire finished before stop returned


def test_six_field_cron_job_fires_every_second():
    s = scheduler.Scheduler(tz="UTC")
    stamps = []
    s.register("rt", "* * * * * *", lambda: stamps.append(time.time()))
    assert isinstance(s._jobs["rt"], scheduler.CronJob)
    s.start()
    try:
        assert _wait(lambda: len(stamps) >= 2, timeout=5.0)
    finally:
        s.stop()
    # fires land on distinct second boundaries: never twice in one second
    assert stamps[1] - stamps[0] > 0.5


def test_failing_job_keeps_firing():
    s = scheduler.Scheduler(tz="UTC")
    calls = []

    def boom():
        calls.append(1)
        raise RuntimeError("job failure")

    s.register("boom", 0.02, boom)
    s.start()
    try:
        assert _wait(lambda: len(calls) >= 3)
    finally:
        s.stop()
