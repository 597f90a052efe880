"""General cron expression parsing with timezone-aware next-fire computation.

Equivalent of the reference's node-cron usage
(KMamiz src/services/Scheduler.ts:31-62), where user-configured
cron settings (GlobalSettings.ts AGGREGATE_INTERVAL / REALTIME_INTERVAL /
DISPATCH_INTERVAL) are arbitrary cron expressions evaluated in a configured
timezone. Supports:

- 5-field (minute hour dom month dow) and 6-field (second + those) forms,
  like the node `cron` package the reference depends on;
- `*`, lists `a,b,c`, ranges `a-b`, steps `*/n` / `a-b/n` / `a/n`
  (open-ended range starting at `a`), and month/weekday names;
- dow 0 and 7 both meaning Sunday;
- standard vixie-cron day matching: when BOTH day-of-month and day-of-week
  are restricted, a date matches if EITHER matches;
- IANA timezones via zoneinfo. DST handling: a fire time that falls in a
  spring-forward gap runs at the first instant after the gap; a time made
  ambiguous by fall-back runs at its first (pre-transition) occurrence.

A copy of kmamiz_tpu/server/cron.py, importing the port's modules.
"""
from __future__ import annotations

import datetime as _dt
from typing import List, Optional, Sequence, Tuple

try:
    from zoneinfo import ZoneInfo
except ImportError:  # pragma: no cover - py<3.9 fallback, not expected here
    ZoneInfo = None  # type: ignore[assignment]

_MONTH_NAMES = {
    "jan": 1, "feb": 2, "mar": 3, "apr": 4, "may": 5, "jun": 6,
    "jul": 7, "aug": 8, "sep": 9, "oct": 10, "nov": 11, "dec": 12,
}
_DOW_NAMES = {
    "sun": 0, "mon": 1, "tue": 2, "wed": 3, "thu": 4, "fri": 5, "sat": 6,
}

# (low, high, name_map) per field in 6-field order
_FIELD_SPECS: Tuple[Tuple[int, int, Optional[dict]], ...] = (
    (0, 59, None),          # second
    (0, 59, None),          # minute
    (0, 23, None),          # hour
    (1, 31, None),          # day of month
    (1, 12, _MONTH_NAMES),  # month
    (0, 7, _DOW_NAMES),     # day of week (0 and 7 = Sunday)
)


class CronError(ValueError):
    pass


def _atom_value(token: str, low: int, high: int, names: Optional[dict]) -> int:
    token = token.strip().lower()
    if names and token in names:
        return names[token]
    try:
        value = int(token)
    except ValueError:
        raise CronError(f"invalid cron field value {token!r}") from None
    if not low <= value <= high:
        raise CronError(f"cron field value {value} out of range [{low},{high}]")
    return value


def _parse_field(field: str, low: int, high: int, names: Optional[dict]) -> Tuple[frozenset, bool]:
    """Parse one field into (allowed values, is_wildcard)."""
    values: set = set()
    wildcard = False
    for part in field.split(","):
        part = part.strip()
        if not part:
            raise CronError(f"empty cron field part in {field!r}")
        step = 1
        if "/" in part:
            range_part, step_part = part.split("/", 1)
            try:
                step = int(step_part)
            except ValueError:
                raise CronError(f"invalid cron step {step_part!r}") from None
            if step <= 0:
                raise CronError(f"cron step must be positive: {part!r}")
        else:
            range_part = part
        if range_part in ("*", ""):
            start, end = low, high
            if step == 1 and len(field.split(",")) == 1:
                wildcard = True
        elif "-" in range_part and not range_part.lstrip("-").isdigit():
            a, b = range_part.split("-", 1)
            start = _atom_value(a, low, high, names)
            end = _atom_value(b, low, high, names)
            if end < start:  # wrap-around range, e.g. fri-mon or nov-feb
                values.update(range(start, high + 1, step))
                values.update(range(low, end + 1, step))
                continue
        elif "/" in part:
            # a/n: open-ended range starting at a (vixie-cron semantics)
            start = _atom_value(range_part, low, high, names)
            end = high
        else:
            start = end = _atom_value(range_part, low, high, names)
        values.update(range(start, end + 1, step))
    return frozenset(values), wildcard


class CronExpr:
    """A parsed cron expression bound to an optional timezone."""

    def __init__(self, expr: str, tz: Optional[str] = None) -> None:
        fields = expr.split()
        if len(fields) == 5:
            fields = ["0"] + fields
        if len(fields) != 6:
            raise CronError(
                f"cron expression must have 5 or 6 fields, got {len(fields)}: {expr!r}"
            )
        parsed = [
            _parse_field(f, lo, hi, names)
            for f, (lo, hi, names) in zip(fields, _FIELD_SPECS)
        ]
        self.expr = expr
        self.seconds = parsed[0][0]
        self.minutes = parsed[1][0]
        self.hours = parsed[2][0]
        self.days = parsed[3][0]
        self.months = parsed[4][0]
        # normalize 7 -> 0 for Sunday
        self.dows = frozenset(v % 7 for v in parsed[5][0])
        # vixie's DOM_STAR/DOW_STAR flags are set whenever the field
        # BEGINS with '*' — including stepped stars like */2 — and the
        # dom/dow OR applies only when NEITHER is star-prefixed. Using
        # "fully unrestricted" here made '0 12 */2 * 1' fire on every
        # odd day OR Monday instead of odd-day Mondays.
        self._dom_wild = fields[3].startswith("*")
        self._dow_wild = fields[5].startswith("*")
        if tz is None:
            self.tzinfo = None
        else:
            if ZoneInfo is None:  # pragma: no cover
                raise CronError("zoneinfo unavailable; cannot use timezone")
            try:
                self.tzinfo = ZoneInfo(tz)
            except Exception as err:
                raise CronError(f"unknown timezone {tz!r}") from err

    # -- matching ------------------------------------------------------------

    def _day_matches(self, local: _dt.datetime) -> bool:
        dom_ok = local.day in self.days
        # Python weekday(): Monday=0; cron: Sunday=0
        dow_ok = ((local.weekday() + 1) % 7) in self.dows
        # vixie: either field star-PREFIXED (incl. stepped */N) -> both
        # bitmasks must match (a plain * passes trivially); neither
        # star-prefixed -> classic OR
        if self._dom_wild or self._dow_wild:
            return dom_ok and dow_ok
        return dom_ok or dow_ok

    def matches(self, local: _dt.datetime) -> bool:
        return (
            local.second in self.seconds
            and local.minute in self.minutes
            and local.hour in self.hours
            and local.month in self.months
            and self._day_matches(local)
        )

    # -- next fire -----------------------------------------------------------

    def next_fire(self, after: _dt.datetime) -> _dt.datetime:
        """First fire time strictly after `after`.

        `after` may be naive (interpreted in the expression's timezone, or
        local wall time when no tz was given) or aware (converted). The
        result carries the expression's tzinfo when one was configured.
        """
        tz = self.tzinfo
        if after.tzinfo is not None and tz is not None:
            local = after.astimezone(tz)
        elif after.tzinfo is not None:
            local = after
        else:
            local = after.replace(tzinfo=tz) if tz is not None else after

        # advance wall-clock fields; cap the search at ~5 years
        candidate = (local + _dt.timedelta(seconds=1)).replace(microsecond=0)
        limit = local + _dt.timedelta(days=366 * 5)
        while candidate <= limit:
            if candidate.month not in self.months:
                # first instant of the next month
                year, month = candidate.year, candidate.month + 1
                if month > 12:
                    year, month = year + 1, 1
                candidate = candidate.replace(
                    year=year, month=month, day=1, hour=0, minute=0, second=0
                )
                continue
            if not self._day_matches(candidate):
                candidate = (candidate + _dt.timedelta(days=1)).replace(
                    hour=0, minute=0, second=0
                )
                continue
            if candidate.hour not in self.hours:
                candidate = (candidate + _dt.timedelta(hours=1)).replace(
                    minute=0, second=0
                )
                continue
            if candidate.minute not in self.minutes:
                candidate = (candidate + _dt.timedelta(minutes=1)).replace(second=0)
                continue
            if candidate.second not in self.seconds:
                candidate = candidate + _dt.timedelta(seconds=1)
                continue
            resolved = self._resolve_dst(candidate)
            if resolved is not None:
                return resolved
            # nonexistent local time (spring-forward gap): fire at the first
            # instant after the gap, like vixie cron does for skipped jobs
            return self._after_gap(candidate)
        raise CronError(f"no fire time within 5 years for {self.expr!r}")

    def _resolve_dst(self, local: _dt.datetime) -> Optional[_dt.datetime]:
        """Return the concrete instant for a wall-clock match, or None when
        the wall time does not exist (DST gap). Ambiguous times resolve to
        the first (fold=0) occurrence."""
        if self.tzinfo is None:
            return local
        probe = local.replace(fold=0)
        # round-trip through UTC: a nonexistent wall time maps forward
        as_utc = probe.astimezone(_dt.timezone.utc)
        back = as_utc.astimezone(self.tzinfo)
        if (back.replace(tzinfo=None, fold=0) != probe.replace(tzinfo=None, fold=0)):
            return None
        return probe

    def _after_gap(self, local: _dt.datetime) -> _dt.datetime:
        """First valid wall-clock instant after the DST gap containing
        `local`, carrying the expression's smallest allowed second so a
        6-field expression whose seconds set excludes 0 still fires at a
        matching second."""
        probe = local.replace(second=0)
        fire_second = min(self.seconds)
        for _ in range(6 * 60):  # gaps are at most a few hours; scan by minute
            probe = probe + _dt.timedelta(minutes=1)
            resolved = self._resolve_dst(probe.replace(second=fire_second))
            if resolved is not None:
                return resolved
        return local + _dt.timedelta(hours=6)  # pragma: no cover - defensive

    def seconds_until_next(self, now: Optional[_dt.datetime] = None) -> float:
        if now is None:
            now = (
                _dt.datetime.now(self.tzinfo)
                if self.tzinfo is not None
                else _dt.datetime.now()
            )
        nxt = self.next_fire(now)
        if nxt.tzinfo is not None and now.tzinfo is None:
            now = now.replace(tzinfo=nxt.tzinfo)
        return max((nxt - now).total_seconds(), 0.0)


def parse(expr: str, tz: Optional[str] = None) -> CronExpr:
    return CronExpr(expr, tz=tz)
