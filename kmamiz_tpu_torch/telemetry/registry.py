"""Unified metrics registry: counters, gauges, fixed-bucket histograms.

A copy of kmamiz_tpu/telemetry/registry.py. One process-wide registry
holds the port's counters (the step timer's phases, the resilience
counters, the tick spans, the kernels' launches) behind one API and
renders the whole set as Prometheus text exposition format 0.0.4 for
`GET /metrics`.

Hot-path contract: handles are PREALLOCATED at module or init scope —
`REGISTRY.counter(...)` / `family.handle(...)` are registration-time
calls. The per-call operations (`inc`, `set`, `observe`) touch one lock
and a few floats; they never format a label string, never build a dict
key, never allocate a handle.

Pull-side collection: modules that keep their own structured state (the
kernels' launch counters, the graph store's arenas, the card's memory
statistics) hook `register_callback` — the callback runs at scrape
(render) time only, so mirroring their numbers into gauges costs the hot
path nothing.
"""
from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, List, Sequence, Tuple

# default latency buckets (ms): tick phases span ~0.1 ms device walks to
# multi-second capacity-growth merges
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000,
)


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integers render bare, floats as repr."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _fmt_le(bound: float) -> str:
    if bound == float("inf"):
        return "+Inf"
    return _fmt_value(bound)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class Counter:
    """Monotonic counter handle. `inc` is the only hot-path operation."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, by: float = 1.0) -> None:
        with self._lock:
            self._value += by

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge:
    """Settable gauge handle."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, by: float = 1.0) -> None:
        with self._lock:
            self._value += by

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram:
    """Fixed-bucket histogram handle.

    Buckets are upper bounds fixed at registration; `observe` does one
    bisect into a preallocated count array — no per-call allocation.
    """

    __slots__ = ("buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, buckets: Sequence[float]) -> None:
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        idx = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(cumulative bucket counts incl +Inf, sum, count)."""
        with self._lock:
            raw = list(self._counts)
            s, c = self._sum, self._count
        cum, acc = [], 0
        for n in raw:
            acc += n
            cum.append(acc)
        return cum, s, c

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0


_KINDS = {"counter": Counter, "gauge": Gauge}


class Family:
    """One named metric with a fixed label schema.

    `handle(*label_values)` allocates (or returns) the child for one
    label combination — call it at init scope, keep the handle, and use
    only the handle on the hot path.
    """

    __slots__ = ("name", "help", "kind", "label_names", "buckets", "_children", "_lock")

    def __init__(self, name, help_text, kind, label_names, buckets=None):
        self.name = name
        self.help = help_text
        self.kind = kind
        self.label_names = tuple(label_names)
        self.buckets = tuple(buckets) if buckets else None
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def handle(self, *label_values: str):
        vals = tuple(str(v) for v in label_values)
        if len(vals) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} label values, "
                f"got {len(vals)}"
            )
        with self._lock:
            child = self._children.get(vals)
            if child is None:
                if self.kind == "histogram":
                    child = Histogram(self.buckets)
                else:
                    child = _KINDS[self.kind]()
                self._children[vals] = child
            return child

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class MetricsRegistry:
    """Process-wide named-metric store with Prometheus text rendering."""

    def __init__(self) -> None:
        self._families: Dict[str, Family] = {}
        self._callbacks: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    # -- registration (init scope only) ---------------------------------
    def _family(self, name, help_text, kind, label_names, buckets=None) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, help_text, kind, label_names, buckets)
                self._families[name] = fam
            elif fam.kind != kind or fam.label_names != tuple(label_names):
                raise ValueError(
                    f"metric {name} re-registered with a different schema"
                )
            return fam

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._family(name, help_text, "counter", ()).handle()

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._family(name, help_text, "gauge", ()).handle()

    def histogram(
        self, name: str, help_text: str = "", buckets: Sequence[float] = DEFAULT_MS_BUCKETS
    ) -> Histogram:
        return self._family(name, help_text, "histogram", (), buckets).handle()

    def counter_family(self, name, help_text="", label_names=()) -> Family:
        return self._family(name, help_text, "counter", label_names)

    def gauge_family(self, name, help_text="", label_names=()) -> Family:
        return self._family(name, help_text, "gauge", label_names)

    def histogram_family(
        self, name, help_text="", label_names=(), buckets=DEFAULT_MS_BUCKETS
    ) -> Family:
        return self._family(name, help_text, "histogram", label_names, buckets)

    def register_callback(self, fn: Callable[[], None]) -> None:
        """Scrape-time collector: `fn` runs at render() to refresh pull
        gauges from structured sources (program registry, arenas, HBM)."""
        with self._lock:
            if fn not in self._callbacks:
                self._callbacks.append(fn)

    # -- introspection ---------------------------------------------------
    def get_value(self, name: str, label_values: Tuple[str, ...] = ()) -> float:
        fam = self._families.get(name)
        if fam is None:
            return 0.0
        child = fam._children.get(tuple(str(v) for v in label_values))
        if child is None:
            return 0.0
        if isinstance(child, Histogram):
            return float(child._count)
        return child.value

    def families(self) -> List[Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    # -- exposition ------------------------------------------------------
    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            callbacks = list(self._callbacks)
        for cb in callbacks:
            try:
                cb()
            except Exception:
                pass  # a broken collector must not poison the scrape
        out: List[str] = []
        for fam in self.families():
            out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for vals, child in fam.children():
                labels = ",".join(
                    f'{k}="{_escape_label(v)}"'
                    for k, v in zip(fam.label_names, vals)
                )
                if isinstance(child, Histogram):
                    cum, total, count = child.snapshot()
                    bounds = list(child.buckets) + [float("inf")]
                    for bound, c in zip(bounds, cum):
                        le = f'le="{_fmt_le(bound)}"'
                        lb = f"{labels},{le}" if labels else le
                        out.append(f"{fam.name}_bucket{{{lb}}} {c}")
                    suffix = f"{{{labels}}}" if labels else ""
                    out.append(f"{fam.name}_sum{suffix} {_fmt_value(total)}")
                    out.append(f"{fam.name}_count{suffix} {count}")
                else:
                    suffix = f"{{{labels}}}" if labels else ""
                    out.append(f"{fam.name}{suffix} {_fmt_value(child.value)}")
        return "\n".join(out) + "\n"

    def reset_for_tests(self) -> None:
        """Zero every value but KEEP families and handles registered —
        module-scope handles captured at import time stay live."""
        for fam in self.families():
            for _vals, child in fam.children():
                child._reset()


# the process-wide registry: all modules register against this instance
REGISTRY = MetricsRegistry()
