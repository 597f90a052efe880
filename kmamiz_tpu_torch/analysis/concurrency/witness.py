"""Runtime lock-witness: record real acquisition orders, cross-check
the static model (KMAMIZ_LOCK_WITNESS=1).

Same two-layer shape as analysis/guards.py's sync guard: graftrace's
static rules catch the *causes* (a cyclic order graph, a blocking call
under a lock) while this witness catches the *symptoms* during tests
and scenario soaks — and closes the loop: a witnessed edge the static
extractor missed is itself a finding (the extractor has a blind spot),
not a pass.

Mechanics: ``install()`` patches the ``threading.Lock`` / ``RLock``
factories so locks **created afterwards from repo code** return a
recording proxy named by its creation site (``rel/path.py:line`` — the
same site the static model keys on). The proxy keeps a thread-local
held stack; each first-depth acquire records one order edge per held
lock plus per-site acquire counts and held-duration maxima. Locks
created before arming (module-level registries) stay raw — the soak
constructs its fleet after arming, which is where the nests live.

``check()`` asserts the witnessed order graph is acyclic AND a subgraph
of the static model's wide (coverage-biased) edge set. Same-site pairs
— two *instances* from one creation site nesting — are reported
informationally: a per-instance hierarchy is real but inexpressible in
a site-keyed static model.

Counterpart of kmamiz_tpu/analysis/concurrency/witness.py: it records
the port's locks (``kmamiz_tpu_torch/`` creation sites) and checks them
against the port's static model; its metrics register in the port's
``telemetry.registry.REGISTRY``.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from kmamiz_tpu_torch import config
from kmamiz_tpu_torch.telemetry.registry import REGISTRY

ENV_WITNESS = "KMAMIZ_LOCK_WITNESS"

# the meta lock is created from the REAL factory before any patching
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_meta = _REAL_LOCK()

_installed = False
_edges: Dict[Tuple[Tuple[str, int], Tuple[str, int]], int] = {}
_acquires: Dict[Tuple[str, int], int] = {}
_max_hold_ms: Dict[Tuple[str, int], float] = {}
_total_hold_ms: Dict[Tuple[str, int], float] = {}

_PKG_ROOT = os.path.dirname(
    os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
)

_ACQUIRES_TOTAL = REGISTRY.counter(
    "kmamiz_lock_witness_acquires_total",
    "first-depth lock acquisitions recorded by the lock witness",
)
_EDGES_GAUGE = REGISTRY.gauge(
    "kmamiz_lock_witness_edges",
    "distinct witnessed lock-order edges (by creation site)",
)
_CYCLES_GAUGE = REGISTRY.gauge(
    "kmamiz_lock_witness_cycles",
    "cycles in the witnessed lock-order graph (must stay 0)",
)
_UNCOVERED_GAUGE = REGISTRY.gauge(
    "kmamiz_lock_witness_uncovered_edges",
    "witnessed order edges missing from the static graftrace model",
)
_MAX_HOLD_GAUGE = REGISTRY.gauge(
    "kmamiz_lock_witness_max_hold_ms",
    "longest witnessed single hold of any repo lock, ms",
)


def enabled() -> bool:
    return config.lock_witness()


def installed() -> bool:
    return _installed


def _repo_rel(filename: str) -> Optional[str]:
    try:
        rel = os.path.relpath(os.path.abspath(filename), _PKG_ROOT)
    except ValueError:
        return None
    rel = rel.replace(os.sep, "/")
    if rel.startswith("kmamiz_tpu_torch/") and rel.endswith(".py"):
        return rel
    return None


class _TLS(threading.local):
    def __init__(self) -> None:
        self.stack: List[List] = []  # [proxy_id, site, t0]
        self.counts: Dict[int, int] = {}


_tls = _TLS()


def _record_first_acquire(site: Tuple[str, int]) -> None:
    _ACQUIRES_TOTAL.inc()
    with _meta:
        _acquires[site] = _acquires.get(site, 0) + 1
        seen: Set[Tuple[str, int]] = set()
        for _pid, src, _t0 in _tls.stack:
            if src == site or src in seen:
                continue
            seen.add(src)
            key = (src, site)
            _edges[key] = _edges.get(key, 0) + 1


def _record_hold(site: Tuple[str, int], dur_ms: float) -> None:
    with _meta:
        if dur_ms > _max_hold_ms.get(site, 0.0):
            _max_hold_ms[site] = dur_ms
        _total_hold_ms[site] = _total_hold_ms.get(site, 0.0) + dur_ms


class _WitnessLock:
    """Recording proxy around one Lock/RLock instance."""

    __slots__ = ("_inner", "_site", "_kind")

    def __init__(self, inner, site: Tuple[str, int], kind: str) -> None:
        self._inner = inner
        self._site = site
        self._kind = kind

    # -- core protocol --------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if not ok:
            return ok
        pid = id(self)
        depth = _tls.counts.get(pid, 0)
        _tls.counts[pid] = depth + 1
        if depth == 0:
            _record_first_acquire(self._site)
            _tls.stack.append([pid, self._site, time.perf_counter()])
        return ok

    def release(self) -> None:
        pid = id(self)
        depth = _tls.counts.get(pid, 0)
        if depth == 1:
            for i in range(len(_tls.stack) - 1, -1, -1):
                if _tls.stack[i][0] == pid:
                    t0 = _tls.stack[i][2]
                    del _tls.stack[i]
                    _record_hold(
                        self._site, (time.perf_counter() - t0) * 1000.0
                    )
                    break
            _tls.counts.pop(pid, None)
        elif depth > 1:
            _tls.counts[pid] = depth - 1
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # -- Condition integration (threading.Condition delegates these) ----

    def _release_save(self):
        pid = id(self)
        depth = _tls.counts.pop(pid, 0)
        if depth:
            for i in range(len(_tls.stack) - 1, -1, -1):
                if _tls.stack[i][0] == pid:
                    t0 = _tls.stack[i][2]
                    del _tls.stack[i]
                    _record_hold(
                        self._site, (time.perf_counter() - t0) * 1000.0
                    )
                    break
        if hasattr(self._inner, "_release_save"):
            return (self._inner._release_save(), depth)
        self._inner.release()
        return (None, depth)

    def _acquire_restore(self, state) -> None:
        inner_state, depth = state
        if inner_state is not None and hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        if depth:
            _tls.counts[id(self)] = depth
            _record_first_acquire(self._site)
            _tls.stack.append([id(self), self._site, time.perf_counter()])

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<WitnessLock {self._kind} {self._site[0]}:{self._site[1]}>"


def _factory(kind: str, real):
    def make():
        inner = real()
        if not _installed:
            return inner
        frame = sys._getframe(1)
        rel = _repo_rel(frame.f_code.co_filename)
        if rel is None:
            return inner
        return _WitnessLock(inner, (rel, frame.f_lineno), kind)

    make.__name__ = kind
    return make


def install() -> None:
    """Patch the lock factories; repo locks created from here on record."""
    global _installed
    if _installed:
        return
    _installed = True
    threading.Lock = _factory("Lock", _REAL_LOCK)
    threading.RLock = _factory("RLock", _REAL_RLOCK)


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    _installed = False
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    _publish()


@contextmanager
def armed():
    """Install for the duration of a scenario/test body."""
    install()
    try:
        yield
    finally:
        uninstall()


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------


def _site_str(site: Tuple[str, int]) -> str:
    return f"{site[0]}:{site[1]}"


def _witnessed_edges() -> Dict[Tuple[Tuple[str, int], Tuple[str, int]], int]:
    with _meta:
        return dict(_edges)


def _find_cycles(
    pairs: Set[Tuple[Tuple[str, int], Tuple[str, int]]]
) -> List[List[str]]:
    adj: Dict[Tuple[str, int], Set[Tuple[str, int]]] = {}
    for src, dst in pairs:
        adj.setdefault(src, set()).add(dst)
    cycles: List[List[str]] = []
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[Tuple[str, int], int] = {}
    path: List[Tuple[str, int]] = []

    def dfs(v: Tuple[str, int]) -> None:
        color[v] = GRAY
        path.append(v)
        for w in sorted(adj.get(v, ())):
            c = color.get(w, WHITE)
            if c == GRAY:
                i = path.index(w)
                cycles.append([_site_str(s) for s in path[i:]] + [_site_str(w)])
            elif c == WHITE:
                dfs(w)
        path.pop()
        color[v] = BLACK

    for v in sorted(adj):
        if color.get(v, WHITE) == WHITE:
            dfs(v)
    return cycles


@dataclass
class WitnessReport:
    cycles: List[List[str]] = field(default_factory=list)
    uncovered: List[Tuple[str, str]] = field(default_factory=list)
    unknown_sites: List[str] = field(default_factory=list)
    peer_edges: List[str] = field(default_factory=list)  # informational
    edge_count: int = 0
    acquire_count: int = 0

    @property
    def acyclic(self) -> bool:
        return not self.cycles

    @property
    def ok(self) -> bool:
        return self.acyclic and not self.uncovered and not self.unknown_sites


_static_cache: Optional[Tuple[Set[Tuple[str, int]], Set[tuple]]] = None


def _static_sites_and_pairs() -> Tuple[Set[Tuple[str, int]], Set[tuple]]:
    """(known creation sites, wide coverage edge set) from the static
    model — built once per process, pure ast."""
    global _static_cache
    if _static_cache is None:
        from kmamiz_tpu_torch.analysis.concurrency import locks as _locks

        model = _locks.repo_model()
        sites = {
            (s.rel_path, s.line) for s in model.locks.values()
        }
        pairs = set()
        for src, dst in model.wide_edge_pairs:
            a = model.creation_site(src)
            b = model.creation_site(dst)
            if a and b:
                pairs.add((a, b))
        _static_cache = (sites, pairs)
    return _static_cache


def check(static: Optional[Tuple[Set, Set]] = None) -> WitnessReport:
    """Cross-check the witnessed order graph against the static model."""
    report = _check_edges(_witnessed_edges(), static)
    with _meta:
        report.acquire_count = sum(_acquires.values())
    _publish(report)
    return report


def check_snapshot(
    snap: dict, static: Optional[Tuple[Set, Set]] = None
) -> WitnessReport:
    """check() over another process's witness, from its snapshot() (the
    DP's /timings `lockWitness`): the same cycles, uncovered edges and
    unknown sites, against this process's static model."""

    def site(s: str) -> Tuple[str, int]:
        rel, line = s.rsplit(":", 1)
        return (rel, int(line))

    edges = {(site(e["src"]), site(e["dst"])): e["count"] for e in snap["edges"]}
    report = _check_edges(edges, static)
    report.acquire_count = sum(v["acquires"] for v in snap["locks"].values())
    return report


def _check_edges(
    edges: Dict[Tuple[Tuple[str, int], Tuple[str, int]], int],
    static: Optional[Tuple[Set, Set]] = None,
) -> WitnessReport:
    """The report of a witnessed edge set ((src site, dst site) -> count)
    against the static model (without the acquire count)."""
    known_sites, static_pairs = (
        static if static is not None else _static_sites_and_pairs()
    )
    report = WitnessReport()
    pairs: Set[Tuple[Tuple[str, int], Tuple[str, int]]] = set()
    for (src, dst), _count in edges.items():
        if src == dst:
            report.peer_edges.append(_site_str(src))
            continue
        pairs.add((src, dst))
    report.edge_count = len(pairs)
    report.cycles = _find_cycles(pairs)
    for src, dst in sorted(pairs):
        for site in (src, dst):
            s = _site_str(site)
            if site not in known_sites and s not in report.unknown_sites:
                report.unknown_sites.append(s)
        if (src, dst) not in static_pairs:
            report.uncovered.append((_site_str(src), _site_str(dst)))
    return report


def _publish(report: Optional[WitnessReport] = None) -> None:
    with _meta:
        distinct = len({(s, d) for (s, d) in _edges if s != d})
        max_hold = max(_max_hold_ms.values(), default=0.0)
    _EDGES_GAUGE.set(distinct)
    _MAX_HOLD_GAUGE.set(max_hold)
    if report is not None:
        _CYCLES_GAUGE.set(len(report.cycles))
        _UNCOVERED_GAUGE.set(len(report.uncovered))


def snapshot() -> dict:
    """JSON-shaped state for /timings."""
    with _meta:
        sites = sorted(_acquires)
        out_sites = {
            _site_str(s): {
                "acquires": _acquires.get(s, 0),
                "maxHoldMs": round(_max_hold_ms.get(s, 0.0), 3),
                "totalHoldMs": round(_total_hold_ms.get(s, 0.0), 3),
            }
            for s in sites
        }
        out_edges = [
            {"src": _site_str(s), "dst": _site_str(d), "count": c}
            for (s, d), c in sorted(_edges.items())
        ]
    _publish()
    return {
        "enabled": enabled(),
        "installed": _installed,
        "locks": out_sites,
        "edges": out_edges,
    }


def reset_for_tests() -> None:
    uninstall()
    global _static_cache
    with _meta:
        _edges.clear()
        _acquires.clear()
        _max_hold_ms.clear()
        _total_hold_ms.clear()
    _static_cache = None
    _tls.stack.clear()
    _tls.counts.clear()
    for g in (_EDGES_GAUGE, _CYCLES_GAUGE, _UNCOVERED_GAUGE, _MAX_HOLD_GAUGE):
        g.set(0.0)
