"""Profiler profiles: build, render, and diff per-phase attributions.

A copy of kmamiz_tpu/telemetry/profiling/report.py. A *profile* is the
analysis-ready condensation of the raw planes (host event ring, native
counters, device logs): per-phase latency stats, the tick-wall
attribution ratio (how much of the dp-tick wall the named phases
explain), the native shard table, and the device plane.
`GET /debug/graftprof` serves the live one; `diff` compares two with
per-phase regression thresholds.

Accepted inputs everywhere: a profile dict (kind "kmamiz-graftprof")
or a flight-recorder artifact (kind "kmamiz-flight") — the latter is
condensed on the fly, so the crash-box and the profiler share one
report path.

One addition to the JAX report: the port-only span that runs on a thread
of its own beside the tick (events.OVERLAP_EVENTS, the cluster fetch)
informs but does not attribute, like the native deltas.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from kmamiz_tpu_torch.telemetry.profiling import device_attr, native_counters
from kmamiz_tpu_torch.telemetry.profiling import events as events_mod
from kmamiz_tpu_torch.telemetry.profiling.events import NATIVE_EVENTS, OVERLAP_EVENTS, ROOT_EVENTS
from kmamiz_tpu_torch.telemetry.profiling.recorder import ARTIFACT_KIND
from kmamiz_tpu_torch.telemetry.slo import percentile

PROFILE_KIND = "kmamiz-graftprof"
PROFILE_VERSION = 1

# events that overlap host phases (native deltas ride inside the parse/
# merge spans; compiles ride inside whatever phase triggered them; the
# freshness watermark spans the whole arrival->visible window; the
# cluster fetch runs beside the tick's thread) — they inform but must
# not double-count in the attribution sum
_NON_ATTRIBUTED = set(NATIVE_EVENTS) | set(OVERLAP_EVENTS) | {"compile", "freshness"}

#: per-phase relative regression thresholds for diff(); phases not
#: listed use "default". merge/lock-wait get headroom: they jitter most.
DEFAULT_THRESHOLDS: Dict[str, float] = {
    "default": 0.25,
    "merge": 0.35,
    "native-merge": 0.35,
    "native-merge-lockwait": 0.50,
}
_DIFF_ABS_SLACK_MS = 0.5


def _phase_stats(durs_ms: List[float]) -> dict:
    vals = sorted(durs_ms)
    return {
        "count": len(vals),
        "total_ms": round(sum(vals), 3),
        "p50_ms": round(percentile(vals, 0.50), 3),
        "p95_ms": round(percentile(vals, 0.95), 3),
        "max_ms": round(vals[-1] if vals else 0.0, 3),
    }


def _native_section(native: dict) -> dict:
    shards = []
    for i, sh in enumerate(native.get("shards", ())):
        shards.append(
            {
                "shard": i,
                "parse_ms": round(sh.get("parse_ns", 0) / 1e6, 3),
                "lock_wait_ms": round(sh.get("wait_ns", 0) / 1e6, 3),
                "spans": int(sh.get("spans", 0)),
            }
        )
    probes = int(native.get("intern_probes", 0))
    hits = int(native.get("intern_hits", 0))
    return {
        "available": bool(native.get("available")),
        "parses": int(native.get("parses", 0)),
        "spans": int(native.get("spans", 0)),
        "merge_ms": round(native.get("merge_ns", 0) / 1e6, 3),
        "merge_lock_wait_ms": round(
            native.get("merge_lock_wait_ns", 0) / 1e6, 3
        ),
        "merge_queue_depth_peak": int(
            native.get("merge_queue_depth_peak", 0)
        ),
        "claim_contended": int(native.get("claim_contended", 0)),
        "intern_probes": probes,
        "intern_hits": hits,
        "intern_hit_rate": round(hits / probes, 4) if probes else 0.0,
        "shards": shards,
    }


def build_profile(
    event_rows: Optional[List[Tuple[str, int, int, int]]] = None,
    native: Optional[dict] = None,
    compile_log: Optional[List[dict]] = None,
    hbm_timeline: Optional[List[List[int]]] = None,
) -> dict:
    """Condense raw planes into a profile. With no arguments, reads the
    live process state (the /debug/graftprof payload)."""
    if event_rows is None:
        event_rows = events_mod.snapshot()
    if native is None:
        native = native_counters.counters()
    if compile_log is None:
        compile_log = device_attr.compile_log()
    if hbm_timeline is None:
        hbm_timeline = device_attr.hbm_timeline()

    # per-tick attribution: root events carry the tick wall; phase
    # events of the same tick id explain it (capped at the root — nested
    # spans must not push a tick past 100%)
    root_by_tick: Dict[int, float] = {}
    phases_by_tick: Dict[int, float] = {}
    phase_durs: Dict[str, List[float]] = {}
    for name, tick, _end_ns, dur_ns in event_rows:
        ms = dur_ns / 1e6
        phase_durs.setdefault(name, []).append(ms)
        if name in ROOT_EVENTS:
            root_by_tick[tick] = root_by_tick.get(tick, 0.0) + ms
        elif name not in _NON_ATTRIBUTED:
            phases_by_tick[tick] = phases_by_tick.get(tick, 0.0) + ms
    wall_ms = sum(root_by_tick.values())
    attributed_ms = sum(
        min(root, phases_by_tick.get(tick, 0.0))
        for tick, root in root_by_tick.items()
    )
    return {
        "kind": PROFILE_KIND,
        "version": PROFILE_VERSION,
        "ticks": len(root_by_tick),
        "wall_ms": round(wall_ms, 3),
        "attributed_ms": round(attributed_ms, 3),
        "attribution_ratio": (
            round(attributed_ms / wall_ms, 4) if wall_ms > 0 else 0.0
        ),
        "phases": {
            name: _phase_stats(durs)
            for name, durs in sorted(phase_durs.items())
        },
        "native": _native_section(native),
        "device": {
            "compileLog": compile_log,
            "hbmTimeline": hbm_timeline,
        },
    }


def from_any(doc: dict) -> dict:
    """A profile from either artifact kind (profile pass-through,
    flight-recorder condensation)."""
    if not isinstance(doc, dict):
        raise ValueError("not a graftprof artifact (expected a JSON object)")
    kind = doc.get("kind")
    if kind == PROFILE_KIND:
        return doc
    if kind == ARTIFACT_KIND:
        return build_profile(
            event_rows=[tuple(e) for e in doc.get("events", [])],
            native=doc.get("native", {}),
            compile_log=doc.get("compileLog", []),
            hbm_timeline=doc.get("hbmTimeline", []),
        )
    raise ValueError(f"unrecognized artifact kind: {kind!r}")


def render(profile: dict) -> str:
    """Per-phase text report."""
    p = profile
    lines = [
        f"graftprof — {p.get('ticks', 0)} tick(s), "
        f"{p.get('wall_ms', 0.0):.1f} ms wall, "
        f"{p.get('attribution_ratio', 0.0) * 100:.1f}% attributed "
        f"({p.get('attributed_ms', 0.0):.1f} ms in named phases)",
        "",
        f"  {'phase':<24} {'count':>6} {'total_ms':>10} {'p50_ms':>9} "
        f"{'p95_ms':>9} {'max_ms':>9}",
    ]
    for name, st in sorted(
        p.get("phases", {}).items(),
        key=lambda kv: -kv[1].get("total_ms", 0.0),
    ):
        lines.append(
            f"  {name:<24} {st.get('count', 0):>6} "
            f"{st.get('total_ms', 0.0):>10.2f} {st.get('p50_ms', 0.0):>9.2f} "
            f"{st.get('p95_ms', 0.0):>9.2f} {st.get('max_ms', 0.0):>9.2f}"
        )
    nat = p.get("native", {})
    lines.append("")
    if nat.get("available"):
        lines.append(
            f"native: {nat.get('parses', 0)} parse(s), "
            f"{nat.get('spans', 0)} spans, merge {nat.get('merge_ms', 0.0)} ms, "
            f"lock-wait {nat.get('merge_lock_wait_ms', 0.0)} ms, "
            f"queue-depth peak {nat.get('merge_queue_depth_peak', 0)}, "
            f"claim contended {nat.get('claim_contended', 0)}, "
            f"intern hit-rate {nat.get('intern_hit_rate', 0.0)}"
        )
        for sh in nat.get("shards", ()):
            lines.append(
                f"  shard {sh['shard']}: parse {sh['parse_ms']:.2f} ms, "
                f"lock-wait {sh['lock_wait_ms']:.2f} ms, "
                f"{sh['spans']} spans"
            )
    else:
        lines.append("native: counters unavailable (no native parse in this process)")
    dev = p.get("device", {})
    clog = dev.get("compileLog", [])
    lines.append(
        f"device: {len(clog)} compile cause(s), "
        f"{len(dev.get('hbmTimeline', []))} HBM watermark sample(s)"
    )
    for entry in clog[-5:]:
        lines.append(
            f"  compile {entry.get('program')} x{entry.get('compiles')} "
            f"({entry.get('ms')} ms, tick {entry.get('tick')})"
        )
    return "\n".join(lines)


def diff(
    baseline: dict,
    candidate: dict,
    thresholds: Optional[Dict[str, float]] = None,
    abs_slack_ms: float = _DIFF_ABS_SLACK_MS,
) -> List[dict]:
    """Per-phase p95 regressions of candidate vs baseline: one row per
    phase whose candidate p95 exceeds baseline p95 by more than the
    phase's relative threshold plus the absolute slack."""
    thresholds = dict(DEFAULT_THRESHOLDS, **(thresholds or {}))
    base = from_any(baseline).get("phases", {})
    cand = from_any(candidate).get("phases", {})
    regressions: List[dict] = []
    for name in sorted(set(base) & set(cand)):
        old = float(base[name].get("p95_ms", 0.0))
        new = float(cand[name].get("p95_ms", 0.0))
        rel = thresholds.get(name, thresholds["default"])
        if new > old * (1.0 + rel) + abs_slack_ms:
            regressions.append(
                {
                    "phase": name,
                    "baseline_p95_ms": old,
                    "candidate_p95_ms": new,
                    "threshold": rel,
                    "ratio": round(new / old, 3) if old > 0 else float("inf"),
                }
            )
    return regressions
