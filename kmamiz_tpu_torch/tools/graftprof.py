"""graftprof CLI: render, capture, and diff hot-path attribution profiles.

Counterpart of the repo's tools/graftprof.py, over the port: the same
modes, last JSON lines and exit codes, and ``--device`` (default: the
card) for the capture. Three modes over the same artifact formats (a
"kmamiz-graftprof" profile, or a "kmamiz-flight" recorder dump — both
render identically):

    # per-phase report of an artifact (scenario flight box, a
    # /debug/graftprof download)
    python -m kmamiz_tpu_torch.tools.graftprof report kmamiz-data/flight/flight-....json
    python -m kmamiz_tpu_torch.tools.graftprof kmamiz-data/flight/flight-....json --json

    # regression gate: candidate vs baseline per-phase p95, exit 1 on
    # any phase past its threshold. When the candidate is a failed
    # scenario cell's flight box, the output also carries a "blame"
    # block — the gate/phase attribution the graftsoak sweep records per
    # cell (bisect a failure against the sweep's last passing flight for
    # the same archetype)
    python -m kmamiz_tpu_torch.tools.graftprof --diff baseline.json candidate.json

    # seeded capture: drive a synthetic collect-tick + raw-ingest
    # workload on the device (seed-0 shape, device statistics on: the
    # segment-stats kernel launches twice a tick on the card;
    # KMAMIZ_PARSE_THREADS=2 so the native merge barrier skew is
    # visible) and write a profile artifact
    python -m kmamiz_tpu_torch.tools.graftprof --capture profile.json --ticks 4

The capture is the zero-infrastructure demo of the acceptance bar:
>=90% of dp_tick wall attributed to named phases, per-shard native
merge lock-wait nonzero at two parse threads.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from kmamiz_tpu_torch.device import DeviceLike


def _load(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _flight_blame(cand_doc: dict, regressions) -> dict:
    """Auto-triage bisection for a scenario flight candidate: the
    runner stamps the failed gates into the flight's ``detail``; map
    the first (sorted, deterministic) onto its owning phase and attach
    the diff's regressed phases as supporting evidence. Empty dict for
    non-scenario candidates."""
    if cand_doc.get("kind") != "kmamiz-flight":
        return {}
    trigger = str(cand_doc.get("trigger", ""))
    if not trigger.startswith("scenario-"):
        return {}
    from kmamiz_tpu_torch.soak.triage import GATE_PHASE

    detail = str(cand_doc.get("detail", ""))
    if detail.startswith("crashed"):
        gates = ["crashed"]
    else:
        gates = sorted(g for g in detail.split(",") if g)
    gate = gates[0] if gates else "unknown"
    return {
        "scenario": trigger[len("scenario-"):],
        "blamed_gate": gate,
        "blamed_phase": GATE_PHASE.get(gate, "unknown"),
        "failed_gates": gates,
        "regressed_phases": [r["phase"] for r in regressions[:4]],
    }


def capture(
    out_path: str,
    ticks: int = 4,
    threads: int = 2,
    seed: int = 0,
    device: DeviceLike = None,
    answers: Optional[List[dict]] = None,
    ingest: Optional[List[dict]] = None,
) -> dict:
    """Run the seeded workload in-process on ``device`` (None: the card,
    raising without one) and write a profile artifact; returns the
    profile. ``answers``, when given, receives each collect tick's
    response, and ``ingest`` the raw-ingest leg's summary (nothing when
    the leg raised and was skipped, as the JAX tool skips it). The tick's device statistics are on: two segment-stats
    launches a tick on the card. The port's raw ingest reads its parse
    workers from KMAMIZ_PARSE_THREADS (``threads`` unless the variable is
    set); it and KMAMIZ_PROF=1 hold for the capture's span only."""
    from kmamiz_tpu_torch.device import resolve_device
    from kmamiz_tpu_torch.scenarios.runner import scoped_env

    dev = resolve_device(device)
    env = {
        "KMAMIZ_PROF": "1",
        "KMAMIZ_PARSE_THREADS": os.environ.get("KMAMIZ_PARSE_THREADS", str(threads)),
    }
    with scoped_env(env):
        return _capture(out_path, ticks, seed, dev, answers, ingest)


def _capture(out_path: str, ticks: int, seed: int, device, answers, ingest) -> dict:
    import kmamiz_tpu_torch.telemetry as telemetry
    from kmamiz_tpu_torch.server.processor import DataProcessor
    from kmamiz_tpu_torch.synth import make_raw_window
    from kmamiz_tpu_torch.telemetry.profiling import report
    from kmamiz_tpu_torch.telemetry.tracing import TRACER

    telemetry.reset_for_tests()
    rng_base = 1_700_000_000_000_000 + seed

    def tick_traces(tick_id: int):
        groups = []
        for t in range(64):
            g = []
            for j in range(7):
                svc = (seed + j) % 5
                g.append(
                    {
                        "traceId": f"{tick_id}-t{t}",
                        "id": f"{tick_id}-{t}-{j}",
                        "parentId": f"{tick_id}-{t}-{j - 1}" if j else None,
                        "kind": "SERVER" if j % 2 == 0 else "CLIENT",
                        "name": f"svc{svc}.ns.svc.cluster.local:80/*",
                        "timestamp": rng_base + j,
                        "duration": 1000 + j,
                        "localEndpoint": {"serviceName": f"svc{svc}"},
                        "tags": {
                            "component": "proxy",
                            "http.method": "GET",
                            "http.status_code": "200",
                            "http.url": (
                                f"http://svc{svc}.ns.svc.cluster.local"
                                f"/api/{j % 7}"
                            ),
                            "istio.canonical_revision": "v1",
                            "istio.canonical_service": f"svc{svc}",
                            "istio.mesh_id": "cluster.local",
                            "istio.namespace": "ns",
                        },
                    }
                )
            groups.append(g)
        return groups

    prebuilt = [tick_traces(i) for i in range(max(1, ticks))]

    def source(_lb, _t, _lim):
        return prebuilt.pop(0) if prebuilt else []

    dp = DataProcessor(trace_source=source, device=device, use_device_stats=True)
    for i in range(max(1, ticks)):
        with TRACER.tick():
            answer = dp.collect(
                {"uniqueId": f"prof{i}", "lookBack": 30_000, "time": i + 1}
            )
        if answers is not None:
            answers.append(answer)
    # raw-ingest leg: big enough that the byte-balanced native parse
    # actually fans out to `threads` workers (barrier skew => per-shard
    # lock-wait)
    raw = make_raw_window(
        2000, 20, t_start=seed * 10_000, trace_prefix=f"prof{seed}-"
    )
    with TRACER.tick(root_name="dp-ingest"):
        try:
            summary = dp.ingest_raw_window(raw)
            if ingest is not None:
                ingest.append(summary)
        except ValueError as exc:
            print(f"raw-ingest leg skipped: {exc}", file=sys.stderr)
    profile = report.build_profile()
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(profile, f, indent=1)
    return profile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "artifact",
        nargs="*",
        help="artifact path(s); optionally prefixed by the 'report' verb",
    )
    ap.add_argument(
        "--json",
        action="store_true",
        help="print the condensed profile JSON instead of the text report",
    )
    ap.add_argument(
        "--diff",
        nargs=2,
        metavar=("BASELINE", "CANDIDATE"),
        help="compare two artifacts' per-phase p95; exit 1 on regression",
    )
    ap.add_argument(
        "--threshold",
        type=float,
        default=None,
        help="override the default relative regression threshold",
    )
    ap.add_argument(
        "--capture",
        metavar="OUT",
        help="run the seeded synthetic workload and write a profile here",
    )
    ap.add_argument("--ticks", type=int, default=4, help="capture ticks")
    ap.add_argument(
        "--threads",
        type=int,
        default=2,
        help="native parse workers for the capture (2 shows barrier skew)",
    )
    ap.add_argument("--seed", type=int, default=0, help="capture seed")
    ap.add_argument(
        "--device", default=None, help="the capture's torch device (default: the card)"
    )
    args = ap.parse_args(argv)

    from kmamiz_tpu_torch.telemetry.profiling import report

    if args.capture:
        profile = capture(
            args.capture, args.ticks, args.threads, args.seed, device=args.device
        )
        print(report.render(profile), file=sys.stderr)
        print(json.dumps({"profile": args.capture, **{
            k: profile[k] for k in ("ticks", "wall_ms", "attribution_ratio")
        }}))
        return 0

    if args.diff:
        base_doc, cand_doc = (_load(p) for p in args.diff)
        base, cand = (report.from_any(d) for d in (base_doc, cand_doc))
        thresholds = (
            {"default": args.threshold} if args.threshold is not None else None
        )
        regressions = report.diff(base, cand, thresholds=thresholds)
        for r in regressions:
            print(
                f"REGRESSION {r['phase']}: p95 {r['baseline_p95_ms']}ms -> "
                f"{r['candidate_p95_ms']}ms "
                f"(x{r['ratio']}, threshold +{int(r['threshold'] * 100)}%)",
                file=sys.stderr,
            )
        out = {"regressions": regressions}
        blame = _flight_blame(cand_doc, regressions)
        if blame:
            out["blame"] = blame
            print(
                f"BLAME {blame['scenario']}: gate={blame['blamed_gate']} "
                f"phase={blame['blamed_phase']}",
                file=sys.stderr,
            )
        print(json.dumps(out))
        return 1 if regressions else 0

    paths = [p for p in args.artifact if p != "report"]
    if not paths:
        ap.error("nothing to do: pass an artifact, --diff, or --capture")
    for path in paths:
        profile = report.from_any(_load(path))
        if args.json:
            print(json.dumps(profile, indent=1))
        else:
            print(report.render(profile))
    return 0


if __name__ == "__main__":
    sys.exit(main())
