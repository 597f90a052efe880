#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kmamiz_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py [--report PATH]

Phases, each timed:

1. card identity (nvidia-smi name and power limit);
2. build every hand-written kernel from kmamiz_tpu_torch/csrc with nvcc
   (one process per source, all at once) and, beside them, the port's
   native host library (csrc/*.cpp) with g++;
3. the segment-stats kernel against its plain PyTorch version on card
   tensors, at the production window (2^20 spans, 10,000 endpoints x 8
   statuses) and at the Data Processor tick's own shape, both passes
   (m = 5 stat rows with timestamps, then m = 1 squared residuals
   without); kernel, plain and library times (`ms`: CUDA events around 20
   back-to-back calls, median of 10 runs after warm-up; `call_ms`: one
   call between the events and a sync after it, median of 20) and the
   kernel's device time (`device_ms`: every device event a call enqueues,
   memset included, under torch.profiler, taken at the end of the run)
   beside the least time the card could take;
4. state load: the endpoint graph built to BASELINE size on the card with
   EndpointGraph.merge_window (150,000 synthetic traces x 7 spans, 1,000
   services x 10 urls, merged in chunks); its graph signature is kept
   before any tick;
5. the fused SDDMM/SpMM kernel against its plain version on card tensors
   at the forecast's shapes: the BASELINE graph's edge columns (masked
   padding included) over node tables at the pow2 bucket of its
   endpoints, ungated at H = 18 and 64 (GraphSAGE's two layers) and gated
   at H = 32 (STLGT), each launch given the prebuilt edge index as the
   forward gives it; two launches on the same inputs must give the same
   bits; times and bound as in phase 3; the edge index's build time
   (beside its plain version, keys in plain PyTorch, which must give the
   same index) and its parts: the keys kernel alone against its plain
   version, with its own bound, then the library ops it hands to, one
   stable torch.sort and one searchsorted; the index's row lengths (mean,
   p99, max), and a GraphSAGE forward's kernel work (one index build and
   the launches at H = 18 and 64) timed together;
6. the backward kernels against their plain versions on the same graph
   and bucket, each alone: the row pass ungated at H = 18 and 64 and
   gated at H = 32 (over the entries' gate and da that the SDDMM writes),
   the SDDMM of the gate's grad at H = 32, over one gather index (its pos
   and split equal to the CPU's), each relaunched for the same bits, with
   times, bound, the bytes its gathers move per entry, and its kernel's
   registers, shared memory, spills and resident warps; the whole gated
   backward as one call (one ctypes call, the same bits twice, db
   included) beside autograd of the index_add_ formulation;
7. the tick path: the port's DataProcessorServer on the card answers 4 DP
   ticks (POST /, gzip) of 2,500 fresh traces each; every kernel launch
   counter is zeroed just before and read just after, and the
   segment-stats kernel must have run exactly twice per tick; every tick
   must answer within 5,000 ms;
8. card against CPU: one more tick on the card and on the port's CPU path,
   both from the carried BASELINE graph (export_named_edges ->
   graph_from_export), compared field by field and by graph signature;
9. the forecast path: a processor on the same graph serves two ticks in
   successive hours (910 and 911), which folds the hour and publishes a
   forecast snapshot of every endpoint; the port's ApiServer, with
   KMAMIZ_MODEL_DIR at tests/fixtures/model10k_torch, answers GET
   /api/v1/model/status and /api/v1/model/forecast over HTTP (the fused
   kernel must launch exactly twice: GraphSAGE's two layers), a second
   GET is served from the memo (no launch), and the STLGT quantile forward
   (hidden 32, seeded weights) runs on the same snapshot (one gated
   launch);
10. forecast card against CPU: the same snapshot and weights through the
   port on the CPU, compared output by output, and the payload the route
   served compared per endpoint with the CPU forward after the route's
   rounding;
11. GraphSAGE training at the served head's shape (hidden 64, 18 features)
   over the BASELINE graph's live edges: 24 seeded slots, 8 fused epochs,
   lr 1e-2, pos_weight 4, through trainer.train with a checkpoint; the
   losses must fall, and the counters, zeroed just before, must show 2
   forward launches and 1 backward C call per step, launching the row
   pass alone; one steady epoch
   timed and profiled; one epoch over 2 slots on the card against the
   CPU (losses rtol 1e-3); then the checkpoint served by GET
   /api/v1/model/forecast (one edge index for the snapshot);
12. the STLGT continual trainer behind the fold hook (KMAMIZ_STLGT=1,
   production defaults) fed by a processor's ticks in 5 successive
   hours (4 folds, 3 refreshes) through the DP server, counters zeroed
   just before (each backward one C call launching the SDDMM and the row
   pass): GET /model/stlgt must show the refreshes and no failure,
   the fold hook no error; the last refresh replayed on the port's CPU
   path from the same ring and params (rtol 1e-3 / atol 1e-5); GET
   /api/v1/model/forecast?quantile=p99&horizon=3 with the trained
   GraphSAGE checkpoint beside the live params (3 launches, one edge index);
13. the graph scorers (ops/scorers.py, no kernel of their own): (a) on
   the BASELINE graph of phase 7's processor, after one more served tick
   whose combined records give the risk inputs, the refresh chain
   (service scores, cohesion, risk) through the store with its caches
   dropped, and the same chain's ops alone over the card snapshot
   (median of 7 synchronised runs, synchronising calls counted under
   torch.cuda.set_sync_debug_mode("warn")); a memoized read (one more
   hit, no upload, and under torch.profiler no device event between two
   marker kernels); a served full-mesh tick (the full recompute) and a
   served tick confined to 16 services (the dirty-service incremental
   splice), each refresh bit-equal to the uncached pipeline; (b) the
   chain at bench.py's refresh shape (10,000 endpoints, 1,000 services,
   50,000 seeded edges, no dist_bits: the legacy pipeline); (c) both
   chains' snapshots through the same functions on the CPU, integer
   lanes and instability equal, relying factor and risk within rel 1e-5,
   cohesion within rel 1e-6; (d) a fresh AppContext fed two 2,500-trace
   ticks over the mesh's endpoints, each endpoint serving at most one
   span per tick (so that the reference's per-window records drop no
   edge: see distinct_endpoint_groups), through
   operator.retrieve_realtime_data(), whose ApiServer
   answers the seven graph routes with every device scorer payload equal
   to its ?scorer=host payload (and /line and /statistics at 200); then
   the BASELINE graph served: /graph/{instability,coupling,cohesion} at
   200 with one row per active service (1,000), instability and coupling
   equal to rows built from CPU lanes, and each route's first GET after a
   merge and its memoized GET timed;
14. profile: one more tick, one GraphSAGE forecast forward, and one
   STLGT fold tick (with its refresh), on the card under torch.profiler
   — the device's busy time (union of its kernel, copy and fill
   intervals), its share of the wall time, the top device ops, and peak
   device memory; then the device times of phases 3, 5, 6, 13 and 15,
   last, because a profiler session leaves every later launch slower on
   the host and would inflate the card times taken after it. Every profiler
   session brackets its work with marker kernels and pads it with small
   launches on both sides (a session on the card's machine can lose the
   device records at its edges); a job whose sessions all lose a marker is
   timed with CUDA events instead, and says so;
15. raw ingest (run after phase 13 and before phase 14's profiler
   sessions): (a) the native host library that phase 2 built with g++ —
   its path under kmamiz_tpu_torch/csrc/build/, the g++ wall time and the
   -march it took; (b) phase 4's windows (the same traces, prefix
   "state") as raw bytes through DataProcessor.ingest_raw_window into a
   fresh card processor, chunked as phase 4 merged them: the graph
   signature, endpoints and edges must equal phase 4's; (c) bench.py's
   raw e2e window (150,000 traces x 7 spans, BASELINE mesh) through
   ingest_raw_window into a fresh card processor, a warm-up and then the
   median of 2 reps each on a fresh processor (counters zeroed just
   before, read just after): spans/s, bytes per span, parse and merge ms,
   the native parse's worker count, peak device memory; the same bytes
   again must ingest 0 spans and 0 traces; (d) that window's parse split
   (the native scan alone against the whole batch build, on fresh
   sessions), and its batch columns through window_stats on the card (2 segment-stats launches, counters
   zeroed just before), and both of its segment-stats passes against the
   plain version on the same card tensors, with times and bound as in
   phase 3, printed after the device times beside phase 3's production
   window; (e) a 2,500-trace window POSTed gzipped to the DP server's
   /ingest must answer the summary and graph of a direct
   ingest_raw_window on a twin processor, and a malformed payload
   quarantined (200, reason truncated-json);
   (f) the body fold of phase 7's ticks (the same pairs, rebuilt from the
   same windows, and the same groups with seeded JSON bodies), native
   against the Python fold, equal results, beside the served ticks'
   combine_assemble;
16. streaming ingest (run after phase 15, before phase 14's profiler
   sessions): (a) phase 15 (c)'s window as bench.py's 4 chunks of 37,500
   traces through DataProcessor.ingest_raw_stream into a persistent card
   processor on a virtual clock: the graph signature, endpoints and edges
   of 15 (c); beside it a twin that takes the same windows one shot; (b)
   one uncounted steady window each; (c) 2 counted windows under fresh
   trace prefixes, the clock stepped 301,000 ms (past the dedup TTL)
   before each, the two paths in turns (counters zeroed just before each,
   read just after, peak device memory over base): the streamed wall,
   spans/s, parse, merge, saved and drain ms, the ring's peak, the chunk
   breakdown and the upload pipeline's counters; (d) the twin's one-shot
   wall, parse and merge on the same bytes; both graphs equal at the end;
   (e) a 10,000-trace body (~41 MB) POSTed gzipped to /ingest takes the
   stream branch (4 chunks) with the totals and graph of a direct
   ingest_raw_stream on a twin; (f) ingest_from_zipkin against a local
   stub serving the last counted window's chunks as 4 pages builds the
   graph of that window taken one shot;
17. the application (run after phase 16, before phase 14's profiler
   sessions): (a) boot 1, `Application` in production mode over a
   FileStore in a temporary directory, its card processor preloaded as in
   phase 4 and its store seeded with the dependency records of the same
   150,000 traces (a deployment's cache); the realtime schedule on a
   six-field one-second cron fires 3 ticks of 2,500 fresh traces through
   the operator (the first 2 an hour back, so one hour folds), each under
   5,000 ms, 2 segment-stats launches each (counters zeroed just before
   the boot, read after tear_down); the aggregation job once while the
   realtime job goes on firing (the ticks that overlap it wait for the
   operator's cache lock: their walls are recorded beside the limit, not
   held to it), the realtime schedule parked, tear_down (every cache
   flushed, the history snapshot among them), each timed; (b) boot
   2, a new card processor over the same store: the cache load and the
   graph warm start timed, its graph signature equal to a read-only CPU
   app's over the same store and its history snapshot equal to the one
   boot 1 flushed; (c) every GET route of boot 2 over HTTP at 200 with
   its wall, the memoized routes (scorers, forecast) a second time, their
   payloads equal to the CPU app's (scorers: integers equal, floats rel
   1e-5, cohesion 1e-6; the forecast within the route's rounding), the
   forecast GET's launches (2, and 1 more while phase 12's STLGT trainer
   serves);
18. GAT (after phase 17): a GAT head (hidden 64, no hand-written kernel:
   no counter may move) trained through trainer.train(model=gat) on phase
   11's dataset for 4 epochs with a checkpoint, its losses falling; a
   2-slot epoch on the card against the CPU (rtol 1e-3); the checkpoint
   served by GET /api/v1/model/forecast (model "gat") on phase 9's
   snapshot, its forward on the card against the CPU (rtol 1e-4 / atol
   1e-5) and the payload within the route's rounding; a warm forward's
   wall and device time, a training step's wall, and, last, the card's
   busy share in each under the profiler.
19. the in-cluster deployment (after phase 18, before phase 14's
   profiler sessions), at the BASELINE mesh against a Zipkin stub and a
   kube API stub (four worker processes on one port, kept-alive
   connections, listen backlog 64: the namespaces, 1-3 pods per service, seeded, and each
   pod's istio-proxy log, written with the port's envoy_filter from the
   SERVER spans of every tick so far, with BODY_POOL bodies, cut to
   tailLines): (a) `python -m kmamiz_tpu_torch.server.dp_server` (its
   main(), the WAL on) serves 2 ticks of 2,500 traces, each under 5,000
   ms and equal to a CPU DataProcessor fed the same stubs (dependencies,
   datatypes with the body schemas, replicas equal; latency mean rel
   1e-5 / abs 1e-6, cv rel 1e-3 / abs 1e-5), printing its wall, the
   client's decode of the answer, the pods read, the log lines, the
   bodies and the datatypes, and, by the DP's own GET / answer, 2
   segment-stats launches a tick and the tick's stage walls; (b) an
   in-process twin on the card gives the stage walls and 2 launches a
   tick, and at the last tick the cluster fetch on the client's worker
   processes (of every request, and of the window's as the tick asks)
   and on threads of this process as the JAX client runs it, one after
   the other (their walls, and the same logs); (f) the same ticks as
   micro-ticks of a DP
   server with KMAMIZ_STREAM=1, 2 launches each, equal to the serial
   answers within (a)'s tolerances, and an equal graph signature; (c)
   phase 4's 150,000 traces POSTed to /ingest as 10 raw windows (1.05M
   spans) in the KMZC wire format, kill -9, a second boot
   through main() that replays the WAL: its next tick equals the CPU
   processor's after the same windows, and an in-process replay_wal of
   the WAL gives the CPU graph's signature (WAL bytes, replay and boot
   walls printed; the whole run within the WAL's default retention);
   (d) every chaos.mutate_payload kind POSTed to
   /ingest: 200, the JAX reason code, a file in the quarantine
   directory, the graph unchanged; (e) a tick past its deadline and one
   whose kube API answers 500, served stale (deadline, tick-fault);
   (g) `python -m kmamiz_tpu_torch.api.app` over a scratch FileStore:
   /api/v1/health with its resilience field, a scheduled realtime tick
   that reads every pod's log, SIGTERM flushes (datatypes with body
   schemas in the store) and exits 0.
20. telemetry (after phase 19, before phase 14's profiler sessions): two
   `python -m kmamiz_tpu_torch.server.dp_server` processes (main(), no
   cluster source, KMAMIZ_STLGT=1), one with KMAMIZ_TELEMETRY=0
   KMAMIZ_PROF=0, serve the same 3 windows of 2,500 traces in alternating
   turns: (a) the tick walls' medians and spreads of each; (b) the
   telemetry DP's GET /metrics (0.0.4 text, kmamiz_ticks_total up by the
   ticks, a span histogram of every tick phase, the device memory and
   graph-arena gauges, kmamiz_program_calls_total{program="segment_stats"}
   up by 2 a tick, equal to GET /'s count); (c) its /debug/traces POSTed
   back to /ingest; (e) /debug/graftprof's attribution ratio (>= 0.90)
   and per-phase p95s; (f) two ticks in the next hours, the second folding
   with an STLGT refresh (its span, kmamiz_model_train_ticks_total and the
   fused kernel's calls up); (d) POST /debug/profile around a tick another
   thread serves, inside the session's window: the capture's kernel join
   credits segment_stats with device time, a second capture meanwhile
   answers 409; every telemetry-on tick under 5,000 ms; (g) the sync
   guard around one warm tick of phase 7's card processor: its
   synchronising calls; (h) a scratch DP in this process with
   KMAMIZ_TICK_DEADLINE_MS=1: the trip's kmamiz-flight artifact,
   condensed by report.from_any.
21. the simulator (after phase 20, before phase 14's profiler sessions),
   at BASELINE.json's synthetic mesh (make_mesh_config: 1,000 services x
   10 endpoints, fault fraction 0.08, seed 0) over 1 simulated day: (a)
   Simulator.generate_simulation_data on the host (its wall, endpoints,
   distance-1 edges, slots, rows per slot); (b) GraphSAGE through
   trainer.train_on_simulation on the card (hidden 64, 8 epochs): slots/s,
   losses, kernel 2's forward and backward launches against the steps,
   the evaluation metrics and threshold, the first-epoch loss against a
   2-epoch CPU copy's (rtol 1e-3); (c) GAT on the same dataset, 2 epochs,
   no launch; (d) (b)'s params saved and restored through
   models/checkpoint.py, the restored forward on the card against the
   trained one (rtol 1e-4 / atol 1e-5); (e) beside (a)-(d), the
   application in simulator mode through its main() over a fresh
   FileStore: POST /api/v1/simulation/startSimulation with the same YAML
   (201), the endpoint graph, generateStaticSimConfig and the export (its
   10,000 dependency records, its SimulatedHistoricalData), then SIGTERM
   (exit 0, the store left empty); (f) kernel 2 at (b)'s buckets: the edge
   index against its plain build, the forward at H = 10, 18 and 64 and the
   ungated row pass at 64 against their plain versions, with bound and
   library times.
22. multi-tenant serving (after phase 21, before phase 14's profiler
   sessions): (a) eight tenants t0-t7, each the BASELINE generator over
   125 services x 10 urls in a namespace of its own (1,250 endpoints,
   the eight together the BASELINE's 10,000), each loaded with 18,750 raw
   traces (phase 4's 150,000 split eight ways), all in one arena capacity
   bucket; (b) a DataProcessorServer with a TickRouter over them (gather
   window 50 ms, an argument) takes 4 rounds in which the eight POST at
   once (t0-t3 by /t/<tenant>/, t4-t7 by the tenant header), 312 traces
   each: each round one batched_collect with one stacked merge of 8 lanes,
   no serial merge but drift re-merges, 16 segment-stats launches, every
   answer under 5,000 ms; (c) eight serial twin processors on the card
   take the same windows (graph signatures equal, answers within the tick
   tolerances), two tenants are replayed on the CPU (equal edge columns),
   the batched scorers equal each twin's (integer lanes and instability
   equal, the relying factor rel 1e-5), and the last stacked merge equals
   eight serial merges on its inputs, both timed; (d) KMAMIZ_CONTROL=1 with
   the STLGT head phase 12 left (or one refreshed from two seeded folds):
   t0 and t1 fold two hours, each fold one gated kernel-2 launch, the
   controller's p99 within rel 1e-4 of the same forward on the CPU; with
   t0's SLO under its forecast, t0's tick is deferred (no kernel-1
   launch), a high-priority one runs, t1 stays fresh, and in shed mode t0
   gets a 429; (e) the scenario factory's multi-tenant-mix (seed 0, index
   2, 12 ticks) through a second gathered server with the WAL on: alpha's
   and beta's windows tick by tick, beta's poison storm to
   /t/beta/ingest (beta's quarantine namespace only), alpha's graph equal
   to a clean serial run of its windows, /timings with tenancy and
   control, and a restart over the same WAL replaying each tenant to its
   signature.

It prints the kernels line (JSON) and, last, {"ok": true, "device": ...}.
With --kernels-only it stops after phase 6 and prints the kernel cases,
for a comparison of two checkouts on the same card in one run. With
--zeroing it stops after phase 3 and times the segment-stats kernel's
zeroing prologue against the same source built to zero with a
cudaMemsetAsync before a plain launch (SEGMENT_STATS_ZERO_BY_MEMSET).
With --backward-of DIR it imports the port from the checkout at DIR
(a parent unpacked with git archive, or .) and times its fused_backward,
the API every checkout since port PR 4 shares, on a seeded edge list:
run once per checkout, in turns, for an A/B of their host work. With
--backward-variants it stops after phase 4 and times the backward
kernels as shipped against builds with other tuning values (KMZ_* in
csrc/fused_sddmm_spmm.cu) on the BASELINE graph. With --cluster-only it
runs phases 1-2 and then phase 19 alone; with --telemetry-only, phases
1-2 and then phase 20 alone ((g) on a fresh card processor after one
warm tick); with --simulator-only, phases 1-2 and then phase 21 alone;
with --tenancy-only, phases 1-2 and then phase 22 alone.
Any failed check raises, and the script then exits non-zero without the
result line; so does a machine without a CUDA device, or a directory that
holds this script without the kmamiz_tpu_torch package.
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.parse
import urllib.request

#: peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

BASELINE = dict(n_services=1000, urls_per_service=10)  # bench.py's mesh
SPANS_PER_TRACE = 7
STATE_TRACES = 150_000
STATE_CHUNK = 15_000
TICKS = 4
TICK_TRACES = 2_500  # the reference's per-tick cap (ZIPKIN_LIMIT)
#: the trace-bomb cap of phases 15-16's processors: bench.py's one-shot
#: window is one 609 MB body, past the quarantine's 256 MiB default
RAW_CAP = 1 << 30
PROD_SPANS = 1 << 20
PROD_ENDPOINTS = 10_000
PROD_STATUSES = 8
TIMING_REPS = 20
TIMING_RUNS = 10
TIMING_CALLS = 20
REPO = os.path.dirname(os.path.abspath(__file__))
HOUR_MS = 3_600_000
FORECAST_HOURS = (910, 911)  # two ticks in successive hours: one fold
MODEL_DIR = "tests/fixtures/model10k_torch"
STLGT_HIDDEN = 32  # the STLGT head's default width
SEED = 0
# GraphSAGE training at the served head's shape (bench.py's training setup)
SAGE_SLOTS = 24
SAGE_EPOCHS = 8
SAGE_HIDDEN = 64
SAGE_FEATURES = 18  # 10 base + 8 history columns
SAGE_LR = 1e-2
STLGT_HOURS = (920, 921, 922, 923, 924)  # 5 ticks: 4 folds, 3 refreshes
RAW_TRACES = 150_000  # bench.py's raw e2e window: 1.05M spans
RAW_REPS = 2
TICK_WALL_LIMIT_MS = 5_000  # the DP's realtime cadence (PERF.md section 2)


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str, walls: dict) -> None:
        self.name, self.walls = name, walls

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.walls[self.name] = time.perf_counter() - self.t0
        log(f"   {self.name}: {self.walls[self.name]:.2f} s")
        return False


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(torch, fn, runs: int = TIMING_RUNS, calls: int = TIMING_CALLS) -> float:
    """Card time of one fn() call: CUDA events around `calls` back-to-back
    calls (no sync between them, as a caller's stream sees them), divided
    by `calls`; the median of `runs` runs after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_ms(torch, fn, runs: int = TIMING_RUNS, calls: int = TIMING_CALLS) -> float:
    """Host time of one fn() call: the host clock around `calls`
    back-to-back calls (no sync between them), divided by `calls`; the
    median of `runs` runs after three warm-up calls, each run started on an
    idle card. Where it is near cuda_ms, the host issuing the calls sets
    their card time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def call_ms(torch, fn, reps: int = TIMING_REPS) -> float:
    """Median ms of one fn() call alone: CUDA events around each call and a
    sync after it, after three warm-up calls (chip_smoke's earlier
    method; it also counts the host's wake-up after each sync)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


#: a profiler session on the card's machine sometimes loses device records
#: at its edges (seen: a session of one kernel that records none, while
#: larger sessions in the same process record theirs), so measured work is
#: bracketed by marker kernels (torch.cuda._sleep's spin kernel, which no
#: measured path launches) with PAD_LAUNCHES small fills before and after
#: (64 until a whole run lost a marker in 38 sessions of torch-op work)
PAD_LAUNCHES = 256
MARK = "spin_kernel"


def pad_launches(torch, buf) -> None:
    for _ in range(PAD_LAUNCHES):
        buf.fill_(0)


def traced(torch, fn):
    """The device events (kernels, copies, fills) that fn() enqueues, under
    torch.profiler: those between the two marker kernels, the session
    being padded before and after. None when the session lost a marker."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    buf = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pad_launches(torch, buf)
        torch.cuda._sleep(1000)
        fn()
        torch.cuda._sleep(1000)
        pad_launches(torch, buf)
        torch.cuda.synchronize()
    events = sorted(
        (evt for evt in prof.events() if evt.device_type == DeviceType.CUDA),
        key=lambda evt: evt.time_range.start,
    )
    marks = [k for k, evt in enumerate(events) if MARK in evt.name]
    if len(marks) != 2:
        return None
    return events[marks[0] + 1 : marks[1]]


def device_ms(torch, fn, reps: int = 10, attempts: int = 3):
    """Device time of one fn() call, and how it was taken: the summed
    duration of every device event (kernels, memsets, copies) that reps
    calls enqueue under torch.profiler (see traced), over reps, after one
    warm-up call ("profiler"). A session that lost a marker is tried
    again; after `attempts` such sessions the time is CUDA events around
    the reps back-to-back calls ("cuda events", which also counts the gaps
    between launches). Returns (ms, method, sessions that lost a marker,
    device events per call or None)."""
    fn()
    torch.cuda.synchronize()
    for lost in range(attempts):
        events = traced(torch, lambda: [fn() for _ in range(reps)])
        if events is not None:
            total_us = sum(evt.time_range.end - evt.time_range.start for evt in events)
            return total_us / reps / 1e3, "profiler", lost, len(events) / reps
    return cuda_ms(torch, fn, calls=reps), "cuda events", attempts, None


def device_times(torch, jobs) -> int:
    """Fill in the device times that phases 3, 5, 6 and 13 queued as (case, key,
    fn), each beside how it was taken (key + "_by") and the device events
    per call (key + "_events"); returns the number of profiler sessions
    that lost a marker. They run after every
    CUDA-event timing of the run: a profiler session leaves the host slower
    at each launch for the rest of the process, which would inflate the
    card times taken after it."""
    empty = 0
    for case, key, fn in jobs:
        case[key], case[f"{key}_by"], n, case[f"{key}_events"] = device_ms(torch, fn)
        empty += n
        log(f"   {case.get('shape', 'edge index')}: {key} {case[key]} ({case[f'{key}_by']})")
    return empty


def segment_stats_case(torch, ss, label, values, seg, ts, num_segments, jobs):
    """One shape of the segment-stats kernel (ts None: no timestamps, as
    window_stats's second pass calls it): agreement with the plain version
    on the same card tensors, and its times beside the bound; its device
    time is queued on jobs."""
    m, n = values.shape
    sums, ts_max = ss.segment_stats(values, seg, ts, num_segments)
    torch.cuda.synchronize()
    want_sums, want_max = ss.segment_stats_plain(values, seg, ts, num_segments)
    if ts is None:
        check(ts_max is None and want_max is None, f"{label}: a ts_max without ts")
    else:
        check(torch.equal(ts_max, want_max), f"{label}: ts_max differs")
    exact_rows = 3 if m == 5 else 0  # count, 4xx, 5xx are integers in f32
    check(
        torch.equal(sums[:exact_rows], want_sums[:exact_rows]),
        f"{label}: count rows differ",
    )
    # float rows: rtol 1e-5 (atomic and index_add_ sums run in other orders)
    torch.testing.assert_close(sums, want_sums, rtol=1e-5, atol=1e-6)
    max_abs_err = float((sums - want_sums).abs().max()) if sums.numel() else 0.0

    idx = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments).long()

    def library():
        out = torch.zeros((m, num_segments + 1), dtype=torch.float32, device=values.device)
        out.index_add_(1, idx, values)
        if ts is not None:
            top = torch.zeros(num_segments + 1, dtype=torch.int32, device=values.device)
            top.scatter_reduce_(0, idx, ts, "amax", include_self=True)

    with_ts = ts is not None
    read = values.numel() * 4 + seg.numel() * 4 + (ts.numel() * 4 if with_ts else 0)
    written = m * num_segments * 4 + (num_segments * 4 if with_ts else 0)
    ops = (m + int(with_ts)) * n  # one add per stat row and one max per span
    t_bytes = (read + written) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3

    def kernel():
        ss.segment_stats(values, seg, ts, num_segments)

    case = {
        "shape": label,
        "m": m,
        "n": n,
        "segments": num_segments,
        "timestamps": with_ts,
        "max_abs_err": max_abs_err,
        "ms": cuda_ms(torch, kernel),
        "call_ms": call_ms(torch, kernel),
        "plain_ms": cuda_ms(
            torch, lambda: ss.segment_stats_plain(values, seg, ts, num_segments)
        ),
        "library_ms": cuda_ms(torch, library),
        "library_call_ms": call_ms(torch, library),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": read + written,
    }
    jobs.append((case, "device_ms", kernel))
    log("   " + json.dumps(case))
    return case


def _raw_window(spec: dict) -> bytes:
    from kmamiz_tpu_torch import synth

    return synth.make_raw_window(**spec)


def raw_windows(specs) -> list:
    """synth.make_raw_window(**spec) of every spec, made on a pool of
    spawned processes (one a core, up to 8), in order: the generator is
    pure Python, and phases 4, 15, 16, 17 and 22 make 1.05M spans each
    with it. The bytes are the in-process calls'."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    specs = list(specs)
    workers = max(1, min(8, os.cpu_count() or 1, len(specs)))
    with ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(_raw_window, specs))


def state_windows(n_traces: int = None, chunk: int = None) -> list:
    """Phase 4's windows (prefix "state") as raw bytes, chunk by chunk
    (STATE_TRACES in STATE_CHUNK unless given)."""
    n_traces = STATE_TRACES if n_traces is None else n_traces
    chunk = STATE_CHUNK if chunk is None else chunk
    return raw_windows(
        dict(
            n_traces=min(chunk, n_traces - start),
            spans_per=SPANS_PER_TRACE,
            t_start=start,
            trace_prefix="state",
            **BASELINE,
        )
        for start in range(0, n_traces, chunk)
    )


def joined_window(n_traces: int, parts: int = 8, **shape) -> bytes:
    """synth.make_raw_window(n_traces, SPANS_PER_TRACE, **shape)'s bytes,
    made in `parts` slices at once and joined (json.dumps joins a list's
    items with ", ")."""
    bounds = [n_traces * k // parts for k in range(parts + 1)]
    pieces = raw_windows(
        dict(n_traces=b - a, spans_per=SPANS_PER_TRACE, t_start=a, **shape) for a, b in zip(bounds, bounds[1:]) if b > a
    )
    return b"[" + b", ".join(p[1:-1] for p in pieces if len(p) > 2) + b"]"


def synth_groups(n_traces: int, t_start: int, prefix: str):
    from kmamiz_tpu_torch import synth

    return json.loads(
        synth.make_raw_window(
            n_traces, SPANS_PER_TRACE, t_start=t_start, trace_prefix=prefix, **BASELINE
        )
    )


def segment_inputs(torch, device, tick_groups):
    """Phase 3's inputs: (label, values, seg, ts, num_segments) at the
    production window and at the tick's shape, both passes of window_stats
    (the second takes no timestamps)."""
    import numpy as np

    from kmamiz_tpu_torch.domain.traces import Traces
    from kmamiz_tpu_torch.ops import segment_stats as ss
    from kmamiz_tpu_torch.ops import window as window_ops
    from kmamiz_tpu_torch.server.processor import stats_columns

    rng = np.random.default_rng(0)  # bench.py's production window inputs
    n = PROD_SPANS
    prod = dict(
        endpoint_id=rng.integers(0, PROD_ENDPOINTS, n, dtype=np.int32),
        status_id=rng.integers(0, PROD_STATUSES, n, dtype=np.int32),
        status_class=rng.choice([2, 4, 5], n, p=[0.95, 0.04, 0.01]).astype(np.int8),
        latency_ms=rng.gamma(2.0, 50.0, n).astype(np.float32),
        timestamp_rel=rng.integers(0, 30_000_000, n, dtype=np.int32),
        valid_server=np.ones(n, dtype=bool),
    )
    records = Traces(tick_groups).combine_logs_to_realtime_data([], []).to_json()
    cols = stats_columns(records)
    tick = dict(
        endpoint_id=cols.endpoint_id,
        status_id=cols.status_id,
        status_class=cols.status_class,
        latency_ms=cols.latency_ms,
        timestamp_rel=cols.timestamp_rel,
        valid_server=cols.valid,
    )
    inputs = []
    for label, arrays, ne, ns in (
        ("production window", prod, PROD_ENDPOINTS, PROD_STATUSES),
        ("tick", tick, cols.num_endpoints, cols.num_statuses),
    ):
        dev = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
        values, seg, ts, n_seg = window_ops.stat_rows(
            **dev, num_endpoints=ne, num_statuses=ns
        )
        inputs.append((f"{label} pass 1", values, seg, ts, n_seg))
        sums, _ = ss.segment_stats_plain(values, seg, ts, n_seg)
        resid = window_ops.residual_rows(values, seg, sums, n_seg)
        inputs.append((f"{label} pass 2", resid, seg, None, n_seg))
    return inputs


def kernel_cases(torch, device, tick_groups, jobs):
    """Phase 3: the segment-stats kernel at the production window and at
    the tick's shape, both passes of window_stats."""
    from kmamiz_tpu_torch.ops import segment_stats as ss

    return [
        segment_stats_case(torch, ss, *case, jobs)
        for case in segment_inputs(torch, device, tick_groups)
    ]


def zeroing_cases(torch, device, tick_groups, jobs):
    """--zeroing: the segment-stats kernel as shipped (a zeroing prologue
    and a grid barrier in one cooperative launch) against the same source
    built with SEGMENT_STATS_ZERO_BY_MEMSET (a cudaMemsetAsync, then a plain
    launch), at phase 3's shapes. A memset call allocates and launches as
    the wrapper does but skips its input checks, which favours that side;
    `ms` is timed in turns (shipped, memset, memset, shipped, shipped,
    memset), `device_ms` is queued on jobs."""
    import ctypes

    from kmamiz_tpu_torch.ops import cuda_build
    from kmamiz_tpu_torch.ops import segment_stats as ss

    variant = ctypes.CDLL(str(cuda_build.build(ss.KERNEL, ("SEGMENT_STATS_ZERO_BY_MEMSET",))))
    memset_fn = variant.kmamiz_segment_stats
    memset_fn.argtypes = ss._kernel().argtypes
    memset_fn.restype = ctypes.c_int

    def case_of(label, values, seg, ts, n_seg):
        m, n = values.shape
        device = values.device  # with its index, as the wrapper passes it

        def memset_call():
            buf, sums, ts_max = ss._outputs(m, n_seg, ts is not None, device)
            args = (
                values.data_ptr(),
                m,
                n,
                seg.data_ptr(),
                None if ts is None else ts.data_ptr(),
                n_seg,
                ss.row_stride(m),
                buf.data_ptr(),
            )
            check(cuda_build.launch(memset_fn, args, device) == 0, f"{label}: memset variant launch")
            return sums, ts_max

        def shipped_call():
            return ss.segment_stats(values, seg, ts, n_seg)

        (got, got_ts), (want, want_ts) = memset_call(), shipped_call()
        torch.cuda.synchronize()
        exact_rows = 3 if m == 5 else 0  # count, 4xx, 5xx
        check(torch.equal(got[:exact_rows], want[:exact_rows]), f"{label}: variant counts differ")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        check(got_ts is None or torch.equal(got_ts, want_ts), f"{label}: variant ts_max differs")
        times = {"prologue": [], "memset": []}
        for name in ("prologue", "memset", "memset", "prologue", "prologue", "memset"):
            times[name].append(cuda_ms(torch, shipped_call if name == "prologue" else memset_call))
        case = {
            "shape": label,
            "prologue_ms": statistics.median(times["prologue"]),
            "memset_ms": statistics.median(times["memset"]),
            "runs_ms": times,
        }
        jobs.append((case, "prologue_device_ms", shipped_call))
        jobs.append((case, "memset_device_ms", memset_call))
        log("   " + json.dumps(case))
        return case

    return [case_of(*case) for case in segment_inputs(torch, device, tick_groups)]


def fused_case(torch, sparse, label, v, src, dst, mask, gated_args, index, jobs):
    """One shape of the fused SDDMM/SpMM, called as the model calls it
    (with the forward's prebuilt edge index; the ungated mode without the
    gate output, as fused_neighbor_sums does): agreement with the plain
    version on the same card tensors, the same bits from two launches, and
    its times beside the bound."""
    n, h = v.shape
    e = src.shape[0]
    gated = bool(gated_args)
    args = (v, src, dst, mask, *gated_args)
    kw = {"want_gate": gated, "index": index}
    bias, deg, gate = sparse.fused_sddmm_spmm(*args, **kw)
    torch.cuda.synchronize()
    again = sparse.fused_sddmm_spmm(*args, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("bias", "deg", "gate"), (bias, deg, gate), again):
        check(
            a is None and b is None or torch.equal(a, b),
            f"{label}: two launches give different {name}",
        )
    want_bias, want_deg, want_gate = sparse.fused_plain(*args)
    # the gate is one sigmoid per edge: atol 1e-6; bias and deg are fp32
    # sums in the index's row order against index_add_'s: rtol/atol 1e-5
    torch.testing.assert_close(bias, want_bias, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(deg, want_deg, rtol=1e-5, atol=1e-5)
    pairs = [(bias, want_bias), (deg, want_deg)]
    if gated:
        torch.testing.assert_close(gate, want_gate, rtol=0, atol=1e-6)
        check(bool(torch.all(gate[~mask] == 0)), f"{label}: masked edges gate non-zero")
        pairs.append((gate, want_gate))
    else:
        check(gate is None, f"{label}: ungated call returned a gate")
    max_abs_err = max(float((a - b).abs().max()) for a, b in pairs)

    # the library yardstick: the index_add_ pair over materialised [E, H+1]
    # messages (the gate as the last column gives the degree)
    src_l, dst_l = src.long(), dst.long()
    src_c, dst_c = src_l.clamp(0, n - 1), dst_l.clamp(0, n - 1)
    src_s = torch.where(mask & (src_l < n), src_l, n)
    dst_s = torch.where(mask & (dst_l < n), dst_l, n)
    g = want_gate[:, None]
    msg_fwd = torch.cat([v[src_c] * g, g], dim=1)
    msg_bwd = torch.cat([v[dst_c] * g, g], dim=1)

    def library():
        out = torch.zeros((n + 1, h + 1), dtype=torch.float32, device=v.device)
        out.index_add_(0, dst_s, msg_fwd)
        out.index_add_(0, src_s, msg_bwd)

    # bytes this run's data needs: the mask of every slot; the two ids of
    # live edges only (the kernel skips a masked slot before reading its
    # ids); the node-table rows that live edges reference, once each (v at
    # both ends; gated, q at the source and k at the destination); the
    # full outputs (bias and deg at N rows, the gate at E when gated)
    live = int(mask.sum())
    src_live, dst_live = src_c[mask], dst_c[mask]
    rows = int(torch.unique(torch.cat([src_live, dst_live])).numel())
    if gated:
        rows += int(torch.unique(src_live).numel()) + int(torch.unique(dst_live).numel())
    read = e * 1 + live * (4 + 4) + rows * h * 4 + (4 if gated else 0)
    written = n * h * 4 + n * 4 + (e * 4 if gated else 0)
    # per live edge: 2H multiply-adds of the scatter and 2 degree adds,
    # plus, gated, H multiply-adds of the dot and ~6 for scale and sigmoid
    ops = live * ((4 * h + 2) + ((2 * h + 6) if gated else 0))
    t_bytes = (read + written) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3

    def kernel():
        sparse.fused_sddmm_spmm(*args, **kw)

    case = {
        "shape": label,
        "n": n,
        "h": h,
        "edges": e,
        "live_edges": live,
        "table_rows_read": rows,
        "gated": gated,
        "bit_equal_relaunch": True,
        "max_abs_err": max_abs_err,
        "ms": cuda_ms(torch, kernel),
        "call_ms": call_ms(torch, kernel),
        "plain_ms": cuda_ms(torch, lambda: sparse.fused_plain(*args)),
        "library_ms": cuda_ms(torch, library),
        "library_call_ms": call_ms(torch, library),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": read + written,
    }
    jobs.append((case, "device_ms", kernel))
    log("   " + json.dumps(case))
    return case


def check_edge_index(torch, sparse, src, dst, mask, n, index):
    """Check `index` (sparse.edge_index of the edge list over n rows)
    against the same build with its keys in plain PyTorch
    (sparse.edge_keys_plain in place of the keys kernel: the same sort and
    searchsorted), and the keys kernel alone against its plain version.
    Returns the plain build, as a function of no arguments."""

    def plain_index():
        keys, other = sparse.edge_keys_plain(src, dst, mask, n)
        sorted_keys, order = torch.sort(keys, stable=True)
        bounds = torch.arange(n + 1, dtype=keys.dtype, device=keys.device)
        return torch.searchsorted(sorted_keys, bounds, out_int32=True), other[order], order

    row_ptr, nbr, order = plain_index()
    check(
        torch.equal(row_ptr, index.row_ptr) and torch.equal(nbr, index.nbr)
        and torch.equal(order, index.eid),
        "the edge index differs from its plain version",
    )
    keys, other = sparse.edge_keys(src, dst, mask, n)
    keys_plain, other_plain = sparse.edge_keys_plain(src, dst, mask, n)
    check(
        torch.equal(keys.to(keys_plain.dtype), keys_plain) and torch.equal(other, other_plain),
        "the keys kernel differs from edge_keys_plain",
    )
    return plain_index


def fused_cases(torch, graph, jobs):
    """Phase 5: the fused kernel at the forecast's shapes, on the BASELINE
    graph's edge columns and seeded node tables; the edge index's build
    and row lengths; and a GraphSAGE forward's share of it (one index
    build and the launches at H = 18 and 64). Returns (cases, index
    report)."""
    import numpy as np

    from kmamiz_tpu_torch.core.spans import _pad_size
    from kmamiz_tpu_torch.ops import sparse

    src, dst, _dist, mask = graph.edge_arrays()
    # the store's capacity is a power of two: the forward's edge bucket
    check(src.shape[0] == _pad_size(src.shape[0]), "edge capacity not a pow2 bucket")
    n_eps = len(graph.interner.endpoints)
    n = _pad_size(n_eps)
    rng = np.random.default_rng(SEED)

    def table(h):
        return torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32)).to(src.device)

    index = sparse.edge_index(src, dst, mask, n)
    lengths = (index.row_ptr[1:] - index.row_ptr[:-1]).float()
    real = lengths[:n_eps]
    e, live = int(src.shape[0]), int(mask.sum())
    plain_index = check_edge_index(torch, sparse, src, dst, mask, n, index)
    keys = sparse.edge_keys(src, dst, mask, n)[0]
    sorted_keys = torch.sort(keys, stable=True)[0]
    bounds = torch.arange(n + 1, dtype=keys.dtype, device=keys.device)
    report = {
        "index_ms": cuda_ms(torch, lambda: sparse.edge_index(src, dst, mask, n)),
        "index_plain_ms": cuda_ms(torch, plain_index),
        # bytes: every slot's mask and both ids of each live edge read once;
        # row_ptr and the 2E entries (int32 neighbour, int64 edge id)
        # written once
        "index_bound_ms": (e + 8 * live + 4 * (n + 1) + 12 * 2 * e) / PEAK_BYTES_PER_S * 1e3,
        "index_bound_by": "bytes",
        # the build's parts: the keys kernel (its own bound: every slot's
        # mask and ids read, 2E keys and 2E int32 opposite ends written),
        # then two library ops, one stable sort and one searchsorted
        "keys_ms": cuda_ms(torch, lambda: sparse.edge_keys(src, dst, mask, n)),
        "keys_plain_ms": cuda_ms(torch, lambda: sparse.edge_keys_plain(src, dst, mask, n)),
        "keys_bound_ms": (9 * e + 2 * e * keys.element_size() + 8 * e) / PEAK_BYTES_PER_S * 1e3,
        "keys_bound_by": "bytes",
        "sort_library_ms": cuda_ms(torch, lambda: torch.sort(keys, stable=True)),
        "searchsorted_library_ms": cuda_ms(
            torch, lambda: torch.searchsorted(sorted_keys, bounds, out_int32=True)
        ),
        "entries": int(index.row_ptr[-1]),
        # row lengths of the endpoints' rows (the bucket's padding rows past
        # them are empty)
        "row_length": {
            "mean": float(real.mean()),
            "p99": float(torch.quantile(real, 0.99)),
            "max": float(real.max()),
            "empty_padding_rows": int((lengths[n_eps:] == 0).sum()),
        },
    }
    log("   edge index " + json.dumps(report))
    jobs.append((report, "index_device_ms", lambda: sparse.edge_index(src, dst, mask, n)))
    jobs.append((report, "keys_device_ms", lambda: sparse.edge_keys(src, dst, mask, n)))

    cases = []
    for label, h, gated in (
        ("graphsage layer 1 (ungated)", 18, False),
        ("graphsage layer 2 (ungated)", 64, False),
        ("stlgt (gated)", STLGT_HIDDEN, True),
    ):
        gated_args = ()
        if gated:
            b = torch.tensor([0.1], dtype=torch.float32, device=src.device)
            gated_args = (table(h), table(h), b)
        cases.append(
            fused_case(torch, sparse, label, table(h), src, dst, mask, gated_args, index, jobs)
        )

    # a GraphSAGE forward's kernel work: one index build and two launches
    v18, v64 = table(18), table(64)

    def forward_share():
        idx = sparse.edge_index(src, dst, mask, n)
        sparse.fused_sddmm_spmm(v18, src, dst, mask, want_gate=False, index=idx)
        sparse.fused_sddmm_spmm(v64, src, dst, mask, want_gate=False, index=idx)

    report["forward_ms"] = cuda_ms(torch, forward_share)
    report["forward_call_ms"] = call_ms(torch, forward_share)
    jobs.append((report, "forward_device_ms", forward_share))
    log("   per forward (index build + 2 launches) " + json.dumps(
        {k: report[k] for k in ("forward_ms", "forward_call_ms")}
    ))
    return cases, report


def get_route(port: int, path: str):
    """GET any API route over HTTP (gzip accepted): (status, body, wall
    ms), the body parsed when it is JSON, else its bytes (the export's
    tgz, the swagger YAML)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", headers={"Accept-Encoding": "gzip"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        body = resp.read()
        if resp.headers.get("Content-Encoding") == "gzip":
            body = gzip.decompress(body)
        status, kind = resp.status, resp.headers.get("Content-Type", "")
    ms = (time.perf_counter() - t0) * 1e3
    return status, json.loads(body) if kind.startswith("application/json") else body, ms


def serve_forecast(torch, graph, device, launch_counters, t_start: int):
    """Phase 9, the forecast path: two ticks in successive hours through
    the DP server of a processor on the carried graph (its hourly history
    starts empty), then the forecast routes over HTTP and the STLGT
    quantile forward on the published snapshot. Returns the report, the
    processor and the STLGT outputs."""
    import numpy as np

    from kmamiz_tpu_torch.api.app import build_router
    from kmamiz_tpu_torch.api.router import ApiServer
    from kmamiz_tpu_torch.config import Settings
    from kmamiz_tpu_torch.models import serving
    from kmamiz_tpu_torch.models.stlgt import model as stlgt
    from kmamiz_tpu_torch.models.stlgt import serving as stlgt_serving
    from kmamiz_tpu_torch.ops import sparse
    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer
    from kmamiz_tpu_torch.server.initializer import AppContext
    from kmamiz_tpu_torch.server.processor import DataProcessor

    def zero():
        for counter in launch_counters:
            counter.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {c.__name__: c.launches for c in launch_counters}

    feed = TickFeed()
    proc = DataProcessor(trace_source=feed, device=device, graph=graph)
    dp_server = DataProcessorServer(proc, host="127.0.0.1", port=0)
    dp_server.start()
    ticks = []
    try:
        for k, hour in enumerate(FORECAST_HOURS):
            feed.groups = synth_groups(TICK_TRACES, t_start + k * TICK_TRACES, f"hour{hour}-")
            t0 = time.perf_counter()
            resp = post_tick(
                dp_server.port,
                {"uniqueId": f"hour{hour}", "lookBack": 30_000, "time": hour * HOUR_MS},
            )
            wall = (time.perf_counter() - t0) * 1e3
            check_response(resp, f"hour{hour}")
            ticks.append({"hour": hour, "wall_ms": round(wall, 3), **proc.last_stage_ms})
            log("   " + json.dumps(ticks[-1]))
    finally:
        dp_server.stop()
    snap = proc.forecast_snapshot
    check(snap is not None, "no forecast snapshot after an hour rolled over")
    n_eps = len(snap["names"])
    check(n_eps >= 10_000, f"snapshot holds {n_eps} endpoints")
    check(all(isinstance(snap[k], np.ndarray) for k in ("src", "dst", "mask")), "snapshot edges not on the host")

    os.environ["KMAMIZ_MODEL_DIR"] = os.path.join(REPO, MODEL_DIR)
    api = ApiServer(build_router(AppContext(settings=Settings(), processor=proc)), host="127.0.0.1", port=0)
    api.start()
    try:
        zero()
        status, st, status_ms = get_route(api.port, "/api/v1/model/status")
        check(status == 200 and st["modelLoaded"] is True, f"model not loaded: {st}")
        builds = sparse.edge_index.builds
        status, fc, get_ms = get_route(api.port, "/api/v1/model/forecast")
        check(status == 200, f"forecast answered {status}")
        first = counts()
        index_builds = sparse.edge_index.builds - builds
        zero()
        status, fc2, memo_ms = get_route(api.port, "/api/v1/model/forecast")
        memo = counts()
    finally:
        api.stop()
    forward_ms = serving.serve_stats()["last_ms"]
    want_hour = (FORECAST_HOURS[0] % 24 + 1) % 24
    check(fc["predictedHour"] == want_hour, f"predictedHour {fc['predictedHour']} != {want_hour}")
    check(len(fc["endpoints"]) == n_eps, f"{len(fc['endpoints'])} forecasts for {n_eps} endpoints")
    check(len({e["uniqueEndpointName"] for e in fc["endpoints"]}) == n_eps, "duplicate endpoints")
    for e in fc["endpoints"]:
        p = e["anomalyProbability"]
        check(math.isfinite(p) and 0.0 <= p <= 1.0, f"probability {p} of {e['uniqueEndpointName']}")
        check(math.isfinite(e["predictedLatencyMs"]), f"latency of {e['uniqueEndpointName']}")
    check(first[sparse.fused_sddmm_spmm.__name__] == 2, f"GraphSAGE GET launched {first}")
    check(index_builds == 1, f"{index_builds} edge index builds for one snapshot")
    check(memo[sparse.fused_sddmm_spmm.__name__] == 0, f"memoized GET launched {memo}")
    check(fc2 == fc, "memoized forecast differs")

    params = stlgt.init_params(
        torch.Generator().manual_seed(SEED), hidden=STLGT_HIDDEN, num_features=snap["features"].shape[1], device=device
    )
    zero()
    t0 = time.perf_counter()
    q_ms, prob, gate = stlgt_serving.quantile_forward(
        params, snap["features"], snap["src"], snap["dst"], snap["mask"], stlgt
    )
    stlgt_ms = (time.perf_counter() - t0) * 1e3
    st_counts = counts()
    check(st_counts[sparse.fused_sddmm_spmm.__name__] == 1, f"STLGT forward launched {st_counts}")
    check(q_ms.shape == (n_eps, 3) and bool(np.all(np.isfinite(q_ms))), "STLGT quantiles")
    check(bool(np.all(q_ms[:, 0] <= q_ms[:, 1])) and bool(np.all(q_ms[:, 1] <= q_ms[:, 2])), "quantiles cross")
    check(bool(np.all((gate >= 0) & (gate <= 1))), "gates outside [0, 1]")
    check(bool(np.all(gate[~snap["mask"]] == 0)), "padded edges gate non-zero")
    check(bool(np.all((prob >= 0) & (prob <= 1))), "STLGT probabilities outside [0, 1]")
    report = {
        "ticks": ticks,
        "endpoints": n_eps,
        "edges": int(snap["mask"].sum()),
        "edge_bucket": int(snap["src"].shape[0]),
        "predicted_hour": fc["predictedHour"],
        "status_get_ms": status_ms,
        "forecast_get_ms": get_ms,
        "forecast_forward_ms": forward_ms,
        "memo_get_ms": memo_ms,
        "stlgt_forward_ms": stlgt_ms,
        "launches": {"graphsage_get": first, "memo_get": memo, "stlgt": st_counts},
        "graphsage_get_index_builds": index_builds,
    }
    return report, proc, fc, (q_ms, prob, gate)


def forecast_card_against_cpu(torch, proc, served, card_stlgt) -> dict:
    """Phase 10: the snapshot's GraphSAGE forecast and STLGT forward on the
    card against the port on the CPU, with the same weights; and the
    payload the forecast route served against the CPU forward after the
    route's rounding."""
    import numpy as np

    from kmamiz_tpu_torch.models import checkpoint, graphsage, serving
    from kmamiz_tpu_torch.models.stlgt import model as stlgt
    from kmamiz_tpu_torch.models.stlgt import serving as stlgt_serving

    snap = proc.forecast_snapshot
    inputs = (snap["features"], snap["src"], snap["dst"], snap["mask"])
    out = {}
    for dev in (proc.device, "cpu"):
        params, _meta = checkpoint.restore_params(os.path.join(REPO, MODEL_DIR), graphsage, device=dev)
        t0 = time.perf_counter()
        out[str(dev)] = serving.forecast_forward(params, *inputs, graphsage)
        out[f"{dev}_ms"] = (time.perf_counter() - t0) * 1e3
    card, cpu = out[str(proc.device)], out["cpu"]
    for name, a, b in (("latency ms", card[0], cpu[0]), ("probability", card[1], cpu[1])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)
    # the served payload, matched by endpoint name: one rounding unit of
    # the route (4 decimals of probability, 2 of latency ms), since a value
    # at a rounding edge may round either way
    index = {name: i for i, name in enumerate(snap["names"])}
    served_diff = {"probability": 0.0, "latency_ms": 0.0}
    for e in served["endpoints"]:
        i = index[e["uniqueEndpointName"]]
        d_prob = abs(e["anomalyProbability"] - round(float(cpu[1][i]), 4))
        d_lat = abs(e["predictedLatencyMs"] - round(float(max(cpu[0][i], 0.0)), 2))
        check(d_prob <= 1e-4 + 1e-9, f"served probability of {e['uniqueEndpointName']} off by {d_prob}")
        check(d_lat <= 0.01 + 1e-6, f"served latency of {e['uniqueEndpointName']} off by {d_lat}")
        served_diff["probability"] = max(served_diff["probability"], d_prob)
        served_diff["latency_ms"] = max(served_diff["latency_ms"], d_lat)
    check(len(served["endpoints"]) == len(index), "served payload misses endpoints")
    params = stlgt.init_params(
        torch.Generator().manual_seed(SEED), hidden=STLGT_HIDDEN, num_features=snap["features"].shape[1], device="cpu"
    )
    cpu_q, cpu_prob, cpu_gate = stlgt_serving.quantile_forward(params, *inputs, stlgt)
    np.testing.assert_allclose(card_stlgt[2], cpu_gate, rtol=0, atol=1e-6, err_msg="gates")
    np.testing.assert_allclose(card_stlgt[0], cpu_q, rtol=1e-4, atol=1e-5, err_msg="quantiles")
    np.testing.assert_allclose(card_stlgt[1], cpu_prob, rtol=1e-4, atol=1e-5, err_msg="STLGT probability")
    return {
        "card_forward_ms": out[f"{proc.device}_ms"],
        "cpu_forward_ms": out["cpu_ms"],
        "max_abs_diff": {
            "latency_ms": float(np.abs(card[0] - cpu[0]).max()),
            "probability": float(np.abs(card[1] - cpu[1]).max()),
            "gate": float(np.abs(card_stlgt[2] - cpu_gate).max()),
            "quantile_ms": float(np.abs(card_stlgt[0] - cpu_q).max()),
        },
        "served_max_abs_diff": served_diff,
    }


def load_state(device, n_traces: int = STATE_TRACES, chunk: int = STATE_CHUNK, records: bool = False):
    """Phase 4: a processor whose graph holds the BASELINE edge set. With
    records, also the dependency records those traces leave in the cache
    of a deployment that saw them: each endpoint with every entry its
    spans' records carry. A tick keeps the last record of an endpoint in
    its window, so a cache takes many windows to hold them all (phase 17
    seeds its store with them). They stop growing at the first chunk that
    adds no entry, and are not built further (the mesh repeats every
    28,000 traces)."""
    from kmamiz_tpu_torch.core.spans import spans_to_batch
    from kmamiz_tpu_torch.domain.endpoint_dependencies import EndpointDependencies
    from kmamiz_tpu_torch.domain.traces import Traces
    from kmamiz_tpu_torch.server.processor import DataProcessor

    feed = TickFeed()
    proc = DataProcessor(trace_source=feed, device=device)
    deps, entries, grown = None, 0, records
    for raw in state_windows(n_traces, chunk):
        groups = json.loads(raw)
        proc.graph.merge_window(spans_to_batch(groups, interner=proc.graph.interner))
        if grown:
            # combine_with merges the records its other side repeats
            spans = EndpointDependencies([]).combine_with(Traces(groups).to_endpoint_dependencies())
            deps = spans if deps is None else spans.combine_with(deps)
            n = sum(len(d["dependingBy"]) + len(d["dependingOn"]) for d in deps.dependencies)
            grown, entries = n > entries, n
    if records:
        return proc, feed, deps.trim().to_json()
    return proc, feed


class TickFeed:
    """The trace source of the smoke's processors: hands out the window
    queued for the next tick."""

    def __init__(self) -> None:
        self.groups = []

    def __call__(self, look_back, end_ts, limit):
        return self.groups[:limit]


def post_tick(port: int, request: dict, timing: dict = None) -> dict:
    """A DP tick as the host app posts it (gzip both ways), its answer
    decoded; with `timing`, the client's gunzip + JSON decode wall goes
    into timing["decode_ms"]."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/",
        data=gzip.compress(json.dumps(request).encode()),
        headers={
            "Content-Type": "application/json",
            "Content-Encoding": "gzip",
            "Accept-Encoding": "gzip",
        },
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        check(resp.status == 200, f"tick answered {resp.status}")
        body = resp.read()
        t = time.perf_counter()
        if resp.headers.get("Content-Encoding") == "gzip":
            body = gzip.decompress(body)
        out = json.loads(body)
    if timing is not None:
        timing["decode_ms"] = round((time.perf_counter() - t) * 1e3, 3)
    return out


def check_response(resp: dict, unique_id: str) -> None:
    check(
        set(resp) == {"uniqueId", "combined", "dependencies", "datatype", "log"},
        f"response keys {sorted(resp)}",
    )
    check(resp["uniqueId"] == unique_id, "uniqueId not echoed")
    check(len(resp["combined"]) > 0, "no combined records")
    check(len(resp["dependencies"]) > 0, "no dependencies")
    for c in resp["combined"]:
        check(c["combined"] > 0, f"empty segment {c['uniqueEndpointName']}")
        for k in ("mean", "cv"):
            check(math.isfinite(c["latency"][k]), f"non-finite latency {k}")


def serve_ticks(torch, proc, feed, launch_counters, t_start: int, ticks: int = TICKS):
    """Phase 7, the tick path: DP ticks through the port's HTTP server.
    Returns per-tick stage timings and the launch counts of the run."""
    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer

    windows = [
        synth_groups(TICK_TRACES, t_start + k * TICK_TRACES, f"tick{k}-")
        for k in range(ticks)
    ]
    server = DataProcessorServer(proc, host="127.0.0.1", port=0)
    server.start()
    timings = []
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/", timeout=60) as r:
            check(json.loads(r.read())["status"] == "UP", "health")
        for counter in launch_counters:
            counter.launches = 0
        for k, groups in enumerate(windows):
            feed.groups = groups
            t0 = time.perf_counter()
            resp = post_tick(server.port, {"uniqueId": f"tick{k}", "lookBack": 30_000})
            wall = (time.perf_counter() - t0) * 1e3
            check_response(resp, f"tick{k}")
            stages = {k_: round(v, 3) for k_, v in proc.last_stage_ms.items()}
            timings.append({"tick": k, "wall_ms": round(wall, 3), **stages})
            log("   " + json.dumps(timings[-1]))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in launch_counters}
    finally:
        server.stop()
    return timings, launches


def compare_ticks(got: dict, want: dict) -> None:
    """The port's parity rules: dependencies, datatype and every combined
    field equal, except latency mean (rel 1e-5, abs 1e-6) and cv (rel 1e-3,
    abs 1e-5)."""
    check(got["dependencies"] == want["dependencies"], "dependencies differ")
    check(got["datatype"] == want["datatype"], "datatype differs")
    g_idx = {(c["uniqueEndpointName"], c["status"]): c for c in got["combined"]}
    w_idx = {(c["uniqueEndpointName"], c["status"]): c for c in want["combined"]}
    check(set(g_idx) == set(w_idx), "combined keys differ")
    for key, w in w_idx.items():
        g, w = dict(g_idx[key]), dict(w)
        g_lat, w_lat = g.pop("latency"), w.pop("latency")
        check(g == w, f"combined record differs: {key}")
        check(
            math.isclose(g_lat["mean"], w_lat["mean"], rel_tol=1e-5, abs_tol=1e-6),
            f"latency mean differs: {key} {g_lat['mean']} {w_lat['mean']}",
        )
        check(
            math.isclose(g_lat["cv"], w_lat["cv"], rel_tol=1e-3, abs_tol=1e-5),
            f"latency cv differs: {key} {g_lat['cv']} {w_lat['cv']}",
        )


def card_against_cpu(proc, device, t_start: int) -> dict:
    """Phase 8: one tick on the card and on the CPU from the same carried
    graph."""
    from kmamiz_tpu_torch.graph.convert import graph_from_export
    from kmamiz_tpu_torch.graph.store import graph_signature
    from kmamiz_tpu_torch.server.processor import DataProcessor

    export = proc.graph.export_named_edges()
    groups = synth_groups(TICK_TRACES, t_start, "compare")
    out = {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        p = DataProcessor(
            trace_source=lambda lb, t, lim: groups,
            device=dev,
            graph=graph_from_export(export, dev),
        )
        t0 = time.perf_counter()
        resp = p.collect({"uniqueId": "compare", "lookBack": 30_000})
        tick_s = time.perf_counter() - t0
        out[name] = (resp, graph_signature(p.graph), p.graph.n_edges, tick_s)
    compare_ticks(out["card"][0], out["cpu"][0])
    check(out["card"][1] == out["cpu"][1], "graph signatures differ")
    check(out["card"][2] == out["cpu"][2], "edge counts differ")
    return {
        "edges": out["card"][2],
        "signature": out["card"][1],
        "card_tick_ms": out["card"][3] * 1e3,
        "cpu_tick_ms": out["cpu"][3] * 1e3,
    }


def profile_device(torch, run, kernel_names) -> dict:
    """run() once under torch.profiler: the device's busy time, its share
    of the wall time, peak device memory, the port's kernels and the
    device ops that took the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # padded with marker kernels on both sides (see traced), outside
        # the wall time and left out of the counts
        for _ in range(PAD_LAUNCHES):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        for _ in range(PAD_LAUNCHES):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    # device-side events only (kernels, copies, fills); the busy time is
    # the union of their intervals, so overlapping work counts once
    spans, per_op = [], {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA or MARK in evt.name:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        ms, calls = per_op.get(evt.name, (0.0, 0))
        per_op[evt.name] = (ms + (end - start) / 1e3, calls + 1)
    device_ms, cursor = 0.0, None
    for start, end in sorted(spans):
        if cursor is None or start > cursor:
            device_ms += (end - start) / 1e3
            cursor = end
        elif end > cursor:
            device_ms += (end - cursor) / 1e3
            cursor = end
    ops = sorted(((ms, name, calls) for name, (ms, calls) in per_op.items()), reverse=True)
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_events": len(spans),
        "device_busy_share": device_ms / wall_ms,
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
        "port_kernels": {
            name: {"ms": ms, "calls": calls}
            for ms, name, calls in ops
            if any(f"{k}_kernel" in name for k in kernel_names)
        },
        "top_device_ops": [
            {"op": key[:100], "ms": ms, "calls": count} for ms, key, count in ops[:8]
        ],
    }


def profile_tick(torch, proc, feed, t_start: int, kernel_names) -> dict:
    """Phase 14a: one more tick on the card processor under the profiler."""
    feed.groups = synth_groups(TICK_TRACES, t_start, "profile")
    out = profile_device(
        torch, lambda: proc.collect({"uniqueId": "profile", "lookBack": 30_000}), kernel_names
    )
    out["stages_ms"] = dict(proc.last_stage_ms)
    return out


def profile_forecast(torch, proc, kernel_names) -> dict:
    """Phase 14b: one GraphSAGE forecast forward of the snapshot (the work
    behind an un-memoized GET) on the card under the profiler."""
    from kmamiz_tpu_torch.models import checkpoint, graphsage, serving

    snap = proc.forecast_snapshot
    params, _meta = checkpoint.restore_params(os.path.join(REPO, MODEL_DIR), graphsage, device=proc.device)
    inputs = (snap["features"], snap["src"], snap["dst"], snap["mask"])
    serving.forecast_forward(params, *inputs, graphsage)  # warm
    return profile_device(
        torch, lambda: serving.forecast_forward(params, *inputs, graphsage), kernel_names
    )


def kernel_case(torch, label, kernel, plain, library, nbytes, ops, jobs, select=None, **info):
    """One shape of a backward kernel: its outputs against the plain
    version's on the same card tensors (rtol 1e-4 / atol 1e-5: fp32 sums
    in the gather index's order against index_add_'s), the same bits from
    two launches, and its times (`host_ms`: the host's share, see host_ms)
    beside the bound; the device time is queued on jobs. kernel() and plain() return tuples of tensors (None
    where an output is not computed), compared after select() when given;
    library() is one PyTorch call of the same function, or None."""
    select = select or (lambda out: out)
    got = select(kernel())
    torch.cuda.synchronize()
    again = select(kernel())
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        check(a is None and b is None or torch.equal(a, b), f"{label}: two launches give different bits")
    want = select(plain())
    errs = []
    for a, w in zip(got, want):
        if w is None:
            continue
        a, w = a.reshape(-1), w.reshape(-1)
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5, msg=label)
        errs.append(float((a - w).abs().max()) if a.numel() else 0.0)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    case = {
        "shape": label,
        **info,
        "bit_equal_relaunch": True,
        "max_abs_err": max(errs),
        "ms": cuda_ms(torch, kernel),
        "call_ms": call_ms(torch, kernel),
        "host_ms": host_ms(torch, kernel),
        "plain_ms": cuda_ms(torch, plain),
        "library_ms": None if library is None else cuda_ms(torch, library),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes,
    }
    jobs.append((case, "device_ms", kernel))
    log("   " + json.dumps(case))
    return case


def vector_width(h: int) -> int:
    """The vector loads the kernels take for fresh [N, H] tables."""
    return 4 if h % 4 == 0 else 2 if h % 2 == 0 else 1


def ungated_rows_case(torch, sparse, label, src, dst, mask, n, index, v, d_bias, jobs):
    """The ungated row pass (GraphSAGE's backward: dv of the neighbour sums
    from d_bias) over `index` (a gather index of src/dst/mask over n rows)
    against its plain version, with autograd of the index_add_
    formulation as the library yardstick. The bound: every slot's mask and
    the ids of live edges, the d_bias rows at the live ends, dv written
    whole."""
    h = v.shape[1]
    dev = v.device
    live = int(mask.sum())
    src_l, dst_l = src.long(), dst.long()
    src_c, dst_c = src_l.clamp(0, n - 1), dst_l.clamp(0, n - 1)
    src_s = torch.where(mask & (src_l < n), src_l, n)
    dst_s = torch.where(mask & (dst_l < n), dst_l, n)
    ends = int(torch.unique(torch.cat([src_c[mask], dst_c[mask]])).numel())
    em = mask.float()
    leaf = v.clone().requires_grad_()
    # gathers by index_select, whose backward is an index_add_
    msg_fwd = leaf.index_select(0, src_c) * em[:, None]
    msg_bwd = leaf.index_select(0, dst_c) * em[:, None]
    lib_out = torch.zeros((n + 1, h), device=dev).index_add(0, dst_s, msg_fwd).index_add(0, src_s, msg_bwd)
    d_pad = torch.cat([d_bias, torch.zeros(1, h, device=dev)])
    vw = vector_width(h)
    return kernel_case(
        torch,
        label,
        lambda: sparse.fused_sddmm_spmm_grad_rows(n, d_bias, index=index),
        lambda: sparse.grad_rows_plain(n, src, dst, mask, em, d_bias),
        lambda: torch.autograd.grad(lib_out, leaf, d_pad, retain_graph=True),
        src.shape[0] * 1 + live * 8 + ends * h * 4 + n * h * 4,
        live * 4 * h,
        jobs,
        # each entry gathers one d_bias row beside its id
        gather_bytes_per_entry=h * 4 + 4,
        resources=sparse.backward_info("rows", vw, False),
        n=n,
        h=h,
        edges=src.shape[0],
        live_edges=live,
        gated=False,
        vector_width=vw,
    )


def backward_cases(torch, graph, jobs):
    """Phase 6: the backward kernels against their plain versions on card
    tensors at the training shapes: the BASELINE graph's edge columns over
    node tables at the pow2 bucket of its endpoints, the row pass ungated
    at H = 18 and 64 (GraphSAGE's layers) and gated at H = 32 (STLGT, over
    the entries' (gate, da) that the SDDMM before it writes), each alone,
    over one gather index (whose pos and split must equal the CPU's); the
    whole gated backward as one call beside autograd of the index_add_
    formulation, with its ctypes calls counted. Each case carries its
    kernel's registers, shared memory, spills and resident warps
    (`resources`), the bytes its gathers move per entry, and the bytes
    that the SDDMM hands the gated row pass through the entries' (gate,
    da) (`handoff_bytes`). Each bound counts the bytes of the kernel's
    function alone, each once: the edge list, the rows the live edges
    touch, the outputs, as port PR 4 counted them; neither the gathers'
    repeats nor the handoff. Returns (rows cases, edges cases, report)."""
    import numpy as np

    from kmamiz_tpu_torch.core.spans import _pad_size
    from kmamiz_tpu_torch.ops import cuda_build, sparse

    src, dst, _dist, mask = graph.edge_arrays()
    n_eps = len(graph.interner.endpoints)
    n = _pad_size(n_eps)
    e = src.shape[0]
    dev = src.device
    rng = np.random.default_rng(SEED + 1)

    def table(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    index = sparse.edge_index(src, dst, mask, n, for_backward=True)
    gather = index.gather
    on_cpu = sparse.edge_index(src.cpu(), dst.cpu(), mask.cpu(), n, for_backward=True).gather
    check(
        torch.equal(gather.pos.cpu(), on_cpu.pos) and torch.equal(gather.split.cpu(), on_cpu.split),
        "the gather index's pos/split differ from the CPU's",
    )
    entries = int(gather.row_ptr[-1])  # live entries: 2 per live edge
    report = {
        "index_with_gather_ms": cuda_ms(
            torch, lambda: sparse.edge_index(src, dst, mask, n, for_backward=True)
        ),
        "gather_equals_forward_index": all(
            torch.equal(a, b) for a, b in zip(index[:3], gather[:3])
        ),
        "entries": entries,
    }
    live = int(mask.sum())
    src_l, dst_l = src.long(), dst.long()
    src_c, dst_c = src_l.clamp(0, n - 1), dst_l.clamp(0, n - 1)
    ends = int(torch.unique(torch.cat([src_c[mask], dst_c[mask]])).numel())
    src_rows = int(torch.unique(src_c[mask]).numel())
    dst_rows = int(torch.unique(dst_c[mask]).numel())
    ids_bytes = e * 1 + live * 8  # the mask of every slot, the ids of live edges
    # the library yardstick: autograd of the index_add_ formulation
    src_s = torch.where(mask & (src_l < n), src_l, n)
    dst_s = torch.where(mask & (dst_l < n), dst_l, n)
    em = mask.float()

    def library_of(v, q=None, k=None, b=None):
        # gathers by index_select, whose backward is an index_add_ (an
        # advanced-indexing gather's backward is a sort-based index_put_)
        def rows(t, ids):
            return t.index_select(0, ids)

        if q is None:
            g = em
        else:
            g = torch.sigmoid((rows(q, src_c) * rows(k, dst_c)).sum(dim=1) / math.sqrt(v.shape[1]) + b) * em
        bias = torch.zeros((n + 1, v.shape[1]), device=dev).index_add(0, dst_s, rows(v, src_c) * g[:, None])
        bias = bias.index_add(0, src_s, rows(v, dst_c) * g[:, None])
        deg = torch.zeros(n + 1, device=dev).index_add(0, dst_s, g).index_add(0, src_s, g)
        return bias, deg, g

    rows_cases, edges_cases = [], []

    # one scope per shape: the device times run at the end of the run, and a
    # lambda over a loop variable would then read the last shape's tables
    def shape_cases(label, h, gated):
        v, d_bias = table(n, h), table(n, h)
        vw = vector_width(h)
        info = {"n": n, "h": h, "edges": e, "live_edges": live, "gated": gated, "vector_width": vw}
        rows_kernel = sparse.backward_info("rows", vw, gated)
        if not gated:
            rows_cases.append(ungated_rows_case(torch, sparse, label, src, dst, mask, n, index, v, d_bias, jobs))
            return
        q, k = table(n, h), table(n, h)
        b = torch.tensor([0.1], device=dev)
        d_deg, d_gate = table(n), table(e)
        with torch.no_grad():
            _bias, _deg, gate = sparse.fused_sddmm_spmm(v, src, dst, mask, q, k, b, index=index)
        edge_args = (v, src, dst, mask, gate, d_bias, d_deg, d_gate)
        edges_cases.append(
            kernel_case(
                torch,
                label + ": da (SDDMM)",
                lambda: sparse.fused_sddmm_spmm_grad_edges(*edge_args, index=index),
                lambda: (
                    sparse.grad_edges_plain(*edge_args),
                    sparse.entry_values_plain(gather, gate, sparse.grad_edges_plain(*edge_args)),
                ),
                None,
                # the gate and d_gate of live edges, d_deg at the live ends,
                # v and d_bias rows at the live ends, da written whole
                ids_bytes + live * 8 + ends * 4 + 2 * ends * h * 4 + e * 4,
                live * (4 * h + 10),
                jobs,
                # da, and the live entries' (gate, da): parked entries are
                # not written
                select=lambda out: (out[0], out[1][:entries]),
                # each live edge gathers d_bias and v at both ends
                gather_bytes_per_edge=4 * h * 4,
                # pos read for each live edge, (gate, da) written into each
                # live entry, for the row pass
                handoff_bytes=live * 8 + entries * 8,
                resources=sparse.backward_info("edges", vw, True),
                **info,
            )
        )
        da, gda = sparse.fused_sddmm_spmm_grad_edges(*edge_args, index=index)
        rows_cases.append(
            kernel_case(
                torch,
                label + ": dv, dq, dk (row pass)",
                lambda: sparse.fused_sddmm_spmm_grad_rows(n, d_bias, gda, q, k, index=index),
                lambda: sparse.grad_rows_plain(n, src, dst, mask, gate, d_bias, da, q, k),
                None,
                # gate and da of live edges; d_bias at the live ends, q at the
                # live sources, k at the live destinations; dv, dq, dk whole
                ids_bytes + live * 8 + (ends + src_rows + dst_rows) * h * 4 + 3 * n * h * 4,
                live * 8 * h + 2 * n * h,
                jobs,
                # each entry gathers a d_bias row and a q or k row beside its
                # id and (gate, da)
                gather_bytes_per_entry=2 * h * 4 + 12,
                # the entries' (gate, da) and each row's split, read
                handoff_bytes=entries * 8 + n * 4,
                resources=rows_kernel,
                **info,
            )
        )
        # the whole gated backward (one C call: the SDDMM, then the row pass
        # and db) against autograd of the index_add_ formulation
        leaves = [t.clone().requires_grad_() for t in (v, q, k, b)]
        lib_out = library_of(*leaves)
        ups = (
            torch.cat([d_bias, torch.zeros(1, h, device=dev)]),
            torch.cat([d_deg, torch.zeros(1, device=dev)]),
            d_gate,
        )
        whole = lambda: sparse.fused_backward(v, src, dst, mask, gate, d_bias, d_deg, d_gate, q, k, index)  # noqa: E731
        launch = cuda_build.launch
        calls = []
        cuda_build.launch = lambda *a: calls.append(a) or launch(*a)
        try:
            got = whole()
        finally:
            cuda_build.launch = launch
        check(len(calls) == 1, f"the whole gated backward made {len(calls)} ctypes calls")
        again = whole()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b2) for a, b2 in zip(got, again)), "whole backward: two calls give different bits")
        want = sparse.fused_backward_plain(v, src, dst, mask, gate, d_bias, d_deg, d_gate, q, k)
        for a, w in zip(got, want):
            torch.testing.assert_close(a.reshape(w.shape), w, rtol=1e-4, atol=1e-5, msg="whole gated backward")
        # the bound of the whole function: its inputs read once (ids; v and
        # d_bias rows and d_deg at the live ends, q at the live sources, k at
        # the live destinations, gate and d_gate of live edges) and its
        # outputs written once (dv, dq, dk whole, db); da stays inside
        whole_bytes = (
            ids_bytes
            + live * 8
            + ends * 4
            + (2 * ends + src_rows + dst_rows) * h * 4
            + 3 * n * h * 4
            + 4
        )
        whole_ops = live * (4 * h + 10) + live * 8 * h + 2 * n * h + e
        t_bytes = whole_bytes / PEAK_BYTES_PER_S * 1e3
        t_ops = whole_ops / PEAK_F32_OPS_PER_S * 1e3
        report["stlgt_backward"] = {
            "ctypes_calls": len(calls),
            "bit_equal_relaunch": True,
            "max_abs_err": max(
                float((a.reshape(w.shape) - w).abs().max()) for a, w in zip(got, want)
            ),
            "bytes": whole_bytes,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "ms": cuda_ms(torch, whole),
            "call_ms": call_ms(torch, whole),
            "host_ms": host_ms(torch, whole),
            "plain_ms": cuda_ms(
                torch, lambda: sparse.fused_backward_plain(v, src, dst, mask, gate, d_bias, d_deg, d_gate, q, k)
            ),
            "library_ms": cuda_ms(
                torch, lambda: torch.autograd.grad(lib_out, leaves, ups, retain_graph=True)
            ),
        }
        jobs.append((report["stlgt_backward"], "device_ms", whole))
        log("   whole gated backward " + json.dumps(report["stlgt_backward"]))

    for label, h, gated in (
        ("graphsage layer 1 backward (ungated)", 18, False),
        ("graphsage layer 2 backward (ungated)", 64, False),
        ("stlgt backward (gated)", STLGT_HIDDEN, True),
    ):
        shape_cases(label, h, gated)
    return rows_cases, edges_cases, report


#: --backward-of's seeded edge list, at phase 6's shape: E slots, the first
#: LIVE live between ENDPOINTS of N rows at random, the rest masked padding
AB_N, AB_E, AB_LIVE, AB_ENDPOINTS = 16_384, 262_144, 166_000, 10_000


def backward_of(torch, sparse, jobs):
    """--backward-of: the fused kernel's backward of the checkout whose
    package this process imported, called through the wrapper API that
    every checkout since port PR 4 shares (edge_index(...,
    for_backward=True), fused_sddmm_spmm for the gate, fused_backward, and
    autograd of fused_gated_bias), on a seeded edge list (AB_*): the host
    work per call does not depend on the graph, and phase 6 times the
    kernels on the BASELINE graph. Per shape (ungated H = 18 and 64,
    gated H = 32), after a check against fused_backward_plain (rtol 1e-4 /
    atol 1e-5): ms, call_ms, host_ms, device_ms (queued on jobs); gated
    also ms and call_ms through torch.autograd.grad, the engine's host
    work included. For an A/B of two checkouts on one card: one process
    each, in turns."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    src = np.full(AB_E, np.iinfo(np.int32).max, np.int32)
    dst = src.copy()
    src[:AB_LIVE] = rng.integers(0, AB_ENDPOINTS, AB_LIVE)
    dst[:AB_LIVE] = rng.integers(0, AB_ENDPOINTS, AB_LIVE)
    mask = np.arange(AB_E) < AB_LIVE
    src, dst, mask = (torch.from_numpy(a).to(dev) for a in (src, dst, mask))
    index = sparse.edge_index(src, dst, mask, AB_N, for_backward=True)

    def table(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    def shape_case(h, gated):
        v, d_bias = table(AB_N, h), table(AB_N, h)
        case = {
            "shape": f"fused_backward, {'gated' if gated else 'ungated'} H = {h}",
            "n": AB_N, "edges": AB_E, "live_edges": AB_LIVE, "h": h, "gated": gated,
        }
        if gated:
            q, k = table(AB_N, h), table(AB_N, h)
            b = torch.tensor([0.1], device=dev)
            d_deg, d_gate = table(AB_N), table(AB_E)
            with torch.no_grad():
                gate = sparse.fused_sddmm_spmm(v, src, dst, mask, q, k, b, index=index)[2]
            args = (v, src, dst, mask, gate, d_bias, d_deg, d_gate, q, k)
            leaves = [t.clone().requires_grad_() for t in (q, k, v, b)]
            outs = sparse.fused_gated_bias(*leaves, src, dst, mask, index=index)

            def through_autograd():
                return torch.autograd.grad(outs, leaves, (d_bias, d_deg, d_gate), retain_graph=True)

            case["autograd_ms"] = cuda_ms(torch, through_autograd)
            case["autograd_call_ms"] = call_ms(torch, through_autograd)
        else:
            args = (v, src, dst, mask, None, d_bias)

        def call():
            return sparse.fused_backward(*args, index=index)

        for a, w in zip(call(), sparse.fused_backward_plain(*args)):
            if w is not None:
                torch.testing.assert_close(a.reshape(w.shape), w, rtol=1e-4, atol=1e-5, msg=case["shape"])
        case.update(ms=cuda_ms(torch, call), call_ms=call_ms(torch, call), host_ms=host_ms(torch, call))
        jobs.append((case, "device_ms", call))
        log("   " + json.dumps(case))
        return case

    return [shape_case(h, gated) for h, gated in ((18, False), (64, False), (STLGT_HIDDEN, True))]


#: --backward-variants: settings of the backward kernels' tuning values
#: (csrc/fused_sddmm_spmm.cu, KMZ_*), each built apart
BACKWARD_VARIANTS = {
    # the ungated pass with 2 or 8 entries in flight per lane group (4
    # shipped)
    "ungated u2": ("KMZ_ROW_UNGATED_UNROLL=2",),
    "ungated u8": ("KMZ_ROW_UNGATED_UNROLL=8",),
    # the gated pass with 4 (2 shipped)
    "gated u4": ("KMZ_ROW_UNROLL=4",),
    # 8 in flight in both passes, with registers for them (2 blocks per SM)
    "u8, 2 blocks": (
        "KMZ_ROW_UNROLL=8",
        "KMZ_ROW_MIN_BLOCKS=2",
        "KMZ_ROW_UNGATED_UNROLL=8",
        "KMZ_ROW_UNGATED_MIN_BLOCKS=2",
        "KMZ_EDGE_MIN_BLOCKS=2",
    ),
    # twice the resident warps (8 blocks per SM: 32 registers)
    "8 blocks": ("KMZ_ROW_MIN_BLOCKS=8", "KMZ_ROW_UNGATED_MIN_BLOCKS=8", "KMZ_EDGE_MIN_BLOCKS=8"),
}


def backward_variants(torch, graph):
    """--backward-variants: the backward kernels as shipped against the
    same source built with each setting of BACKWARD_VARIANTS (one nvcc
    each, all at once), on the BASELINE graph at phase 6's shapes: the row
    pass ungated at H = 18 and 64, gated at H = 32 over the SDDMM's
    entries, the SDDMM alone and the whole gated backward, each through
    its wrapper with the library's backward entries swapped for the
    variant's. Each variant's outputs must match the plain versions (rtol
    1e-4 / atol 1e-5). device_ms (profiler) in turns: shipped, the
    variants, the variants reversed, shipped; each variant's registers,
    spills and resident warps beside."""
    import contextlib
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from kmamiz_tpu_torch.core.spans import _pad_size
    from kmamiz_tpu_torch.ops import cuda_build, sparse

    with ThreadPoolExecutor(max_workers=len(BACKWARD_VARIANTS)) as pool:
        paths = dict(
            zip(
                BACKWARD_VARIANTS,
                pool.map(lambda d: cuda_build.build(sparse.KERNEL, d), BACKWARD_VARIANTS.values()),
            )
        )
    entries = ("kmamiz_fused_sddmm_spmm_backward", "kmamiz_fused_sddmm_spmm_backward_info")

    @contextlib.contextmanager
    def entries_of(name):
        shipped = {e: sparse._kernel(e) for e in entries}
        if name != "shipped":
            lib = ctypes.CDLL(str(paths[name]))
            for e, fn in shipped.items():
                variant = getattr(lib, e)
                variant.argtypes, variant.restype = fn.argtypes, fn.restype
                sparse._entries[e] = variant
        try:
            yield
        finally:
            sparse._entries.update(shipped)

    src, dst, _dist, mask = graph.edge_arrays()
    n = _pad_size(len(graph.interner.endpoints))
    e = src.shape[0]
    dev = src.device
    rng = np.random.default_rng(SEED + 1)

    def table(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    index = sparse.edge_index(src, dst, mask, n, for_backward=True)
    entries_live = int(index.gather.row_ptr[-1])
    em = mask.float()
    d18, d64 = table(n, 18), table(n, 64)
    v, d_bias, q, k = (table(n, STLGT_HIDDEN) for _ in range(4))
    d_deg, d_gate = table(n), table(e)
    b = torch.tensor([0.1], device=dev)
    with torch.no_grad():
        gate = sparse.fused_sddmm_spmm(v, src, dst, mask, q, k, b, index=index)[2]
    edge_args = (v, src, dst, mask, gate, d_bias, d_deg, d_gate)
    da = sparse.grad_edges_plain(*edge_args)
    gda = sparse.entry_values_plain(index.gather, gate, da)
    calls = {
        "row pass, ungated H = 18": lambda: sparse.fused_sddmm_spmm_grad_rows(n, d18, index=index),
        "row pass, ungated H = 64": lambda: sparse.fused_sddmm_spmm_grad_rows(n, d64, index=index),
        "row pass, gated H = 32": lambda: sparse.fused_sddmm_spmm_grad_rows(n, d_bias, gda, q, k, index=index),
        "SDDMM of da, H = 32": lambda: sparse.fused_sddmm_spmm_grad_edges(*edge_args, index=index),
        "whole gated backward, H = 32": lambda: sparse.fused_backward(*edge_args, q, k, index),
    }
    wants = {
        "row pass, ungated H = 18": sparse.grad_rows_plain(n, src, dst, mask, em, d18),
        "row pass, ungated H = 64": sparse.grad_rows_plain(n, src, dst, mask, em, d64),
        "row pass, gated H = 32": sparse.grad_rows_plain(n, src, dst, mask, gate, d_bias, da, q, k),
        "SDDMM of da, H = 32": (da, gda[:entries_live]),
        "whole gated backward, H = 32": sparse.fused_backward_plain(*edge_args, q, k),
    }
    report = {"variants": {"shipped": []}, "device_ms": {}, "device_ms_by": set()}
    for name, defines in BACKWARD_VARIANTS.items():
        report["variants"][name] = list(defines)
    for name in report["variants"]:
        with entries_of(name):
            for label, fn in calls.items():
                got = fn()
                if label.startswith("SDDMM"):
                    got = (got[0], got[1][:entries_live])
                for a, w in zip(got, wants[label]):
                    if w is not None:
                        torch.testing.assert_close(a.reshape(w.shape), w, rtol=1e-4, atol=1e-5, msg=f"{name}: {label}")
            report.setdefault("resources", {})[name] = {
                f"{which} {'gated' if gated else 'ungated'} vw {vw}": sparse.backward_info(which, vw, gated)
                for which, vw, gated in (("rows", 2, False), ("rows", 4, False), ("rows", 4, True), ("edges", 4, True))
            }
    names = list(BACKWARD_VARIANTS)
    for name in ["shipped", *names, *reversed(names), "shipped"]:
        with entries_of(name):
            timed = {label: device_ms(torch, fn) for label, fn in calls.items()}
        turn = {label: t[0] for label, t in timed.items()}
        for label, (ms, by, _lost, _events) in timed.items():
            report["device_ms"].setdefault(name, {}).setdefault(label, []).append(ms)
            report["device_ms_by"].add(by)
        log(f"   {name}: " + json.dumps(turn))
    report["device_ms_by"] = sorted(report["device_ms_by"])
    return report


class PlainOnCard:
    """Counts the calls of the fused kernel's plain versions (forward and
    backward) that are handed a card tensor, while the block runs: a
    training path on the card must make none."""

    NAMES = (
        "fused_plain",
        "fused_backward_plain",
        "grad_edges_plain",
        "grad_rows_plain",
        "entry_values_plain",
        "grad_rows_index_plain",
    )

    def __init__(self, torch, sparse) -> None:
        self.torch, self.sparse, self.calls = torch, sparse, 0

    def __enter__(self):
        self.saved = {name: getattr(self.sparse, name) for name in self.NAMES}
        for name, plain in self.saved.items():
            setattr(self.sparse, name, self._counting(plain))
        return self

    def _counting(self, plain):
        def call(*args, **kw):
            if any(isinstance(a, self.torch.Tensor) and a.is_cuda for a in args):
                self.calls += 1
            return plain(*args, **kw)

        return call

    def __exit__(self, *exc):
        for name, plain in self.saved.items():
            setattr(self.sparse, name, plain)
        return False


def zero_counts(counters) -> None:
    for counter in counters:
        counter.launches = 0


def read_counts(torch, counters) -> dict:
    torch.cuda.synchronize()
    return {c.__name__: c.launches for c in counters}


def training_dataset(torch, graph, slots: int):
    """GraphSAGE training slots over the BASELINE graph's live edges: seeded
    18-column features (the served width), latency targets, a quarter of
    the endpoints anomalous in every slot (pos_weight 4), every endpoint
    active."""
    import numpy as np

    from kmamiz_tpu_torch.models import trainer

    src, dst, _dist, mask = graph.edge_arrays()
    cols = torch.stack([src, dst, mask.to(torch.int32)]).cpu().numpy()
    live = cols[2].astype(bool)
    n = len(graph.interner.endpoints)
    rng = np.random.default_rng(SEED + 2)
    anomalous = np.zeros(n, dtype=np.float32)
    anomalous[: n // 4] = 1.0
    return trainer.GraphDataset(
        endpoint_names=[graph.interner.endpoints.lookup(i) for i in range(n)],
        src=cols[0][live],
        dst=cols[1][live],
        edge_mask=np.ones(int(live.sum()), dtype=bool),
        features=[rng.normal(size=(n, SAGE_FEATURES)).astype(np.float32) for _ in range(slots)],
        target_latency=[rng.normal(size=n).astype(np.float32) for _ in range(slots)],
        target_anomaly=[rng.permutation(anomalous) for _ in range(slots)],
        node_mask=[np.ones(n, dtype=bool) for _ in range(slots)],
        slot_keys=[f"0-{i}-0" for i in range(slots)],
    )


def train_graphsage(torch, graph, device, counters, ckpt_dir: str) -> dict:
    """Phase 11: GraphSAGE training at the model10k head's shape (hidden
    64, 18 features) over the BASELINE graph: 24 slots, 8 fused epochs,
    lr 1e-2, through trainer.train with a checkpoint at the end; the
    launches per step; one steady epoch timed and profiled; one epoch over
    2 slots on the card against the port on the CPU."""
    import numpy as np

    from kmamiz_tpu_torch.models import graphsage, stacked, trainer
    from kmamiz_tpu_torch.ops import sparse

    ds = training_dataset(torch, graph, SAGE_SLOTS)
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = trainer.train(
        ds, epochs=SAGE_EPOCHS, hidden=SAGE_HIDDEN, lr=SAGE_LR, seed=SEED,
        checkpoint_dir=ckpt_dir, checkpoint_every=0, device=device,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(torch, counters)
    steps = SAGE_SLOTS * SAGE_EPOCHS
    losses = result.losses
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"losses did not fall: {losses}")
    check(launches[sparse.fused_sddmm_spmm.__name__] == 2 * steps, f"forward launches {launches}")
    # layer 1 aggregates the features (no grad); layer 2 its hidden state
    # one C call per step, launching the row pass alone (ungated)
    check(launches[sparse.fused_backward.__name__] == steps, f"backward calls {launches}")
    check(launches[sparse.fused_sddmm_spmm_grad_rows.__name__] == steps, f"backward launches {launches}")
    check(launches[sparse.fused_sddmm_spmm_grad_edges.__name__] == 0, f"gated backward in GraphSAGE {launches}")

    # one steady epoch on the stacked slots (no upload, no index build)
    st = stacked.stack_dataset(ds, device)
    pos_weight = 1.0 / float(np.mean([a.mean() for a in ds.target_anomaly]))
    run = stacked.epoch_runner(graphsage, SAGE_LR, pos_weight)
    slots = (st.features, st.target_latency, st.target_anomaly, st.node_mask, st.src, st.dst, st.edge_mask)
    opt = graphsage.make_optimizer(SAGE_LR)

    def epoch():
        p = result.params
        run(p, opt.init(p), *slots, 1, index=st.index)[2].cpu()

    epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch()
    epoch_s = time.perf_counter() - t0
    profile = profile_device(torch, epoch, [sparse.KERNEL])

    # one epoch over 2 slots: card against CPU
    two = dataclasses.replace(
        ds,
        features=ds.features[:2],
        target_latency=ds.target_latency[:2],
        target_anomaly=ds.target_anomaly[:2],
        node_mask=ds.node_mask[:2],
        slot_keys=ds.slot_keys[:2],
    )
    out = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        r = trainer.train(two, epochs=1, hidden=SAGE_HIDDEN, lr=SAGE_LR, seed=SEED, device=dev)
        out[str(dev)] = (r, time.perf_counter() - t0)
    card_r, cpu_r = out[str(device)][0], out["cpu"][0]
    np.testing.assert_allclose(card_r.losses, cpu_r.losses, rtol=1e-3, err_msg="2-slot epoch losses")
    param_diff = max(
        float((a.cpu() - b).abs().max()) for a, b in zip(card_r.params, cpu_r.params) if b is not None
    )
    return {
        "slots": SAGE_SLOTS,
        "epochs": SAGE_EPOCHS,
        "hidden": SAGE_HIDDEN,
        "features": SAGE_FEATURES,
        "endpoints": ds.num_nodes,
        "live_edges": int(ds.src.shape[0]),
        "layout": st.layout(),
        "pos_weight": pos_weight,
        "losses": losses,
        "train_wall_s": wall,
        "train_slots_per_s": steps / wall,
        "steady_epoch_s": epoch_s,
        "steady_slots_per_s": SAGE_SLOTS / epoch_s,
        "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "profile_epoch": profile,
        "two_slot_epoch": {
            "card_loss": card_r.losses[0],
            "cpu_loss": cpu_r.losses[0],
            "card_s": out[str(device)][1],
            "cpu_s": out["cpu"][1],
            "max_abs_param_diff": param_diff,
        },
    }


def serve_trained_checkpoint(torch, proc, counters, ckpt_dir: str) -> dict:
    """Phase 11b: the checkpoint phase 11 saved, served by GET
    /api/v1/model/forecast on the forecast processor's snapshot (one edge
    index built for it, two forward launches)."""
    from kmamiz_tpu_torch.api.app import build_router
    from kmamiz_tpu_torch.api.router import ApiServer
    from kmamiz_tpu_torch.config import Settings
    from kmamiz_tpu_torch.ops import sparse
    from kmamiz_tpu_torch.server.initializer import AppContext

    os.environ["KMAMIZ_MODEL_DIR"] = ckpt_dir
    api = ApiServer(build_router(AppContext(settings=Settings(), processor=proc)), host="127.0.0.1", port=0)
    api.start()
    try:
        zero_counts(counters)
        builds = sparse.edge_index.builds
        status, st, _ms = get_route(api.port, "/api/v1/model/status")
        check(status == 200 and st["modelLoaded"], f"trained checkpoint not loaded: {st}")
        check(st["checkpoint"]["step"] == SAGE_EPOCHS, f"checkpoint {st['checkpoint']}")
        status, fc, get_ms = get_route(api.port, "/api/v1/model/forecast")
        launches = read_counts(torch, counters)
        index_builds = sparse.edge_index.builds - builds
    finally:
        api.stop()
    check(status == 200 and fc["model"] == "graphsage", f"forecast answered {status}")
    check(len(fc["endpoints"]) == len(proc.forecast_snapshot["names"]), "forecast misses endpoints")
    for e in fc["endpoints"]:
        check(0.0 <= e["anomalyProbability"] <= 1.0, f"probability of {e['uniqueEndpointName']}")
        check(math.isfinite(e["predictedLatencyMs"]), f"latency of {e['uniqueEndpointName']}")
    check(launches[sparse.fused_sddmm_spmm.__name__] == 2, f"trained head's GET launched {launches}")
    check(index_builds == 1, f"{index_builds} edge index builds for one snapshot")
    return {"forecast_get_ms": get_ms, "launches": launches, "index_builds": index_builds}


def serve_stlgt(torch, graph, device, counters, t_start: int, ckpt_dir: str) -> dict:
    """Phase 12: the STLGT continual trainer behind the fold hook
    (KMAMIZ_STLGT=1, production defaults: depth 8, refresh every fold, 2
    epochs, hidden 32, lr 0.05), fed by a processor's folds: ticks in 5
    successive hours through the DP server (4 folds, 3 refreshes), GET
    /model/stlgt, the last refresh replayed on the CPU from the same ring
    and params, then GET /api/v1/model/forecast?quantile=p99&horizon=3
    with the GraphSAGE checkpoint of phase 11 beside the live params (one
    edge index for the snapshot, shared by both heads)."""
    from kmamiz_tpu_torch.api.app import build_router
    from kmamiz_tpu_torch.api.router import ApiServer
    from kmamiz_tpu_torch.config import Settings
    from kmamiz_tpu_torch.models import stlgt as stlgt_pkg
    from kmamiz_tpu_torch.ops import sparse
    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer
    from kmamiz_tpu_torch.server.initializer import AppContext
    from kmamiz_tpu_torch.server.processor import DataProcessor

    os.environ["KMAMIZ_STLGT"] = "1"
    stlgt_pkg.reset_for_tests()  # the process trainer, built anew at the first fold
    feed = TickFeed()
    proc = DataProcessor(trace_source=feed, device=device, graph=graph)
    dp_server = DataProcessorServer(proc, host="127.0.0.1", port=0)
    dp_server.start()
    ticks = []
    try:
        zero_counts(counters)
        for k, hour in enumerate(STLGT_HOURS):
            if k == len(STLGT_HOURS) - 1:
                # the trainer as the last fold finds it, for the CPU replay
                replica = stlgt_pkg.get_trainer().replica("cpu")
            feed.groups = synth_groups(TICK_TRACES, t_start + k * TICK_TRACES, f"stlgt{hour}-")
            t0 = time.perf_counter()
            resp = post_tick(
                dp_server.port,
                {"uniqueId": f"stlgt{hour}", "lookBack": 30_000, "time": hour * HOUR_MS},
            )
            wall = (time.perf_counter() - t0) * 1e3
            check_response(resp, f"stlgt{hour}")
            status = stlgt_pkg.trainer_status()
            ticks.append(
                {
                    "hour": hour,
                    "wall_ms": round(wall, 3),
                    "history_ms": round(proc.last_stage_ms["history"], 3),
                    # the trainer exists from the first fold on
                    "refreshes": status.get("refreshes", 0),
                    "examples": status.get("examples", 0),
                    "staleSlots": status.get("staleSlots", 0),
                    "lastLoss": status.get("lastLoss"),
                }
            )
            log("   " + json.dumps(ticks[-1]))
        launches = read_counts(torch, counters)
        status, doc, _ms = get_route(dp_server.port, "/model/stlgt")
    finally:
        dp_server.stop()
    check(status == 200, f"/model/stlgt answered {status}")
    check(doc["refreshes"] >= 2, f"{doc['refreshes']} refreshes")
    check(doc["refreshFailures"] == 0 and doc["lastError"] is None, f"refresh failures: {doc}")
    check(proc.fold_errors["stlgtFoldErrors"] == 0, f"fold hook errors {proc.fold_errors}")
    for name in (
        sparse.fused_sddmm_spmm.__name__,
        sparse.fused_sddmm_spmm_grad_edges.__name__,
        sparse.fused_sddmm_spmm_grad_rows.__name__,
    ):
        check(launches[name] > 0, f"{name} never launched on the STLGT path: {launches}")
    # each STLGT step's backward: one C call, launching both kernels
    backward_calls = launches[sparse.fused_backward.__name__]
    check(
        launches[sparse.fused_sddmm_spmm_grad_edges.__name__] == backward_calls
        and launches[sparse.fused_sddmm_spmm_grad_rows.__name__] == backward_calls,
        f"STLGT backward calls and launches {launches}",
    )

    # the last refresh, replayed on the CPU from the same ring and params
    t0 = time.perf_counter()
    cpu_report = replica.observe_fold(proc.forecast_snapshot)
    cpu_s = time.perf_counter() - t0
    check(cpu_report is not None and cpu_report["ok"], f"CPU replay {cpu_report}")
    card, cpu = stlgt_pkg.serving_params(), replica.serving()
    check(cpu["version"] == card["version"], "replay versions differ")
    param_diff = 0.0
    for name, a, b in zip(card["params"]._fields, card["params"], cpu["params"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-5, msg=f"replayed {name}")
        param_diff = max(param_diff, float((a.cpu() - b).abs().max()))

    os.environ["KMAMIZ_MODEL_DIR"] = ckpt_dir
    api = ApiServer(build_router(AppContext(settings=Settings(), processor=proc)), host="127.0.0.1", port=0)
    api.start()
    try:
        zero_counts(counters)
        builds = sparse.edge_index.builds
        status, fc, get_ms = get_route(api.port, "/api/v1/model/forecast?quantile=p99&horizon=3")
        get_launches = read_counts(torch, counters)
        index_builds = sparse.edge_index.builds - builds
        zero_counts(counters)
        status2, fc2, memo_ms = get_route(api.port, "/api/v1/model/forecast?quantile=p99&horizon=3")
        memo_launches = read_counts(torch, counters)
    finally:
        api.stop()
    check(status == 200 and status2 == 200, f"quantile forecast answered {status}, {status2}")
    sec = fc.get("stlgt")
    check(sec is not None and sec["quantile"] == "p99" and sec["horizon"] == 3, f"stlgt section {sec and {k: sec[k] for k in ('quantile', 'horizon')}}")
    check(sec["paramsVersion"] == doc["paramsVersion"], "served params version")
    check(len(sec["endpoints"]) == len(proc.forecast_snapshot["names"]), "stlgt section misses endpoints")
    for row in sec["endpoints"]:
        q = row["latencyQuantilesMs"]
        check(set(q) == {"p99"} and math.isfinite(q["p99"]), f"quantiles of {row['uniqueEndpointName']}")
    check(len(sec["attributions"]) > 0, "no attributions")
    check(fc["model"] == "graphsage", f"model {fc['model']}")
    check(get_launches[sparse.fused_sddmm_spmm.__name__] == 3, f"quantile GET launched {get_launches}")
    check(index_builds == 1, f"{index_builds} edge index builds for one snapshot")
    check(memo_launches[sparse.fused_sddmm_spmm.__name__] == 0 and fc2 == fc, "memoized quantile GET")
    return proc, feed, {
        "ticks": ticks,
        "fold_walls_ms": [t["wall_ms"] for t in ticks if t["refreshes"] > 0],
        "status": doc,
        "launches": launches,
        "cpu_replay_s": cpu_s,
        "cpu_replay_max_abs_param_diff": param_diff,
        "quantile_get_ms": get_ms,
        "quantile_memo_get_ms": memo_ms,
        "quantile_get_launches": get_launches,
        "quantile_get_index_builds": index_builds,
    }


def profile_fold(torch, proc, feed, t_start: int, kernel_names) -> dict:
    """Phase 14c: one more tick of the STLGT processor, in the next hour,
    on the card under the profiler: the tick, its fold and the refresh the
    fold triggers."""
    from kmamiz_tpu_torch.models import stlgt as stlgt_pkg

    hour = STLGT_HOURS[-1] + 1
    feed.groups = synth_groups(TICK_TRACES, t_start, "stlgt-profile")
    before = stlgt_pkg.trainer_status()["refreshes"]
    out = profile_device(
        torch,
        lambda: proc.collect({"uniqueId": "stlgt-profile", "lookBack": 30_000, "time": hour * HOUR_MS}),
        kernel_names,
    )
    check(stlgt_pkg.trainer_status()["refreshes"] == before + 1, "the profiled fold did not refresh")
    out["stages_ms"] = dict(proc.last_stage_ms)
    return out


# -- phase 13: the graph scorers ----------------------------------------------


def count_syncs(torch, fn) -> int:
    """fn() once under torch.cuda.set_sync_debug_mode("warn"): the number
    of synchronising CUDA calls it made (uploads from pageable memory,
    scalar reads)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def memo_device_events(torch, graph, attempts: int = 3) -> int:
    """Device events (kernels, copies, fills) of a memoized refresh
    (service scores and cohesion read back from the memo), under
    torch.profiler between marker kernels (see traced): must be none. A
    session that lost a marker is tried again."""
    for _ in range(attempts):
        events = traced(torch, lambda: (graph.service_scores(), graph.usage_cohesion()))
        if events is not None:
            return len(events)
    raise AssertionError(f"the profiler lost a marker kernel in {attempts} sessions")


def synced_median_ms(torch, fn, runs: int = 7) -> float:
    """Median wall ms of fn() followed by a synchronize, over `runs` runs."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def risk_inputs(torch, graph, combined, num_services, device):
    """Risk inputs from a served tick's combined records, built as
    tests/test_graph_scorers.py builds them: per service the requests,
    the 5xx errors and the cv-weighted latency sum; replicas 1; active
    where the window saw the service."""
    import numpy as np

    req = np.zeros(num_services, dtype=np.float32)
    err = np.zeros(num_services, dtype=np.float32)
    cvw = np.zeros(num_services, dtype=np.float32)
    active = np.zeros(num_services, dtype=bool)
    for r in combined:
        sid = graph.interner.services.get(r["uniqueServiceName"])
        check(sid is not None, f"service {r['uniqueServiceName']} not interned")
        req[sid] += r["combined"]
        if str(r["status"]).startswith("5"):
            err[sid] += r["combined"]
        cvw[sid] += (r["latency"].get("cv") or 0.0) * r["combined"]
        active[sid] = True
    check(bool(active.any()), "no active service in the tick")
    host = (np.ones(num_services, dtype=np.float32), req, err, cvw, active)
    return [torch.from_numpy(a).to(device) for a in host]


def assert_scores_match(got, want, what: str) -> float:
    """Integer lanes and instability equal; relying_factor, risk and
    norm_risk (and the risk chain's impact and probability) within rel
    1e-5, usage_cohesion within rel 1e-6. Returns the largest relative
    difference of the float lanes."""
    rtol = {
        "relying_factor": 1e-5, "impact": 1e-5, "probability": 1e-5, "risk": 1e-5,
        "norm_risk": 1e-5, "usage_cohesion": 1e-6,
    }
    worst = 0.0
    for name, g, w in zip(want._fields, got, want):
        g, w = g.cpu(), w.cpu()
        check(g.shape == w.shape and g.dtype == w.dtype, f"{what}: {name} shape or dtype differs")
        if name in rtol:
            diff = (g - w).abs()
            bound = rtol[name] * w.abs()
            check(bool((diff <= bound).all()), f"{what}: {name} off by {float(diff.max())}")
            rel = diff / w.abs().clamp(min=1e-30)
            worst = max(worst, float(rel.max()) if rel.numel() else 0.0)
        else:
            check(bool((g == w).all()), f"{what}: {name} differs")
    return worst


def assert_bits(got, want, what: str) -> None:
    for name, g, w in zip(want._fields, got, want):
        check(bool((g == w).all()), f"{what}: {name} not bit-equal")


def scorer_chain(scorers, graph, risk_in):
    """One refresh through the store: service scores, cohesion, risk."""
    s = graph.service_scores()
    c = graph.usage_cohesion()
    r = scorers.risk_scores(s.relying_factor, s.acs, *risk_in)
    return s, c, r


def ops_chain(scorers, snap, risk_in, num_services, dist_bits):
    """The same refresh's device work alone, over tensors on the device."""
    src, dst, dist, mask, ep_service, ep_ml, ep_record = snap
    s = scorers.service_scores(
        src, dst, dist, mask, ep_service, ep_ml, ep_record, num_services=num_services, dist_bits=dist_bits
    )
    c = scorers.usage_cohesion(src, dst, dist, mask, ep_service, ep_record, num_services=num_services)
    r = scorers.risk_scores(s.relying_factor, s.acs, *risk_in)
    return s, c, r


def store_snapshot(torch, graph, device):
    """The store's scorer snapshot (edge columns and per-endpoint tables,
    unlabeled) on `device`, with its service capacity and dist_bits."""
    src, dst, dist, mask = graph.edge_arrays()
    ep_service, ep_ml, ep_record, _ep_cap = graph._ep_tables()
    tables = [torch.from_numpy(a).to(device) for a in (ep_service, ep_ml, ep_record)]
    cols = [t.to(device) for t in (src, dst, dist, mask)]
    from kmamiz_tpu_torch.core.spans import _pad_size

    return cols + tables, _pad_size(max(len(graph.interner.services), 1)), graph._scorer_dist_bits()


def quiet_groups(n_traces: int, t_start: int, prefix: str, hot: int = 16):
    """A tick in which only `hot` services take traffic: BASELINE-named
    7-span chains (the same endpoint names as the mesh's first `hot`
    services) whose every hop stays among those services."""
    from kmamiz_tpu_torch import synth

    return json.loads(
        synth.make_raw_window(
            n_traces, SPANS_PER_TRACE, t_start=t_start, trace_prefix=prefix,
            n_services=hot, urls_per_service=BASELINE["urls_per_service"],
        )
    )


def distinct_endpoint_groups(n_traces: int, t_start: int, prefix: str, mult: int):
    """A tick over the BASELINE mesh's endpoints in which every endpoint
    serves at most one SERVER span: trace t's four SERVER spans call the
    endpoints numbered (4t + i) * mult mod 10,000 (i = 0..3) in a chain,
    each CLIENT span naming its callee; mult (coprime with 10,000) varies
    the chains between ticks. The mesh's own windows serve an endpoint many
    times, and the reference's per-window dependency records keep only
    the last record of an endpoint (the JAX package's and the port's
    alike), so their cache holds fewer edges than the graph's union; in
    these windows nothing is overwritten, and the cache and the graph hold
    the same dependencies."""
    groups = synth_groups(n_traces, t_start, prefix)
    urls = BASELINE["urls_per_service"]
    n_ep = BASELINE["n_services"] * urls
    for k, group in enumerate(groups):
        for j, span in enumerate(group):
            svc, ep = divmod(((4 * (t_start + k) + (j + 1) // 2) * mult) % n_ep, urls)
            ns = svc % 8
            span["name"] = f"svc{svc}.ns{ns}.svc.cluster.local:80/*"
            span["localEndpoint"] = {"serviceName": f"svc{svc}"}
            span["tags"]["http.url"] = f"http://svc{svc}.ns{ns}.svc.cluster.local/api/v1/ep{ep}"
            span["tags"]["istio.canonical_service"] = f"svc{svc}"
            span["tags"]["istio.namespace"] = f"ns{ns}"
    return groups


def bench_refresh_inputs(torch, device):
    """bench.py's graph-refresh shape: 10,000 endpoints, 1,000 services,
    50,000 seeded edges (distances 1..7), ep_ml in 0..4095, every endpoint
    a record holder, every service active; no dist_bits (the legacy
    pipeline)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    n_ep, n_svc, n_edges = 10_000, 1_000, 50_000
    ep_service = rng.integers(0, n_svc, n_ep, dtype=np.int32)
    ep_ml = rng.integers(0, 4096, n_ep, dtype=np.int32)
    src = rng.integers(0, n_ep, n_edges, dtype=np.int32)
    dst = rng.integers(0, n_ep, n_edges, dtype=np.int32)
    dist = rng.integers(1, 8, n_edges, dtype=np.int32)
    req = rng.gamma(2.0, 100.0, n_svc).astype(np.float32)
    snap = [src, dst, dist, np.ones(n_edges, dtype=bool), ep_service, ep_ml, np.ones(n_ep, dtype=bool)]
    risk = [np.ones(n_svc, dtype=np.float32), req, req * 0.01, req * 0.5, np.ones(n_svc, dtype=bool)]
    return [torch.from_numpy(a).to(device) for a in snap], [torch.from_numpy(a).to(device) for a in risk], n_svc


def instability_rows(graph, scores, active):
    """The instability and coupling routes' rows built from lanes: what
    GraphHandler serves, from the given (CPU) scores."""
    on, by = scores.instability_on.tolist(), scores.instability_by.tolist()
    ais, ads = scores.ais.tolist(), scores.ads.tolist()
    inst, coup = [], []
    for sid in range(len(graph.interner.services)):
        if not active[sid]:
            continue
        usn = graph.interner.services.lookup(sid)
        service, ns, version = (usn.split("\t") + ["", ""])[:3]
        name = f"{service}.{ns} ({version})"
        d_on, d_by, d_ais, d_ads = int(on[sid]), int(by[sid]), int(ais[sid]), int(ads[sid])
        total = d_on + d_by
        inst.append({"uniqueServiceName": usn, "name": name, "dependingBy": d_by, "dependingOn": d_on,
                     "instability": d_on / total if total else 0})
        coup.append({"uniqueServiceName": usn, "name": name, "ais": d_ais, "ads": d_ads, "acs": d_ais * d_ads})
    inst.sort(key=lambda r: r["name"])
    coup.sort(key=lambda r: r["name"])
    return inst, coup


def canon_cohesion(payload):
    return [{**row, "consumers": sorted(row["consumers"], key=lambda c: c["uniqueServiceName"])} for row in payload]


GRAPH_ROUTES = (
    "dependency/endpoint", "dependency/service", "chord/direct", "chord/indirect",
    "cohesion", "instability", "coupling",
)
SCORER_ROUTES = ("instability", "coupling", "cohesion")


def serve_scorers(torch, proc, feed, device, t_start: int, jobs) -> dict:
    """Phase 13, the graph scorers: (a) on the BASELINE graph the store's
    refresh chain cold, memoized, after a full-mesh tick and after a quiet
    tick (the incremental splice); (b) the chain at bench.py's refresh
    shape (the legacy pipeline); (c) both against the port on the CPU;
    (d) the graph routes over HTTP, device payloads against the host
    oracle, and the BASELINE graph served."""
    from kmamiz_tpu_torch.api.app import build_router
    from kmamiz_tpu_torch.api.router import ApiServer
    from kmamiz_tpu_torch.ops import scorers
    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer
    from kmamiz_tpu_torch.server.initializer import AppContext, Initializer
    from kmamiz_tpu_torch.server.processor import DataProcessor

    graph = proc.graph
    out: dict = {}
    dp_server = DataProcessorServer(proc, host="127.0.0.1", port=0)
    dp_server.start()

    def tick(groups, uid):
        feed.groups = groups
        t0 = time.perf_counter()
        resp = post_tick(dp_server.port, {"uniqueId": uid, "lookBack": 30_000})
        check_response(resp, uid)
        return resp, (time.perf_counter() - t0) * 1e3

    try:
        # -- (a) the BASELINE graph ----------------------------------------------
        resp, _ = tick(synth_groups(TICK_TRACES, t_start, "scorer-a-"), "scorer-a")
        snap, svc_cap, dist_bits = store_snapshot(torch, graph, device)
        risk_in = risk_inputs(torch, graph, resp["combined"], svc_cap, device)
        out["baseline"] = {
            "endpoints": len(graph.interner.endpoints),
            "services": len(graph.interner.services),
            "edges": graph.n_edges,
            "capacity": graph.capacity,
            "svc_cap": svc_cap,
            "dist_bits": dist_bits,
            "pipeline": "sparse" if dist_bits is not None and scorers._sparse_scorer_ok(
                svc_cap, int(snap[4].shape[0]), graph.capacity, dist_bits) else "legacy",
        }
        log("   baseline " + json.dumps(out["baseline"]))

        def cold():
            graph.invalidate_labels()  # drops the memo, bases and device tables
            return scorer_chain(scorers, graph, risk_in)

        def ops():
            return ops_chain(scorers, snap, risk_in, svc_cap, dist_bits)

        # the refresh through the store (host tables, uploads, dispatch)
        # and its device work alone over the same snapshot
        for key, fn, shape in (
            ("cold_chain", cold, "BASELINE refresh through the store, cold"),
            ("ops_chain", ops, "BASELINE refresh, ops over the card snapshot"),
        ):
            out[key] = {"shape": shape, "wall_ms": synced_median_ms(torch, fn), "syncs": count_syncs(torch, fn)}
            jobs.append((out[key], "device_ms", fn))
        card_s, card_c, card_r = cold()
        assert_bits(ops()[0], card_s, "ops chain against the store")

        before = graph.scorer_cache_stats()
        t0 = time.perf_counter()
        memo_s, memo_c = graph.service_scores(), graph.usage_cohesion()
        out["memo_wall_ms"] = (time.perf_counter() - t0) * 1e3
        after = graph.scorer_cache_stats()
        check(memo_s is card_s and memo_c is card_c, "memoized scores recomputed")
        check(after["hits"] == before["hits"] + 2, f"memo hits {before['hits']} -> {after['hits']}")
        check(after["uploads"] == before["uploads"], "a memoized read uploaded")
        out["memo_syncs"] = count_syncs(torch, graph.service_scores)
        out["memo_device_events"] = memo_device_events(torch, graph)
        check(out["memo_device_events"] == 0, f"a memoized read enqueued {out['memo_device_events']} device events")

        # (c) the BASELINE snapshot on the CPU, through the same functions
        cpu_snap = [t.cpu() for t in snap]
        cpu_risk = [t.cpu() for t in risk_in]
        t0 = time.perf_counter()
        cpu_s, cpu_c, cpu_r = ops_chain(scorers, cpu_snap, cpu_risk, svc_cap, dist_bits)
        out["cpu_chain_ms"] = (time.perf_counter() - t0) * 1e3
        out["card_vs_cpu_max_rel"] = max(
            assert_scores_match(card_s, cpu_s, "BASELINE service scores, card vs CPU"),
            assert_scores_match(card_c, cpu_c, "BASELINE cohesion, card vs CPU"),
            assert_scores_match(card_r, cpu_r, "BASELINE risk, card vs CPU"),
        )
        for name in ("risk", "norm_risk"):
            lane = getattr(card_r, name)
            check(bool(torch.isfinite(lane).all()), f"non-finite {name}")

        # a full-mesh tick touches every service: the full recompute
        def refresh_after(groups, uid, key):
            """Serve a tick, then one timed service_scores (its syncs
            counted): the first refresh after the merge."""
            _, out[f"{key}_tick_wall_ms"] = tick(groups, uid)
            held = {}

            def call():
                t0 = time.perf_counter()
                held["scores"] = graph.service_scores()
                torch.cuda.synchronize()
                held["ms"] = (time.perf_counter() - t0) * 1e3

            out[f"{key}_refresh_syncs"] = count_syncs(torch, call)
            out[f"{key}_refresh_ms"] = held["ms"]
            return held["scores"]

        # a full-mesh tick touches every service: the full recompute
        stats = graph.scorer_cache_stats()
        full = refresh_after(synth_groups(TICK_TRACES, t_start + TICK_TRACES, "scorer-b-"), "scorer-b", "mesh")
        after = graph.scorer_cache_stats()
        check(after["full"] == stats["full"] + 1, f"a full-mesh tick took {after} (was {stats})")
        assert_bits(full, graph.service_scores_uncached(), "after a full-mesh tick, cached vs uncached")

        # a quiet tick (16 of 1,000 services): the incremental splice
        stats = graph.scorer_cache_stats()
        inc = refresh_after(quiet_groups(TICK_TRACES, t_start + 2 * TICK_TRACES, "scorer-q-"), "scorer-q", "quiet")
        after = graph.scorer_cache_stats()
        check(after["incremental"] == stats["incremental"] + 1, f"quiet tick: {after} (was {stats})")
        assert_bits(inc, graph.service_scores_uncached(), "incremental splice vs uncached")
        out["cache_stats"] = after
        log("   " + json.dumps({k: v for k, v in out.items() if k != "baseline"}))
    finally:
        dp_server.stop()

    # -- (b) bench.py's refresh shape: the legacy pipeline ------------------------
    b_snap, b_risk, b_svc = bench_refresh_inputs(torch, device)

    def b_ops():
        return ops_chain(scorers, b_snap, b_risk, b_svc, None)

    b_card = b_ops()
    bench = {"shape": "bench.py refresh shape, legacy pipeline", "wall_ms": synced_median_ms(torch, b_ops)}
    bench["syncs"] = count_syncs(torch, b_ops)
    t0 = time.perf_counter()
    b_cpu = ops_chain(scorers, [t.cpu() for t in b_snap], [t.cpu() for t in b_risk], b_svc, None)
    bench["cpu_ms"] = (time.perf_counter() - t0) * 1e3
    bench["card_vs_cpu_max_rel"] = max(
        assert_scores_match(b_card[0], b_cpu[0], "bench shape service scores, card vs CPU"),
        assert_scores_match(b_card[1], b_cpu[1], "bench shape cohesion, card vs CPU"),
        assert_scores_match(b_card[2], b_cpu[2], "bench shape risk, card vs CPU"),
    )
    jobs.append((bench, "device_ms", b_ops))
    out["bench_refresh"] = bench
    log("   bench refresh " + json.dumps(bench))

    # -- (d) HTTP -------------------------------------------------------------------
    # a fresh context whose cache and graph hold the same dependencies
    ffeed = TickFeed()
    ctx = AppContext(processor=DataProcessor(trace_source=ffeed, device=device))
    Initializer(ctx).register_data_caches()
    for k, mult in enumerate((1, 7)):
        ffeed.groups = distinct_endpoint_groups(TICK_TRACES, t_start + (3 + k) * TICK_TRACES, f"scorer-http{k}-", mult)
        ctx.operator.retrieve_realtime_data()
    api = ApiServer(build_router(ctx), host="127.0.0.1", port=0)
    api.start()
    http: dict = {"edges": ctx.processor.graph.n_edges}
    try:
        for route in GRAPH_ROUTES:
            status, payload, ms = get_route(api.port, f"/api/v1/graph/{route}")
            check(status == 200, f"/graph/{route} answered {status}")
            http[f"{route}_ms"] = ms
            if route in SCORER_ROUTES:
                check(len(payload) > 0, f"/graph/{route} is empty")
                status, host, host_ms = get_route(api.port, f"/api/v1/graph/{route}?scorer=host")
                check(status == 200, f"/graph/{route}?scorer=host answered {status}")
                if route == "cohesion":
                    payload, host = canon_cohesion(payload), canon_cohesion(host)
                check(payload == host, f"/graph/{route}: device payload differs from the host oracle")
                http[f"{route}_host_ms"] = host_ms
                http[f"{route}_rows"] = len(payload)
        # the chart routes read the store's historical data: none here
        for route in ("line", "statistics"):
            status, payload, _ms = get_route(api.port, f"/api/v1/graph/{route}")
            check(status == 200, f"/graph/{route} answered {status}")
    finally:
        api.stop()
    out["http_fresh"] = http
    log("   http " + json.dumps(http))

    # the BASELINE graph served: rows against (c)'s CPU lanes, then the
    # first GET after a merge and the memoized GET of each route
    bctx = AppContext(processor=proc)
    Initializer(bctx).register_data_caches()
    api = ApiServer(build_router(bctx), host="127.0.0.1", port=0)
    api.start()
    served: dict = {}
    try:
        # the BASELINE graph has moved on since (c) (two more ticks):
        # rebuild the CPU lanes from its current snapshot
        snap_now, svc_cap, dist_bits = store_snapshot(torch, graph, "cpu")
        cpu_now = scorers.service_scores(*snap_now, num_services=svc_cap, dist_bits=dist_bits)
        active = graph.active_services()
        want_inst, want_coup = instability_rows(graph, cpu_now, active)
        for route, want in (("instability", want_inst), ("coupling", want_coup), ("cohesion", None)):
            status, payload, ms = get_route(api.port, f"/api/v1/graph/{route}")
            check(status == 200, f"BASELINE /graph/{route} answered {status}")
            check(len(payload) == int(active.sum()) == 1000, f"BASELINE /graph/{route}: {len(payload)} rows")
            if want is not None:
                check(payload == want, f"BASELINE /graph/{route} differs from the CPU lanes' rows")
            served[f"{route}_first_label_ms"] = ms
        feed.groups = synth_groups(TICK_TRACES, t_start + 5 * TICK_TRACES, "scorer-m-")
        proc.collect({"uniqueId": "scorer-m", "lookBack": 30_000})
        for route in SCORER_ROUTES:
            status, payload, ms = get_route(api.port, f"/api/v1/graph/{route}")
            check(status == 200 and len(payload) == 1000, f"BASELINE /graph/{route} after a merge")
            served[f"{route}_first_ms"] = ms
            status, again, memo_ms = get_route(api.port, f"/api/v1/graph/{route}")
            check(again == payload, f"BASELINE /graph/{route} memoized payload differs")
            served[f"{route}_memo_ms"] = memo_ms
    finally:
        api.stop()
    out["http_baseline"] = served
    log("   baseline http " + json.dumps(served))
    return out


# -- phase 15: raw ingest -----------------------------------------------------

#: the fold's body pool for the timing with bodies (Istio ticks that carry
#: envoy logs fold request/response bodies of this kind)
BODY_POOL = (
    '{"id":1,"name":"a","tags":["x","y"],"price":9.5}',
    '{"id":2,"name":"b","tags":[],"owner":{"id":7,"roles":["r"]}}',
    '[{"k":1},{"k":"s","z":[{"q":false}]}]',
    '{"items":[{"sku":"s1","qty":2},{"sku":"s2","qty":1,"note":null}],"total":3}',
    '{"ok":true}',
    None,
)


def raw_state_load(torch, device, state) -> dict:
    """Phase 15 (b): phase 4's windows (the same traces and prefix) as raw
    bytes through ingest_raw_window into a fresh card processor; the graph
    must equal phase 4's."""
    from kmamiz_tpu_torch.graph.store import graph_signature
    from kmamiz_tpu_torch.server.processor import DataProcessor

    proc = DataProcessor(trace_source=TickFeed(), device=device, max_payload_bytes=RAW_CAP)
    spans = 0
    wall_s = 0.0
    parse_ms = merge_ms = 0.0
    for raw in state_windows():
        t0 = time.perf_counter()
        summary = proc.ingest_raw_window(raw)
        wall_s += time.perf_counter() - t0
        spans += summary["spans"]
        parse_ms += proc.last_ingest_ms["parse"]
        merge_ms += proc.last_ingest_ms["merge"]
    sig = graph_signature(proc.graph)
    out = {
        "spans": spans,
        "endpoints": len(proc.graph.interner.endpoints),
        "edges": proc.graph.n_edges,
        "signature": sig,
        "wall_s": wall_s,
        "parse_ms": parse_ms,
        "merge_ms": merge_ms,
        "spans_per_s": spans / wall_s,
    }
    check(spans == STATE_TRACES * SPANS_PER_TRACE, f"raw load ingested {spans} spans")
    check(sig == state["signature"], "raw-built graph signature differs from phase 4's")
    check(out["endpoints"] == state["endpoints"], "raw-built endpoints differ from phase 4's")
    check(out["edges"] == state["edges"], "raw-built edges differ from phase 4's")
    return out


def raw_one_shot(torch, device, counters) -> tuple:
    """Phase 15 (c): bench.py's raw e2e window (150,000 traces x 7 spans)
    through ingest_raw_window into a fresh card processor: a warm-up, then
    RAW_REPS reps on fresh processors; then the same bytes again into the
    last processor (the dedup). The launch counters are zeroed just before
    the reps and read just after. Returns (report, raw bytes)."""
    from kmamiz_tpu_torch import native, synth
    from kmamiz_tpu_torch.graph.store import graph_signature
    from kmamiz_tpu_torch.server.processor import DataProcessor

    raw = joined_window(RAW_TRACES, **BASELINE)
    DataProcessor(trace_source=TickFeed(), device=device, max_payload_bytes=RAW_CAP).ingest_raw_window(raw)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_mib = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    reps = []
    zero_counts(counters)
    for _ in range(RAW_REPS):
        proc = DataProcessor(trace_source=TickFeed(), device=device, max_payload_bytes=RAW_CAP)
        t0 = time.perf_counter()
        summary = proc.ingest_raw_window(raw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        reps.append({"wall_ms": wall_ms, **proc.last_ingest_ms, "summary": summary})
    launches = read_counts(torch, counters)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    again = proc.ingest_raw_window(raw)
    signature = graph_signature(proc.graph)  # phase 16 streams to this graph
    spans = reps[0]["summary"]["spans"]
    check(spans == RAW_TRACES * SPANS_PER_TRACE, f"one-shot window ingested {spans} spans")
    check(all(r["summary"]["spans"] == spans for r in reps), "reps ingested different windows")
    check(again["spans"] == 0 and again["traces"] == 0, f"re-ingest not deduplicated: {again}")
    wall = statistics.median(r["wall_ms"] for r in reps)
    out = {
        "traces": RAW_TRACES,
        "spans": spans,
        "bytes": len(raw),
        "bytes_per_span": len(raw) / spans,
        "endpoints": reps[0]["summary"]["endpoints"],
        "edges": reps[0]["summary"]["edges"],
        "reps": RAW_REPS,
        "wall_ms": wall,
        "parse_ms": statistics.median(r["parse"] for r in reps),
        "merge_ms": statistics.median(r["merge"] for r in reps),
        "spans_per_s": spans / (wall / 1e3),
        "wall_ms_all": [r["wall_ms"] for r in reps],
        "effective_parse_threads": native.effective_parse_threads(),
        "peak_device_mib": peak_mib,
        "peak_over_base_mib": peak_mib - base_mib,
        "launches": launches,
        "reingest": again,
        "signature": signature,
    }
    return out, raw


def raw_window_stats(torch, device, counters, raw, jobs) -> tuple:
    """Phase 15 (d): the one-shot window's parse split (the native scan
    alone, then the whole batch build on a fresh session, as
    ingest_raw_window parses), its batch columns through window_stats on
    the card, as bench.py's raw e2e window does (counters zeroed just
    before, read just after: two segment_stats launches); then both of
    its segment_stats passes against the plain version on the same card
    tensors, as phase 3 holds the kernel."""
    import numpy as np

    from kmamiz_tpu_torch import native
    from kmamiz_tpu_torch.core.interning import EndpointInterner
    from kmamiz_tpu_torch.core.spans import RawIngestSession, raw_spans_to_batch
    from kmamiz_tpu_torch.ops import segment_stats as ss
    from kmamiz_tpu_torch.ops import window as window_ops

    t0 = time.perf_counter()
    scan_timings = native.parse_spans(raw, session=native.ParseSession())["timings"]
    scan_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    batch, _kept = raw_spans_to_batch(raw, session=RawIngestSession(EndpointInterner()))
    batch_ms = (time.perf_counter() - t0) * 1e3
    cols = dict(
        endpoint_id=batch.endpoint_id,
        status_id=batch.status_id,
        status_class=batch.status_class,
        latency_ms=batch.latency_ms.astype(np.float32),
        timestamp_rel=batch.timestamp_rel,
        valid_server=batch.valid,
    )
    dev = {k: torch.from_numpy(v).to(device) for k, v in cols.items()}
    sizes = dict(num_endpoints=batch.num_endpoints, num_statuses=batch.num_statuses)
    torch.cuda.synchronize()
    zero_counts(counters)
    stats = window_ops.window_stats(**dev, **sizes)
    launches = read_counts(torch, counters)
    check(
        launches[ss.segment_stats.__name__] == 2,
        f"window_stats launched segment_stats {launches[ss.segment_stats.__name__]} times",
    )
    check(int(stats.count.sum()) == batch.n_spans, "window_stats lost spans")
    values, seg, ts, n_seg = window_ops.stat_rows(**dev, **sizes)
    cases = [segment_stats_case(torch, ss, "raw window pass 1", values, seg, ts, n_seg, jobs)]
    sums, _ = ss.segment_stats_plain(values, seg, ts, n_seg)
    resid = window_ops.residual_rows(values, seg, sums, n_seg)
    cases.append(segment_stats_case(torch, ss, "raw window pass 2", resid, seg, None, n_seg, jobs))
    info = {"spans": batch.n_spans, "capacity": batch.capacity, "segments": n_seg, **sizes}
    split = {"native_parse_ms": scan_ms, "native_timings_us": scan_timings, "batch_ms": batch_ms}
    return {"launches": launches, "parse_split": split, **info}, cases


def raw_http_ingest(torch, device, t_start: int) -> dict:
    """Phase 15 (e): a 2,500-trace window POSTed gzipped to the port's DP
    server's /ingest against a direct ingest_raw_window of the same bytes
    on a twin processor; a malformed payload is quarantined: 200 with the
    zero-span summary and its reason code."""
    from kmamiz_tpu_torch import synth
    from kmamiz_tpu_torch.graph.store import graph_signature
    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer
    from kmamiz_tpu_torch.server.processor import DataProcessor

    raw = synth.make_raw_window(
        TICK_TRACES, SPANS_PER_TRACE, t_start=t_start, trace_prefix="ingest", **BASELINE
    )
    twin = DataProcessor(trace_source=TickFeed(), device=device, max_payload_bytes=RAW_CAP)
    direct = twin.ingest_raw_window(raw)
    proc = DataProcessor(trace_source=TickFeed(), device=device, max_payload_bytes=RAW_CAP)
    server = DataProcessorServer(proc, host="127.0.0.1", port=0)
    server.start()
    try:

        def post(body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/ingest",
                data=gzip.compress(body),
                headers={"Content-Encoding": "gzip"},
                method="POST",
            )
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=600) as resp:
                    status, answer = resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                status, answer = e.code, json.loads(e.read())
            return status, answer, (time.perf_counter() - t0) * 1e3

        status, served, wall_ms = post(raw)
        check(status == 200, f"/ingest answered {status}: {served}")
        same = {k: v for k, v in served.items() if k != "ms"} == {
            k: v for k, v in direct.items() if k != "ms"
        }
        check(same, f"/ingest summary {served} differs from the direct call's {direct}")
        check(graph_signature(proc.graph) == graph_signature(twin.graph), "/ingest graph differs")
        bad_status, bad, _ = post(b'[[{"traceId": "t", "id": ')
        check(
            bad_status == 200 and bad.get("quarantined") == 1 and bad.get("reason") == "truncated-json",
            f"malformed /ingest answered {bad_status}: {bad}",
        )
    finally:
        server.stop()
    return {"summary": served, "wall_ms": wall_ms, "malformed_status": bad_status, "malformed": bad}


def tick_body_fold(ticks, t_start: int) -> dict:
    """Phase 15 (f): the body fold of phase 7's served ticks — the same
    (bodies, content type) pairs, rebuilt from the same windows — native
    against the Python fold (median of 5 each, results equal); and the
    same groups with JSON bodies drawn from BODY_POOL (seeded), since the
    synthetic spans carry none."""
    import random

    from kmamiz_tpu_torch.core import schema
    from kmamiz_tpu_torch.domain.traces import Traces
    from kmamiz_tpu_torch.server.processor import record_groups

    def median_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), out

    rng = random.Random(SEED)
    cases = []
    for k in range(TICKS):
        groups = synth_groups(TICK_TRACES, t_start + k * TICK_TRACES, f"tick{k}-")
        records = Traces(groups).combine_logs_to_realtime_data([], []).to_json()
        pairs = schema.body_pairs_for_groups([rows for _key, rows in record_groups(records)])
        with_bodies = [
            ([rng.choice(BODY_POOL) for _ in bodies], "application/json") for bodies, _ct in pairs
        ]
        for label, p in (("tick", pairs), ("tick with bodies", with_bodies)):
            native_ms, got = median_ms(lambda: schema.merge_and_infer_bodies(p))
            python_ms, want = median_ms(lambda: schema.merge_and_infer_bodies_python(p))
            check(got == want, f"native body fold differs from the Python fold ({label} {k})")
            cases.append(
                {
                    "tick": k,
                    "pairs": label,
                    "groups": len(p) // 2,
                    "bodies": sum(len(b) for b, _ in p),
                    "native_ms": native_ms,
                    "python_ms": python_ms,
                }
            )
            log("   " + json.dumps(cases[-1]))
    return {"cases": cases, "combine_assemble_ms": [t["combine_assemble"] for t in ticks]}


def raw_ingest(torch, device, counters, state, ticks, build, jobs) -> tuple:
    """Phase 15: raw ingest on the card, (a)-(f). Returns the report, the
    raw window's segment-stats cases and the window's bytes."""
    from kmamiz_tpu_torch import native
    from kmamiz_tpu_torch.ops import host_build

    path = native.library_path()
    info = host_build.build_info(path)
    check(
        os.path.commonpath([path, host_build.BUILD_DIR]) == str(host_build.BUILD_DIR),
        f"host library {path} is not the port's build",
    )
    out = {
        "build": {
            "library": os.path.relpath(path, REPO),
            "built_in_this_run": build["built_in_this_run"],
            "gxx_s": info["seconds"],
            "march": info["march"],
        }
    }
    log("   (a) " + json.dumps(out["build"]))
    out["state_load"] = raw_state_load(torch, device, state)
    log("   (b) " + json.dumps(out["state_load"]))
    out["one_shot"], raw = raw_one_shot(torch, device, counters)
    log("   (c) " + json.dumps(out["one_shot"]))
    out["window_stats"], cases = raw_window_stats(torch, device, counters, raw, jobs)
    log("   (d) " + json.dumps(out["window_stats"]))
    out["http"] = raw_http_ingest(torch, device, STATE_TRACES + 40 * TICK_TRACES)
    log("   (e) " + json.dumps(out["http"]))
    out["body_fold"] = tick_body_fold(ticks, STATE_TRACES + TICK_TRACES)
    log(
        "   (f) served ticks' combine_assemble ms "
        + json.dumps(out["body_fold"]["combine_assemble_ms"])
        + " (77-180 ms with the Python fold: PERF.md section 5)"
    )
    torch.cuda.empty_cache()
    return out, cases, raw


# -- phase 16: streaming ingest -----------------------------------------------

STREAM_CHUNKS = 4  # bench.py's streaming split: 4 chunks of 37,500 traces
STREAM_WINDOWS = 2  # counted steady windows, one in each order
STREAM_CLOCK_STEP_MS = 301_000  # past the processed map's 5-minute TTL
STREAM_HTTP_TRACES = 10_000  # ~41 MB of JSON: over /ingest's 32 MiB threshold


def window_chunks(base, prefix: str) -> list:
    """synth's chunks (trace prefix "w") with the trace ids renamed to
    `prefix`: the bytes make_raw_chunks gives for that prefix, without
    generating them again."""
    old, new = b'"traceId": "w', f'"traceId": "{prefix}'.encode()
    return [c.replace(old, new) for c in base]


def join_chunks(chunks) -> bytes:
    """One response holding the chunks' trace groups, in order."""
    return b"[" + b", ".join(c[1:-1] for c in chunks) + b"]"


class PageStub:
    """A local Zipkin stub: GET /zipkin/api/v2/traces answers the queued
    pages in request order, whatever the query."""

    def __init__(self, pages) -> None:
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        stub = self
        self.pages, self.queries = list(pages), []
        self._lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                with stub._lock:
                    stub.queries.append(self.path)
                    body = stub.pages[(len(stub.queries) - 1) % len(stub.pages)]
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        return False


def overlap_path_ms(chunk_detail, drain_ms: float) -> float:
    """The streamed wall if the two threads did not slow each other: the
    worker parses back to back, the consumer merges chunk k once it is
    parsed and chunk k-1 merged, then the drain (measured per-chunk times,
    transfers included)."""
    parsed = merged = 0.0
    for d in chunk_detail:
        parsed += d["parse_ms"]
        merged = max(parsed, merged) + d["merge_ms"]
    return merged + drain_ms


class HostTimer:
    """Sums the wall ms of some methods of one object while it is
    installed: the producer's work around the parse."""

    def __init__(self, obj, names) -> None:
        self.ms = dict.fromkeys(names, 0.0)
        for name in names:
            setattr(obj, name, self._wrap(name, getattr(obj, name)))

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.ms[name] += (time.perf_counter() - t0) * 1e3

        return timed

    def take(self) -> dict:
        out, self.ms = self.ms, dict.fromkeys(self.ms, 0.0)
        return out


def stream_totals(summary: dict) -> dict:
    return {k: summary[k] for k in ("spans", "traces", "chunks", "endpoints", "edges")}


def stream_windows(torch, device, counters, one_shot, raw) -> dict:
    """Phase 16 (a)-(d): one persistent card processor streaming bench.py's
    window in 4 chunks, beside a twin taking the same bytes one shot, both
    on one virtual clock: the cold window (the graph of phase 15 (c)), one
    uncounted steady window, then STREAM_WINDOWS counted ones, each after
    a clock step past the dedup TTL and under a fresh trace prefix, the
    two processors in turns."""
    from kmamiz_tpu_torch import synth
    from kmamiz_tpu_torch.graph.store import graph_signature
    from kmamiz_tpu_torch.server.processor import DataProcessor

    # synth.make_raw_chunks's pages, made at once
    per = RAW_TRACES // STREAM_CHUNKS
    base = raw_windows(
        dict(
            n_traces=per if c < STREAM_CHUNKS - 1 else RAW_TRACES - c * per,
            spans_per=SPANS_PER_TRACE,
            t_start=c * per,
            **BASELINE,
        )
        for c in range(STREAM_CHUNKS)
    )
    check(join_chunks(base) == raw, "the stream's chunks are not phase 15 (c)'s window")
    spans = RAW_TRACES * SPANS_PER_TRACE
    clock = {"ms": 1_700_000_000_000.0}
    stream_proc = DataProcessor(trace_source=TickFeed(), device=device, max_payload_bytes=RAW_CAP, now_ms=lambda: clock["ms"])
    window_proc = DataProcessor(trace_source=TickFeed(), device=device, max_payload_bytes=RAW_CAP, now_ms=lambda: clock["ms"])
    # the dedup work around each parse: registration, skip-set sync
    host_names = ("_register_processed", "_skipset_locked")
    host_timers = {"stream": HostTimer(stream_proc, host_names), "window": HostTimer(window_proc, host_names)}

    def streamed(chunks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = stream_proc.ingest_raw_stream(chunks)
        torch.cuda.synchronize()
        return summary, (time.perf_counter() - t0) * 1e3

    def one_shot_of(window):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = window_proc.ingest_raw_window(window)
        torch.cuda.synchronize()
        return summary, (time.perf_counter() - t0) * 1e3, dict(window_proc.last_ingest_ms)

    # (a) the cold window: phase 15 (c)'s bytes in 4 chunks
    cold, cold_ms = streamed(base)
    check(cold["spans"] == spans and cold["chunks"] == STREAM_CHUNKS, f"cold stream: {cold}")
    check(cold["endpoints"] == one_shot["endpoints"] == PROD_ENDPOINTS, f"cold stream endpoints {cold}")
    check(cold["edges"] == one_shot["edges"], f"cold stream edges {cold['edges']} != {one_shot['edges']}")
    check(graph_signature(stream_proc.graph) == one_shot["signature"], "streamed graph differs from 15 (c)'s")
    one_shot_of(raw)
    # (b) one uncounted steady window each
    clock["ms"] += STREAM_CLOCK_STEP_MS
    warm = window_chunks(base, "warm-")
    streamed(warm)
    one_shot_of(join_chunks(warm))
    del warm
    # (c), (d): counted windows, the two paths in turns
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_mib = torch.cuda.memory_allocated() / 2**20
    for timer in host_timers.values():
        timer.take()
    reps = []
    for k in range(STREAM_WINDOWS):
        clock["ms"] += STREAM_CLOCK_STEP_MS
        chunks = window_chunks(base, f"stream{k}-")
        window = join_chunks(chunks)
        rep = {}
        for path in ("stream", "window") if k % 2 == 0 else ("window", "stream"):
            torch.cuda.reset_peak_memory_stats()
            zero_counts(counters)
            if path == "stream":
                summary, wall_ms = streamed(chunks)
                split = {}
            else:
                summary, wall_ms, split = one_shot_of(window)
            launches = read_counts(torch, counters)
            peak = torch.cuda.max_memory_allocated() / 2**20 - base_mib
            rep[path] = {"wall_ms": wall_ms, **split, "summary": summary,
                         "peak_over_base_mib": peak, "launches": launches,
                         "dedup_ms": host_timers[path].take()}
        s, w = rep["stream"]["summary"], rep["window"]["summary"]
        check(s["spans"] == w["spans"] == spans, f"window {k}: {s['spans']} / {w['spans']} spans")
        check(s["traces"] == w["traces"] == RAW_TRACES, f"window {k}: traces {s['traces']} / {w['traces']}")
        check(s["edges"] == w["edges"] == one_shot["edges"], f"window {k}: edges {s['edges']} / {w['edges']}")
        check(s["chunks"] == STREAM_CHUNKS and s["pipeline_depth"] == 2, f"window {k}: {s}")
        rep["stream"]["overlap_path_ms"] = overlap_path_ms(s["chunk_detail"], s["drain_ms"])
        reps.append(rep)
        log(f"   (c) window {k}: stream {rep['stream']['wall_ms']:.1f} ms "
            f"(parse {s['parse_ms']}, merge {s['merge_ms']}, saved {s['saved_ms']}, "
            f"drain {s['drain_ms']}, overlap path {rep['stream']['overlap_path_ms']:.1f}, "
            f"dedup {json.dumps(rep['stream']['dedup_ms'])}), "
            f"one shot {rep['window']['wall_ms']:.1f} ms (dedup {json.dumps(rep['window']['dedup_ms'])})")
    check(
        graph_signature(stream_proc.graph) == graph_signature(window_proc.graph),
        "the streamed graph differs from the one-shot twin's",
    )
    med = statistics.median
    stream_wall = med(r["stream"]["wall_ms"] for r in reps)
    window_wall = med(r["window"]["wall_ms"] for r in reps)

    def field(key):
        return med(r["stream"]["summary"][key] for r in reps)

    return {
        "windows": STREAM_WINDOWS,
        "chunks": STREAM_CHUNKS,
        "traces": RAW_TRACES,
        "spans": spans,
        "cold": {"wall_ms": cold_ms, **{k: v for k, v in cold.items() if k != "chunk_detail"},
                 "chunk_detail": cold["chunk_detail"]},
        "stream": {
            "wall_ms": stream_wall,
            "spans_per_s": spans / (stream_wall / 1e3),
            "parse_ms": field("parse_ms"),
            "merge_ms": field("merge_ms"),
            "saved_ms": field("saved_ms"),
            "drain_ms": field("drain_ms"),
            "overlap_path_ms": med(r["stream"]["overlap_path_ms"] for r in reps),
            "dedup_ms": [r["stream"]["dedup_ms"] for r in reps],
            "ring_peak": max(r["stream"]["summary"]["ring_peak"] for r in reps),
            "peak_over_base_mib": max(r["stream"]["peak_over_base_mib"] for r in reps),
            "launches_per_window": [r["stream"]["launches"] for r in reps],
            "wall_ms_all": [r["stream"]["wall_ms"] for r in reps],
            "chunk_detail": [r["stream"]["summary"]["chunk_detail"] for r in reps],
            "upload_stats": stream_proc.graph.upload_stats(),
        },
        "one_shot": {
            "wall_ms": window_wall,
            "spans_per_s": spans / (window_wall / 1e3),
            "parse_ms": med(r["window"]["parse"] for r in reps),
            "merge_ms": med(r["window"]["merge"] for r in reps),
            "dedup_ms": [r["window"]["dedup_ms"] for r in reps],
            "peak_over_base_mib": max(r["window"]["peak_over_base_mib"] for r in reps),
            "wall_ms_all": [r["window"]["wall_ms"] for r in reps],
        },
        "stream_over_one_shot": window_wall / stream_wall,
        "base_mib": base_mib,
    }, base


def stream_http(torch, device, t_start: int) -> dict:
    """Phase 16 (e): a body over /ingest's 32 MiB threshold POSTed gzipped
    to the DP server takes the stream branch (4 chunks) and answers the
    totals and graph of a direct ingest_raw_stream on a twin processor."""
    from kmamiz_tpu_torch import native, synth
    from kmamiz_tpu_torch.graph.store import graph_signature
    from kmamiz_tpu_torch.server.dp_server import DEFAULT_STREAM_BYTES, DataProcessorServer
    from kmamiz_tpu_torch.server.processor import DataProcessor

    raw = synth.make_raw_window(
        STREAM_HTTP_TRACES, SPANS_PER_TRACE, t_start=t_start, trace_prefix="streamhttp", **BASELINE
    )
    check(len(raw) >= DEFAULT_STREAM_BYTES, f"/ingest body of {len(raw)} bytes is under the threshold")
    body = gzip.compress(raw, compresslevel=1)
    twin = DataProcessor(trace_source=TickFeed(), device=device, max_payload_bytes=RAW_CAP)
    direct = twin.ingest_raw_stream(native.split_groups(raw, STREAM_CHUNKS))
    proc = DataProcessor(trace_source=TickFeed(), device=device, max_payload_bytes=RAW_CAP)
    server = DataProcessorServer(proc, host="127.0.0.1", port=0)
    server.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/ingest",
            data=body,
            headers={"Content-Encoding": "gzip"},
            method="POST",
        )
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            status, served = resp.status, json.loads(resp.read())
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        server.stop()
    check(status == 200, f"/ingest answered {status}: {served}")
    check(
        served.get("pipeline_depth") == 2 and served.get("chunks") == STREAM_CHUNKS,
        f"/ingest of {len(raw)} bytes did not stream: {served}",
    )
    check(stream_totals(served) == stream_totals(direct), f"/ingest {served} differs from {direct}")
    check(graph_signature(proc.graph) == graph_signature(twin.graph), "streamed /ingest graph differs")
    return {
        "bytes": len(raw),
        "gzip_bytes": len(body),
        "wall_ms": wall_ms,
        "summary": {k: v for k, v in served.items() if k != "chunk_detail"},
    }


def stream_zipkin(torch, device, chunks) -> dict:
    """Phase 16 (f): ingest_from_zipkin against a local stub serving the
    last counted window's 4 chunks as pages, into a fresh card processor:
    the graph of the same window taken one shot by another."""
    from kmamiz_tpu_torch.graph.store import graph_signature
    from kmamiz_tpu_torch.ingestion import ZipkinClient
    from kmamiz_tpu_torch.server.processor import DataProcessor

    one = DataProcessor(trace_source=TickFeed(), device=device, max_payload_bytes=RAW_CAP)
    want = one.ingest_raw_window(join_chunks(chunks))
    proc = DataProcessor(trace_source=TickFeed(), device=device, max_payload_bytes=RAW_CAP)
    with PageStub(chunks) as base_url:
        t0 = time.perf_counter()
        got = proc.ingest_from_zipkin(
            ZipkinClient(base_url), look_back_ms=4 * 60_000, end_ts=1_700_000_000_000, pages=STREAM_CHUNKS
        )
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(got["chunks"] == STREAM_CHUNKS, f"ingest_from_zipkin took {got['chunks']} pages")
    check(
        {k: got[k] for k in ("spans", "traces", "endpoints", "edges")}
        == {k: want[k] for k in ("spans", "traces", "endpoints", "edges")},
        f"ingest_from_zipkin {stream_totals(got)} differs from one shot {want}",
    )
    check(graph_signature(proc.graph) == graph_signature(one.graph), "ingest_from_zipkin graph differs")
    return {"wall_ms": wall_ms, "summary": {k: v for k, v in got.items() if k != "chunk_detail"}}


def stream_ingest(torch, device, counters, one_shot, raw) -> dict:
    """Phase 16: streaming ingest on the card, (a)-(f)."""
    out, base = stream_windows(torch, device, counters, one_shot, raw)
    shown = {
        k: v for k, v in out["stream"].items() if k not in ("chunk_detail", "launches_per_window", "dedup_ms")
    }
    log("   (a) cold " + json.dumps({k: v for k, v in out["cold"].items() if k != "chunk_detail"}))
    log("   (c) stream " + json.dumps(shown))
    log("   (c) chunk_detail " + json.dumps(out["stream"]["chunk_detail"]))
    log("   (c) launches " + json.dumps(out["stream"]["launches_per_window"][0]))
    log("   (d) one shot " + json.dumps(out["one_shot"]))
    out["http"] = stream_http(torch, device, RAW_TRACES)
    log("   (e) " + json.dumps(out["http"]))
    out["zipkin"] = stream_zipkin(torch, device, window_chunks(base, f"stream{STREAM_WINDOWS - 1}-"))
    log("   (f) " + json.dumps(out["zipkin"]))
    torch.cuda.empty_cache()
    return out


# -- phase 17: the application -------------------------------------------------

APP_TICKS = 3  # scheduled realtime ticks of boot 1 before its aggregation
APP_WINDOWS = APP_TICKS + 4  # and windows for the ticks that overlap the aggregation
APP_FOLD_AT = 2  # boot 1's ticks before this one run an hour back: one fold
NEVER_CRON = "0 0 1 1 *"  # New Year's midnight: a schedule that does not fire in a run


def app_settings(store_dir: str, **kw):
    """The application's settings in phase 17: a FileStore in store_dir,
    the forecast route on the model10k fixture, every schedule parked on
    NEVER_CRON unless kw sets it."""
    from kmamiz_tpu_torch.config import Settings

    s = Settings()
    s.storage_uri = "file://" + store_dir
    s.external_data_processor = ""
    s.static_dir = s.wasm_path = ""
    s.model_dir = os.path.join(REPO, MODEL_DIR)
    s.realtime_interval = s.aggregate_interval = s.dispatch_interval = NEVER_CRON
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def history_json(docs) -> str:
    """A history snapshot's part documents as compared across boots: in
    part order, without the time the snapshot was taken (savedAt) and the
    store's own fields."""
    drop = ("savedAt", "_id", "_schemaVersion")
    parts = sorted(docs, key=lambda d: d["part"])
    return json.dumps([{k: v for k, v in d.items() if k not in drop} for d in parts], sort_keys=True)


def timed_call(fn, sink: dict, key: str):
    """fn, recording its wall ms under sink[key] at each call."""

    def call(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            sink[key] = (time.perf_counter() - t0) * 1e3

    return call


def app_urls(app) -> list:
    """One concrete URL per GET route of the app (path parameters from
    its own caches), and a few more for the optional namespace."""
    dts = [d.to_json() for d in app.ctx.cache.get("EndpointDataType").get_data()]
    label = app.ctx.cache.get("LabelMapping").get_label
    first = min(dts, key=lambda d: d["uniqueEndpointName"])
    label_name = "\t".join(first["uniqueEndpointName"].split("\t")[:4] + [label(first["uniqueEndpointName"])])
    service = first["uniqueServiceName"]
    namespace = service.split("\t")[1]
    q = urllib.parse.quote
    params = {
        ":namespace?": "",
        ":uniqueLabelName": q(label_name, safe=""),
        ":uniqueName": q(service, safe=""),
        ":uniqueServiceName": q(service, safe=""),
    }
    urls = []
    for line in app.router.route_list:
        method, path = line.split("] ", 1)
        if method != "[GET":
            continue
        url = path
        for key, value in params.items():
            url = url.replace("/" + key if key == ":namespace?" else key, value)
        if path.endswith("/interface"):
            url += "?uniqueLabelName=" + params[":uniqueLabelName"]
        urls.append(url)
        if ":namespace?" in path:
            urls.append(f"{url}/{namespace}")
    return urls


def compare_payload(got, want, rel: float, what: str) -> None:
    """Integers, strings and booleans equal; floats within rel."""
    if isinstance(want, dict):
        check(isinstance(got, dict) and set(got) == set(want), f"{what}: keys differ")
        for k in want:
            compare_payload(got[k], want[k], rel, f"{what}.{k}")
    elif isinstance(want, list):
        check(isinstance(got, list) and len(got) == len(want), f"{what}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            compare_payload(g, w, rel, f"{what}[{i}]")
    elif isinstance(want, float):
        check(abs(got - want) <= rel * abs(want), f"{what}: {got} against {want}")
    else:
        check(got == want, f"{what}: {got!r} against {want!r}")


def compare_forecast(got: dict, want: dict, what: str) -> None:
    """Two forecast payloads per endpoint name, within one unit of the
    route's rounding (probability 1e-4, latency 0.01 ms)."""
    check(got["model"] == want["model"] and got["predictedHour"] == want["predictedHour"], what)
    w_idx = {e["uniqueEndpointName"]: e for e in want["endpoints"]}
    check(len(got["endpoints"]) == len(w_idx), f"{what}: endpoint counts differ")
    for e in got["endpoints"]:
        w = w_idx[e["uniqueEndpointName"]]
        check(abs(e["anomalyProbability"] - w["anomalyProbability"]) <= 1e-4 + 1e-9, f"{what}: probability")
        check(abs(e["predictedLatencyMs"] - w["predictedLatencyMs"]) <= 0.01 + 1e-9, f"{what}: latency")


def serve_application(torch, device, counters, t_start: int) -> dict:
    """Phase 17: the port's Application (api/app.py) on the card. (a) Boot
    1 over a FileStore in a temporary directory, its processor preloaded
    with phase 4's graph (load_state) and its store seeded with the
    dependency records of the same 150,000 traces, so that its dependency
    cache starts at a deployment's size; the realtime job on a six-field
    one-second cron firing APP_TICKS scheduled ticks of 2,500 fresh traces
    (the first APP_FOLD_AT an hour back, so one hour folds), counters
    zeroed just before the boot and read after tear_down; then the
    aggregation job once while the realtime job goes on firing (the
    ticks that overlap it wait for the operator's cache lock: their walls
    are recorded apart, beside the limit, not held to it), the realtime
    schedule parked, and tear_down (schedules stopped, every cache
    flushed). (b) Boot 2: a new card processor over the same directory,
    the cache load and the graph warm start timed; its graph signature
    equal to a CPU graph warm-started from the same records, its history
    snapshot equal to the one boot 1 flushed. A read-only CPU app boots
    over the same store: boot 2's graph signature equals its CPU graph's,
    warm-started from the same records. (c) Every GET route of boot
    2 over HTTP at 200, first walls (and memoized walls of the memoized
    routes: the scorers and the forecast); their payloads equal to a
    read-only CPU app's over the same store."""
    from kmamiz_tpu_torch.api.app import Application
    from kmamiz_tpu_torch.api.router import ApiServer
    from kmamiz_tpu_torch.graph.store import graph_signature
    from kmamiz_tpu_torch.ops import segment_stats as ss
    from kmamiz_tpu_torch.ops import sparse
    from kmamiz_tpu_torch.server.initializer import AppContext
    from kmamiz_tpu_torch.server.processor import DataProcessor
    from kmamiz_tpu_torch.server.storage import FileStore

    out: dict = {}
    root = tempfile.TemporaryDirectory(prefix="chip_smoke_store_")
    store_dir = root.name
    try:
        # -- (a) boot 1 -----------------------------------------------------
        t0 = time.perf_counter()
        proc1, feed, seed = load_state(device, records=True)
        out["state_load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        FileStore(store_dir).insert_many("EndpointDependencies", seed)
        out["seed_write_s"] = time.perf_counter() - t0
        out["seed_records"] = len(seed)
        out["seed_entries"] = sum(len(d["dependingOn"]) + len(d["dependingBy"]) for d in seed)
        del seed
        windows = [
            synth_groups(TICK_TRACES, t_start + k * TICK_TRACES, f"app{k}-") for k in range(APP_WINDOWS)
        ]
        app = Application(
            ctx=AppContext.build(
                app_settings=app_settings(store_dir, realtime_interval="* * * * * *"), processor=proc1
            )
        )
        op = app.ctx.operator
        clock = {"shift_ms": HOUR_MS}
        op._now_ms = lambda: time.time() * 1000 - clock["shift_ms"]
        ticks: list = []
        retrieve = op.retrieve_realtime_data

        def realtime_job() -> None:
            k = len(ticks)
            feed.groups = windows[k] if k < len(windows) else []
            clock["shift_ms"] = HOUR_MS if k < APP_FOLD_AT else 0
            t0 = time.perf_counter()
            retrieve()
            t1 = time.perf_counter()
            stages = {s: round(v, 3) for s, v in proc1.last_stage_ms.items()}
            tick = {"tick": k, "traces": len(feed.groups), "wall_ms": round((t1 - t0) * 1e3, 3), **stages}
            ticks.append({**tick, "span": (t0, t1)})
            log("   " + json.dumps(tick))

        op.retrieve_realtime_data = realtime_job  # what the schedule registers
        zero_counts(counters)
        t0 = time.perf_counter()
        app.start_up()
        out["boot1_start_up_ms"] = (time.perf_counter() - t0) * 1e3
        check(app.ctx.scheduler.jobs == ["aggregation", "realtime", "dispatch"], "boot 1 schedules")
        deadline = time.monotonic() + 120
        while len(ticks) < APP_TICKS and time.monotonic() < deadline:
            time.sleep(0.05)
        check(len(ticks) >= APP_TICKS, f"{len(ticks)} scheduled ticks in 120 s")
        # the aggregation with the realtime job firing, as in a deployment,
        # whose realtime and aggregation schedules meet at every
        # aggregation; then the realtime schedule parked (re-registering
        # stops the job and waits for a fire in progress)
        agg0 = time.perf_counter()
        op.create_historical_and_aggregated_data()
        agg1 = time.perf_counter()
        out["aggregation_ms"] = (agg1 - agg0) * 1e3
        app.ctx.scheduler.register("realtime", NEVER_CRON, op.retrieve_realtime_data)
        for t in ticks:
            t0, t1 = t.pop("span")
            t["overlaps_aggregation"] = t0 < agg1 and t1 > agg0
        t0 = time.perf_counter()
        app.tear_down()
        out["tear_down_ms"] = (time.perf_counter() - t0) * 1e3
        launches = read_counts(torch, counters)
        fed = [t for t in ticks if t["traces"]]
        alone = [t for t in fed if not t["overlaps_aggregation"]]
        overlapping = [t for t in fed if t["overlaps_aggregation"]]
        out["ticks"] = ticks
        out["boot1_launches"] = launches
        out["max_tick_wall_ms"] = max(t["wall_ms"] for t in alone)
        check(len(alone) >= APP_TICKS, f"{len(alone)} ticks apart from the aggregation")
        check(bool(overlapping), "no fed tick overlapped the aggregation")
        out["overlap_tick_walls_ms"] = [t["wall_ms"] for t in overlapping]
        check(
            launches[ss.segment_stats.__name__] == 2 * len(fed),
            f"segment_stats launched {launches[ss.segment_stats.__name__]} times in {len(fed)} ticks",
        )
        check(out["max_tick_wall_ms"] < TICK_WALL_LIMIT_MS, f"a scheduled tick took {out['max_tick_wall_ms']} ms")
        check(proc1.forecast_snapshot is not None, "boot 1 folded no hour")
        stored = FileStore(store_dir)
        flushed = stored.find_all("ModelHistoryState")
        check(bool(flushed), "boot 1 flushed no history snapshot")
        check(len(stored.find_all("HistoricalData")) > 0, "the aggregation stored no historical data")
        check(stored.get_aggregated_data() is not None, "the aggregation stored no aggregate")
        out["store_bytes"] = sum(
            os.path.getsize(os.path.join(store_dir, f)) for f in os.listdir(store_dir)
        )
        del app, proc1, op, retrieve, stored
        torch.cuda.empty_cache()

        # -- (b) boot 2 -----------------------------------------------------
        boot: dict = {}
        t0 = time.perf_counter()
        store2 = FileStore(store_dir)
        boot["store_open_ms"] = (time.perf_counter() - t0) * 1e3
        proc2 = DataProcessor(trace_source=TickFeed(), device=device)
        app2 = Application(ctx=AppContext.build(app_settings=app_settings(store_dir), store=store2, processor=proc2))
        app2.ctx.cache.load_base_data = timed_call(app2.ctx.cache.load_base_data, boot, "cache_load_ms")
        app2.initializer.warm_start = timed_call(app2.initializer.warm_start, boot, "warm_start_ms")
        zero_counts(counters)
        t0 = time.perf_counter()
        app2.start_up()
        torch.cuda.synchronize()
        boot["start_up_ms"] = (time.perf_counter() - t0) * 1e3
        boot["cache_load_plus_warm_start_ms"] = boot["cache_load_ms"] + boot["warm_start_ms"]
        # a read-only CPU app over the same store: its processor restores
        # the same history (interning the same names first) and warm-starts
        # its CPU graph from the same records
        cpu_app = Application(
            ctx=AppContext.build(
                app_settings=app_settings(store_dir, read_only_mode=True),
                store=FileStore(store_dir),
                processor=DataProcessor(trace_source=TickFeed(), device="cpu"),
            )
        )
        t0 = time.perf_counter()
        cpu_app.start_up()
        boot["cpu_start_up_ms"] = (time.perf_counter() - t0) * 1e3
        records = app2.ctx.cache.get("EndpointDependencies").get_data().to_json()
        boot["records"] = len(records)
        boot["endpoints"] = len(proc2.graph.interner.endpoints)
        boot["edges"] = proc2.graph.n_edges
        check(boot["edges"] > 0, "boot 2 warm-started no edge")
        check(
            graph_signature(proc2.graph) == graph_signature(cpu_app.ctx.processor.graph),
            "boot 2's graph differs from the CPU warm start",
        )
        check(history_json(proc2.snapshot_history()) == history_json(flushed), "boot 2's history snapshot differs")
        check(proc2.forecast_snapshot is not None, "boot 2 restored no forecast snapshot")
        out["boot2"] = boot
        log("   boot 2 " + json.dumps(boot))

        # -- (c) every GET route over HTTP ----------------------------------
        label = {"labels": [{"label": "/smoke", "samples": [], "uniqueServiceName": "svc0\tns0\tlatest", "method": "GET", "block": False}]}
        for a in (app2, cpu_app):
            resp = a.router.dispatch("POST", "/api/v1/data/label/user", json.dumps(label).encode())
            check(resp.status == 201, f"POST /data/label/user answered {resp.status}")
        api = ApiServer(app2.router, host="127.0.0.1", port=0)
        api.start()
        routes: dict = {}
        served: dict = {}  # the memoized routes' payloads, compared below
        try:
            for url in app_urls(app2):
                status, payload, first_ms = get_route(api.port, url)
                check(status == 200, f"GET {url} answered {status}")
                routes[url] = {"first_ms": round(first_ms, 3)}
                if not url.startswith(("/api/v1/graph/cohesion", "/api/v1/graph/instability",
                                       "/api/v1/graph/coupling", "/api/v1/model/forecast")):
                    continue  # host views: no memo, a second GET costs the first's
                status, again, memo_ms = get_route(api.port, url)
                check(status == 200 and again == payload, f"GET {url}: the memoized answer differs")
                routes[url]["memo_ms"] = round(memo_ms, 3)
                served[url] = payload
            out["boot2_launches"] = read_counts(torch, counters)
            # the device-backed payloads against the CPU app's (whose STLGT
            # head, phase 12's process trainer, also serves from the card)
            for url, payload in served.items():
                want = cpu_app.router.dispatch("GET", url)
                check(want.status == 200, f"CPU app: GET {url} answered {want.status}")
                if url.startswith("/api/v1/model/forecast"):
                    compare_forecast(payload, want.payload, f"{url} card against CPU")
                else:
                    rel = 1e-6 if "cohesion" in url else 1e-5
                    compare_payload(payload, want.payload, rel, f"{url} card against CPU")
                routes[url]["rows"] = len(payload) if isinstance(payload, list) else len(payload["endpoints"])
                routes[url]["matches_cpu"] = True
        finally:
            api.stop()
            app2.tear_down()
            cpu_app.tear_down()
        out["routes"] = routes
        log("   routes " + json.dumps(routes))
        log("   boot 2 launches " + json.dumps(out["boot2_launches"]))
        # the forecast GET: GraphSAGE's two layers, and the STLGT head's
        # gated launch while phase 12's process trainer serves
        from kmamiz_tpu_torch.models import stlgt

        want = 2 + (stlgt.serving_params() is not None)
        check(
            out["boot2_launches"][sparse.fused_sddmm_spmm.__name__] == want,
            f"boot 2's GETs launched {out['boot2_launches']}, {want} fused launches expected",
        )
    finally:
        root.cleanup()
    return out


# -- phase 18: GAT ------------------------------------------------------------

GAT_EPOCHS = 4
GAT_HIDDEN = 64


def train_gat(torch, graph, device, counters, fproc, ckpt_dir: str) -> dict:
    """Phase 18: the GAT head (models/gat.py, PyTorch ops: no hand-written
    kernel) trained at hidden 64 on phase 11's dataset (24 seeded slots of
    18 features over the BASELINE graph's live edges) through
    trainer.train(model=gat) for GAT_EPOCHS fused epochs with a
    checkpoint; no port kernel may launch. One epoch over 2 slots on the
    card against the CPU (losses rtol 1e-3); the checkpoint served by GET
    /api/v1/model/forecast on phase 9's snapshot, and its forward on the
    card against the CPU (latency and probability rtol 1e-4 / atol 1e-5,
    the served payload within the route's rounding); a warm forward's wall
    and device time, a training step's wall, and the card's busy share in
    each under the profiler."""
    import numpy as np

    from kmamiz_tpu_torch.api.app import build_router
    from kmamiz_tpu_torch.api.router import ApiServer
    from kmamiz_tpu_torch.config import Settings
    from kmamiz_tpu_torch.models import checkpoint, gat, serving, trainer
    from kmamiz_tpu_torch.server.initializer import AppContext

    ds = training_dataset(torch, graph, SAGE_SLOTS)
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = trainer.train(
        ds, epochs=GAT_EPOCHS, hidden=GAT_HIDDEN, lr=SAGE_LR, seed=SEED,
        checkpoint_dir=ckpt_dir, checkpoint_every=0, model=gat, device=device,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(torch, counters)
    losses = result.losses
    check(all(math.isfinite(x) for x in losses), f"GAT losses {losses}")
    check(losses[-1] < losses[0], f"GAT losses did not fall: {losses}")
    check(not any(launches.values()), f"GAT launched a port kernel: {launches}")

    two = dataclasses.replace(
        ds,
        features=ds.features[:2],
        target_latency=ds.target_latency[:2],
        target_anomaly=ds.target_anomaly[:2],
        node_mask=ds.node_mask[:2],
        slot_keys=ds.slot_keys[:2],
    )
    epoch2 = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        r = trainer.train(two, epochs=1, hidden=GAT_HIDDEN, lr=SAGE_LR, seed=SEED, model=gat, device=dev)
        epoch2[str(dev)] = (r.losses[0], time.perf_counter() - t0)
    np.testing.assert_allclose(
        epoch2[str(device)][0], epoch2["cpu"][0], rtol=1e-3, err_msg="GAT 2-slot epoch loss"
    )

    os.environ["KMAMIZ_MODEL_DIR"] = ckpt_dir
    api = ApiServer(build_router(AppContext(settings=Settings(), processor=fproc)), host="127.0.0.1", port=0)
    api.start()
    try:
        status, st, _ms = get_route(api.port, "/api/v1/model/status")
        check(status == 200 and st["modelLoaded"] and st["checkpoint"]["model"] == "gat", f"GAT status {st}")
        status, fc, get_ms = get_route(api.port, "/api/v1/model/forecast")
    finally:
        api.stop()
    check(status == 200 and fc["model"] == "gat", f"GAT forecast answered {status}")
    snap = fproc.forecast_snapshot
    inputs = (snap["features"], snap["src"], snap["dst"], snap["mask"])
    card_params, _ = checkpoint.restore_params(ckpt_dir, gat, device=device)
    cpu_params, _ = checkpoint.restore_params(ckpt_dir, gat, device="cpu")
    lat, prob = serving.forecast_forward(card_params, *inputs, gat)
    cpu_lat, cpu_prob = serving.forecast_forward(cpu_params, *inputs, gat)
    np.testing.assert_allclose(lat, cpu_lat, rtol=1e-4, atol=1e-5, err_msg="GAT forecast latency")
    np.testing.assert_allclose(prob, cpu_prob, rtol=1e-4, atol=1e-5, err_msg="GAT forecast probability")
    names = snap["names"]
    served = {e["uniqueEndpointName"]: e for e in fc["endpoints"]}
    check(len(served) == len(names), "the GAT forecast misses endpoints")
    for i, name in enumerate(names):
        e = served[name]
        check(abs(e["anomalyProbability"] - round(float(cpu_prob[i]), 4)) <= 1e-4 + 1e-9, f"served probability of {name}")
        want_ms = round(max(float(cpu_lat[i]), 0.0), 2)
        check(abs(e["predictedLatencyMs"] - want_ms) <= 0.01 + 1e-9, f"served latency of {name}")

    padded = serving.pad_snapshot(*inputs, device)

    def forward():
        with torch.no_grad():
            gat.forward(card_params, padded.features, padded.src, padded.dst, padded.mask)

    warm_ms = call_ms(torch, forward)

    # one training step on slot 0 (unpadded), its wall and, last, its profile
    slot = [
        torch.from_numpy(np.asarray(a)).to(device)
        for a in (ds.features[0], ds.src, ds.dst, ds.edge_mask, ds.target_latency[0],
                  ds.target_anomaly[0], ds.node_mask[0])
    ]
    optimizer = gat.make_optimizer(SAGE_LR)
    train_step = gat.make_train_step(optimizer)
    opt_state = optimizer.init(result.params)

    def step():
        train_step(result.params, opt_state, *slot)[2].item()

    step_ms = call_ms(torch, step, reps=5)
    steps = SAGE_SLOTS * GAT_EPOCHS
    out = {
        "slots": SAGE_SLOTS,
        "epochs": GAT_EPOCHS,
        "hidden": GAT_HIDDEN,
        "endpoints": ds.num_nodes,
        "live_edges": int(ds.src.shape[0]),
        "bucket": [int(padded.features.shape[0]), int(padded.src.shape[0])],
        "losses": losses,
        "train_wall_s": wall,
        "train_slots_per_s": steps / wall,
        "launches": launches,
        "two_slot_epoch": {
            "card_loss": epoch2[str(device)][0],
            "cpu_loss": epoch2["cpu"][0],
            "card_s": epoch2[str(device)][1],
            "cpu_s": epoch2["cpu"][1],
        },
        "forecast_get_ms": get_ms,
        "forecast_max_abs_diff": {
            "latency_ms": float(np.abs(lat - cpu_lat).max()),
            "probability": float(np.abs(prob - cpu_prob).max()),
        },
        "warm_forward_ms": warm_ms,
        "train_step_ms": step_ms,
    }
    # profiler sessions last: they slow every later launch on the host
    out["warm_forward_device_ms"], out["warm_forward_device_ms_by"], _lost, _ev = device_ms(torch, forward)
    out["profile_forward"] = profile_device(torch, forward, [])
    out["profile_step"] = profile_device(torch, step, [])
    return out


# -- phase 19: the in-cluster deployment -------------------------------------

CLUSTER_TICKS = 2  # DP ticks through main() with cluster state
WAL_WINDOWS = 10  # phase 4's 150,000 traces as raw /ingest windows
DAY_MS = 86_400_000  # a Zipkin query looking back this far is a backfill
STUB_BACKLOG = 64  # listen backlog of the stubs: over the 16-worker fan-out
#: the JAX package's reason code of each chaos.mutate_payload kind
#: (kmamiz_tpu/resilience/quarantine.py; the size cap at 4,096 bytes)
POISON_REASONS = {
    "truncate": "truncated-json",
    "corrupt": "garbage-utf8",
    "schema": "schema-drift",
    "bomb": "trace-bomb",
}


def hex_ids(groups):
    """The windows' trace and span ids in hex, as Zipkin writes them: an
    envoy log line's header takes word characters only, so synth's "t-j"
    ids could never be logged."""
    for group in groups:
        for span in group:
            for key in ("traceId", "id", "parentId"):
                if span.get(key):
                    span[key] = span[key].encode().hex()
    return groups


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ZipkinStub:
    """A local Zipkin on a free port (a ThreadingHTTPServer, listen backlog
    STUB_BACKLOG): GET /zipkin/api/v2/traces answers the queued window to
    a tick's look-back and an empty list to a backfill's (DAY_MS and
    more)."""

    def __init__(self) -> None:
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlsplit

        stub = self
        self.body = b"[]"

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                split = urlsplit(self.path)
                status, body = 404, b"{}"
                if split.path == "/zipkin/api/v2/traces":
                    look_back = int(parse_qs(split.query).get("lookback", ["0"])[0])
                    status, body = 200, stub.body if look_back < DAY_MS else b"[]"
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        class Server(ThreadingHTTPServer):
            request_queue_size = STUB_BACKLOG
            daemon_threads = True

        self.server = Server(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def queue(self, groups) -> None:
        self.body = json.dumps(groups).encode()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


#: a kube API stub worker: an HTTP/1.1 server with kept-alive connections,
#: a thread each (a listen backlog of STUB_BACKLOG), of the state that
#: KubeStub writes under argv[1] (namespaces.json, pods/<ns>.json,
#: logs/<ns>/<pod>; FAIL answers every call 500), on the port argv[2],
#: which the workers share through SO_REUSEPORT; each log GET appends its
#: line count to access.<pid>
KUBE_WORKER = r"""
import ctypes, os, signal, socket, sys, threading
from urllib.parse import parse_qs, urlsplit

ctypes.CDLL(None).prctl(1, signal.SIGTERM)  # PR_SET_PDEATHSIG: end with the parent
root, port = sys.argv[1], int(sys.argv[2])
access = open(os.path.join(root, "access.%d" % os.getpid()), "a", buffering=1)
REASONS = {200: b"OK", 404: b"Not Found", 500: b"Internal Server Error"}


def read(*parts):
    try:
        with open(os.path.join(root, *parts), "rb") as f:
            return f.read()
    except OSError:
        return None


def route(target):
    split = urlsplit(target)
    parts = split.path.strip("/").split("/")
    if os.path.exists(os.path.join(root, "FAIL")):
        return 500, b'{"error": "apiserver down"}'
    body = None
    if parts[:3] == ["api", "v1", "namespaces"]:
        if len(parts) == 3:
            body = read("namespaces.json")
        elif len(parts) == 5 and parts[4] == "pods":
            body = read("pods", parts[3] + ".json")
        elif len(parts) == 7 and parts[6] == "log":
            body = read("logs", parts[3], parts[5])
            if body is not None:
                tail = int(parse_qs(split.query).get("tailLines", ["10000"])[0])
                lines = body.count(b"\n") + 1 if body else 0
                if lines > tail:
                    body, lines = b"\n".join(body.split(b"\n")[-tail:]), tail
                access.write("%d\n" % lines)
    return (200, body) if body is not None else (404, b"{}")


def serve(conn):
    try:
        with conn, conn.makefile("rb") as rfile:
            while True:
                request = rfile.readline()
                if not request:
                    return  # the client closed, or a readiness probe's bare connect
                while rfile.readline() not in (b"\r\n", b"\n", b""):
                    pass
                status, body = route(request.split(b" ")[1].decode())
                conn.sendall(
                    b"HTTP/1.1 %d %s\r\nContent-Type: application/json\r\nContent-Length: %d\r\n\r\n"
                    % (status, REASONS[status], len(body)) + body
                )
    except OSError:
        pass  # a client that went away


sock = socket.socket()
sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
sock.bind(("127.0.0.1", port))
sock.listen(64)
while True:
    threading.Thread(target=serve, args=(sock.accept()[0],), daemon=True).start()
"""


class KubeStub:
    """The kube API of the mesh, served by `workers` processes (the
    stand-in of an API server that serves concurrently): the namespaces,
    each service's 1-3 pods (seeded) with the Istio canonical labels, and
    each pod's istio-proxy log. add_window writes, with the port's
    envoy_filter, a Request and a Response line for every SERVER span into
    the log of one of its service's pods: the Request under the span's
    parent id, the Response under the span's own id (the wasm filter's
    shape), each with a JSON body from BODY_POOL or none (seeded). A log
    GET answers the pod's lines of every window so far, cut to its
    tailLines. With `fail` set every call answers 500. reads() counts the
    log GETs served and their lines."""

    def __init__(self, root: str, workers: int = 4, seed: int = SEED) -> None:
        import random
        import socket

        self.rng = random.Random(seed)
        self.root = root
        self.pods: dict = {}  # (service, namespace) -> pod names
        self.logs: dict = {}  # (namespace, pod) -> istio-proxy lines (bytes)
        os.makedirs(os.path.join(root, "pods"))
        os.makedirs(os.path.join(root, "logs"))
        self._write("namespaces.json", b'{"items": []}')
        port = free_port()
        self.procs = [
            subprocess.Popen([sys.executable, "-c", KUBE_WORKER, root, str(port)]) for _ in range(workers)
        ]
        self.base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 60
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                break
            except OSError:
                check(time.monotonic() < deadline, "the kube API stub did not start")
                time.sleep(0.05)

    def _write(self, rel: str, data: bytes) -> None:
        path = os.path.join(self.root, rel)
        with open(path + ".tmp", "wb") as f:
            f.write(data)
        os.replace(path + ".tmp", path)

    @property
    def fail(self) -> bool:
        return os.path.exists(os.path.join(self.root, "FAIL"))

    @fail.setter
    def fail(self, on: bool) -> None:
        if on:
            self._write("FAIL", b"")
        elif self.fail:
            os.unlink(os.path.join(self.root, "FAIL"))

    def add_window(self, groups) -> int:
        """Log the window's SERVER spans; returns the bodies logged."""
        from datetime import datetime, timezone

        from kmamiz_tpu_torch.core import envoy_filter

        bodies = 0
        touched, new_ns = set(), set()
        for group in groups:
            for span in group:
                if span.get("kind") != "SERVER":
                    continue
                tags = span["tags"]
                svc, ns = tags["istio.canonical_service"], tags["istio.namespace"]
                pods = self.pods.get((svc, ns))
                if pods is None:
                    pods = self.pods[(svc, ns)] = [f"{svc}-{i}" for i in range(self.rng.randint(1, 3))]
                    new_ns.add(ns)
                    touched.update((ns, p) for p in pods)
                pod = pods[self.rng.randrange(len(pods))]
                host, path = tags["http.url"].split("://", 1)[1].split("/", 1)
                req_body, res_body = self.rng.choice(BODY_POOL), self.rng.choice(BODY_POOL)
                bodies += (req_body is not None) + (res_body is not None)
                parent = span.get("parentId") or f"{span['id']}00"
                request_id, trace_id = f"r{span['traceId']}", span["traceId"]
                stamp = (
                    datetime.fromtimestamp(span["timestamp"] / 1e6, tz=timezone.utc)
                    .isoformat(timespec="microseconds")
                    .replace("+00:00", "Z")
                )
                prefix = f"{stamp}\tdebug\tenvoy wasm\twasm log kmamiz-filter {ns}: "
                request = envoy_filter.format_request_log(
                    tags["http.method"], host, "/" + path, request_id, trace_id, parent, "NO_ID",
                    "application/json" if req_body else "", req_body or "",
                )
                response = envoy_filter.format_response_log(
                    tags["http.status_code"], request_id, trace_id, span["id"], parent,
                    "application/json" if res_body else "", res_body or "",
                )
                self.logs.setdefault((ns, pod), []).extend(
                    [(prefix + request).encode(), (prefix + response).encode()]
                )
                touched.add((ns, pod))
        for ns, pod in touched:
            os.makedirs(os.path.join(self.root, "logs", ns), exist_ok=True)
            self._write(os.path.join("logs", ns, pod), b"\n".join(self.logs.get((ns, pod), [])))
        for ns in new_ns:
            self._write(os.path.join("pods", ns + ".json"), self.pod_list(ns))
        if new_ns:
            names = sorted({n for _, n in self.pods})
            self._write("namespaces.json", json.dumps({"items": [{"metadata": {"name": n}} for n in names]}).encode())
        return bodies

    def pod_list(self, ns: str) -> bytes:
        items = [
            {
                "metadata": {
                    "name": pod,
                    "namespace": ns,
                    "labels": {
                        "service.istio.io/canonical-name": svc,
                        "service.istio.io/canonical-revision": "latest",
                    },
                }
            }
            for (svc, pns), pods in sorted(self.pods.items())
            if pns == ns
            for pod in pods
        ]
        return json.dumps({"items": items}).encode()

    def reads(self) -> tuple:
        """(log GETs served, lines they carried) so far."""
        gets = lines = 0
        for name in os.listdir(self.root):
            if name.startswith("access."):
                with open(os.path.join(self.root, name)) as f:
                    counts = [int(x) for x in f.read().split()]
                gets += len(counts)
                lines += sum(counts)
        return gets, lines

    def stop(self) -> None:
        for p in self.procs:
            p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


class env_set:
    """Environment variables set (None: unset) for a with-block, then
    restored."""

    def __init__(self, **kw) -> None:
        self.kw, self.saved = kw, {}

    def __enter__(self):
        for k, v in self.kw.items():
            self.saved[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def http_json(port: int, path: str, body: bytes = None, timeout: float = 600):
    """(status, parsed JSON) of a GET, or of a POST of `body`."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class Served:
    """A server started through its `python -m` entry (its main()), with
    the environment given; waits until `health` answers 200 and records
    the boot wall. Output goes to `log_path`. stop() sends `sig` and
    waits; kill() is kill -9."""

    def __init__(self, module: str, env: dict, port: int, health: str, log_path: str, timeout: float = 300) -> None:
        full = {k: v for k, v in os.environ.items() if not k.startswith("KMAMIZ_")}
        full.update(env, PYTHONPATH=REPO)
        self.port, self.log_path = port, log_path
        t0 = time.perf_counter()
        self.out = open(log_path, "ab")
        # a session of its own: stop() and kill() end its children too (the
        # cluster client's fan-out processes)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module],
            cwd=REPO,
            env=full,
            stdout=self.out,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        deadline = time.monotonic() + timeout
        while True:
            if self.proc.poll() is not None:
                self.out.close()
                raise AssertionError(f"{module} exited {self.proc.returncode}: {self.tail()}")
            try:
                status, self.health = http_json(port, health, timeout=5)
                if status == 200:
                    break
            except (OSError, ValueError):
                pass
            check(time.monotonic() < deadline, f"{module} did not answer in {timeout} s: {self.tail()}")
            time.sleep(0.1)
        self.boot_ms = (time.perf_counter() - t0) * 1e3

    def tail(self, n: int = 3000) -> str:
        with open(self.log_path, "rb") as f:
            return f.read()[-n:].decode("utf-8", "replace")

    def stop(self, sig: int, timeout: float = 120) -> int:
        """`sig` to the server, a wait for its exit, then SIGKILL to
        whatever of its session is left; its exit code."""
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(sig)
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        if not self.out.closed:
            self.out.close()
        return self.proc.returncode

    def kill(self) -> None:
        """kill -9 of the server and its session."""
        import signal

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.stop(signal.SIGKILL)


def dp_health(port: int) -> dict:
    """A DP server process's GET / answer: its segment-stats launches so
    far and its last tick's stage walls."""
    status, health = http_json(port, "/", timeout=30)
    check(status == 200, f"GET / answered {status}")
    return health


def dp_launches(port: int) -> int:
    """The segment-stats launches a DP server process has made so far."""
    return dp_health(port)["launches"]["segment_stats"]


def threaded_fetch(client, namespaces) -> tuple:
    """The tick's cluster fetch as the JAX client runs it: the pod listings,
    then each pod's log fetched, parsed (natively) and structured on
    DEFAULT_FANOUT_WORKERS threads of this process; (replicas, the
    joinable combined logs), as get_replicas_and_joinable_logs gives."""
    from concurrent.futures import ThreadPoolExecutor

    from kmamiz_tpu_torch.core.envoy import EnvoyLogs
    from kmamiz_tpu_torch.ingestion.kubernetes import DEFAULT_FANOUT_WORKERS, joinable

    replicas, targets = client._replicas_and_targets(list(namespaces))
    with ThreadPoolExecutor(DEFAULT_FANOUT_WORKERS) as pool:
        per_pod = list(pool.map(lambda t: joinable(client.get_envoy_logs(*t).to_structured()), targets))
    return replicas, EnvoyLogs.combine_structured(per_pod)


def kmzc_window(i: int) -> bytes:
    """Phase 19 (c)'s raw window i: phase 4's traces from i * STATE_CHUNK on,
    in the KMZC wire format."""
    from kmamiz_tpu_torch import synth
    from kmamiz_tpu_torch.core import wire

    return wire.encode_groups(
        json.loads(
            synth.make_raw_window(
                STATE_CHUNK, SPANS_PER_TRACE, t_start=i * STATE_CHUNK, trace_prefix="state", **BASELINE
            )
        )
    )


def count_bodies(combined) -> int:
    return sum((c["requestBody"] is not None) + (c["responseBody"] is not None) for c in combined)


def serve_in_cluster(torch, device, counters) -> dict:
    """Phase 19: the port deployed in a cluster, on the card, at the
    BASELINE mesh (1,000 services x 10 urls, 8 namespaces, 7-span chains,
    2,500-trace ticks), against a Zipkin stub and a kube API stub (1-3
    pods per service, istio-proxy logs of the SERVER spans of every tick
    so far, with JSON bodies). (a) The DP through its main() (python -m
    kmamiz_tpu_torch.server.dp_server, the WAL on) serves CLUSTER_TICKS
    ticks, each under the limit and equal to a CPU processor fed the same
    stubs; (b) an in-process twin on the card gives the stage walls and
    the segment-stats launches (2 per tick); (f) a DP server with
    KMAMIZ_STREAM=1 answers each tick as a micro-tick, equal to the serial
    answer. (c) Phase 4's traces POSTed to /ingest as WAL_WINDOWS raw
    windows, kill -9, a boot through main() again: its next tick equals
    the CPU processor's after the same windows, and an in-process
    replay_wal of the same WAL gives the CPU processor's graph signature.
    (d) Every chaos.mutate_payload kind at /ingest: 200, JAX's reason
    code, a file in the quarantine directory, the graph unchanged. (e)
    A tick past its deadline and one whose kube API answers 500: both
    served stale (deadline, tick-fault). (g) The application through its
    main() (python -m kmamiz_tpu_torch.api.app): /api/v1/health with its
    resilience field, a scheduled realtime tick with envoy logs, SIGTERM
    flushes and exits 0."""
    import multiprocessing
    import random
    import signal
    from concurrent.futures import ProcessPoolExecutor

    from kmamiz_tpu_torch.graph.store import graph_signature
    from kmamiz_tpu_torch.ingestion import KubernetesClient, ZipkinClient
    from kmamiz_tpu_torch.ops import segment_stats as ss
    from kmamiz_tpu_torch.resilience import chaos, quarantine
    from kmamiz_tpu_torch.resilience import wal as wal_mod
    from kmamiz_tpu_torch.resilience.wal import IngestWAL
    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer
    from kmamiz_tpu_torch.server.processor import DataProcessor
    from kmamiz_tpu_torch.server.storage import FileStore

    out: dict = {}
    root = tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_")
    wal_dir = os.path.join(root.name, "wal")
    q_dir = os.path.join(root.name, "quarantine")
    t0 = time.perf_counter()
    windows = [
        hex_ids(synth_groups(TICK_TRACES, STATE_TRACES + (60 + k) * TICK_TRACES, f"cluster{k}-"))
        for k in range(CLUSTER_TICKS + 5)
    ]
    zipkin, kube = ZipkinStub(), KubeStub(os.path.join(root.name, "kube"))
    out["windows_s"] = time.perf_counter() - t0
    servers, served, clients = [], [], []

    def processor_on(dev):
        """A processor fed by the stubs, its kube client's fan-out
        processes started (as the servers' boots start them)."""
        client = KubernetesClient(kube.base)
        client.warm_up()
        clients.append(client)
        return DataProcessor(
            trace_source=ZipkinClient(zipkin.base).get_trace_list, k8s_source=client, device=dev, wal=None
        )

    def queue(k: int) -> int:
        zipkin.queue(windows[k])
        t = time.perf_counter()
        bodies = kube.add_window(windows[k])
        out.setdefault("log_write_ms", []).append(round((time.perf_counter() - t) * 1e3, 1))
        return bodies

    dp_env = {
        "ZIPKIN_URL": zipkin.base,
        "KUBEAPI_HOST": kube.base,
        "IS_RUNNING_IN_K8S": "false",
        "BIND_IP": "127.0.0.1",
        "KMAMIZ_WAL": "1",
        "KMAMIZ_WAL_DIR": wal_dir,
        "KMAMIZ_QUARANTINE_DIR": q_dir,
        "LOG_LEVEL": "warn",
    }
    try:
        # -- (a), (b), (f): the DP through main(), its twins ----------------
        port = free_port()
        dp = Served(
            "kmamiz_tpu_torch.server.dp_server", {**dp_env, "DP_PORT": str(port)}, port, "/",
            os.path.join(root.name, "dp.log"),
        )
        served.append(dp)
        out["dp_boot_ms"] = dp.boot_ms
        check(dp.health["device"].startswith("cuda"), f"the DP runs on {dp.health['device']}")
        cpu, twin, streamed = processor_on("cpu"), processor_on(device), processor_on(device)
        stream_server = DataProcessorServer(streamed, host="127.0.0.1", port=0)
        stream_server.start()
        servers.append(stream_server)
        ticks = []
        for k in range(CLUSTER_TICKS):
            bodies = queue(k)
            request = {"uniqueId": f"cluster{k}", "lookBack": 30_000, "time": int(time.time() * 1000)}
            gets, lines = kube.reads()
            launched = dp_launches(port)
            t = time.perf_counter()
            timing: dict = {}
            resp = post_tick(port, request, timing)
            wall = (time.perf_counter() - t) * 1e3
            gets_after, lines_after = kube.reads()
            tick = {
                "tick": k,
                "wall_ms": round(wall, 3),
                "client_decode_ms": timing["decode_ms"],
                "pods_read": gets_after - gets,
                "log_lines": lines_after - lines,
                "bodies_logged": bodies,
                "bodies_folded": count_bodies(resp["combined"]),
                "datatypes": len(resp["datatype"]),
            }
            health = dp_health(port)
            tick["dp_launches"] = health["launches"]["segment_stats"] - launched
            tick["dp_stages"] = {s: round(v, 3) for s, v in health["lastTickStagesMs"].items()}
            check(tick["dp_launches"] == 2, f"tick {k}: the DP launched segment_stats {tick['dp_launches']} times")
            check_response(resp, request["uniqueId"])
            want = cpu.collect(dict(request))
            compare_ticks(resp, want)
            # (b) the in-process twin: stage walls and launches
            zero_counts(counters)
            t = time.perf_counter()
            twin_resp = twin.collect(dict(request))
            tick["twin_wall_ms"] = round((time.perf_counter() - t) * 1e3, 3)
            launches = read_counts(torch, counters)
            tick["launches"] = launches[ss.segment_stats.__name__]
            check(tick["launches"] == 2, f"tick {k}: segment_stats launched {tick['launches']} times")
            tick["stages"] = {s: round(v, 3) for s, v in twin.last_stage_ms.items()}
            compare_ticks(twin_resp, want)
            if k == CLUSTER_TICKS - 1:
                # the fan-out's design against the JAX client's threads
                namespaces = sorted({ns for _svc, ns in kube.pods})
                client, fetch_ms = twin._k8s, {}
                t = time.perf_counter()
                pooled = client.get_replicas_and_joinable_logs(namespaces)
                fetch_ms["workers"] = round((time.perf_counter() - t) * 1e3, 3)
                fetch_ms["workers_parts"] = {p: round(v, 3) for p, v in client.last_fetch_ms.items()}
                t = time.perf_counter()
                threaded = threaded_fetch(client, namespaces)
                fetch_ms["threads"] = round((time.perf_counter() - t) * 1e3, 3)
                check(threaded == pooled, "the threaded fetch differs from the workers'")
                # the tick's own call: the window's requests only
                t = time.perf_counter()
                client.get_replicas_and_joinable_logs(
                    namespaces, trace_ids={s["traceId"] for g in windows[k] for s in g}
                )
                fetch_ms["workers_window"] = round((time.perf_counter() - t) * 1e3, 3)
                fetch_ms["workers_window_parts"] = {p: round(v, 3) for p, v in client.last_fetch_ms.items()}
                tick["fetch_ms"] = fetch_ms
                del pooled, threaded
            # (f) the same tick as a micro-tick of the stream engine
            zero_counts(counters)
            with env_set(KMAMIZ_STREAM="1"):
                stream_resp = post_tick(stream_server.port, request)
            tick["stream_launches"] = read_counts(torch, counters)[ss.segment_stats.__name__]
            check(tick["stream_launches"] == 2, f"micro-tick {k}: segment_stats launched {tick['stream_launches']} times")
            compare_ticks(stream_resp, resp)
            check(tick["bodies_folded"] > 0, f"tick {k} folded no body")
            check(tick["pods_read"] > 0 and tick["log_lines"] > 0, f"tick {k} read no pod log")
            ticks.append(tick)
            log("   (a) " + json.dumps({key: v for key, v in tick.items() if key not in ("stages", "dp_stages", "fetch_ms")}))
            log("   (a) DP stages " + json.dumps(tick["dp_stages"]))
            log("   (b) " + json.dumps(tick["stages"]))
            if "fetch_ms" in tick:
                log("   (b) fetch " + json.dumps(tick["fetch_ms"]))
        check(cpu._last_replicas == twin._last_replicas, "replica counts differ from the CPU's")
        check(
            graph_signature(streamed.graph) == graph_signature(twin.graph) == graph_signature(cpu.graph),
            "the stream, serial and CPU graphs differ",
        )
        out["ticks"] = ticks
        out["max_tick_wall_ms"] = max(t["wall_ms"] for t in ticks)
        check(out["max_tick_wall_ms"] < TICK_WALL_LIMIT_MS, f"a cluster tick took {out['max_tick_wall_ms']} ms")
        out["pods"] = sum(len(p) for p in kube.pods.values())
        out["stream_micro_ticks"] = CLUSTER_TICKS

        # -- (c) crash recovery ----------------------------------------------
        # the windows in the KMZC wire format: with the ticks' JSON records
        # about 170 MB of WAL, within its default retention (4 segments of
        # 64 MiB); as JSON they are 610 MB, whose oldest records the
        # retention drops before a replay, as the JAX package's does
        rec: dict = {"windows": WAL_WINDOWS, "spans": 0}
        t = time.perf_counter()
        with ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1), mp_context=multiprocessing.get_context("spawn")
        ) as pool:
            raws = list(pool.map(kmzc_window, range(WAL_WINDOWS)))
        rec["encode_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        for raw in raws:
            status, summary = http_json(port, "/ingest", raw)
            check(status == 200 and summary["spans"] == STATE_CHUNK * SPANS_PER_TRACE, f"/ingest: {summary}")
            rec["spans"] += summary["spans"]
            cpu.ingest_raw_window(raw)
        del raws
        rec["ingest_and_cpu_twin_ms"] = (time.perf_counter() - t) * 1e3
        rec["wal_bytes"] = IngestWAL(wal_dir).bytes_on_disk()
        check(
            rec["wal_bytes"] < wal_mod.KEEP_SEGMENTS * wal_mod.SEGMENT_BYTES,
            f"{rec['wal_bytes']} bytes of WAL: past its retention",
        )
        dp.kill()
        served.remove(dp)
        # an in-process replay of the same WAL on the card
        replica = DataProcessor(trace_source=lambda lb, t, lim: [], device=device, wal=IngestWAL(wal_dir))
        t = time.perf_counter()
        replayed = replica.replay_wal()
        torch.cuda.synchronize()
        rec["replay_ms"] = (time.perf_counter() - t) * 1e3
        rec["replayed"] = replayed
        # every tick's window and every raw window's span, none quarantined
        want_spans = CLUSTER_TICKS * TICK_TRACES * SPANS_PER_TRACE + rec["spans"]
        check(replayed["spans"] == want_spans and replayed["quarantined"] == 0, f"replay {replayed}")
        check(graph_signature(replica.graph) == graph_signature(cpu.graph), "the replayed graph differs")
        del replica
        torch.cuda.empty_cache()
        dp = Served(
            "kmamiz_tpu_torch.server.dp_server", {**dp_env, "DP_PORT": str(port)}, port, "/",
            os.path.join(root.name, "dp.log"),
        )
        served.append(dp)
        rec["boot_ms"] = dp.boot_ms
        queue(CLUSTER_TICKS)
        request = {"uniqueId": "after-crash", "lookBack": 30_000, "time": int(time.time() * 1000)}
        launched = dp_launches(port)
        t = time.perf_counter()
        resp = post_tick(port, request)
        rec["next_tick_ms"] = (time.perf_counter() - t) * 1e3
        rec["next_tick_launches"] = dp_launches(port) - launched
        check(rec["next_tick_launches"] == 2, f"the tick after the crash launched {rec['next_tick_launches']} times")
        compare_ticks(resp, cpu.collect(dict(request)))
        out["recovery"] = rec
        log("   (c) " + json.dumps(rec))

        # -- (d) quarantine, (e) watchdog: a DP server over the twin ---------
        server = DataProcessorServer(twin, host="127.0.0.1", port=0)
        server.start()
        servers.append(server)
        before = graph_signature(twin.graph)
        clean = json.dumps([windows[0][0][:3]]).encode()  # ~1.9 KB: under the 4,096-byte cap
        poison: dict = {}
        q_here = str(quarantine.default_quarantine().directory)
        twin.max_payload_bytes = 4096  # the JAX tests' trace-bomb cap
        with env_set(KMAMIZ_QUARANTINE=None):
            for kind, reason in POISON_REASONS.items():
                files = set(os.listdir(q_here)) if os.path.isdir(q_here) else set()
                raw = chaos.mutate_payload(clean, kind, random.Random(SEED))
                status, summary = http_json(server.port, "/ingest", raw)
                check(status == 200, f"{kind}: /ingest answered {status}")
                check(summary.get("reason") == reason and summary["quarantined"] == 1, f"{kind}: {summary}")
                new = set(os.listdir(q_here)) - files
                check(any(n.endswith(f"-{reason}.bin") for n in new), f"{kind}: no {reason} file")
                poison[kind] = reason
        twin.max_payload_bytes = quarantine.MAX_PAYLOAD_BYTES
        check(graph_signature(twin.graph) == before, "a quarantined payload changed the graph")
        out["quarantine"] = poison
        log("   (d) " + json.dumps(poison))
        stale: dict = {}
        queue(CLUSTER_TICKS + 1)
        status, good = http_json(server.port, "/", json.dumps({"uniqueId": "good", "lookBack": 30_000}).encode())
        check(status == 200 and not good.get("stale"), "the good tick")
        queue(CLUSTER_TICKS + 2)
        with env_set(KMAMIZ_TICK_DEADLINE_MS="1"):
            status, body = http_json(server.port, "/", json.dumps({"uniqueId": "late", "lookBack": 30_000}).encode())
        check(status == 200 and body.get("staleReason") == "deadline", f"deadline: {status} {body.get('staleReason')}")
        stale["deadline"] = body["staleAgeMs"]
        deadline = time.monotonic() + 60
        time.sleep(0.05)
        while twin.tick_lock.locked() and time.monotonic() < deadline:
            time.sleep(0.01)  # the straggler finishes
        queue(CLUSTER_TICKS + 3)
        kube.fail = True
        try:
            status, body = http_json(server.port, "/", json.dumps({"uniqueId": "fault", "lookBack": 30_000}).encode())
        finally:
            kube.fail = False
        check(status == 200 and body.get("staleReason") == "tick-fault", f"fault: {status} {body.get('staleReason')}")
        stale["tick-fault"] = body["staleAgeMs"]
        out["stale_age_ms"] = stale
        log("   (e) " + json.dumps(stale))

        # -- (g) the application through main() -------------------------------
        app_port = free_port()
        queue(CLUSTER_TICKS + 4)
        gets = kube.reads()[0]
        store_dir = os.path.join(root.name, "store")
        app = Served(
            "kmamiz_tpu_torch.api.app",
            {
                "PORT": str(app_port),
                "STORAGE_URI": "file://" + store_dir,
                "ZIPKIN_URL": zipkin.base,
                "KUBEAPI_HOST": kube.base,
                "IS_RUNNING_IN_K8S": "false",
                "REALTIME_INTERVAL": "* * * * * *",
                "AGGREGATE_INTERVAL": NEVER_CRON,
                "DISPATCH_INTERVAL": NEVER_CRON,
                "KMAMIZ_STATIC_DIR": "",
                "KMAMIZ_WASM_PATH": "",
                "KMAMIZ_QUARANTINE_DIR": q_dir,
                "LOG_LEVEL": "warn",
            },
            app_port,
            "/api/v1/health",
            os.path.join(root.name, "app.log"),
        )
        served.append(app)
        check("resilience" in app.health, "/api/v1/health has no resilience field")
        deadline = time.monotonic() + 120
        while kube.reads()[0] - gets < out["pods"] and time.monotonic() < deadline:
            time.sleep(0.1)  # a scheduled tick reads every pod's log
        check(kube.reads()[0] - gets >= out["pods"], "no scheduled tick read the pod logs")
        t = time.perf_counter()
        code = app.stop(signal.SIGTERM)
        served.remove(app)
        application = {"boot_ms": app.boot_ms, "sigterm_exit_ms": (time.perf_counter() - t) * 1e3, "exit": code}
        check(code == 0, f"the application exited {code} on SIGTERM: {app.tail()}")
        datatypes = FileStore(store_dir).find_all("EndpointDataType")
        with_schema = sum(
            1 for d in datatypes for s in d.get("schemas", []) if s.get("responseSchema") or s.get("requestSchema")
        )
        check(with_schema > 0, "the flushed datatypes carry no body schema")
        application.update(datatypes=len(datatypes), with_body_schema=with_schema)
        out["application"] = application
        log("   (g) " + json.dumps(application))
    finally:
        for s in servers:
            s.stop()
        for p in served:
            p.kill()
        for c in clients:
            c.close()
        zipkin.stop()
        kube.stop()
        root.cleanup()
    return out


# -- phase 20: telemetry ------------------------------------------------------

TEL_TICKS = 3  # ticks of each gate state, alternating between the two DPs
TEL_HOUR = 930  # the hour of phase 20's ticks; its fold ticks run in the next two
CAPTURE_MS = 4_000  # the capture's window, around one tick
CAPTURE_LEAD_S = 1.0  # the tick starts this long after the capture is asked for
#: the phases of a tick without a cluster source or a WAL, each of which
#: /metrics must hold a histogram of
TICK_PHASES = ("parse", "walk_sparse", "pack", "merge", "scorers", "assemble", "host-transfer", "encode-serve")
GUARD_TRACES = 200  # the scratch DP's window in (h)


def get_text(port: int, path: str) -> tuple:
    """(content type, body text) of a GET."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return resp.headers.get("Content-Type"), resp.read().decode()


def scrape(port: int) -> dict:
    """A DP's /metrics as {(name, ((label, value), ...)): value}, after
    checking the 0.0.4 text: every histogram's buckets cumulative and
    ending at le="+Inf" equal to its _count."""
    import re

    ctype, text = get_text(port, "/metrics")
    check(ctype == "text/plain; version=0.0.4; charset=utf-8", f"/metrics content type {ctype}")
    samples, kinds, buckets = {}, {}, {}
    for line in text.strip().splitlines():
        if line.startswith("# TYPE"):
            _, _, name, kind = line.split(maxsplit=3)
            kinds[name] = kind
            continue
        if line.startswith("#"):
            continue
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{([^}]*)\})? (\S+)$", line)
        check(m is not None, f"/metrics line {line!r}")
        labels = tuple(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', m.group(2) or ""))
        samples[(m.group(1), labels)] = float(m.group(3))
        if m.group(1).endswith("_bucket"):
            key = (m.group(1)[: -len("_bucket")], tuple(kv for kv in labels if kv[0] != "le"))
            buckets.setdefault(key, []).append((dict(labels)["le"], float(m.group(3))))
    for (name, labels), series in buckets.items():
        check(kinds.get(name) == "histogram", f"{name} has buckets but is no histogram")
        values = [v for _le, v in series]
        check(series[-1][0] == "+Inf" and values == sorted(values), f"{name}{labels} buckets {series}")
        check(values[-1] == samples[(f"{name}_count", labels)], f"{name}{labels}: +Inf != _count")
    return samples


def post_raw_tick(port: int, request: dict) -> tuple:
    """A DP tick as the host app posts it (gzip both ways): (its wall ms
    until the answer's bytes are read, the answer's size)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/",
        data=gzip.compress(json.dumps(request).encode()),
        headers={"Content-Type": "application/json", "Content-Encoding": "gzip", "Accept-Encoding": "gzip"},
        method="POST",
    )
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        check(resp.status == 200, f"tick answered {resp.status}")
        body = resp.read()
    return (time.perf_counter() - t) * 1e3, len(body)


def spread(walls) -> dict:
    return {
        "median_ms": round(statistics.median(walls), 3),
        "min_ms": round(min(walls), 3),
        "max_ms": round(max(walls), 3),
        "walls_ms": [round(w, 3) for w in walls],
    }


def serve_telemetry(torch, device, proc, feed) -> dict:
    """Phase 20: the telemetry of a DP started through its main() at the
    BASELINE mesh's 2,500-trace ticks. (a) Two DPs, telemetry on and off
    (KMAMIZ_TELEMETRY=0 KMAMIZ_PROF=0), serve the same TEL_TICKS windows in
    alternating turns: their tick walls' medians and spreads. (b) The on
    DP's /metrics: 0.0.4 text, kmamiz_ticks_total up by its ticks, a span
    histogram of every tick phase, the device memory and arena gauges,
    kmamiz_program_calls_total{program="segment_stats"} up by 2 a tick and
    equal to GET /'s count. (c) Its /debug/traces POSTed back to /ingest.
    (e) /debug/graftprof: the attribution ratio (>= 0.90) and the
    per-phase p95s. (f) Two ticks in the next two hours (KMAMIZ_STLGT=1):
    the second folds with an STLGT refresh (its span in the trace, the
    train-ticks counter and the fused kernel's launches up). (d) POST
    /debug/profile around one tick another thread serves: a Chrome trace
    whose kernel join credits segment_stats with device time, a second
    capture meanwhile answered 409. (g) The sync guard around one warm
    tick of this process's card processor `proc` (fed by `feed`): its
    synchronising calls. (h) A scratch DP in this process with
    KMAMIZ_TICK_DEADLINE_MS=1: the trip writes one kmamiz-flight artifact,
    which report.from_any condenses."""
    from concurrent.futures import ThreadPoolExecutor

    from kmamiz_tpu_torch.analysis import guards
    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer
    from kmamiz_tpu_torch.server.processor import DataProcessor
    from kmamiz_tpu_torch.telemetry.profiling import device_attr, report

    out: dict = {}
    root = tempfile.TemporaryDirectory(prefix="chip_smoke_telemetry_")
    capture_dir = os.path.join(root.name, "profiles")
    zipkin = ZipkinStub()
    served = []
    base_env = {
        "ZIPKIN_URL": zipkin.base,
        "BIND_IP": "127.0.0.1",
        "KMAMIZ_STLGT": "1",
        "KMAMIZ_PROF_FLIGHT_DIR": os.path.join(root.name, "flight"),
        "KMAMIZ_QUARANTINE_DIR": os.path.join(root.name, "quarantine"),
        "LOG_LEVEL": "warn",
    }
    gates = {"on": {}, "off": {"KMAMIZ_TELEMETRY": "0", "KMAMIZ_PROF": "0"}}
    try:
        ports = {gate: free_port() for gate in gates}

        def boot(gate):
            return Served(
                "kmamiz_tpu_torch.server.dp_server", {**base_env, **gates[gate], "DP_PORT": str(ports[gate])},
                ports[gate], "/", os.path.join(root.name, f"dp-{gate}.log"),
            )

        # the windows are made while the two DPs boot
        with ThreadPoolExecutor(2) as pool:
            booting = [pool.submit(boot, gate) for gate in gates]
            t0 = time.perf_counter()
            windows = [
                synth_groups(TICK_TRACES, STATE_TRACES + (80 + k) * TICK_TRACES, f"tel{k}-") for k in range(TEL_TICKS + 3)
            ]
            out["windows_s"] = round(time.perf_counter() - t0, 3)
            # every DP that booted is stopped at the end, even when the
            # other's boot failed
            served.extend(job.result() for job in booting if job.exception() is None)
            dps = {gate: job.result() for gate, job in zip(gates, booting)}
        out["boot_ms"] = {gate: round(dp.boot_ms, 3) for gate, dp in dps.items()}
        on = ports["on"]
        for dp in dps.values():
            check(dp.health["device"].startswith("cuda"), f"a DP runs on {dp.health['device']}")

        # -- (a) telemetry on against off, alternating -------------------------------
        before = scrape(on)
        launched = dp_launches(on)
        walls = {gate: [] for gate in gates}
        for k in range(TEL_TICKS):
            zipkin.queue(windows[k])
            for gate in (("on", "off") if k % 2 == 0 else ("off", "on")):
                request = {"uniqueId": f"tel{k}-{gate}", "lookBack": 30_000, "time": TEL_HOUR * HOUR_MS + k}
                wall, size = post_raw_tick(ports[gate], request)
                check(size > 0, "an empty answer")
                walls[gate].append(wall)
        out["ticks"] = {gate: spread(w) for gate, w in walls.items()}
        out["on_over_off_median"] = round(out["ticks"]["on"]["median_ms"] / out["ticks"]["off"]["median_ms"], 4)
        log("   (a) " + json.dumps({g: {k: v for k, v in t.items() if k != "walls_ms"} for g, t in out["ticks"].items()}))
        log(f"   (a) on {out['ticks']['on']['walls_ms']}, off {out['ticks']['off']['walls_ms']}")
        on_walls = list(walls["on"])

        # -- (b) /metrics ---------------------------------------------------------------
        after = scrape(on)
        ticks = after[("kmamiz_ticks_total", ())] - before[("kmamiz_ticks_total", ())]
        calls_key = ("kmamiz_program_calls_total", (("program", "segment_stats"),))
        calls = after[calls_key] - before[calls_key]
        launches = dp_launches(on) - launched
        metrics_check = {"ticks_total": ticks, "segment_stats_calls": calls, "get_launches": launches}
        check(ticks == TEL_TICKS, f"kmamiz_ticks_total rose by {ticks} in {TEL_TICKS} ticks")
        check(calls == launches == 2 * TEL_TICKS, f"segment_stats: {calls} in /metrics, {launches} by GET /")
        for phase in TICK_PHASES:
            n = after.get(("kmamiz_tick_span_ms_bucket", (("phase", phase), ("le", "+Inf"))), 0)
            check(n >= TEL_TICKS, f"kmamiz_tick_span_ms{{phase={phase}}} holds {n} spans")
        in_use = after.get(("kmamiz_device_bytes_in_use", ()), 0)
        limit = after.get(("kmamiz_device_bytes_limit", ()), 0)
        edges = after.get(("kmamiz_arena_bytes", (("arena", "graph.edges"),)), 0)
        check(0 < in_use <= limit, f"device bytes in use {in_use}, limit {limit}")
        check(edges > 0, "no graph.edges arena bytes")
        metrics_check.update(device_bytes_in_use=in_use, device_bytes_limit=limit, arena_graph_edges=edges)
        out["metrics"] = metrics_check
        log("   (b) " + json.dumps(metrics_check))

        # -- (c) the self-trace -----------------------------------------------------------
        status, export = http_json(on, "/debug/traces")
        check(status == 200 and len(export) > 0, "no traces at /debug/traces")
        status, summary = http_json(on, "/ingest", json.dumps(export).encode())
        check(status == 200 and summary["traces"] > 0 and summary["spans"] > 0, f"self-trace ingest {summary}")
        out["self_trace"] = {"traces": summary["traces"], "spans": summary["spans"], "edges": summary["edges"]}
        log("   (c) " + json.dumps(out["self_trace"]))

        # -- (e) the live profile -----------------------------------------------------------
        status, prof = http_json(on, "/debug/graftprof")
        check(status == 200 and prof["kind"] == "kmamiz-graftprof", "/debug/graftprof")
        out["graftprof"] = {
            "ticks": prof["ticks"],
            "attribution_ratio": prof["attribution_ratio"],
            "p95_ms": {name: st["p95_ms"] for name, st in prof["phases"].items()},
            "max_ms": {name: st["max_ms"] for name, st in prof["phases"].items()},
        }
        check(prof["attribution_ratio"] >= 0.90, f"attribution ratio {prof['attribution_ratio']}")
        log("   (e) " + json.dumps(out["graftprof"]))

        # -- (f) an STLGT fold tick -------------------------------------------------------------
        before = scrape(on)
        fold_walls = []
        for k, hour in enumerate((TEL_HOUR + 1, TEL_HOUR + 2)):
            zipkin.queue(windows[TEL_TICKS + k])
            wall, _size = post_raw_tick(on, {"uniqueId": f"fold{hour}", "lookBack": 30_000, "time": hour * HOUR_MS})
            fold_walls.append(wall)
        on_walls += fold_walls
        after = scrape(on)
        status, export = http_json(on, "/debug/traces")
        names = {s["localEndpoint"]["serviceName"] for s in export[-1]}
        fused_key = ("kmamiz_program_calls_total", (("program", "fused_sddmm_spmm"),))
        train_key = ("kmamiz_model_train_ticks_total", (("model", "stlgt"),))
        fold = {
            "walls_ms": [round(w, 3) for w in fold_walls],
            "train_ticks": after.get(train_key, 0) - before.get(train_key, 0),
            "fused_calls": after[fused_key] - before[fused_key],
        }
        check("stlgt-refresh" in names, f"the fold tick's trace has no stlgt-refresh span: {sorted(names)}")
        check(fold["train_ticks"] >= 1 and fold["fused_calls"] > 0, f"fold tick {fold}")
        out["fold"] = fold
        log("   (f) " + json.dumps(fold))

        # -- (d) a capture around one tick ---------------------------------------------------------
        zipkin.queue(windows[TEL_TICKS + 2])
        # a first short session pays the profiler's one-time start-up in the
        # DP process, so that the measured one opens within its lead
        status, first = http_json(on, "/debug/profile", json.dumps({"durationMs": 50, "dir": capture_dir}).encode())
        check(status == 200 and first["ok"], f"the first capture {status} {first}")
        os.remove(first["trace"])
        with ThreadPoolExecutor(1) as pool:
            # the capture's directory in the request: KMAMIZ_PROFILE_DIR would
            # also have every tick capture itself (core/profiling.trace)
            job = pool.submit(
                http_json, on, "/debug/profile", json.dumps({"durationMs": CAPTURE_MS, "dir": capture_dir}).encode()
            )
            time.sleep(CAPTURE_LEAD_S)
            status, busy = http_json(on, "/debug/profile", json.dumps({"durationMs": 10}).encode())
            check(status == 409 and busy.get("busy") is True, f"a second capture answered {status} {busy}")
            t_tick = time.time() * 1e3
            wall, _size = post_raw_tick(on, {"uniqueId": "captured", "lookBack": 30_000, "time": (TEL_HOUR + 2) * HOUR_MS + 1})
            t_done = time.time() * 1e3
            status, answer = job.result()
        check(status == 200 and answer["ok"], f"capture {status} {answer}")
        # the tick sits strictly inside the session's window (a session can
        # lose the device records at its edges); one host, one epoch clock
        opened, closed = answer["window_ms"]
        check(opened < t_tick and t_done < closed, f"the captured tick [{t_tick}, {t_done}] is not inside {answer['window_ms']}")
        joined = device_attr.parse_profile_dir(capture_dir)
        credited = joined["programs"].get("segment_stats", 0.0)
        check(credited > 0, f"the capture credits segment_stats with {credited} ms: {joined}")
        out["capture"] = {
            "tick_wall_ms": round(wall, 3),
            "uncaptured_on_median_ms": out["ticks"]["on"]["median_ms"],
            "busy_status": 409,
            "segment_stats_device_ms": credited,
            "total_device_ms": joined["total_device_ms"],
            "unattributed_ms": joined["unattributed_ms"],
            "events": joined["events"],
        }
        on_walls.append(wall)
        log("   (d) " + json.dumps(out["capture"]))
        out["max_on_tick_wall_ms"] = round(max(on_walls), 3)
        check(out["max_on_tick_wall_ms"] < TICK_WALL_LIMIT_MS, f"a telemetry-on tick took {out['max_on_tick_wall_ms']} ms")

        # -- (g) the sync guard around one warm tick of this process ------------------------------
        feed.groups = windows[TEL_TICKS + 2]
        with guards.hot_path_guard("allow", device=device) as guard:
            proc.collect({"uniqueId": "guarded", "lookBack": 30_000})
        torch.cuda.synchronize()
        out["guard"] = {"level": guard.level, "syncs": guard.syncs}
        check(guard.syncs > 0, "the guard counted no synchronising call")
        log("   (g) " + json.dumps(out["guard"]))

        # -- (h) a watchdog trip freezes a flight artifact ----------------------------------------
        flight_dir = os.path.join(root.name, "flight-h")
        scratch = DataProcessor(
            trace_source=lambda lb, t, lim: synth_groups(GUARD_TRACES, 0, "guard"), device=device, wal=None
        )
        server = DataProcessorServer(scratch, host="127.0.0.1", port=0)
        server.start()
        try:
            with env_set(KMAMIZ_TICK_DEADLINE_MS="1", KMAMIZ_PROF_FLIGHT_DIR=flight_dir):
                status, body = http_json(server.port, "/", json.dumps({"uniqueId": "trip", "lookBack": 30_000}).encode())
            deadline = time.monotonic() + 60
            time.sleep(0.05)
            while scratch.tick_lock.locked() and time.monotonic() < deadline:
                time.sleep(0.01)  # the straggler finishes
        finally:
            server.stop()
        check(status == 503 and body.get("reason") == "deadline", f"the tripped tick answered {status} {body}")
        dumps = [n for n in os.listdir(flight_dir) if n.endswith("-watchdog.json")]
        check(len(dumps) == 1, f"flight artifacts {dumps}")
        with open(os.path.join(flight_dir, dumps[0])) as f:
            artifact = json.load(f)
        condensed = report.from_any(artifact)
        check(artifact["kind"] == "kmamiz-flight" and condensed["kind"] == "kmamiz-graftprof", "the flight artifact")
        out["flight"] = {"file": dumps[0], "trigger": artifact["trigger"], "detail": artifact["detail"], "ticks": condensed["ticks"]}
        log("   (h) " + json.dumps(out["flight"]))
    finally:
        for dp in served:
            dp.kill()
        zipkin.stop()
        root.cleanup()
    return out


# -- phase 21: the simulator -------------------------------------------------

SIM_SERVICES, SIM_ENDPOINTS_PER_SERVICE = 1000, 10  # BASELINE.json's synthetic mesh
SIM_DAYS = 1  # of MODELS.md's 4 simulated days: the depth cut
SIM_FAULT_FRACTION = 0.08
SIM_DATE_MS = 1_700_000_000_000.0
SIM_EPOCHS = 8
SIM_CPU_EPOCHS = 2
SIM_GAT_EPOCHS = 2
SIM_HIDDEN = 64
SIM_TRAIN_FRACTION = 0.75  # trainer.train_on_simulation's default split
SIM_NAMESPACE = "mesh"


def make_mesh_config(
    n_services: int,
    eps_per_service: int,
    days: int,
    rng: np.random.Generator,
    fault_fraction: float = 0.08,
) -> str:
    """Layered mesh: gateway tier (external traffic) -> mid tiers -> leaf
    tier; each endpoint depends on 1-3 endpoints one tier deeper. A copy
    of tools/eval_models_large.py's make_mesh_config (that tool imports
    jax): the same arguments give the same YAML."""
    import yaml

    n_gw = max(1, n_services // 20)
    n_leaf = max(1, int(n_services * 0.3))
    n_mid = max(1, n_services - n_gw - n_leaf)
    tiers = (
        [0] * n_gw + [1] * (n_mid // 2) + [2] * (n_mid - n_mid // 2) + [3] * n_leaf
    )

    services = []
    ep_ids: list = [[] for _ in range(4)]
    for s in range(n_services):
        tier = tiers[s]
        endpoints = []
        for e in range(eps_per_service):
            eid = f"s{s}-e{e}"
            ep_ids[tier].append(eid)
            endpoints.append(
                {
                    "endpointId": eid,
                    "endpointInfo": {
                        "path": f"/api/s{s}/op{e}",
                        "method": "post" if e % 3 == 0 else "get",
                    },
                }
            )
        services.append(
            {
                "serviceName": f"svc{s}",
                "versions": [
                    {
                        "version": "v1",
                        "replica": int(rng.integers(1, 4)),
                        "endpoints": endpoints,
                    }
                ],
            }
        )

    dependencies = []
    for tier in range(4):
        deeper = ep_ids[tier + 1] if tier < 3 else []
        for eid in ep_ids[tier]:
            entry: dict = {"endpointId": eid}
            if tier == 0:
                entry["isExternal"] = True
            if deeper:
                k = int(rng.integers(1, min(3, len(deeper)) + 1))
                picks = rng.choice(len(deeper), size=k, replace=False)
                entry["dependOn"] = [
                    {"endpointId": deeper[int(p)]} for p in picks
                ]
            if "dependOn" in entry or entry.get("isExternal"):
                dependencies.append(entry)

    tier_latency = [25, 15, 10, 5]
    endpoint_metrics = []
    for tier in range(4):
        for eid in ep_ids[tier]:
            m = {
                "endpointId": eid,
                "delay": {
                    "latencyMs": tier_latency[tier] + int(rng.integers(0, 6)),
                    "jitterMs": 2 + int(rng.integers(0, 4)),
                },
                "errorRatePercent": 1,
            }
            if tier == 0:
                m["expectedExternalDailyRequestCount"] = 4800
            endpoint_metrics.append(m)

    # -- fault schedule -------------------------------------------------------
    all_eps = [e for t in ep_ids for e in t]
    n_faulty = max(3, int(len(all_eps) * fault_fraction))
    faulty = [all_eps[int(i)] for i in rng.choice(len(all_eps), n_faulty, False)]
    third = max(1, n_faulty // 3)
    faults = []

    def window(day, hour, dur, prob=100):
        return {
            "startTime": {"day": day, "hour": hour},
            "durationHours": dur,
            "probabilityPercent": prob,
        }

    # (a) recurring nightly error windows — periodic, learnable, invisible
    # to persistence at onset
    for eid in faulty[:third]:
        hour = int(rng.integers(1, 20))
        faults.append(
            {
                "type": "increase-error-rate",
                "targets": {"services": [], "endpoints": [{"endpointId": eid}]},
                "timePeriods": [window(d, hour, 3) for d in range(1, days + 1)],
                "increaseErrorRatePercent": int(rng.integers(50, 85)),
            }
        )
    # (b) overlapping multi-endpoint incidents: one window, several
    # endpoints at once (correlated failures along the graph)
    incident_eps = faulty[third : 2 * third]
    for i in range(0, len(incident_eps), 3):
        group = incident_eps[i : i + 3]
        day = int(rng.integers(1, days + 1))
        hour = int(rng.integers(0, 20))
        faults.append(
            {
                "type": "increase-error-rate",
                "targets": {
                    "services": [],
                    "endpoints": [{"endpointId": e} for e in group],
                },
                "timePeriods": [window(day, hour, int(rng.integers(2, 5)))],
                "increaseErrorRatePercent": int(rng.integers(50, 80)),
            }
        )
    # (c) probabilistic recurring latency faults (drifting severity)
    for eid in faulty[2 * third :]:
        hour = int(rng.integers(0, 20))
        faults.append(
            {
                "type": "increase-latency",
                "targets": {"services": [], "endpoints": [{"endpointId": eid}]},
                "timePeriods": [
                    window(d, hour, 2, prob=70) for d in range(1, days + 1)
                ],
                "increaseLatencyMs": int(rng.integers(150, 400)),
            }
        )
    # (d) gateway traffic bursts -> overload errors downstream
    for eid in ep_ids[0][: max(1, len(ep_ids[0]) // 4)]:
        day = int(rng.integers(1, days + 1))
        faults.append(
            {
                "type": "inject-traffic",
                "targets": {"services": [], "endpoints": [{"endpointId": eid}]},
                "timePeriods": [window(day, int(rng.integers(8, 16)), 2)],
                "increaseRequestCount": 4000,
            }
        )

    config = {
        "servicesInfo": [{"namespace": "mesh", "services": services}],
        "endpointDependencies": dependencies,
        "loadSimulation": {
            "config": {
                "simulationDurationInDays": days,
                "overloadErrorRateIncreaseFactor": 3,
            },
            "serviceMetrics": [],
            "endpointMetrics": endpoint_metrics,
            "faultInjection": faults,
        },
    }
    return yaml.safe_dump(config, sort_keys=False)



class SimulatorApp:
    """Phase 21 (e): the application in simulator mode, started through
    its main() over a fresh FileStore, and a thread that POSTs the YAML to
    startSimulation and then reads the routes, while the phase goes on
    with (a)-(d) in this process. result() waits for the thread, checks
    the answers, stops the application (SIGTERM: it clears its store and
    exits 0) and returns the walls."""

    ROUTES = (
        ("graph", f"/api/v1/graph/dependency/endpoint/{SIM_NAMESPACE}"),
        ("static_config", "/api/v1/simulation/generateStaticSimConfig"),
        ("export", "/api/v1/data/export"),
    )

    def __init__(self, yaml_text: str, root: str) -> None:
        import threading

        self.store = os.path.join(root, "store")
        os.makedirs(self.store)
        port = free_port()
        self.served = Served(
            "kmamiz_tpu_torch.api.app",
            {"SIMULATOR_MODE": "true", "PORT": str(port), "STORAGE_URI": f"file://{self.store}"},
            port,
            "/api/v1/health/",
            os.path.join(root, "app.log"),
        )
        self.out: dict = {"boot_ms": self.served.boot_ms}
        self.bodies: dict = {}
        self.error = None
        self.thread = threading.Thread(target=self._drive, args=(yaml_text.encode(),), daemon=True)
        self.thread.start()

    def _drive(self, body: bytes) -> None:
        try:
            port = self.served.port
            t0 = time.perf_counter()
            status, answer = http_json(port, "/api/v1/simulation/startSimulation", body, timeout=900)
            self.out["start_simulation"] = {
                "status": status,
                "answer": answer,
                "ms": (time.perf_counter() - t0) * 1e3,
            }
            for key, path in self.ROUTES:
                status, self.bodies[key], ms = get_route(port, path)
                self.out[key] = {"status": status, "ms": ms}
        except Exception as e:  # noqa: BLE001 - raised in result()
            self.error = e

    def result(self, n_endpoints: int) -> dict:
        import signal

        from kmamiz_tpu_torch.server.import_export import ImportExportHandler
        from kmamiz_tpu_torch.server.storage import COLLECTIONS, store_from_uri

        try:
            self.thread.join(timeout=900)
            check(not self.thread.is_alive(), "startSimulation did not answer in 900 s")
            if self.error is not None:
                raise self.error
        finally:
            code = self.served.stop(signal.SIGTERM)
        out = self.out
        start = out["start_simulation"]
        check(start["status"] == 201 and start["answer"] == {"message": "ok"}, f"startSimulation answered {start}")
        for key, _path in self.ROUTES:
            check(out[key]["status"] == 200, f"{key} answered {out[key]['status']}")
        nodes = self.bodies["graph"]["nodes"]
        out["graph_nodes"] = len(nodes)
        check(len(nodes) > n_endpoints, f"the endpoint graph has {len(nodes)} nodes")
        check(self.bodies["static_config"]["staticYamlStr"].startswith("servicesInfo"), "the static config")
        out["static_config_bytes"] = len(self.bodies["static_config"]["staticYamlStr"])
        pairs = dict(ImportExportHandler.read_tgz(self.bodies["export"]))
        out["export_bytes"] = len(self.bodies["export"])
        out["dependencies"] = len(pairs["EndpointDependencies"])
        out["simulated_historical"] = len(pairs["SimulatedHistoricalData"])
        check(out["dependencies"] == n_endpoints, f"EndpointDependencies holds {out['dependencies']} endpoints")
        check(out["simulated_historical"] > 0, "SimulatedHistoricalData is empty")
        out["exit_code"] = code
        check(code == 0, f"the application exited {code}: {self.served.tail()}")
        # simulator mode keeps nothing in its store past its exit
        store = store_from_uri(f"file://{self.store}")
        kept = {c: len(store.find_all(c)) for c in COLLECTIONS if store.find_all(c)}
        check(not kept, f"the store kept {kept}")
        return out


def simulation_dataset(result) -> dict:
    """(a)'s counts: endpoints, distance-1 edges, slots, the realtime rows of
    each slot."""
    deps = result.endpoint_dependencies
    edges = sum(1 for d in deps for on in d.get("dependingOn", []) if on.get("distance") == 1)
    rows = [len(v) for v in result.realtime_data_per_slot.values()]
    return {
        "endpoints": len(deps),
        "edges": edges,
        "slots": len(rows),
        "rows_per_slot": {"min": min(rows), "mean": sum(rows) / len(rows), "max": max(rows)},
        "realtime_rows": sum(rows),
    }


def simulate(torch, device, counters, jobs) -> dict:
    """Phase 21, the simulator at BASELINE.json's synthetic mesh (1,000
    services x 10 endpoints, fault fraction 0.08, seed 0, 1 simulated day):
    (a) Simulator.generate_simulation_data on the host; (b) GraphSAGE
    through trainer.train_on_simulation on the card (hidden 64, 8 epochs),
    its launches against the steps, its first-epoch loss against a CPU
    copy's (rtol 1e-3); (c) GAT on the same dataset (no kernel launch);
    (d) (b)'s params saved and restored through models/checkpoint.py, and
    the restored forward on the card against the trained one; (e) the
    application in simulator mode (SimulatorApp), beside (a)-(d); (f)
    kernel 2 at (b)'s buckets against its plain version."""
    import numpy as np

    from kmamiz_tpu_torch.models import stacked
    from kmamiz_tpu_torch.ops import sparse
    from kmamiz_tpu_torch.simulator import Simulator

    root = tempfile.TemporaryDirectory(prefix="chip_smoke_sim_")
    app = None
    out: dict = {
        "services": SIM_SERVICES,
        "endpoints_per_service": SIM_ENDPOINTS_PER_SERVICE,
        "days": SIM_DAYS,
        "fault_fraction": SIM_FAULT_FRACTION,
    }
    try:
        yaml_text = make_mesh_config(
            SIM_SERVICES, SIM_ENDPOINTS_PER_SERVICE, SIM_DAYS, np.random.default_rng(SEED), SIM_FAULT_FRACTION
        )
        out["yaml_bytes"] = len(yaml_text)
        app = SimulatorApp(yaml_text, root.name)

        # (a) the simulation, on the host
        t0 = time.perf_counter()
        result = Simulator().generate_simulation_data(yaml_text, SIM_DATE_MS, rng=np.random.default_rng(SEED))
        out["simulation_s"] = time.perf_counter() - t0
        check(not result.validation_error_message, result.validation_error_message)
        check(not result.converting_error_message, result.converting_error_message)
        out.update(simulation_dataset(result))
        n_endpoints = SIM_SERVICES * SIM_ENDPOINTS_PER_SERVICE
        check(out["endpoints"] == n_endpoints, f"{out['endpoints']} endpoints")
        check(out["slots"] == 24 * SIM_DAYS, f"{out['slots']} slots")
        log("   (a) " + json.dumps(out))

        # (b)-(d), making no plain-version call on card tensors
        args = (result.endpoint_dependencies, result.realtime_data_per_slot, result.replica_counts)
        with PlainOnCard(torch, sparse) as plain:
            train_set = train_simulated(torch, device, counters, args, os.path.join(root.name, "ckpt"), out)
        check(plain.calls == 0, f"{plain.calls} plain calls on card tensors in (b)-(d)")
        out["plain_calls_on_card"] = plain.calls

        # (f) kernel 2 at (b)'s buckets
        out["kernels"] = simulated_kernel_cases(torch, sparse, stacked.stack_dataset(train_set, device), jobs)

        # (e) the application's answers
        out["app"] = app.result(n_endpoints)
        log("   (e) " + json.dumps(out["app"]))
    finally:
        if app is not None and "app" not in out:
            app.served.kill()
        root.cleanup()
    return out


def train_simulated(torch, device, counters, args, ckpt_dir: str, out: dict):
    """Phase 21 (b)-(d) on the simulator's output `args` (dependencies,
    realtime data per slot, replica counts), into `out`; returns the
    training slots' dataset."""
    import numpy as np

    from kmamiz_tpu_torch.models import checkpoint as ckpt
    from kmamiz_tpu_torch.models import gat, graphsage, stacked, trainer
    from kmamiz_tpu_torch.ops import sparse

    # (b) GraphSAGE on the card
    t0 = time.perf_counter()
    dataset = trainer.dataset_from_simulation(*args)
    out["dataset_s"] = time.perf_counter() - t0
    train_set, eval_set = trainer.temporal_split(dataset, SIM_TRAIN_FRACTION)
    train_slots, eval_slots = len(train_set.features), len(eval_set.features)
    steps = train_slots * SIM_EPOCHS
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sage, metrics, _ = trainer.train_on_simulation(
        *args, train_fraction=SIM_TRAIN_FRACTION, epochs=SIM_EPOCHS, hidden=SIM_HIDDEN, seed=SEED, device=device
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(torch, counters)
    losses = sage.losses
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    # the forwards: two a step, two a slot in calibrate_threshold and in
    # evaluate; the backward: one C call a step, the ungated row pass
    forwards = 2 * (steps + train_slots + eval_slots)
    check(launches[sparse.fused_sddmm_spmm.__name__] == forwards, f"forward launches {launches}, want {forwards}")
    check(launches[sparse.fused_backward.__name__] == steps, f"backward calls {launches}, want {steps}")
    check(launches[sparse.fused_sddmm_spmm_grad_rows.__name__] == steps, f"row-pass launches {launches}")
    check(launches[sparse.fused_sddmm_spmm_grad_edges.__name__] == 0, f"gated backward in GraphSAGE {launches}")
    t0 = time.perf_counter()
    cpu = trainer.train_on_simulation(
        *args, train_fraction=SIM_TRAIN_FRACTION, epochs=SIM_CPU_EPOCHS, hidden=SIM_HIDDEN, seed=SEED, device="cpu"
    )[0]
    cpu_s = time.perf_counter() - t0
    np.testing.assert_allclose(losses[0], cpu.losses[0], rtol=1e-3, err_msg="first-epoch loss, card against CPU")
    out["train"] = {
        "train_slots": train_slots,
        "eval_slots": eval_slots,
        "epochs": SIM_EPOCHS,
        "hidden": SIM_HIDDEN,
        "steps": steps,
        "wall_s": wall,
        "slots_per_s": steps / wall,
        "losses": losses,
        "launches": launches,
        "threshold": metrics.threshold,
        "metrics": {k: v for k, v in dataclasses.asdict(metrics).items() if k != "per_slot_flagged"},
        "cpu_epochs": SIM_CPU_EPOCHS,
        "cpu_s": cpu_s,
        "cpu_losses": cpu.losses,
        "first_loss_rel_diff": abs(losses[0] - cpu.losses[0]) / abs(cpu.losses[0]),
    }
    log("   (b) " + json.dumps(out["train"]))

    # (c) GAT on the same dataset: no hand-written kernel
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gat_r, gat_metrics, _ = trainer.train_on_simulation(
        *args, train_fraction=SIM_TRAIN_FRACTION, epochs=SIM_GAT_EPOCHS, hidden=SIM_HIDDEN, seed=SEED,
        model=gat, device=device,
    )
    torch.cuda.synchronize()
    gat_wall = time.perf_counter() - t0
    gat_launches = read_counts(torch, counters)
    check(all(math.isfinite(x) for x in gat_r.losses), f"GAT losses {gat_r.losses}")
    check(not any(gat_launches.values()), f"GAT launched {gat_launches}")
    out["gat"] = {
        "epochs": SIM_GAT_EPOCHS,
        "wall_s": gat_wall,
        "slots_per_s": train_slots * SIM_GAT_EPOCHS / gat_wall,
        "losses": gat_r.losses,
        "launches": gat_launches,
        "threshold": gat_metrics.threshold,
        "anomaly_f1": gat_metrics.anomaly_f1,
    }
    log("   (c) " + json.dumps(out["gat"]))

    # (d) (b)'s params through the checkpoint module, forward on the card
    ckpt.save_params(
        ckpt_dir, sage.params, SIM_EPOCHS,
        {"model": "graphsage", "hidden": SIM_HIDDEN, "num_features": graphsage.NUM_FEATURES, "num_nodes": 0},
    )
    restored, meta = ckpt.restore_params(ckpt_dir, graphsage, device=device)
    want = stacked.predict_all(sage.params, eval_set, graphsage)
    got = stacked.predict_all(restored, eval_set, graphsage)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5, err_msg="restored checkpoint's forward")
    out["checkpoint"] = {
        "step": meta["step"],
        "max_abs_diff": max(float(np.abs(a - w).max()) for a, w in zip(got, want)),
    }
    log("   (d) " + json.dumps(out["checkpoint"]))

    return train_set


def simulated_kernel_cases(torch, sparse, st, jobs) -> dict:
    """Phase 21 (f): kernel 2 on the simulated mesh's edge list at the
    buckets the training stacked it to (st: models/stacked.StackedDataset):
    the edge index against its plain build; the forward, ungated, at the
    simulator's feature width (10), the served width (18) and the hidden
    width (64); the ungated row pass at 64, GraphSAGE's one backward."""
    import numpy as np

    src, dst, mask, n = st.src, st.dst, st.edge_mask, st.bucket_nodes
    index = st.index
    check_edge_index(torch, sparse, src, dst, mask, n, index)
    out_deg = torch.zeros(n, dtype=torch.int64, device=src.device)
    in_deg = torch.zeros_like(out_deg)
    live_src, live_dst = src[mask].long(), dst[mask].long()
    out_deg.index_add_(0, live_src, torch.ones_like(live_src))
    in_deg.index_add_(0, live_dst, torch.ones_like(live_dst))
    real = slice(0, st.num_nodes)
    layout = {
        "layout": st.layout(),
        "live_edges": int(mask.sum()),
        "no_in_edges": int((in_deg[real] == 0).sum()),
        "no_out_edges": int((out_deg[real] == 0).sum()),
        "isolated": int(((in_deg[real] + out_deg[real]) == 0).sum()),
    }
    log("   (f) " + json.dumps(layout))
    rng = np.random.default_rng(SEED + 3)

    def table(h):
        return torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32)).to(src.device)

    forward = [
        fused_case(torch, sparse, f"simulated mesh forward H = {h}", table(h), src, dst, mask, (), index, jobs)
        for h in (10, 18, 64)
    ]
    backward = [
        ungated_rows_case(
            torch, sparse, "simulated mesh backward H = 64 (ungated)", src, dst, mask, n, index,
            table(64), table(64), jobs,
        )
    ]
    return {**layout, "forward": forward, "backward": backward}


TENANTS = tuple(f"t{i}" for i in range(8))  # BASELINE split into eight clusters
TENANT_SERVICES = BASELINE["n_services"] // len(TENANTS)  # 125 services x 10 urls each
TENANT_TRACES = STATE_TRACES // len(TENANTS)  # phase 4's 150,000 traces split eight ways
TENANT_TICK_TRACES = TICK_TRACES // len(TENANTS)  # a round carries one BASELINE tick
TENANT_ROUNDS = 4
GATHER_WINDOW_MS = 50.0
TENANT_HOUR = 950  # the rounds' hour; (d) folds it and the next
SCENARIO = ("multi-tenant-mix", 0, 2, 12)  # build_scenario(archetype, seed, index, ticks)
SCENARIO_HOUR = 970
#: the scenario tenants' trace-bomb cap: under chaos.mutate_payload's bomb
#: (~4.1 KB), so every poison-storm bomb trips it (the JAX runner's
#: POISON_SIZE_CAP)
SCENARIO_PAYLOAD_CAP = 4000


def tenant_spec(n_traces: int, t_start: int, prefix: str) -> dict:
    """synth.make_raw_window's arguments of a tenant's window: the
    BASELINE generator over 125 services x 10 urls in one namespace."""
    return dict(
        n_traces=n_traces,
        spans_per=SPANS_PER_TRACE,
        t_start=t_start,
        n_services=TENANT_SERVICES,
        n_namespaces=1,
        urls_per_service=BASELINE["urls_per_service"],
        trace_prefix=prefix,
    )


def in_namespace(i: int, raw: bytes) -> bytes:
    """A tenant_spec window moved into tenant t<i>'s own namespace."""
    return raw.replace(b"ns0", f"ns-{TENANTS[i]}".encode())


def tenant_window(i: int, n_traces: int, t_start: int, prefix: str) -> bytes:
    """Tenant t<i>'s raw Zipkin window, made in this process."""
    return in_namespace(i, _raw_window(tenant_spec(n_traces, t_start, prefix)))


def post_as_tenant(port: int, tenant: str, request: dict, by_header: bool) -> tuple:
    """(status, answer, X-KMamiz-Control header, wall ms) of a DP tick
    posted for `tenant`: by its /t/<tenant>/ route, or by the tenant
    header."""
    path = "/" if by_header else f"/t/{tenant}/"
    headers = {"Content-Type": "application/json", "Accept-Encoding": "gzip"}
    if by_header:
        headers["x-kmamiz-tenant"] = tenant
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(request).encode(), headers=headers, method="POST"
    )
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            status, body, header = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        status, body, header = e.code, e.read(), e.headers
    if header.get("Content-Encoding") == "gzip":
        body = gzip.decompress(body)
    wall = (time.perf_counter() - t0) * 1e3
    return status, json.loads(body), header.get("X-KMamiz-Control"), wall


def post_round(port: int, posts) -> tuple:
    """Every (tenant, request, by_header) of `posts` at once, each on a
    thread of its own released together; returns ({tenant: post's
    result}, the round's wall in ms)."""
    import gc
    import threading

    # a collection of the process's older generations inside the gather
    # window would hold arrivals back past it: collect before the round
    gc.collect()
    out, gate = {}, threading.Barrier(len(posts) + 1)

    def run(tenant, request, by_header):
        gate.wait()
        out[tenant] = post_as_tenant(port, tenant, request, by_header)

    threads = [threading.Thread(target=run, args=p) for p in posts]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    return out, (time.perf_counter() - t0) * 1e3


def install_stlgt_head(torch, device) -> str:
    """The STLGT head the control plane forecasts with: phase 12's
    continual trainer when it ran; otherwise the process trainer takes two
    seeded fold snapshots, as phase 12's folds feed it, and refreshes once."""
    import numpy as np

    from kmamiz_tpu_torch.models import stlgt as stlgt_pkg

    if stlgt_pkg.serving_params() is not None:
        return "phase 12"
    rng = np.random.default_rng(SEED)
    n, e = 256, 1024
    src, dst = rng.integers(0, n, e).astype(np.int32), rng.integers(0, n, e).astype(np.int32)
    trainer = stlgt_pkg.get_trainer(device)
    for hour in range(2):
        feats = (rng.random((n, SAGE_FEATURES)) * 0.5).astype(np.float32)
        trainer.observe_fold(
            {
                "features": feats,
                "src": src,
                "dst": dst,
                "mask": np.ones(e, dtype=bool),
                "names": [f"svc{k}\tns\tlatest\tGET\t/api/{k}" for k in range(n)],
                "predicted_hour": hour + 1,
                "cache_key": (1, 0, hour),
            }
        )
    check(stlgt_pkg.serving_params() is not None, "the STLGT head did not refresh")
    return "seeded folds"


def serve_tenancy(torch, device, counters, jobs) -> dict:
    """Phase 22, multi-tenant serving: (a) eight tenants of 125 services x
    10 urls, each loaded with 18,750 raw traces, in one capacity bucket;
    (b) four gathered rounds through a DataProcessorServer (gather window
    50 ms): the eight post at once (t0-t3 by /t/<tenant>/, t4-t7 by the
    tenant header), one stacked merge of 8 lanes and 16 segment-stats
    launches a round; (c) eight serial twins on the card and two CPU
    replays against them; the batched scorers against the twins'; (d) the
    control plane on the card: t0 and t1 fold two hours with the live STLGT
    head (one gated kernel-2 launch a fold), defer, high priority and shed;
    (e) the scenario factory's multi-tenant-mix through a second server
    with the WAL on: beta's poison storm in beta's quarantine only,
    alpha's graph equal to a clean serial run, a restart replaying each
    tenant's namespace."""
    import numpy as np

    from kmamiz_tpu_torch import control, scenarios
    from kmamiz_tpu_torch.graph.store import _merge_edges, graph_signature
    from kmamiz_tpu_torch.models import stlgt as stlgt_pkg
    from kmamiz_tpu_torch.models.stlgt import serving as stlgt_serving
    from kmamiz_tpu_torch.ops import segment_stats as ss
    from kmamiz_tpu_torch.ops import sparse
    from kmamiz_tpu_torch.scenarios import runner as scn_runner
    from kmamiz_tpu_torch.scenarios import storyline, topology
    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer, _make_runtime
    from kmamiz_tpu_torch.server.processor import DataProcessor
    from kmamiz_tpu_torch.tenancy import TickRouter, batch, default_arena

    seg, fused = ss.segment_stats.__name__, sparse.fused_sddmm_spmm.__name__
    out: dict = {"tenants": len(TENANTS), "services_per_tenant": TENANT_SERVICES, "gather_window_ms": GATHER_WINDOW_MS}
    launches = {c.__name__: 0 for c in counters}

    def add_launches(got):
        for k, v in got.items():
            launches[k] += v

    # (a) eight tenants and their twins from the same raw state
    t0 = time.perf_counter()
    feeds = {t: TickFeed() for t in TENANTS}
    twin_feeds = {t: TickFeed() for t in TENANTS}
    procs, twins = {}, {}
    state_raw = {
        t: in_namespace(i, raw)
        for i, (t, raw) in enumerate(
            zip(TENANTS, raw_windows(tenant_spec(TENANT_TRACES, 0, f"{t}-state-") for t in TENANTS))
        )
    }
    for t in TENANTS:
        procs[t] = DataProcessor(trace_source=feeds[t], device=device, wal=None, tenant=t)
        twins[t] = DataProcessor(trace_source=twin_feeds[t], device=device, wal=None, tenant=f"twin-{t}")
        for proc in (procs[t], twins[t]):
            proc.ingest_raw_window(state_raw[t])
    arena = default_arena()
    buckets = {cap: [t for t in members if t in TENANTS] for cap, members in arena.buckets().items()}
    buckets = {cap: m for cap, m in buckets.items() if m}
    per_tenant = {
        t: {"endpoints": len(procs[t].graph.interner.endpoints), "edges": procs[t].graph.n_edges} for t in TENANTS
    }
    out["load_s"] = time.perf_counter() - t0
    out["bucket"] = next(iter(buckets)) if len(buckets) == 1 else sorted(buckets)
    out["per_tenant"] = per_tenant
    by_tenant = arena.arena_bytes_by_tenant()
    out["arena_bytes"] = sum(by_tenant[t] for t in TENANTS)
    log("   (a) " + json.dumps(out))
    check(len(buckets) == 1 and sorted(next(iter(buckets.values()))) == list(TENANTS), f"buckets {buckets}")
    check(
        sum(p["endpoints"] for p in per_tenant.values()) == PROD_ENDPOINTS,
        f"{sum(p['endpoints'] for p in per_tenant.values())} endpoints in all",
    )
    for t in TENANTS:
        check(graph_signature(procs[t].graph) == graph_signature(twins[t].graph), f"{t}'s twin differs at load")

    cpu_feeds = {t: TickFeed() for t in TENANTS[:2]}
    cpu_replays = {t: DataProcessor(trace_source=cpu_feeds[t], device="cpu", wal=None, tenant=f"cpu-{t}") for t in TENANTS[:2]}
    for t, cpu in cpu_replays.items():
        cpu.ingest_raw_window(state_raw[t])
    del state_raw

    router = TickRouter(lambda t: _make_runtime(t, procs[t]), batch_window_ms=GATHER_WINDOW_MS)
    router.keep_inputs = True
    default = DataProcessor(trace_source=TickFeed(), device=device, wal=None)
    server = DataProcessorServer(default, host="127.0.0.1", port=0, router=router)
    server.start()
    rounds = []
    try:
        # every tenant's runtime made (and its route served) before the rounds
        for t in TENANTS:
            status, health = http_json(server.port, f"/t/{t}/")
            check(status == 200 and health["tenant"] == t, f"{t}'s health answered {status}")
        # (b) gathered rounds, (c) the references after each
        for r in range(TENANT_ROUNDS):
            request = {"uniqueId": f"round{r}", "lookBack": 30_000, "time": TENANT_HOUR * HOUR_MS + r}
            windows = {}
            for i, t in enumerate(TENANTS):
                start = TENANT_TRACES + (r * len(TENANTS) + i) * TENANT_TICK_TRACES
                windows[t] = json.loads(tenant_window(i, TENANT_TICK_TRACES, start, f"{t}-r{r}-"))
                feeds[t].groups = twin_feeds[t].groups = windows[t]
            before = router.stats()
            zero_counts(counters)
            answers, round_ms = post_round(
                server.port, [(t, dict(request), i >= 4) for i, t in enumerate(TENANTS)]
            )
            got = read_counts(torch, counters)
            add_launches(got)
            stats = {k: v - before[k] for k, v in router.stats().items()}
            record = {
                "round": r,
                "wall_ms": round(round_ms, 3),
                "tick_walls_ms": {t: round(answers[t][3], 3) for t in TENANTS},
                "launches": got[seg],
                "stacked_lanes": stats["stackedLanes"],
                "drift_remerges": stats["driftRemerges"],
                "merge_ms": round(router.last_batch_merge_ms, 3),
            }
            log("   (b) " + json.dumps(record))
            for t in TENANTS:
                status, body, _h, wall = answers[t]
                check(status == 200, f"round {r}: {t} answered {status}")
                check_response(body, f"round{r}")
                check(wall < TICK_WALL_LIMIT_MS, f"round {r}: {t}'s tick took {wall:.1f} ms")
            check(stats["batches"] == 1 and stats["stackedMerges"] == 1, f"round {r}: {stats}")
            check(stats["stackedLanes"] == len(TENANTS), f"round {r}: {stats['stackedLanes']} lanes")
            check(stats["serialMerges"] == stats["driftRemerges"], f"round {r}: non-drift serial merges {stats}")
            check(got[seg] == 2 * len(TENANTS), f"round {r}: segment_stats launched {got[seg]} times")
            # (c) the serial twins (gather window 0) and the CPU replays
            for t in TENANTS:
                want = twins[t].collect(dict(request))
                compare_ticks(answers[t][1], want)
                check(graph_signature(procs[t].graph) == graph_signature(twins[t].graph), f"round {r}: {t} differs from its twin")
            for t, cpu in cpu_replays.items():
                cpu_feeds[t].groups = windows[t]
                cpu.collect(dict(request))
                for got_col, want_col in zip(procs[t].graph.edge_arrays(), cpu.graph.edge_arrays()):
                    check(torch.equal(got_col.cpu(), want_col), f"round {r}: {t}'s edges differ from the CPU's")
            rounds.append(record)
        out["rounds"] = rounds
        out["stacked_bytes"] = arena.stacked_bytes()

        # (c) the batched scorers against each twin's serial scores
        scores, svc_caps = router.batched_service_scores(list(TENANTS))
        exact = ("instability_on", "instability_by", "instability", "ais", "ads", "acs", "is_gateway")
        worst = 0.0
        for lane, t in enumerate(TENANTS):
            want = twins[t].graph.service_scores_uncached()
            n = svc_caps[lane]
            for name, got_f, want_f in zip(scores._fields, scores, want):
                g, w = got_f[lane][:n].cpu().numpy(), want_f[:n].cpu().numpy()
                if name in exact:
                    check(np.array_equal(g, w), f"batched {name} of {t} differs")
                else:
                    check(np.allclose(g, w, rtol=1e-5, atol=0), f"batched {name} of {t} differs")
                    worst = max(worst, float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30))))
        out["batched_scores_rf_max_rel"] = worst

        # the last stacked merge against eight serial merges, on its inputs
        stack_cols, win_cols, counts = router.last_stack_inputs
        serial_inputs = []
        for lane in range(len(TENANTS)):
            n = int(win_cols[3][lane].sum())
            width = 1 << max(0, (n - 1).bit_length())
            serial_inputs.append(
                [c[lane] for c in stack_cols] + [c[lane, :width] for c in win_cols[:3]] + [win_cols[3][lane, :width]]
            )
        stacked_out = batch.batched_merge_edges(*stack_cols, *win_cols)
        for lane, args in enumerate(serial_inputs):
            s, d, ds, v = _merge_edges(*args)
            k = int(v.sum())
            check(k == counts[lane] == int(stacked_out[4][lane]), f"lane {lane}: counts differ")
            for a, b in zip(stacked_out[:3], (s, d, ds)):
                check(torch.equal(a[lane, :k], b[:k]), f"lane {lane}: the stacked union differs from the serial one")
        stacked_case = {"shape": f"stacked merge, {len(TENANTS)} lanes x {int(stack_cols[0].shape[1])} + {int(win_cols[0].shape[1])}"}
        serial_case = {"shape": f"{len(TENANTS)} serial merges"}
        stacked_fn = lambda: batch.batched_merge_edges(*stack_cols, *win_cols)  # noqa: E731
        serial_fn = lambda: [_merge_edges(*args) for args in serial_inputs]  # noqa: E731
        stacked_case["ms"] = cuda_ms(torch, stacked_fn)
        serial_case["ms"] = cuda_ms(torch, serial_fn)
        jobs.append((stacked_case, "device_ms", stacked_fn))
        jobs.append((serial_case, "device_ms", serial_fn))
        out["merge_cases"] = [stacked_case, serial_case]
        log("   (c) " + json.dumps({"scores_rf_max_rel": worst, "merges": out["merge_cases"]}))

        # (d) the control plane on the card
        out["stlgt_head"] = install_stlgt_head(torch, device)
        control.reset_for_tests()
        control.configure(hysteresis=1)
        with env_set(KMAMIZ_CONTROL="1", KMAMIZ_CONTROL_MODE="defer", KMAMIZ_STLGT=None):
            folds = []
            for step, hour in enumerate((TENANT_HOUR + 1, TENANT_HOUR + 2)):
                if step == 1:
                    # t0's SLO well under its forecast p99, t1's well over
                    seen = control.snapshot()["tenants"]
                    control.configure(
                        tenant_slo_ms={
                            "t0": seen["t0"]["forecast_p99_ms"] / 10,
                            "t1": max(seen["t1"]["forecast_p99_ms"] * 10, 1.0),
                        }
                    )
                request = {"uniqueId": f"fold{hour}", "lookBack": 30_000, "time": hour * HOUR_MS}
                for i, t in enumerate(TENANTS[:2]):
                    start = TENANT_TRACES + (TENANT_ROUNDS * len(TENANTS) + step * 2 + i) * TENANT_TICK_TRACES
                    feeds[t].groups = json.loads(tenant_window(i, TENANT_TICK_TRACES, start, f"{t}-h{hour}-"))
                zero_counts(counters)
                answers, wall = post_round(server.port, [(t, dict(request), False) for t in TENANTS[:2]])
                got = read_counts(torch, counters)
                add_launches(got)
                for t in TENANTS[:2]:
                    check(answers[t][0] == 200, f"fold tick of {t} answered {answers[t][0]}")
                check(got[fused] == 2, f"2 folds launched the fused kernel {got[fused]} times")
                check(got[seg] == 4, f"2 fold ticks launched segment_stats {got[seg]} times")
                check(all(procs[t].fold_errors["controlFoldErrors"] == 0 for t in TENANTS[:2]), "control fold errors")
                folds.append({"hour": hour, "wall_ms": round(wall, 3), "launches": got, "control": control.snapshot()["tenants"]})
                log("   (d) " + json.dumps({k: v for k, v in folds[-1].items() if k != "control"}))
            # the view against the same forward on the CPU
            live = stlgt_pkg.serving_params()
            cpu_params = type(live["params"])(*(p.detach().cpu() for p in live["params"]))
            for t in TENANTS[:2]:
                snap = procs[t].forecast_snapshot
                q_ms, _prob, gate = stlgt_serving.quantile_forward(
                    cpu_params, snap["features"], snap["src"], snap["dst"], snap["mask"], live["model"]
                )
                view = control.view_from_forecast(t, q_ms, gate, snap, version=live["version"])
                state = control.snapshot()["tenants"][t]
                check(
                    math.isclose(state["forecast_p99_ms"], view.p99_ms, rel_tol=1e-4, abs_tol=1e-5),
                    f"{t}: card p99 {state['forecast_p99_ms']} against the CPU's {view.p99_ms}",
                )
                slo = control.slo_ms(t)
                cpu_action = "defer" if view.p99_ms > slo else "allow"
                check(state["action"] == cpu_action, f"{t}: action {state['action']} against the CPU's {cpu_action}")
            tenants_state = control.snapshot()["tenants"]
            check(tenants_state["t0"]["action"] == "defer" and not tenants_state["t1"]["active"], f"{tenants_state}")
            out["control_folds"] = folds
            hour = TENANT_HOUR + 2
            verdicts = {}
            feeds["t0"].groups = feeds["t1"].groups = []
            zero_counts(counters)
            status, body, header, _w = post_as_tenant(server.port, "t0", {"uniqueId": "d-low", "lookBack": 30_000, "time": hour * HOUR_MS}, False)
            deferred_launches = read_counts(torch, counters)[seg]
            verdicts["t0_low"] = [status, bool(body.get("deferred")), header]
            check(status == 200 and body.get("deferred") is True and header == "defer", f"t0 low: {verdicts['t0_low']}")
            check(deferred_launches == 0, f"a deferred tick launched segment_stats {deferred_launches} times")
            feeds["t0"].groups = json.loads(tenant_window(0, TENANT_TICK_TRACES, TENANT_TRACES * 3, "t0-high-"))
            status, body, header, _w = post_as_tenant(
                server.port, "t0", {"uniqueId": "d-high", "lookBack": 30_000, "time": hour * HOUR_MS, "priority": "high"}, True
            )
            verdicts["t0_high"] = [status, bool(body.get("deferred")), header]
            check(status == 200 and not body.get("deferred"), f"t0 high: {verdicts['t0_high']}")
            feeds["t1"].groups = json.loads(tenant_window(1, TENANT_TICK_TRACES, TENANT_TRACES * 3, "t1-fresh-"))
            status, body, header, _w = post_as_tenant(server.port, "t1", {"uniqueId": "d-t1", "lookBack": 30_000, "time": hour * HOUR_MS}, False)
            verdicts["t1"] = [status, bool(body.get("deferred")), header]
            check(status == 200 and not body.get("deferred") and not body.get("stale"), f"t1: {verdicts['t1']}")
            with env_set(KMAMIZ_CONTROL_MODE="shed"):
                state = control.snapshot()["tenants"]["t0"]
                control.ingest_forecast(
                    control.ForecastView(tenant="t0", p99_ms=state["forecast_p99_ms"], cost_ms=state["predictedCostMs"])
                )
                status, body, header, _w = post_as_tenant(server.port, "t0", {"uniqueId": "d-shed", "lookBack": 30_000, "time": hour * HOUR_MS}, False)
            verdicts["t0_shed"] = [status, body.get("control", {}).get("action"), header]
            check(status == 429 and header == "shed", f"t0 shed: {verdicts['t0_shed']}")
            out["verdicts"] = verdicts
            log("   (d) " + json.dumps(verdicts))
        control.reset_for_tests()
    finally:
        server.stop()

    out["scenario"] = serve_scenario_tenants(torch, device, scenarios, scn_runner, storyline, topology)
    out["launches"] = launches
    return out


def serve_scenario_tenants(torch, device, scenarios, scn_runner, storyline, topology) -> dict:
    """Phase 22 (e): multi-tenant-mix's alpha and beta windows, tick by
    tick through a gathered DP server with the WAL on; beta's poison-storm
    payloads to /t/beta/ingest; then a restart over the same WAL."""
    from kmamiz_tpu_torch.graph.store import graph_signature
    from kmamiz_tpu_torch.resilience import quarantine
    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer, _make_runtime
    from kmamiz_tpu_torch.server.processor import DataProcessor
    from kmamiz_tpu_torch.tenancy import TickRouter

    DEFAULT_PAYLOAD_CAP = quarantine.MAX_PAYLOAD_BYTES
    spec = scenarios.build_scenario(*SCENARIO)
    plans = {plan.tenant: plan for plan in spec.tenants}
    root = tempfile.TemporaryDirectory(prefix="chip_smoke_tenancy_")
    out: dict = {"spec": spec.name, "signature": scenarios.spec_signature(spec)}

    def boot(cap):
        feeds = {t: TickFeed() for t in plans}

        def factory(tenant):
            proc = DataProcessor(trace_source=feeds[tenant], device=device, tenant=tenant, max_payload_bytes=cap)
            proc.replay_wal()
            return _make_runtime(tenant, proc)

        router = TickRouter(factory, batch_window_ms=GATHER_WINDOW_MS)
        server = DataProcessorServer(
            DataProcessor(trace_source=TickFeed(), device=device, wal=None), host="127.0.0.1", port=0, router=router
        )
        server.start()
        return server, router, feeds

    def windows(plan, tick):
        view = scn_runner._tick_view(plan, tick)
        return topology.tick_groups(
            plan.topology,
            spec.name,
            tick,
            plan.traffic[tick],
            drop_services=frozenset(view["drop"]),
            error_services=frozenset(view["error"]),
            version_of=scn_runner._deploy_version_fn(plan, tick),
            latency_boost_us=view["latency_us"],
        ), view

    q_root = os.path.join(os.environ["KMAMIZ_QUARANTINE_DIR"], "tenants")
    try:
        with env_set(KMAMIZ_WAL="1", KMAMIZ_WAL_DIR=os.path.join(root.name, "wal"), KMAMIZ_CONTROL=None):
            # the live boot caps /ingest payloads so that every bomb trips
            server, router, feeds = boot(SCENARIO_PAYLOAD_CAP)
            ref_feed = TickFeed()
            reference = DataProcessor(trace_source=ref_feed, device=device, wal=None, tenant="alpha-ref")
            poisons = {"delivered": 0, "quarantined": 0}
            t0 = time.perf_counter()
            try:
                for tick in range(spec.n_ticks):
                    request = {"uniqueId": f"scn{tick}", "lookBack": 30_000, "time": SCENARIO_HOUR * HOUR_MS + tick}
                    views = {}
                    for t, plan in plans.items():
                        feeds[t].groups, views[t] = windows(plan, tick)
                    answers, _wall = post_round(server.port, [(t, dict(request), False) for t in plans])
                    for t in plans:
                        check(answers[t][0] == 200, f"tick {tick}: {t} answered {answers[t][0]}")
                    ref_feed.groups = feeds["alpha"].groups
                    reference.collect(dict(request))
                    plan = plans["beta"]
                    for ev in views["beta"]["poisons"]:
                        clean = json.dumps([topology.trace_group(plan.topology, f"{spec.name}-poison", tick, 0)]).encode()
                        for _kind, payload in storyline.poison_payloads_for(ev, plan.topology, tick, clean):
                            status, summary = http_json(server.port, "/t/beta/ingest", payload)
                            poisons["delivered"] += 1
                            poisons["quarantined"] += int(status == 200 and summary.get("quarantined") == 1)
                out["ticks_s"] = time.perf_counter() - t0
                status, timings = http_json(server.port, "/timings")
                check(status == 200 and {"tenancy", "control"} <= set(timings), f"/timings {sorted(timings)}")
                check(sorted(timings["tenancy"]["tenants"]) == ["alpha", "beta"], f"{timings['tenancy']['tenants']}")
                signatures = {t: graph_signature(router.runtime(t).processor.graph) for t in plans}
                out["stacked"] = router.stats()
                for t in plans:
                    router.runtime(t).processor.wal.close()
            finally:
                server.stop()
            out["poisons"] = poisons
            check(poisons["delivered"] > 0 and poisons["quarantined"] == poisons["delivered"], f"poisons {poisons}")
            beta_files = [p for p in os.listdir(os.path.join(q_root, "beta")) if p.endswith(".bin")]
            alpha_dir = os.path.join(q_root, "alpha")
            alpha_files = [p for p in os.listdir(alpha_dir) if p.endswith(".bin")] if os.path.isdir(alpha_dir) else []
            out["quarantine_files"] = {"beta": len(beta_files), "alpha": len(alpha_files)}
            check(len(beta_files) == poisons["delivered"] and not alpha_files, f"quarantine {out['quarantine_files']}")
            check(signatures["alpha"] == graph_signature(reference.graph), "alpha differs from its clean serial run")
            check(out["stacked"]["stackedMerges"] > 0, f"no stacked merge: {out['stacked']}")
            # the restart: each tenant replays its own WAL namespace (the
            # default cap: the logged tick windows are larger than the
            # live boot's)
            t0 = time.perf_counter()
            server, router, _feeds = boot(DEFAULT_PAYLOAD_CAP)
            try:
                for t in plans:
                    status, health = http_json(server.port, f"/t/{t}/")
                    check(status == 200 and health["tenant"] == t, f"restart: {t} answered {status}")
                    check(graph_signature(router.runtime(t).processor.graph) == signatures[t], f"restart: {t}'s replay differs")
                    router.runtime(t).processor.wal.close()
            finally:
                server.stop()
            out["restart_s"] = time.perf_counter() - t0
            out["tenant_quarantine"] = {t: s["count"] for t, s in quarantine.tenant_quarantine_stats().items()}
    finally:
        root.cleanup()
    log("   (e) " + json.dumps(out))
    return out


def write_report(path, report) -> None:
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(report, f, indent=1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--report", help="also write the full report as JSON here")
    parser.add_argument(
        "--kernels-only",
        action="store_true",
        help="phases 1-6 only (card, build, the kernel checks with the state "
        "load they need), then the report: for timing two checkouts on one card",
    )
    parser.add_argument(
        "--zeroing",
        action="store_true",
        help="phases 1-3, then the segment-stats kernel's zeroing prologue timed "
        "against a cudaMemsetAsync before a plain launch, then the report",
    )
    parser.add_argument(
        "--backward-of",
        metavar="DIR",
        help="phase 1, then the fused kernel's backward of the port checked out at "
        "DIR (. for this one) timed through the wrapper API that every checkout "
        "since port PR 4 shares, then the report: for the host work of two "
        "checkouts on one card, one process each, in turns",
    )
    parser.add_argument(
        "--backward-variants",
        action="store_true",
        help="phases 1-4, then the backward kernels as shipped timed against "
        "builds with other tuning values (BACKWARD_VARIANTS), then the report",
    )
    parser.add_argument(
        "--telemetry-only",
        action="store_true",
        help="phases 1-2, then phase 20 (telemetry), then the report",
    )
    parser.add_argument(
        "--simulator-only",
        action="store_true",
        help="phases 1-2, then phase 21 (the simulator), then the device times and the report",
    )
    parser.add_argument(
        "--tenancy-only",
        action="store_true",
        help="phases 1-2, then phase 22 (multi-tenant serving), then the device times and the report",
    )
    parser.add_argument(
        "--cluster-only",
        action="store_true",
        help="phases 1-2, then phase 19 (the in-cluster deployment), then the "
        "report: for working on the deployment's path alone",
    )
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.abspath(args.backward_of) if args.backward_of else here)
    from kmamiz_tpu_torch.ops import cuda_build
    from kmamiz_tpu_torch.ops import segment_stats as ss

    from kmamiz_tpu_torch.ops import sparse

    # every kernel: (wrapper, source, TPU kernel it replaces); the two
    # backward kernels are kernel 2's backward (the JAX package has none:
    # it differentiates its XLA formulation)
    fused_src = f"kmamiz_tpu_torch/csrc/{sparse.KERNEL}.cu"
    kernels = [
        (ss.segment_stats, f"kmamiz_tpu_torch/csrc/{ss.KERNEL}.cu", ss.REPLACES),
        (sparse.fused_sddmm_spmm, fused_src, sparse.REPLACES),
        (sparse.fused_sddmm_spmm_grad_edges, fused_src, sparse.REPLACES),
        (sparse.fused_sddmm_spmm_grad_rows, fused_src, sparse.REPLACES),
    ]
    # and the whole backward's C calls (each launches the backward's kernels)
    counters = [k[0] for k in kernels] + [sparse.fused_backward]
    kernel_names = [ss.KERNEL, sparse.KERNEL]
    device = torch.device("cuda")
    # the quarantine (on by default) writes into a directory of the run's,
    # not into the checkout's kmamiz-data
    quarantine_root = tempfile.TemporaryDirectory(prefix="chip_smoke_quarantine_")
    os.environ["KMAMIZ_QUARANTINE_DIR"] = quarantine_root.name
    # and so do the flight artifacts of this process's watchdog trips
    os.environ["KMAMIZ_PROF_FLIGHT_DIR"] = os.path.join(quarantine_root.name, "flight")
    walls: dict = {}
    report: dict = {}
    jobs: list = []  # device times to take after every event timing

    with Phase("card", walls):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            check=True,
        ).stdout.strip().splitlines()[0]
        log(smi)
        report["card"] = smi
        report["torch"] = f"{torch.__version__} cuda {torch.version.cuda}"
        log(f"   torch {report['torch']}, {torch.cuda.get_device_name(0)}")

    if args.backward_of:
        with Phase("build", walls):
            cuda_build.build_all([sparse.KERNEL])
        with Phase("backward", walls):
            report["backward_of"] = {
                "package": os.path.dirname(os.path.dirname(os.path.abspath(sparse.__file__))),
                "cases": backward_of(torch, sparse, jobs),
            }
        with Phase("device times", walls):
            report["profiler_lost_sessions"] = device_times(torch, jobs)
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"backward_of": report["backward_of"]}))
        return 0

    with Phase("build", walls):
        # the host library (g++) builds beside the kernels (nvcc), so that
        # the first served tick's body fold does not pay for it
        from concurrent.futures import ThreadPoolExecutor

        from kmamiz_tpu_torch import native
        from kmamiz_tpu_torch.ops import host_build

        build = {
            "built_in_this_run": not host_build.library_path(native.NAME, native.SOURCES).exists()
        }
        with ThreadPoolExecutor(max_workers=1) as pool:
            host_lib = pool.submit(native.library_path)
            for path in cuda_build.build_all(kernel_names):
                log(f"   built {os.path.relpath(path)}")
            log(f"   built {os.path.relpath(host_lib.result())}")

    if args.telemetry_only:
        from kmamiz_tpu_torch.server.processor import DataProcessor

        feed = TickFeed()
        proc = DataProcessor(trace_source=feed, device=device, wal=None)
        feed.groups = synth_groups(TICK_TRACES, 0, "warm")
        proc.collect({"uniqueId": "warm", "lookBack": 30_000})
        with Phase("telemetry", walls):
            report["telemetry"] = serve_telemetry(torch, device, proc, feed)
        quarantine_root.cleanup()
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"telemetry": report["telemetry"]}))
        return 0

    if args.simulator_only:
        with Phase("simulator", walls):
            report["simulator"] = simulate(torch, device, counters, jobs)
        with Phase("device times", walls):
            report["profiler_lost_sessions"] = device_times(torch, jobs)
        quarantine_root.cleanup()
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"simulator": report["simulator"]}))
        return 0

    if args.tenancy_only:
        with Phase("multi-tenant serving", walls):
            report["tenancy"] = serve_tenancy(torch, device, counters, jobs)
        with Phase("device times", walls):
            report["profiler_lost_sessions"] = device_times(torch, jobs)
        quarantine_root.cleanup()
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"tenancy": {k: v for k, v in report["tenancy"].items() if k != "rounds"}}))
        return 0

    if args.cluster_only:
        with Phase("in-cluster deployment", walls):
            report["in_cluster"] = serve_in_cluster(torch, device, counters)
        quarantine_root.cleanup()
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"in_cluster": {k: v for k, v in report["in_cluster"].items() if k != "ticks"}}))
        return 0

    tick_shape_groups = synth_groups(TICK_TRACES, STATE_TRACES, "shape")
    with Phase("kernel check", walls):
        cases = kernel_cases(torch, device, tick_shape_groups, jobs)
        report["segment_stats_cases"] = cases

    if args.zeroing:
        with Phase("zeroing", walls):
            report["zeroing"] = zeroing_cases(torch, device, tick_shape_groups, jobs)
        with Phase("device times", walls):
            report["profiler_lost_sessions"] = device_times(torch, jobs)
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"zeroing": report["zeroing"]}))
        return 0

    with Phase("state load", walls):
        proc, feed = load_state(device)
        n_eps = len(proc.graph.interner.endpoints)
        n_edges = proc.graph.n_edges
        log(f"   endpoints {n_eps}, edges {n_edges}, capacity {proc.graph.capacity}")
        check(n_eps >= 10_000, f"only {n_eps} endpoints")
        check(n_edges >= 100_000, f"only {n_edges} edges")
        from kmamiz_tpu_torch.graph.store import graph_signature

        report["state"] = {
            "traces": STATE_TRACES,
            "endpoints": n_eps,
            "edges": n_edges,
            # before any tick: phase 15 rebuilds this graph from raw bytes
            "signature": graph_signature(proc.graph),
        }

    if args.backward_variants:
        with Phase("backward variants", walls):
            report["backward_variants"] = backward_variants(torch, proc.graph)
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"backward_variants": report["backward_variants"]}))
        return 0

    with Phase("fused kernel check", walls):
        f_cases, report["edge_index"] = fused_cases(torch, proc.graph, jobs)
        report["fused_sddmm_spmm_cases"] = f_cases

    with Phase("backward kernel check", walls):
        rows_cases, edges_cases, report["backward"] = backward_cases(torch, proc.graph, jobs)
        report["fused_sddmm_spmm_grad_rows_cases"] = rows_cases
        report["fused_sddmm_spmm_grad_edges_cases"] = edges_cases

    if args.kernels_only:
        with Phase("device times", walls):
            report["profiler_lost_sessions"] = device_times(torch, jobs)
        report["walls_s"] = walls
        write_report(args.report, report)
        log(
            json.dumps(
                {
                    "segment_stats": cases,
                    "fused_sddmm_spmm": f_cases,
                    "edge_index": report["edge_index"],
                    "grad_rows": rows_cases,
                    "grad_edges": edges_cases,
                    "backward": report["backward"],
                }
            )
        )
        return 0

    with Phase("serve ticks", walls):
        timings, launches = serve_ticks(
            torch, proc, feed, counters, STATE_TRACES + TICK_TRACES
        )
        report["ticks"] = timings
        report["launches"] = launches
        log(f"   launches {launches}")
        check(
            launches[ss.segment_stats.__name__] == 2 * TICKS,
            f"segment_stats launched {launches[ss.segment_stats.__name__]} times in {TICKS} ticks",
        )
        report["max_tick_wall_ms"] = max(t["wall_ms"] for t in timings)
        check(
            report["max_tick_wall_ms"] < TICK_WALL_LIMIT_MS,
            f"a served tick took {report['max_tick_wall_ms']} ms",
        )
        report["edges_after_ticks"] = proc.graph.n_edges

    with Phase("card against cpu", walls):
        report["compare"] = card_against_cpu(
            proc, device, STATE_TRACES + (TICKS + 1) * TICK_TRACES
        )
        log("   " + json.dumps(report["compare"]))

    with Phase("forecast", walls):
        report["forecast"], fproc, served, card_stlgt = serve_forecast(
            torch, proc.graph, device, counters, STATE_TRACES + (TICKS + 2) * TICK_TRACES
        )
        log("   " + json.dumps(report["forecast"]))
        forecast_launches = {
            name: sum(step[name] for step in report["forecast"]["launches"].values())
            for name in launches
        }

    with Phase("forecast card against cpu", walls):
        report["forecast_compare"] = forecast_card_against_cpu(torch, fproc, served, card_stlgt)
        log("   " + json.dumps(report["forecast_compare"]))

    ckpt_root = tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_")
    ckpt_dir = ckpt_root.name
    with Phase("graphsage training", walls), PlainOnCard(torch, sparse) as plain_calls:
        report["train"] = train_graphsage(torch, proc.graph, device, counters, ckpt_dir)
        train_launches = report["train"]["launches"]
        log("   " + json.dumps({k: v for k, v in report["train"].items() if k != "profile_epoch"}))
        report["train_serve"] = serve_trained_checkpoint(torch, fproc, counters, ckpt_dir)
        log("   served " + json.dumps(report["train_serve"]))

    with Phase("stlgt continual training", walls), PlainOnCard(torch, sparse) as stlgt_plain_calls:
        sproc, sfeed, report["stlgt"] = serve_stlgt(
            torch, proc.graph, device, counters, STATE_TRACES + (TICKS + 5) * TICK_TRACES, ckpt_dir
        )
        stlgt_launches = report["stlgt"]["launches"]
        log("   " + json.dumps({k: v for k, v in report["stlgt"].items() if k != "ticks"}))
    # the training paths on the card ran the kernels, never a plain version
    check(plain_calls.calls == 0, f"{plain_calls.calls} plain calls on card tensors in training")
    check(stlgt_plain_calls.calls == 0, f"{stlgt_plain_calls.calls} plain calls on card tensors (STLGT)")
    report["plain_calls_on_card"] = {"graphsage": plain_calls.calls, "stlgt": stlgt_plain_calls.calls}

    with Phase("graph scorers", walls):
        # the scorer phase's processors fold no hour: no STLGT hook
        stlgt_env = os.environ.pop("KMAMIZ_STLGT", None)
        try:
            report["scorers"] = serve_scorers(
                torch, proc, feed, device, STATE_TRACES + (TICKS + 12) * TICK_TRACES, jobs
            )
        finally:
            if stlgt_env is not None:
                os.environ["KMAMIZ_STLGT"] = stlgt_env

    # phase 15 runs here, before phase 14's profiler sessions (which slow
    # every later launch on the host) and the device times
    with Phase("raw ingest", walls):
        report["raw_ingest"], raw_cases, raw = raw_ingest(
            torch, device, counters, report["state"], report["ticks"], build, jobs
        )

    # phase 16 too: the same window, streamed
    with Phase("streaming ingest", walls):
        report["stream_ingest"] = stream_ingest(
            torch, device, counters, report["raw_ingest"]["one_shot"], raw
        )
        del raw

    # phases 17 and 18 too: the application, then the GAT head (whose own
    # profiler session comes last in it)
    with Phase("application", walls):
        # boot 1 folds an hour: without the STLGT hook, as in phase 13
        stlgt_env = os.environ.pop("KMAMIZ_STLGT", None)
        try:
            report["application"] = serve_application(
                torch, device, counters, STATE_TRACES + (TICKS + 30) * TICK_TRACES
            )
        finally:
            if stlgt_env is not None:
                os.environ["KMAMIZ_STLGT"] = stlgt_env
        log("   " + json.dumps({k: v for k, v in report["application"].items() if k not in ("ticks", "routes")}))

    with Phase("gat", walls):
        report["gat"] = train_gat(torch, proc.graph, device, counters, fproc, os.path.join(ckpt_dir, "gat"))
        log("   " + json.dumps(report["gat"]))

    # phase 19, before phase 14's profiler sessions too
    with Phase("in-cluster deployment", walls):
        stlgt_env = os.environ.pop("KMAMIZ_STLGT", None)
        try:
            report["in_cluster"] = serve_in_cluster(torch, device, counters)
        finally:
            if stlgt_env is not None:
                os.environ["KMAMIZ_STLGT"] = stlgt_env

    # phase 20 too: its capture runs in a DP process of its own
    with Phase("telemetry", walls):
        report["telemetry"] = serve_telemetry(torch, device, proc, feed)

    # and phase 21, the simulator
    with Phase("simulator", walls):
        report["simulator"] = simulate(torch, device, counters, jobs)

    # and phase 22, multi-tenant serving (its control folds use phase 12's
    # STLGT head)
    with Phase("multi-tenant serving", walls):
        stlgt_env = os.environ.pop("KMAMIZ_STLGT", None)
        try:
            report["tenancy"] = serve_tenancy(torch, device, counters, jobs)
        finally:
            if stlgt_env is not None:
                os.environ["KMAMIZ_STLGT"] = stlgt_env
        tenancy_launches = report["tenancy"]["launches"]

    with Phase("profile", walls):
        report["profile"] = profile_tick(
            torch, proc, feed, STATE_TRACES + (TICKS + 4) * TICK_TRACES, kernel_names
        )
        log("   " + json.dumps(report["profile"]))
        report["profile_forecast"] = profile_forecast(torch, fproc, kernel_names)
        log("   " + json.dumps(report["profile_forecast"]))
        report["profile_fold"] = profile_fold(
            torch, sproc, sfeed, STATE_TRACES + (TICKS + 5 + len(STLGT_HOURS)) * TICK_TRACES, kernel_names
        )
        log("   " + json.dumps(report["profile_fold"]))
    ckpt_root.cleanup()

    with Phase("device times", walls):
        report["profiler_lost_sessions"] = device_times(torch, jobs)
    quarantine_root.cleanup()
    # the segment-stats kernel at the raw window's real shape beside phase
    # 3's synthetic production window
    for raw_case, prod_case in zip(raw_cases, cases[:2]):
        log(
            f"   {raw_case['shape']} ({raw_case['n']} spans, {raw_case['segments']} segments): "
            f"ms {raw_case['ms']:.4f} device_ms {raw_case['device_ms']:.4f}; "
            f"{prod_case['shape']} ({prod_case['n']} spans, {prod_case['segments']} segments): "
            f"ms {prod_case['ms']:.4f} device_ms {prod_case['device_ms']:.4f}"
        )

    def entry(wrapper, source, replaces, n_launches, all_cases, shown):
        return {
            "name": wrapper.__name__,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": n_launches,
            "max_abs_err": max(c["max_abs_err"] for c in all_cases),
            "ms": shown["ms"],
            "call_ms": shown["call_ms"],
            "plain_ms": shown["plain_ms"],
            "bound_ms": shown["bound_ms"],
            "bound_by": shown["bound_by"],
            "library_ms": shown["library_ms"],
            "device_ms": shown["device_ms"],
            "device_ms_by": shown["device_ms_by"],
            "shape": shown["shape"],
            "ok": True,
            "cases": all_cases,
        }

    # launches: the segment-stats kernel on the tick path (phase 7's served
    # ticks and phase 22's gathered rounds and fold ticks), the fused kernel
    # on the forecast path (phase 9, and phase 22's control folds), the
    # backward's row pass on the GraphSAGE training path and its SDDMM on
    # the STLGT path; the shown times are the
    # tick's first pass, GraphSAGE's second layer (H = 64) forward and
    # backward, and STLGT's gated backward (H = 32)
    line = {
        "kernels": [
            entry(
                *kernels[0],
                launches[ss.segment_stats.__name__] + tenancy_launches[ss.segment_stats.__name__],
                cases + raw_cases,
                cases[2],
            ),
            entry(
                *kernels[1],
                forecast_launches[sparse.fused_sddmm_spmm.__name__] + tenancy_launches[sparse.fused_sddmm_spmm.__name__],
                f_cases,
                f_cases[1],
            ),
            entry(
                *kernels[2],
                stlgt_launches[sparse.fused_sddmm_spmm_grad_edges.__name__],
                edges_cases,
                edges_cases[0],
            ),
            entry(
                *kernels[3],
                train_launches[sparse.fused_sddmm_spmm_grad_rows.__name__],
                rows_cases,
                rows_cases[1],
            ),
        ]
    }
    report["walls_s"] = walls
    write_report(args.report, report)
    log("   phase walls (s): " + json.dumps({k: round(v, 2) for k, v in walls.items()}))
    log(json.dumps(line))
    log(smi)
    log(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
