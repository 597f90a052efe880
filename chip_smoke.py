#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kmamiz_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py [--report PATH]

Phases, each timed:

1. card identity (nvidia-smi name and power limit);
2. build every hand-written kernel from kmamiz_tpu_torch/csrc with nvcc
   (one process per source, all at once) and, beside them, the port's
   native host library (csrc/*.cpp) with g++, as an image's build step
   does: `python -m kmamiz_tpu_torch.core.compile_cache --prebuild` in a
   process that sees no card (CUDA_VISIBLE_DEVICES=""), into csrc/build/,
   whose libraries this process then loads; beside them the port's own
   lint of this checkout: `python -m kmamiz_tpu_torch.tools.graftlint
   --strict` and `... graftrace --strict`, each of which must exit 0 with
   0 findings (and, in the whole run, phase 28 (b)'s cold probe);
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
   services x 10 urls, merged in chunks, the merge's wall); its graph
   signature and its edges by name are kept before any tick;
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
7. the tick path: the port's DataProcessorServer on the card answers 2 DP
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
   over the BASELINE graph's live edges: 24 seeded slots, 4 fused epochs,
   lr 1e-2, pos_weight 4, through trainer.train with a checkpoint; the
   losses must fall, and the counters, zeroed just before, must show 2
   forward launches and 1 backward C call per step, launching the row
   pass alone; one steady epoch
   timed and profiled; one epoch over 2 slots on the card against the
   CPU (losses rtol 1e-3); then the checkpoint served by GET
   /api/v1/model/forecast (one edge index for the snapshot);
12. the STLGT continual trainer behind the fold hook (KMAMIZ_STLGT=1,
   production defaults) fed by a processor's ticks in 4 successive
   hours (3 folds, 2 refreshes) through the DP server, counters zeroed
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
   median of RAW_REPS (1) reps each on a fresh processor (counters zeroed just
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
   sessions; phase 24 (a)'s sweep runs beside it and is waited for
   before phase 17): (a) phase 15 (c)'s window as bench.py's 4 chunks of
   37,500 traces through DataProcessor.ingest_raw_stream into a persistent card
   processor on a virtual clock: the graph signature, endpoints and edges
   of 15 (c); beside it a twin that takes the same windows one shot; (b)
   one uncounted steady window each; (c) 1 counted window under fresh
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
   FileStore in a temporary directory, its card processor preloaded with
   phase 4's graph (carried by name, its graph signature equal to phase
   4's) and its store seeded with the dependency records of the same
   150,000 traces (a deployment's cache: made and written by a process of
   its own beside phases 15 and 16, the records' and the write's walls
   timed apart); the realtime schedule on a six-field one-second cron fires 2 ticks of 2,500 fresh traces through
   the operator (the first an hour back, so one hour folds), each under
   5,000 ms, 2 segment-stats launches each (counters zeroed just before
   the boot, read after tear_down); the aggregation job once while the
   realtime job goes on firing (the ticks that overlap it wait for the
   operator's cache lock: their walls are recorded beside the limit, not
   held to it), the realtime schedule parked, tear_down (every cache
   flushed, the history snapshot among them), each timed; (b) boot
   2, a new card processor over the same store (opened once, for the
   flush's checks and the boot): the cache load and the
   graph warm start timed, its graph signature equal to a read-only CPU
   app's over the same store and its history snapshot equal to the one
   boot 1 flushed; (c) every GET route of boot 2 over HTTP at 200 with
   its wall, the memoized routes (scorers, forecast) a second time, their
   payloads equal to the CPU app's (scorers: integers equal, floats rel
   1e-5, cohesion 1e-6; the forecast within the route's rounding), the
   forecast GET's launches (2, and 1 more while phase 12's STLGT trainer
   serves), and no library built or loaded by the first forecast GET
   (phase 28 (d));
18. GAT (after phase 17): a GAT head (hidden 64, no hand-written kernel:
   no counter may move) trained through trainer.train(model=gat) on phase
   11's dataset for 2 epochs with a checkpoint, its losses falling; a
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
   main(), the WAL on, KMAMIZ_LOCK_WITNESS=1; its boot prewarm in the
   background, so GET / answers 503 WARMING before 200 with the prewarm
   ready and every library loaded: phase 28 (d)) serves 1 tick of 2,500
   traces, under 5,000
   ms and equal to a CPU DataProcessor fed the same stubs (dependencies,
   datatypes with the body schemas, replicas equal; latency mean rel
   1e-5 / abs 1e-6, cv rel 1e-3 / abs 1e-5), printing its wall, the
   client's decode of the answer, the pods read, the log lines, the
   bodies and the datatypes, and, by the DP's own GET / answer, 2
   segment-stats launches a tick and the tick's stage walls; after its
   ticks, /timings' lockWitness reads installed with acquires, and its
   edges, held here to the port's static lock model, are acyclic, all in
   the model's wide set, with no unknown site (its edges, acquires and
   longest hold printed on a line of their own); (b) an
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
   KMAMIZ_PROF=0, serve the same 2 windows of 2,500 traces in alternating
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
   at BASELINE.json's synthetic mesh (make_mesh_config of the port's
   eval_models_large tool: 1,000 services x 10 endpoints, fault fraction
   0.08, seed 0) over 1 simulated day: (a)
   Simulator.generate_simulation_data on the host (its wall, endpoints,
   distance-1 edges, slots, rows per slot) and the training dataset of
   its slots (trainer.dataset_from_simulation) (the YAML made once for
   (a) and (e), in the whole run in the process that seeds phase 17's
   store beside phases 15-16); (e) the application in
   simulator mode through its main() over a fresh FileStore, started (its
   own phase, "simulator app start", which starts a thread that waits for
   its boot) before phase 17, so that its boot and startSimulation run
   beside phases 17-21 (with --simulator-only: beside (a)): POST
   /api/v1/simulation/startSimulation with the same YAML (201), the
   endpoint graph, generateStaticSimConfig and the export (its 10,000
   dependency records, its SimulatedHistoricalData), then SIGTERM (exit 0,
   the store left empty); (f) kernel 2 at the training split's buckets:
   the edge index against its plain build, the forward at H = 10, 18 and
   64 and the ungated row pass at 64 against their plain versions, with
   bound and library times. The heads train on (a)'s simulation in phase
   26.
26. model evaluation (right after phase 21, over its simulation; no plain
   version of kernel 2 may run on card tensors): (a) the port's
   eval_models_large tool's transductive and inductive protocols
   (transductive_eval, inductive_eval) on the card at hidden 64 and 8
   epochs (MODELS.md round 5's 60 and 4 days cut to phase 21's 1 day):
   GraphSAGE and GAT on the held-out slots, then GraphSAGE with and
   without history features on 20% held-out endpoints, each table logged
   and every row finite; per head, through the tool's on_head hook, kernel
   2's forward and backward launches against the counts worked out from
   its steps, calibration, evaluation and collect_scores (GAT launches
   none), collect_scores on the card against the same params on the CPU
   (probabilities rtol 1e-4 / atol 1e-5, truths, onsets and currents
   equal); the transductive GraphSAGE head's first-epoch loss against a
   CPU epoch's (rtol 1e-3) and its params saved and restored through
   models/checkpoint.py, the restored forward on the card against the
   trained one (rtol 1e-4 / atol 1e-5); the inductive run's
   --checkpoint-dir restored as the forecast handler restores it, its
   forward through serving.forecast_forward against the trained params'
   (rtol 1e-4 / atol 1e-5); (b) the port's eval_stlgt.evaluate at its
   published defaults (cascade-fanout, seed 0, 48 ticks, 4 epochs, hidden
   16, lr 0.02, depth 8, warmup 4): STLGT's p99 coverage must beat
   GraphSAGE's, and kernel 2's gated forward, SDDMM and row-pass launches
   equal the refreshes' steps' and the baseline's; (c) the port's
   eval_models main on its EVAL_YAML at hidden 32 and 12 epochs (its 60
   cut to keep the phase within 60 s on a slow host), its table logged,
   every row finite, the launches its GraphSAGE steps'. The phase records
   the harness's live threads at its start. Its launches join the kernels line.
22. multi-tenant serving (after phase 26, before phase 14's profiler
   sessions): (a) eight tenants t0-t7, each the BASELINE generator over
   125 services x 10 urls in a namespace of its own (1,250 endpoints,
   the eight together the BASELINE's 10,000), each loaded with 18,750 raw
   traces (phase 4's 150,000 split eight ways), all in one arena capacity
   bucket; (b) a DataProcessorServer with a TickRouter over them (gather
   window 50 ms, an argument) takes 2 rounds in which the eight POST at
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
   2, 6 ticks) through a second gathered server with the WAL on: alpha's
   and beta's windows tick by tick, beta's poison storm to
   /t/beta/ingest (beta's quarantine namespace only), alpha's graph equal
   to a clean serial run of its windows, /timings with tenancy and
   control, and a restart over the same WAL replaying each tenant to its
   signature.
23. the fleet and the scenario runner (after phase 22, over its tenant
   windows, before phase 14's profiler sessions): (a) four FleetWorkers
   w0-w3 on the card behind a coordinator with a LocalTransport (ring
   seed 0, 64 vnodes, each worker's WAL on) take phase 22's eight state
   windows (1,250 endpoints and 18,750 traces a tenant) as 10 frames each
   through route_ingest: spans/s per worker and in all; each tenant's
   graph signature equals a serial twin's fed the same frames, and the
   fold of the eight into one aggregate store on the card (its wall;
   its device time under the profiler, taken last) equals the CPU fold of
   the same exports (edge set and signature), its edges the tenants' sum;
   (b) the tenant the placement's rebalance plan names (t0 without one)
   migrates by WAL handoff with one frame of its traffic routed
   mid-handoff: the replay equals the pre-drain signature, the target the
   twin with the frame applied, no trace lost, the source's copy dropped
   (drain, ship, replay and flip walls, the handoff's bytes); (c) four
   `python -m kmamiz_tpu_torch.fleet.worker` processes on the card,
   booted while (a) and (b) run (their boot walls, the card's memory in
   use with all four up, by process where nvidia-smi shows them) behind an
   HTTPTransport, two tenants each (the first ring seed that spreads them
   so), 2 frames a tenant, one migration over the /fleet/* routes with a
   frame mid-handoff, bit-exact as in (b), fleetscrape's merge of the
   four /metrics pages (fleet totals and per-worker series), then the
   port's fleet_bench tool over the same four processes and ring
   (fleet_bench.scorecard, 24 frames a tenant): spans/s through one worker
   and through four, the efficiency (recorded, not gated: four workers
   share one card), and its migration with a frame racing the handoff,
   which must pass with 0 lost spans and no fleet_bench_error; (d)
   run_scenario on the card at seed 0 of steady-chain, cascade-fanout,
   multi-tenant-mix, kill9-wal-replay (its child on the card),
   capacity-growth-chain, fleet-migration and wal-replay at the factory's
   sizes and 10 ticks, and run_counterfactual(seed=0, n_ticks=8): every
   card passes, no span lost, bit-exact, at least one SLO violation
   prevented (walls, p50/p99 ticks); the fleet-migration card runs with
   the lock witness armed (KMAMIZ_LOCK_WITNESS=1) and passes its
   lock_witness_acyclic and lock_witness_covered gates (its edges and
   acquires). No hand-written kernel runs in the
   phase (device statistics off, the counterfactual's forecast given):
   every launch counter must read 0.
24. the soak sweep (after phase 23, before phase 14's profiler sessions):
   (a) `python -m kmamiz_tpu_torch.tools.graftsoak --cells 48 --ticks 4
   --workers 4 --poison 1` (the JAX package's acceptance sweep, cut from
   200 cells to 48, its worker processes on the card), started beside
   phase 16 and waited for before phase 17 (the wait is phase 24's wall
   "soak sweep (a)"): the report
   complete with 48 cells,
   a pass rate >= 0.9999, every failure triaged, exactly one poison cell
   whose bug blames soak_poison, exit 0 iff soak_pass (the sweep's wall,
   cells/min, the cells' p99 ticks, the card's memory with the workers
   up, less this process's allocator's reserve, at least 1 GiB over its
   start); (b) a 12-cell sweep killed (SIGKILL to its process group) once 3
   results have landed, resumed: exactly the remaining cells execute,
   and a third run executes none and reproduces the report's
   deterministic fields; (c) `scenario_soak --matrix 3 --ticks 6` on the
   card: the matrix passes with no span lost; (d) graftprof's seeded
   capture on the card, 4 collect ticks with device statistics on and
   the raw-ingest leg: attribution >= 0.90, the ticks' answers equal a
   CPU capture's (the tick's tolerances), the raw-ingest leg ran (not
   skipped, not quarantined, its tick and native merge profiled) and
   counted the CPU leg's spans, traces, endpoints and edges, the
   segment-stats kernel launched 8 times (counted, and added to the
   kernels line); `--diff`
   of the capture against itself exits 0, and of (a)'s poison cell's
   flight box against its archetype's baseline prints a blame block
   naming soak_poison.

25. the device mesh (kmamiz_tpu_torch/parallel/mesh.py; after phase 24,
   before phase 14's profiler sessions) on 8 virtual shards of the one
   card (parallel/mesh.process_devices, the mesh's test seam, answering 8
   copies of cuda:0, so every deployed caller shards as on a host with 8
   cards; every wall is printed beside "8 x cuda:0": launch cost on one
   card, not scaling): (a) sharded_window_stats under psum, ring and
   hierarchical (a 2 x 4 ('host', 'spans') grid) against window_stats on
   the card, at the production window (2^20 spans, 10,000 endpoints x 8
   statuses) and at a 2,500-trace tick, within the tick's tolerances, the
   segment-stats kernel launching 2 x 8 times a call (counted); (b) a
   collect tick with the mesh (16 launches) and one without (2), both from
   phase 4's graph carried by name (export_named_edges ->
   graph_from_export): combined rows (the tick's tolerances),
   dependencies and graph signature equal; (c) ingest_raw_stream of 4
   chunks of 12,500 traces at the BASELINE mesh with the mesh (each chunk
   staged by sharded_window_edges_compact) and without, and with the mesh
   once more under a stage cap of 256 rows (every shard re-walks through
   sharded_dependency_edges_packed): equal summaries and graph
   signatures; (d) sharded_service_scores on phase 4's graph (grown by
   the ticks since) against the store's single-device scorer (integer
   lanes and instability equal, relying factor rel 1e-5); (e) one
   make_sharded_slot_grad step of GraphSAGE (hidden 64, 18 features, 8
   slots of phase 11's dataset, one a shard) against the per-slot loop
   (rtol 1e-5 / atol 1e-6), the fused kernel's forward launching 2 and
   its backward 1 C call (the row pass) a slot, counted; (f) phase 22's
   last stacked merge with its 8 tenant lanes sharded one a shard
   (tenancy/batch.sharded_merge_edges) against 8 serial merges,
   bit-equal. Its launches join the kernels line.
27. the chaos probe (after phase 25, before phase 14's profiler
   sessions): the four resilience pillars of the port's chaos_probe tool
   (chaos_probe.probe, seed 0) in this process on the card, counters
   zeroed just before and read just after: (1) a seeded poisoned chunk
   stream ingests bit-exact to its clean chunks, every poisoned delivery
   quarantined with its reason (a fresh quarantine bound for the pillar);
   (2) the breaker's state machine; (3) a DP server on the card serves a
   tick past KMAMIZ_TICK_DEADLINE_MS stale (200, the last good payload)
   and fresh again once the straggler lands, its processor's device
   statistics on: the segment-stats kernel launches exactly twice for
   each of the pillar's three ticks (the warm one, the straggler, the
   recovered one); (4) the tool's --child-kill child on the card SIGKILLs
   itself between a WAL append and its merge, and a fresh processor's
   replay gives the graph of every window. Pillars 1 and 4 run with
   device statistics off and launch nothing. chaos_recovery_ms and
   degraded_serve_ms are recorded; every pillar must hold. Its launches
   join the kernels line.
28. restart warmth (right after phase 2): (b) a cold restart, `python -m
   kmamiz_tpu_torch.tools.warm_boot_probe` on the card in a process of its
   own over a copy of the package without csrc/build/ and an empty
   KMAMIZ_COMPILE_CACHE_DIR, started before phase 1 so that it runs
   beside this process's start and phase 2 (which has no gated wall), and
   joined here: its boot prewarm (core/prewarm.py) builds every
   library (the host library and both kernels') into that directory, and
   neither of its two timed 2,500-trace ticks builds or first loads a
   library; (c) a warm restart, the probe again, alone, against (b)'s
   directory: no library built anywhere, both counts 0 again; prewarm_s
   and first_tick_ms of both. (d) In phases 19 and 17: the DP booted
   through main() answers 503 WARMING, then 200 with the prewarm ready,
   and the first forecast GET after phase 17's boot builds and loads no
   library.

Before its last lines every run ends the processes it started that are
still alive (multiprocessing's resource tracker first), logs each, and
checks from /proc that none of its descendants, nor any process carrying
its run mark (CHIP_SMOKE_RUN), is left.

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
warm tick); with --simulator-only, phases 1-2 and then phase 21 alone; with
--eval-only, phases 1-2, phase 21 (a) and then phase 26;
with --tenancy-only, phases 1-2 and then phase 22 alone; with
--mesh-only, phases 1-2 and 4 and then phase 25 without (f); with
--fleet-only, phases 1-2 and then phase 23 alone (over tenant windows it
makes itself); with --soak-only, phases 1-2 and then phase 24 alone; with
--chaos-only, phases 1-2 and then phase 27 alone; with --restart-only,
phases 1-2 and then phase 28 ((b) beside phases 1-2, then (c)).
Any failed check raises, and the script then exits non-zero without the
result line; so does a machine without a CUDA device, or a directory that
holds this script without the kmamiz_tpu_torch package.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import gc
import gzip
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
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
TICKS = 2
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
SAGE_EPOCHS = 4
SAGE_HIDDEN = 64
SAGE_FEATURES = 18  # 10 base + 8 history columns
SAGE_LR = 1e-2
STLGT_HOURS = (920, 921, 922, 923)  # 4 ticks: 3 folds, 2 refreshes
RAW_TRACES = 150_000  # bench.py's raw e2e window: 1.05M spans
RAW_REPS = 1
TICK_WALL_LIMIT_MS = 5_000  # the DP's realtime cadence (PERF.md section 2)
# Taken by every tick whose wall this process times while the tick runs in,
# or answers to, this process (phases 17, 19, 20), and by the harness thread
# that reads phase 21's large route answers beside them: a tick's wall is
# never a harness thread's hold of the interpreter lock.
HOST_QUIET = threading.Lock()


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


class GcPauses:
    """The collections of this process's garbage collector, in any thread,
    while the block runs: their summed wall (`ms`) and how many were full
    (`full`, generation 2)."""

    def __enter__(self):
        self.ms, self.full, self._t = 0.0, 0, None
        gc.callbacks.append(self._on)
        return self

    def _on(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.ms += (time.perf_counter() - self._t) * 1e3
            self.full += info["generation"] == 2
            self._t = None

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on)
        return False


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


#: state_windows' bytes by (n_traces, chunk): phases 4, 15 and 17 read the
#: same windows, made once
_STATE_WINDOWS: dict = {}


def state_windows(n_traces: int = None, chunk: int = None) -> list:
    """Phase 4's windows (prefix "state") as raw bytes, chunk by chunk
    (STATE_TRACES in STATE_CHUNK unless given), made on the first call and
    kept for the run's later readers."""
    n_traces = STATE_TRACES if n_traces is None else n_traces
    chunk = STATE_CHUNK if chunk is None else chunk
    if (n_traces, chunk) not in _STATE_WINDOWS:
        _STATE_WINDOWS[n_traces, chunk] = raw_windows(
            dict(
                n_traces=min(chunk, n_traces - start),
                spans_per=SPANS_PER_TRACE,
                t_start=start,
                trace_prefix="state",
                **BASELINE,
            )
            for start in range(0, n_traces, chunk)
        )
    return _STATE_WINDOWS[n_traces, chunk]


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


def stat_windows(tick_groups) -> list:
    """window_stats' host columns at the production window (2^20 spans,
    10,000 endpoints x 8 statuses, bench.py's inputs) and at the tick's
    shape (the stats columns of a window of tick_groups): (label, columns
    by window_stats' argument names, num_endpoints, num_statuses)."""
    import numpy as np

    from kmamiz_tpu_torch.domain.traces import Traces
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
    return [
        ("production window", prod, PROD_ENDPOINTS, PROD_STATUSES),
        ("tick", tick, cols.num_endpoints, cols.num_statuses),
    ]


def segment_inputs(torch, device, tick_groups):
    """Phase 3's inputs: (label, values, seg, ts, num_segments) at the
    production window and at the tick's shape, both passes of window_stats
    (the second takes no timestamps)."""
    from kmamiz_tpu_torch.ops import segment_stats as ss
    from kmamiz_tpu_torch.ops import window as window_ops

    inputs = []
    for label, arrays, ne, ns in stat_windows(tick_groups):
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


def get_route(port: int, path: str, quiet: bool = False):
    """GET any API route over HTTP (gzip accepted): (status, body, wall
    ms), the body parsed when it is JSON, else its bytes (the export's
    tgz, the swagger YAML). With `quiet`, the whole request holds
    HOST_QUIET (a thread beside timed ticks): the server's work on the
    answer as well as its read, gunzip and parse, and the wall starts once
    the lock is held."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", headers={"Accept-Encoding": "gzip"})
    with HOST_QUIET if quiet else contextlib.nullcontext():
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            body = resp.read()
            if resp.headers.get("Content-Encoding") == "gzip":
                body = gzip.decompress(body)
            status, kind = resp.status, resp.headers.get("Content-Type", "")
            ms = (time.perf_counter() - t0) * 1e3
            if kind.startswith("application/json"):
                body = json.loads(body)
    return status, body, ms


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


LINT_TOOLS = ("graftlint", "graftrace")


def start_lint() -> dict:
    """Phase 2's lint: the port's graftlint and graftrace, --strict, over
    this checkout's kmamiz_tpu_torch/ (no card), each a process of its own
    started beside the kernels' builds."""
    return {
        name: subprocess.Popen(
            [sys.executable, "-m", f"kmamiz_tpu_torch.tools.{name}", "--strict"],
            cwd=REPO,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for name in LINT_TOOLS
    }


def finish_lint(started: dict) -> dict:
    """Each tool's exit code (must be 0) and its finding and suppression
    counts, from its last line."""
    import re

    out = {}
    for name, proc in started.items():
        stdout, stderr = proc.communicate()
        last = stdout.strip().splitlines()[-1] if stdout.strip() else ""
        check(proc.returncode == 0, f"{name} --strict exited {proc.returncode}:\n{stdout[-4000:]}{stderr[-4000:]}")
        m = re.fullmatch(r"graftlint: (\d+) finding\(s\), (\d+) suppressed", last)
        check(m is not None and m.group(1) == "0", f"{name} --strict: {last!r}")
        out[name] = {"exit": proc.returncode, "findings": int(m.group(1)), "suppressed": int(m.group(2))}
    return out


def load_state(device, n_traces: int = STATE_TRACES, chunk: int = STATE_CHUNK):
    """Phase 4: a processor whose graph holds the BASELINE edge set."""
    from kmamiz_tpu_torch.core.spans import spans_to_batch
    from kmamiz_tpu_torch.server.processor import DataProcessor

    feed = TickFeed()
    proc = DataProcessor(trace_source=feed, device=device)
    for raw in state_windows(n_traces, chunk):
        groups = json.loads(raw)
        proc.graph.merge_window(spans_to_batch(groups, interner=proc.graph.interner))
    return proc, feed


def carry_state(graph, signature: str) -> dict:
    """What carried_graph rebuilds `graph` from, on the host: its endpoint
    names in id order with their metadata, and its edges by name."""
    interner = graph.interner
    return {
        "names": list(interner.endpoints.strings),
        "infos": list(interner.endpoint_infos),
        "export": graph.export_named_edges(),
        "signature": signature,
    }


def carried_graph(state: dict, device):
    """A graph on `device` equal to the one carry_state read: the endpoints
    interned in its id order with their metadata, then its edge set
    folded in (EndpointGraph.fold_named_edges), without a merge."""
    from kmamiz_tpu_torch.graph.store import EndpointGraph

    graph = EndpointGraph(device=device)
    for name, info in zip(state["names"], state["infos"]):
        graph.interner.intern_endpoint(name, info)
    graph.fold_named_edges(state["export"])
    return graph


def dependency_records(windows) -> list:
    """The dependency records phase 4's traces leave in the cache of a
    deployment that saw them: each endpoint with every entry its spans'
    records carry. A tick keeps the last record of an endpoint in its
    window, so a cache takes many windows to hold them all (phase 17 seeds
    its store with them). They stop growing at the first chunk that adds
    no entry, and are not built further (the mesh repeats every 28,000
    traces)."""
    from kmamiz_tpu_torch.domain.endpoint_dependencies import EndpointDependencies
    from kmamiz_tpu_torch.domain.traces import Traces

    deps, entries = None, 0
    for raw in windows:
        # combine_with merges the records its other side repeats
        spans = EndpointDependencies([]).combine_with(Traces(json.loads(raw)).to_endpoint_dependencies())
        deps = spans if deps is None else spans.combine_with(deps)
        n = sum(len(d["dependingBy"]) + len(d["dependingOn"]) for d in deps.dependencies)
        if n <= entries:
            break
        entries = n
    return deps.trim().to_json()


def write_seed_store(store_dir: str, windows) -> dict:
    """Phase 17's store seed, made beside phases 15 and 16 in a process of
    its own (no card): the dependency records of phase 4's traces
    (dependency_records) written into a FileStore in store_dir. Returns
    their counts and the two walls, timed apart."""
    from kmamiz_tpu_torch.server.storage import FileStore

    t0 = time.perf_counter()
    seed = dependency_records(windows)
    t1 = time.perf_counter()
    FileStore(store_dir).insert_many("EndpointDependencies", seed)
    return {
        "records_s": t1 - t0,
        "seed_write_s": time.perf_counter() - t1,
        "seed_records": len(seed),
        "seed_entries": sum(len(d["dependingOn"]) + len(d["dependingBy"]) for d in seed),
    }


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
STREAM_WINDOWS = 1  # counted steady windows (the stream first)
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

APP_TICKS = 2  # scheduled realtime ticks of boot 1 before its aggregation
APP_WINDOWS = APP_TICKS + 4  # and windows for the ticks that overlap the aggregation
APP_FOLD_AT = 1  # boot 1's ticks before this one run an hour back: one fold
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


def serve_application(torch, device, counters, t_start: int, state: dict, store, seeded) -> dict:
    """Phase 17: the port's Application (api/app.py) on the card. (a) Boot
    1 over a FileStore in the temporary directory `store` (removed at the
    end), its processor preloaded with phase 4's graph (carried_graph of
    carry_state's `state`, taken before phase 7's ticks; its graph
    signature checked against phase 4's) and its store seeded with the
    dependency records of the same 150,000 traces (write_seed_store, in a
    process of its own beside phases 15 and 16: `seeded` is its future,
    waited for first, the wait timed), so that its dependency cache
    starts at a deployment's size; the realtime job on a six-field
    one-second cron firing APP_TICKS scheduled ticks of 2,500 fresh traces
    (the first APP_FOLD_AT an hour back, so one hour folds), counters
    zeroed just before the boot and read after tear_down; then the
    aggregation job once while the realtime job goes on firing (the
    ticks that overlap it wait for the operator's cache lock: their walls
    are recorded apart, beside the limit, not held to it), the realtime
    schedule parked, and tear_down (schedules stopped, every cache
    flushed). (b) Boot 2: a new card processor over the same directory
    (the store opened once, for the flush's checks and the boot), the
    cache load and the graph warm start timed; its graph signature
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

    store_dir = store.name
    try:
        # -- (a) boot 1 -----------------------------------------------------
        t0 = time.perf_counter()
        out: dict = dict(seeded.result())
        out["seed_wait_s"] = time.perf_counter() - t0
        log("   seed " + json.dumps(out))
        t0 = time.perf_counter()
        feed = TickFeed()
        proc1 = DataProcessor(trace_source=feed, device=device, graph=carried_graph(state, device))
        out["state_carry_s"] = time.perf_counter() - t0
        check(graph_signature(proc1.graph) == state["signature"], "phase 17's graph differs from phase 4's")
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
            with HOST_QUIET:
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
        del app, proc1, op, retrieve
        torch.cuda.empty_cache()

        # -- (b) boot 2 -----------------------------------------------------
        boot: dict = {}
        t0 = time.perf_counter()
        stored = FileStore(store_dir)
        boot["store_open_ms"] = (time.perf_counter() - t0) * 1e3
        flushed = stored.find_all("ModelHistoryState")
        check(bool(flushed), "boot 1 flushed no history snapshot")
        check(len(stored.find_all("HistoricalData")) > 0, "the aggregation stored no historical data")
        check(stored.get_aggregated_data() is not None, "the aggregation stored no aggregate")
        out["store_bytes"] = sum(
            os.path.getsize(os.path.join(store_dir, f)) for f in os.listdir(store_dir)
        )
        proc2 = DataProcessor(trace_source=TickFeed(), device=device)
        app2 = Application(ctx=AppContext.build(app_settings=app_settings(store_dir), store=stored, processor=proc2))
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
        from kmamiz_tpu_torch.core import compile_cache

        first_forecast = True
        try:
            for url in app_urls(app2):
                mark = compile_cache.snapshot()
                status, payload, first_ms = get_route(api.port, url)
                check(status == 200, f"GET {url} answered {status}")
                routes[url] = {"first_ms": round(first_ms, 3)}
                if first_forecast and url.startswith("/api/v1/model/forecast"):
                    # phase 28 (d): the first forecast GET after the boot
                    # builds and loads no library
                    first_forecast = False
                    loads = compile_cache.loads(mark)
                    routes[url]["libraries_loaded"] = len(loads)
                    out["first_forecast_libraries_loaded"] = len(loads)
                    check(not loads, f"the first forecast GET loaded {loads}")
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
        check("first_forecast_libraries_loaded" in out, "boot 2 served no forecast GET")
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
        store.cleanup()
    return out


# -- phase 18: GAT ------------------------------------------------------------

GAT_EPOCHS = 2
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

CLUSTER_TICKS = 1  # DP ticks through main() with cluster state
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
    the environment and command-line `args` given; waits until `health`
    answers 200 and records the boot wall. Its answers before the 200 are
    counted by status (`not_ready`): 503 {"status": "WARMING"} while the
    boot prewarm runs (core/prewarm.py). Output goes to `log_path`.
    stop() sends `sig` and waits; kill() is kill -9."""

    def __init__(
        self, module: str, env: dict, port: int, health: str, log_path: str, timeout: float = 300, args=()
    ) -> None:
        full = {k: v for k, v in os.environ.items() if not k.startswith("KMAMIZ_")}
        full.update(env, PYTHONPATH=REPO)
        self.port, self.log_path = port, log_path
        t0 = time.perf_counter()
        self.out = open(log_path, "ab")
        # a session of its own: stop() and kill() end its children too (the
        # cluster client's fan-out processes)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *args],
            cwd=REPO,
            env=full,
            stdout=self.out,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        self.not_ready: dict = {}
        deadline = time.monotonic() + timeout
        while True:
            if self.proc.poll() is not None:
                self.out.close()
                raise AssertionError(f"{module} exited {self.proc.returncode}: {self.tail()}")
            try:
                status, self.health = http_json(port, health, timeout=5)
                if status == 200:
                    break
                key = f"{status} {self.health.get('status')}"
                self.not_ready[key] = self.not_ready.get(key, 0) + 1
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

    from kmamiz_tpu_torch.analysis.concurrency import witness as lock_witness
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
        # (a)'s DP runs with the lock witness armed by its main()
        port = free_port()
        dp = Served(
            "kmamiz_tpu_torch.server.dp_server", {**dp_env, "DP_PORT": str(port), "KMAMIZ_LOCK_WITNESS": "1"}, port, "/",
            os.path.join(root.name, "dp.log"),
        )
        served.append(dp)
        out["dp_boot_ms"] = dp.boot_ms
        check(dp.health["device"].startswith("cuda"), f"the DP runs on {dp.health['device']}")
        # phase 28 (d): main()'s background prewarm, seen from outside:
        # 503 WARMING first, then 200 with the plan's report
        warm = dp.health["prewarm"]
        out["prewarm"] = {"not_ready": dp.not_ready, "status": warm["status"], "report": warm.get("report")}
        log("   (a) prewarm " + json.dumps(out["prewarm"]))
        check(dp.not_ready.get("503 WARMING", 0) >= 1, f"the DP never answered 503 WARMING: {dp.not_ready}")
        check(set(dp.not_ready) == {"503 WARMING"}, f"the DP's answers before ready: {dp.not_ready}")
        check(warm["status"] == "ready", f"the DP's prewarm: {warm}")
        check(set(warm["report"]["libraries"]) == LIBRARIES, f"the DP's prewarm loaded {sorted(warm['report']['libraries'])}")
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
            timing: dict = {}
            with HOST_QUIET:
                # this process's own heap (every phase's state) is collected
                # before the wall, as post_round does, so that a full
                # collection of it does not land in the client's decode
                t = time.perf_counter()
                gc.collect()
                collect_ms = (time.perf_counter() - t) * 1e3
                with GcPauses() as pauses:
                    t = time.perf_counter()
                    resp = post_tick(port, request, timing)
                    wall = (time.perf_counter() - t) * 1e3
            gets_after, lines_after = kube.reads()
            tick = {
                "tick": k,
                "wall_ms": round(wall, 3),
                "client_decode_ms": timing["decode_ms"],
                "client_gc_ms": round(pauses.ms, 3),
                "client_full_gcs": pauses.full,
                "harness_collect_ms": round(collect_ms, 3),
                "harness_objects": len(gc.get_objects()),
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
        slowest = max(ticks, key=lambda t: t["wall_ms"])
        check(
            out["max_tick_wall_ms"] < TICK_WALL_LIMIT_MS,
            f"a cluster tick took {out['max_tick_wall_ms']} ms: "
            + json.dumps({key: slowest[key] for key in ("client_decode_ms", "client_gc_ms", "dp_stages")}),
        )
        out["pods"] = sum(len(p) for p in kube.pods.values())
        out["stream_micro_ticks"] = CLUSTER_TICKS
        # the DP's witness after its ticks: installed, acquires recorded,
        # and its edges held here to the port's static lock model (acyclic,
        # every edge in the model's wide set, no site unknown to it)
        status, timings = http_json(port, "/timings")
        check(status == 200, f"the DP's /timings answered {status}")
        lw = timings["lockWitness"]
        check(lw["enabled"] and lw["installed"], f"the DP's lock witness: enabled {lw['enabled']}, installed {lw['installed']}")
        t = time.perf_counter()
        witnessed = lock_witness.check_snapshot(lw)
        out["lock_witness"] = {
            "edges": witnessed.edge_count,
            "acquires": witnessed.acquire_count,
            "max_hold_ms": max((v["maxHoldMs"] for v in lw["locks"].values()), default=0.0),
            "sites": len(lw["locks"]),
            "peer_edges": witnessed.peer_edges,
            "model_and_check_ms": round((time.perf_counter() - t) * 1e3, 3),
        }
        log("   (a) lock witness " + json.dumps(out["lock_witness"]))
        check(witnessed.acquire_count > 0, "the DP's lock witness recorded no acquire")
        check(witnessed.acyclic, f"the DP's witnessed lock order has cycles: {witnessed.cycles}")
        check(
            not witnessed.uncovered and not witnessed.unknown_sites,
            f"the DP's witnessed locks outside the static model: edges {witnessed.uncovered}, sites {witnessed.unknown_sites}",
        )

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

TEL_TICKS = 2  # ticks of each gate state, alternating between the two DPs
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
    with HOST_QUIET:
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            check(resp.status == 200, f"tick answered {resp.status}")
            body = resp.read()
        wall = (time.perf_counter() - t) * 1e3
    return wall, len(body)


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
SIM_EPOCHS = 8  # of MODELS.md round 5's 60: the depth cut
SIM_HIDDEN = 64
SIM_TRAIN_FRACTION = 0.75  # trainer.train_on_simulation's default split
SIM_NAMESPACE = "mesh"


class SimulatorApp:
    """Phase 21 (e): the application in simulator mode, started through
    its main() over a fresh FileStore by a thread that waits for its boot,
    POSTs the YAML to startSimulation and then reads the routes, while the
    caller goes on. result() waits for the thread, checks the answers,
    stops the application (SIGTERM: it clears its store and exits 0) and
    returns the walls; kill() ends it if the run ends first."""

    ROUTES = (
        ("graph", f"/api/v1/graph/dependency/endpoint/{SIM_NAMESPACE}"),
        ("static_config", "/api/v1/simulation/generateStaticSimConfig"),
        ("export", "/api/v1/data/export"),
    )

    def __init__(self, yaml_text: str, root: str) -> None:
        import threading

        self.store = os.path.join(root, "store")
        os.makedirs(self.store)
        self.root = root
        self.served = None
        self.out: dict = {}
        self.bodies: dict = {}
        self.error = None
        self.thread = threading.Thread(target=self._drive, args=(yaml_text.encode(),), daemon=True)
        self.thread.start()

    def kill(self) -> None:
        if self.served is not None:
            self.served.kill()

    def _drive(self, body: bytes) -> None:
        try:
            port = free_port()
            self.served = Served(
                "kmamiz_tpu_torch.api.app",
                {"SIMULATOR_MODE": "true", "PORT": str(port), "STORAGE_URI": f"file://{self.store}"},
                port,
                "/api/v1/health/",
                os.path.join(self.root, "app.log"),
            )
            self.out["boot_ms"] = self.served.boot_ms
            t0 = time.perf_counter()
            status, answer = http_json(port, "/api/v1/simulation/startSimulation", body, timeout=900)
            self.out["start_simulation"] = {
                "status": status,
                "answer": answer,
                "ms": (time.perf_counter() - t0) * 1e3,
            }
            # the answers are large: decoded while no tick is timed
            for key, path in self.ROUTES:
                status, self.bodies[key], ms = get_route(port, path, quiet=True)
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
            code = self.served.stop(signal.SIGTERM) if self.served is not None else None
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


def mesh_yaml() -> str:
    """Phase 21's YAML: BASELINE.json's synthetic mesh, seeded, from the
    port's eval_models_large tool."""
    import numpy as np

    from kmamiz_tpu_torch.tools.eval_models_large import make_mesh_config

    return make_mesh_config(
        SIM_SERVICES, SIM_ENDPOINTS_PER_SERVICE, SIM_DAYS, np.random.default_rng(SEED), SIM_FAULT_FRACTION
    )


def simulate_mesh(out: dict, yaml_text: str) -> tuple:
    """Phase 21 (a): the simulation of `yaml_text` (mesh_yaml()) on the
    host and its training dataset, their walls and counts into `out`;
    returns (the simulation, the dataset)."""
    import numpy as np

    from kmamiz_tpu_torch.models import trainer
    from kmamiz_tpu_torch.simulator import Simulator

    out["yaml_bytes"] = len(yaml_text)
    t0 = time.perf_counter()
    result = Simulator().generate_simulation_data(yaml_text, SIM_DATE_MS, rng=np.random.default_rng(SEED))
    out["simulation_s"] = time.perf_counter() - t0
    check(not result.validation_error_message, result.validation_error_message)
    check(not result.converting_error_message, result.converting_error_message)
    out.update(simulation_dataset(result))
    check(out["endpoints"] == SIM_SERVICES * SIM_ENDPOINTS_PER_SERVICE, f"{out['endpoints']} endpoints")
    check(out["slots"] == 24 * SIM_DAYS, f"{out['slots']} slots")
    t0 = time.perf_counter()
    dataset = trainer.dataset_from_simulation(
        result.endpoint_dependencies, result.realtime_data_per_slot, result.replica_counts
    )
    out["dataset_s"] = time.perf_counter() - t0
    log("   (a) " + json.dumps(out))
    return result, dataset


def simulate(torch, device, jobs, app: "SimulatorApp", yaml_text: str) -> tuple:
    """Phase 21, the simulator at BASELINE.json's synthetic mesh (1,000
    services x 10 endpoints, fault fraction 0.08, seed 0, 1 simulated day):
    (a) Simulator.generate_simulation_data on the host, and the training
    dataset of its slots; (e) the application in simulator mode
    (SimulatorApp `app`, started earlier over the same `yaml_text`
    (mesh_yaml()'s)), beside (a); (f) kernel 2 at the training split's
    buckets against its plain version. The heads train on (a)'s simulation
    in phase 26. Returns (the report, the simulation, its dataset)."""
    from kmamiz_tpu_torch.models import stacked, trainer
    from kmamiz_tpu_torch.ops import sparse

    out: dict = {
        "services": SIM_SERVICES,
        "endpoints_per_service": SIM_ENDPOINTS_PER_SERVICE,
        "days": SIM_DAYS,
        "fault_fraction": SIM_FAULT_FRACTION,
    }
    try:
        result, dataset = simulate_mesh(out, yaml_text)

        # (f) kernel 2 at the buckets the training split stacks to
        train_set = trainer.temporal_split(dataset, SIM_TRAIN_FRACTION)[0]
        out["kernels"] = simulated_kernel_cases(torch, sparse, stacked.stack_dataset(train_set, device), jobs)

        # (e) the application's answers
        out["app"] = app.result(SIM_SERVICES * SIM_ENDPOINTS_PER_SERVICE)
        log("   (e) " + json.dumps(out["app"]))
    finally:
        if "app" not in out:
            app.served.kill()
    return out, result, dataset


def simulated_kernel_cases(torch, sparse, st, jobs) -> dict:
    """Phase 21 (f): kernel 2 on the simulated mesh's edge list at the
    buckets its training split stacks to (st: models/stacked.StackedDataset):
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


# -- phase 26: model evaluation ----------------------------------------------

EVAL_SMALL_EPOCHS = 12  # (c): eval_models' 60 epochs, cut to keep phase 26 within 60 s on a slow host
EVAL_SMALL_HIDDEN = 32  # (c): eval_models' default width
#: (b): eval_stlgt's published defaults (its flags' and evaluate()'s)
STLGT_EVAL = dict(archetype="cascade-fanout", seed=0, ticks=48, epochs=4, hidden=16, lr=0.02, depth=8, warmup=4)
EVAL_COMPARE = dict(rtol=1e-4, atol=1e-5)  # card against CPU, as phase 10


def want_counts(counters, **counts) -> dict:
    """Every counter at 0 but the ones named."""
    want = {c.__name__: 0 for c in counters}
    want.update(counts)
    return want


def sage_counts(counters, sparse, steps: int, forwards: int) -> dict:
    """Kernel 2's counts for a GraphSAGE head: two forward launches a
    forward (its two layers), one backward C call a step launching the
    ungated row pass alone."""
    return want_counts(
        counters,
        **{
            sparse.fused_sddmm_spmm.__name__: 2 * forwards,
            sparse.fused_backward.__name__: steps,
            sparse.fused_sddmm_spmm_grad_rows.__name__: steps,
        },
    )


def row_doc(row) -> dict:
    """One row of eval_models_large's table as the report keeps it."""
    name, m, auc, ap, onset, wall = row
    return {
        "model": name,
        "precision": m.anomaly_precision,
        "recall": m.anomaly_recall,
        "f1": m.anomaly_f1,
        "roc_auc": auc,
        "pr_auc": ap,
        "onset_recall": onset,
        "latency_mae_ms": m.latency_mae_ms,
        "train_s": wall,
    }


def row_finite(row) -> bool:
    """Every number of a row finite; the hybrid rows carry no AUCs (nan by
    the tool's construction)."""
    doc = row_doc(row)
    if doc["model"].endswith("(hybrid)"):
        del doc["roc_auc"], doc["pr_auc"]
    return all(math.isfinite(v) for k, v in doc.items() if k != "model")


def on_cpu(params):
    """A params NamedTuple's tensors (None fields kept) copied to the CPU."""
    return type(params)(*(None if t is None else t.detach().cpu() for t in params))


def eval_protocols(torch, device, counters, result, dataset, root: str) -> dict:
    """Phase 26 (a): eval_models_large's transductive and inductive
    protocols (its transductive_eval and inductive_eval) over phase 21's
    simulation at SIM_EPOCHS and SIM_HIDDEN, on the card, each head's
    launches read and zeroed by the tools' on_head hook."""
    import numpy as np

    from kmamiz_tpu_torch.models import checkpoint as ckpt
    from kmamiz_tpu_torch.models import gat, graphsage, serving, stacked, trainer
    from kmamiz_tpu_torch.ops import sparse
    from kmamiz_tpu_torch.tools import eval_models_large as eml

    train_set, eval_set = trainer.temporal_split(dataset, eml.TRAIN_FRACTION)
    train_slots, eval_slots = len(train_set.features), len(eval_set.features)
    steps = train_slots * SIM_EPOCHS
    # a head's forwards: its steps, calibrate_threshold over the training
    # slots, evaluate and collect_scores over the held-out ones
    sage = sage_counts(counters, sparse, steps, steps + train_slots + 2 * eval_slots)
    heads: dict = {}

    def on_head(name, model, res, metrics, scored):
        heads[name] = {
            "model": model,
            "params": res.params,
            "losses": res.losses,
            "threshold": metrics.threshold,
            "scored": scored,
            "launches": read_counts(torch, counters),
        }
        zero_counts(counters)

    ckpt_dir = os.path.join(root, "inductive")
    args = eml.build_parser().parse_args(
        [
            "--services", str(SIM_SERVICES), "--eps-per-service", str(SIM_ENDPOINTS_PER_SERVICE),
            "--days", str(SIM_DAYS), "--epochs", str(SIM_EPOCHS), "--hidden", str(SIM_HIDDEN),
            "--seed", str(SEED), "--checkpoint-dir", ckpt_dir, "--device", str(device),
        ]
    )
    log(
        f"   (a) {SIM_DAYS} simulated day, {SIM_EPOCHS} epochs: the history columns see no earlier "
        "same-hour slot, so these tables prove the path at full width, not MODELS.md's quality"
    )
    out: dict = {"train_slots": train_slots, "eval_slots": eval_slots, "epochs": SIM_EPOCHS, "hidden": SIM_HIDDEN}
    for protocol, run in (("transductive", eml.transductive_eval), ("inductive", eml.inductive_eval)):
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = run(args, result, on_head=on_head)
        out[protocol] = {"wall_s": time.perf_counter() - t0, "rows": [row_doc(r) for r in rows]}
        bad = [r[0] for r in rows if not row_finite(r)]
        check(not bad, f"{protocol}: rows not finite: {bad}")

    for name, head in heads.items():
        want = want_counts(counters) if head["model"] is gat else sage
        check(head["launches"] == want, f"{name}: launches {head['launches']}, want {want}")
        check(all(math.isfinite(x) for x in head["losses"]), f"{name}: losses {head['losses']}")
        # collect_scores on the card against the same params on the CPU
        card = eml.collect_scores(head["params"], head["scored"], head["model"])
        host = eml.collect_scores(on_cpu(head["params"]), head["scored"], head["model"])
        np.testing.assert_allclose(card[0], host[0], err_msg=f"{name}: collect_scores", **EVAL_COMPARE)
        for part, a, b in zip(("truths", "onsets", "currents"), card[1:], host[1:]):
            check(np.array_equal(a, b), f"{name}: collect_scores' {part} differ from the CPU's")
        head["collect_max_abs_diff"] = float(np.abs(card[0] - host[0]).max())
    out["heads"] = {
        name: {k: v for k, v in head.items() if k not in ("model", "params", "scored")}
        for name, head in heads.items()
    }

    # the transductive GraphSAGE head: its first epoch's loss against a
    # CPU copy's from the same seed, and its params through the checkpoint
    # module, restored on the card
    sage_head = heads["GraphSAGE"]
    t0 = time.perf_counter()
    cpu = trainer.train(train_set, epochs=1, hidden=SIM_HIDDEN, seed=SEED, model=graphsage, device="cpu")
    out["cpu_epoch_s"] = time.perf_counter() - t0
    np.testing.assert_allclose(
        sage_head["losses"][0], cpu.losses[0], rtol=1e-3, err_msg="first-epoch loss, card against CPU"
    )
    out["first_loss_rel_diff"] = abs(sage_head["losses"][0] - cpu.losses[0]) / abs(cpu.losses[0])
    sage_dir = os.path.join(root, "transductive")
    ckpt.save_params(
        sage_dir, sage_head["params"], SIM_EPOCHS,
        {"model": "graphsage", "hidden": SIM_HIDDEN, "num_features": graphsage.NUM_FEATURES, "num_nodes": 0},
    )
    restored, meta = ckpt.restore_params(sage_dir, graphsage, device=device)
    want = stacked.predict_all(sage_head["params"], eval_set, graphsage)
    got = stacked.predict_all(restored, eval_set, graphsage)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w, err_msg="restored checkpoint's forward", **EVAL_COMPARE)
    out["checkpoint"] = {"step": meta["step"], "max_abs_diff": max(float(np.abs(a - w).max()) for a, w in zip(got, want))}

    # the inductive run's --checkpoint-dir (the with-history head) as the
    # forecast handler restores it, its forward against the trained params'
    history_head = heads["GraphSAGE (with history features)"]
    restored, meta = ckpt.restore_params(ckpt_dir, graphsage, device=device)
    template = ckpt.restore_checkpoint(ckpt_dir, restored, graphsage.make_optimizer(0.01).init(restored))
    check(template is not None and meta["step"] == SIM_EPOCHS, f"the inductive checkpoint: {meta}")
    scored = history_head["scored"]
    feats = scored.features[-1]
    got = serving.forecast_forward(restored, feats, scored.src, scored.dst, scored.edge_mask, graphsage)
    want = serving.forecast_forward(history_head["params"], feats, scored.src, scored.dst, scored.edge_mask, graphsage)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w, err_msg="the inductive checkpoint's forecast", **EVAL_COMPARE)
    out["inductive_checkpoint"] = {
        "step": meta["step"],
        "num_features": meta["num_features"],
        "max_abs_diff": max(float(np.abs(a - w).max()) for a, w in zip(got, want)),
    }
    out["launches"] = {
        c.__name__: sum(head["launches"][c.__name__] for head in heads.values()) for c in counters
    }
    return out


def eval_stlgt_on_card(torch, device, counters) -> dict:
    """Phase 26 (b): eval_stlgt.evaluate at its published defaults on the
    card; its gate, and kernel 2's launches against the refreshes' steps
    and the baseline's."""
    from kmamiz_tpu_torch.ops import sparse
    from kmamiz_tpu_torch.tools import eval_stlgt

    refreshes: list = []
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eval_stlgt.evaluate(device=device, refreshes=refreshes, **STLGT_EVAL)
    wall = time.perf_counter() - t0
    launches = read_counts(torch, counters)
    doc = {k: v for k, v in res.items() if k != "trainer"}
    log("   (b) " + json.dumps(doc))
    check(res["stlgt_beats_baseline"], f"STLGT's p99 coverage does not beat GraphSAGE's: {doc}")
    check(all(r["ok"] for r in refreshes), f"a refresh failed: {refreshes}")
    epochs = STLGT_EVAL["epochs"]
    # STLGT: per step one gated forward and one backward C call (the SDDMM
    # and the row pass), one gated forward a scored tick; the baseline: per
    # step two forwards and one backward (the row pass alone), two
    # forwards a scored tick
    stlgt_steps = sum(r["stale_slots"] for r in refreshes) * epochs
    sage_steps = (res["trainer"]["foldsSeen"] - 1) * epochs
    scored = res["scored_ticks"]
    want = want_counts(
        counters,
        **{
            sparse.fused_sddmm_spmm.__name__: stlgt_steps + scored + 2 * (sage_steps + scored),
            sparse.fused_backward.__name__: stlgt_steps + sage_steps,
            sparse.fused_sddmm_spmm_grad_edges.__name__: stlgt_steps,
            sparse.fused_sddmm_spmm_grad_rows.__name__: stlgt_steps + sage_steps,
        },
    )
    check(launches == want, f"eval_stlgt launches {launches}, want {want}")
    return {
        "result": doc,
        "wall_s": wall,
        "refreshes": len(refreshes),
        "stlgt_steps": stlgt_steps,
        "sage_steps": sage_steps,
        "launches": launches,
    }


def eval_small_mesh(torch, device, counters) -> dict:
    """Phase 26 (c): eval_models' main on its EVAL_YAML at hidden 32 and
    EVAL_SMALL_EPOCHS on the card (its table logged), its rows finite and
    kernel 2's launches against its GraphSAGE steps (GAT launches none)."""
    import contextlib
    import io
    import re

    from kmamiz_tpu_torch.ops import sparse
    from kmamiz_tpu_torch.tools import eval_models

    printed = io.StringIO()
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        code = eval_models.main(
            ["--epochs", str(EVAL_SMALL_EPOCHS), "--hidden", str(EVAL_SMALL_HIDDEN), "--seed", str(SEED), "--device", str(device)]
        )
    wall = time.perf_counter() - t0
    launches = read_counts(torch, counters)
    table = printed.getvalue()
    for line in table.strip().splitlines():
        if line:
            log(f"   (c) {line}")
    check(code == 0, f"eval_models exited {code}")
    # the slot counts the steps come from: "held-out slots: E (of S)"
    eval_slots, slots = map(int, re.search(r"held-out slots: (\d+) \(of (\d+)\)", table).groups())
    train_slots = slots - eval_slots
    steps = train_slots * EVAL_SMALL_EPOCHS
    rows = {}
    for line in table.splitlines():
        cells = [c.strip() for c in line.strip("|").split("|")]
        if line.startswith("| ") and cells[0] != "model":
            rows[cells[0]] = [float(c) for c in cells[1:]]
    check(len(rows) == 5, f"eval_models' table has rows {sorted(rows)}")
    check(all(math.isfinite(v) for r in rows.values() for v in r), f"eval_models' rows {rows}")
    want = sage_counts(counters, sparse, steps, steps + train_slots + eval_slots)
    check(launches == want, f"eval_models launches {launches}, want {want}")
    return {
        "epochs": EVAL_SMALL_EPOCHS,
        "hidden": EVAL_SMALL_HIDDEN,
        "train_slots": train_slots,
        "eval_slots": eval_slots,
        "wall_s": wall,
        "rows": rows,
        "launches": launches,
    }


def evaluate_models(torch, device, counters, result, dataset) -> dict:
    """Phase 26, model evaluation: (a) eval_protocols over phase 21's
    simulation, (b) eval_stlgt_on_card, (c) eval_small_mesh, with no plain
    version of kernel 2 called on card tensors; the phase's launches summed
    for the kernels line."""
    from kmamiz_tpu_torch.ops import sparse

    root = tempfile.TemporaryDirectory(prefix="chip_smoke_eval_")
    # the eager steps are host-bound: a thread of an earlier phase that
    # still runs in this process takes the interpreter lock from them
    out: dict = {"threads": sorted(t.name for t in threading.enumerate())}
    log(f"   {len(out['threads'])} threads: {out['threads']}")
    try:
        with PlainOnCard(torch, sparse) as plain:
            for key, part in (
                ("protocols", lambda: eval_protocols(torch, device, counters, result, dataset, root.name)),
                ("stlgt", lambda: eval_stlgt_on_card(torch, device, counters)),
                ("eval_models", lambda: eval_small_mesh(torch, device, counters)),
            ):
                t0 = time.perf_counter()
                out[key] = part()
                out[key]["part_s"] = time.perf_counter() - t0
                log(f"   {key}: {out[key]['part_s']:.2f} s, launches {out[key]['launches']}")
        check(plain.calls == 0, f"{plain.calls} plain calls on card tensors in model evaluation")
        out["plain_calls_on_card"] = plain.calls
    finally:
        root.cleanup()
    out["launches"] = {
        c.__name__: sum(out[k]["launches"][c.__name__] for k in ("protocols", "stlgt", "eval_models"))
        for c in counters
    }
    return out


TENANTS = tuple(f"t{i}" for i in range(8))  # BASELINE split into eight clusters
TENANT_SERVICES = BASELINE["n_services"] // len(TENANTS)  # 125 services x 10 urls each
TENANT_TRACES = STATE_TRACES // len(TENANTS)  # phase 4's 150,000 traces split eight ways
TENANT_TICK_TRACES = TICK_TRACES // len(TENANTS)  # a round carries one BASELINE tick
TENANT_ROUNDS = 2
GATHER_WINDOW_MS = 50.0
TENANT_HOUR = 950  # the rounds' hour; (d) folds it and the next
SCENARIO = ("multi-tenant-mix", 0, 2, 6)  # build_scenario(archetype, seed, index, ticks)
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


def tenant_state_windows() -> dict:
    """Each tenant's state window (18,750 raw traces in its namespace),
    made on the process pool: tenant -> raw bytes."""
    raws = raw_windows(tenant_spec(TENANT_TRACES, 0, f"{t}-state-") for t in TENANTS)
    return {t: in_namespace(i, raw) for i, (t, raw) in enumerate(zip(TENANTS, raws))}


def serve_tenancy(torch, device, counters, jobs, windows_out: dict = None, stack_out: dict = None) -> dict:
    """Phase 22, multi-tenant serving: (a) eight tenants of 125 services x
    10 urls, each loaded with 18,750 raw traces, in one capacity bucket;
    (b) TENANT_ROUNDS (2) gathered rounds through a DataProcessorServer (gather window
    50 ms): the eight post at once (t0-t3 by /t/<tenant>/, t4-t7 by the
    tenant header), one stacked merge of 8 lanes and 16 segment-stats
    launches a round; (c) eight serial twins on the card and two CPU
    replays against them; the batched scorers against the twins'; (d) the
    control plane on the card: t0 and t1 fold two hours with the live STLGT
    head (one gated kernel-2 launch a fold), defer, high priority and shed;
    (e) the scenario factory's multi-tenant-mix through a second server
    with the WAL on: beta's poison storm in beta's quarantine only,
    alpha's graph equal to a clean serial run, a restart replaying each
    tenant's namespace. The tenants' state windows go into `windows_out`
    when one is given (phase 23 routes them through the fleet), and the
    last stacked merge's inputs into `stack_out["inputs"]` (phase 25 (f)
    shards them over the mesh)."""
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
    state_raw = tenant_state_windows()
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
    if windows_out is not None:
        windows_out.update(state_raw)
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
        if stack_out is not None:
            stack_out["inputs"] = router.last_stack_inputs
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


# -- phase 23: the fleet and the scenario runner ------------------------------

FLEET_WORKERS = tuple(f"w{i}" for i in range(4))
FLEET_VNODES = 64
FLEET_SEED = 0
FLEET_FRAMES = 10  # (a): each tenant's state window as this many frames
FLEET_PROC_FRAMES = 2  # (c): the frames each tenant sends the worker processes
FLEET_BENCH_FRAMES = 24  # (c): the fleet bench's frames a tenant (the tool's default)
#: (d): the archetypes the runner drives on the card, each at the factory's
#: own sizes and DEFAULT_TICKS (the always-on first three, kill -9, growth,
#: the fleet and the WAL replay)
RUNNER_ARCHETYPES = (
    "steady-chain",
    "cascade-fanout",
    "multi-tenant-mix",
    "kill9-wal-replay",
    "capacity-growth-chain",
    "fleet-migration",
    "wal-replay",
)
COUNTERFACTUAL_TICKS = 8


class TimedTransport:
    """A fleet transport proxy that times the migration's steps (drain,
    ship = the WAL export, replay = the import, flip = from the commit to
    the migration's end, which the caller closes) and fires `mid` once,
    between the drain and the export: a frame racing the handoff."""

    def __init__(self, inner, mid) -> None:
        self._inner, self._mid = inner, mid
        self.walls: dict = {}
        self.blob_bytes = 0
        self.commit_t0 = None

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _timed(self, key, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.walls[key] = (time.perf_counter() - t0) * 1e3

    def drain(self, worker_id, tenant):
        return self._timed("drain_ms", self._inner.drain, worker_id, tenant)

    def wal_export(self, worker_id, tenant):
        self._mid()
        blob = self._timed("ship_ms", self._inner.wal_export, worker_id, tenant)
        self.blob_bytes = len(blob)
        return blob

    def wal_import(self, worker_id, tenant, data):
        return self._timed("replay_ms", self._inner.wal_import, worker_id, tenant, data)

    def commit_import(self, worker_id, tenant):
        self.commit_t0 = time.perf_counter()
        return self._inner.commit_import(worker_id, tenant)


def migrate_with_frame(coord, tenant: str, target: str, mid_frame: bytes, migrate_tenant) -> tuple:
    """migrate_tenant(coord, tenant, target) through a TimedTransport whose
    mid-handoff frame is `mid_frame`, routed through the coordinator (it
    must park in the drain queue); returns (the migration's result, its
    step walls and handoff bytes)."""
    parked = []

    def mid():
        parked.append(coord.route_ingest(tenant, mid_frame))

    real = coord.transport
    timed = TimedTransport(real, mid)
    coord.swap_transport(timed)
    try:
        result = migrate_tenant(coord, tenant, target)
    finally:
        coord.swap_transport(real)
    walls = dict(timed.walls, flip_ms=(time.perf_counter() - timed.commit_t0) * 1e3, handoff_bytes=timed.blob_bytes)
    check(parked == [None], f"the mid-handoff frame was not queued: {parked}")
    check(result["ok"] and result["queuedReleased"] == 1, f"migration {result}")
    return result, {k: round(v, 3) if isinstance(v, float) else v for k, v in walls.items()}


def gpu_memory_used_mib() -> int:
    """The card's memory in use, every process's, by nvidia-smi (MiB)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout
    return int(out.strip().splitlines()[0])


def gpu_memory_by_process_mib() -> dict:
    """pid -> the card memory each process holds, by nvidia-smi (MiB);
    empty where the sandbox hides the processes."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
        capture_output=True,
        text=True,
    ).stdout
    rows = [line.split(",") for line in out.strip().splitlines() if line.count(",") == 1]
    return {pid.strip(): int(mib) for pid, mib in rows if mib.strip().isdigit()}


def serve_fleet(torch, device, counters, state_raw: dict) -> dict:
    """Phase 23, the fleet and the scenario runner: (a) four in-process
    FleetWorkers on the card behind a LocalTransport coordinator (ring seed
    0, 64 vnodes) take phase 22's eight tenant state windows as 10 frames
    each through route_ingest; every tenant's signature equals a serial
    twin fed the same frames, and the fold of the eight on the card equals
    the CPU fold of the same exports; (b) the tenant placement's rebalance
    plan names (t0 without a plan) migrates with one frame mid-handoff,
    bit-exact with the twin, no trace lost, the source's copy dropped;
    (c) four `python -m kmamiz_tpu_torch.fleet.worker` processes on the
    card (booted while (a) and (b) run) behind an HTTPTransport, two
    tenants each, one migration over the
    /fleet/* routes with a frame mid-handoff, fleetscrape's merge of
    their /metrics, and the fleet_bench tool's scorecard over them; (d)
    run_scenario of RUNNER_ARCHETYPES and run_counterfactual on the card,
    every card passing. No kernel runs on
    this path (device statistics off, the counterfactual's forecast
    given): the counters must read 0."""
    from kmamiz_tpu_torch import native
    from kmamiz_tpu_torch.fleet import placement
    from kmamiz_tpu_torch.fleet.coordinator import FleetCoordinator, HTTPTransport, LocalTransport
    from kmamiz_tpu_torch.fleet.migration import migrate_tenant
    from kmamiz_tpu_torch.fleet.ring import HashRing
    from kmamiz_tpu_torch.fleet.worker import FleetWorker
    from kmamiz_tpu_torch.graph.store import EndpointGraph, graph_signature
    from kmamiz_tpu_torch.scenarios import ARCHETYPES, build_scenario, run_counterfactual, run_scenario
    from kmamiz_tpu_torch.scenarios.factory import DEFAULT_TICKS
    from kmamiz_tpu_torch.server.processor import DataProcessor
    from kmamiz_tpu_torch.telemetry import fleetscrape
    from kmamiz_tpu_torch.tools import fleet_bench

    from concurrent.futures import ThreadPoolExecutor

    out: dict = {"workers": len(FLEET_WORKERS), "tenants": len(TENANTS), "frames_per_tenant": FLEET_FRAMES}
    root = tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_")
    zero_counts(counters)
    frames = {t: native.split_groups(state_raw[t], FLEET_FRAMES) for t in TENANTS}
    check(all(len(f) == FLEET_FRAMES for f in frames.values()), "a state window split into fewer frames")

    # (c)'s worker processes boot while (a) and (b) run: the first ring
    # seed that gives each worker two tenants
    seed = next(s for s in range(1000) if set(HashRing(list(FLEET_WORKERS), FLEET_VNODES, s).spread(TENANTS).values()) == {2})
    ring2 = HashRing(list(FLEET_WORKERS), vnodes=FLEET_VNODES, seed=seed)
    ports = {w: free_port() for w in FLEET_WORKERS}
    mem_before = gpu_memory_used_mib()

    def boot(w):
        env = {
            "KMAMIZ_WAL": "1",
            "KMAMIZ_WAL_DIR": os.path.join(root.name, "procs", w),
            "KMAMIZ_QUARANTINE_DIR": os.path.join(root.name, "quarantine", w),
        }
        args = ["--worker-id", w, "--port", str(ports[w])]
        return Served("kmamiz_tpu_torch.fleet.worker", env, ports[w], "/", os.path.join(root.name, f"{w}.log"), args=args)

    boots = ThreadPoolExecutor(max_workers=len(FLEET_WORKERS))
    booting = {w: boots.submit(boot, w) for w in FLEET_WORKERS}

    def twin_of(t, frame_list, tag):
        twin = DataProcessor(TickFeed(), device=device, use_device_stats=False, wal=None, tenant=f"{tag}-{t}")
        for raw in frame_list:
            twin.ingest_raw_window(raw)
        return twin

    def mid_frame(t, k):
        i = TENANTS.index(t)
        return tenant_window(i, TENANT_TICK_TRACES, TENANT_TRACES * (4 + k), f"{t}-mid{k}-")

    try:
        # (a) the in-process fleet at BASELINE width
        ring = HashRing(list(FLEET_WORKERS), vnodes=FLEET_VNODES, seed=FLEET_SEED)
        workers = {w: FleetWorker(w, wal_root=os.path.join(root.name, "inproc"), device=device) for w in ring.workers}
        coord = FleetCoordinator(ring, LocalTransport(workers))
        out["placement"] = ring.assignment(TENANTS)
        per_worker = {w: {"spans": 0, "ms": 0.0} for w in ring.workers}
        t0 = time.perf_counter()
        for k in range(FLEET_FRAMES):
            for t in TENANTS:
                owner = coord.owner(t)
                t1 = time.perf_counter()
                summary = coord.route_ingest(t, frames[t][k])  # returns after the merge
                per_worker[owner]["ms"] += (time.perf_counter() - t1) * 1e3
                per_worker[owner]["spans"] += summary["spans"]
        route_s = time.perf_counter() - t0
        spans = sum(w["spans"] for w in per_worker.values())
        out["spans"] = spans
        out["spans_per_s"] = spans / route_s
        out["spans_per_s_by_worker"] = {
            w: (v["spans"] / (v["ms"] / 1e3) if v["ms"] else 0.0) for w, v in per_worker.items()
        }
        check(spans == TENANT_TRACES * SPANS_PER_TRACE * len(TENANTS), f"{spans} spans routed")
        twins = {t: twin_of(t, frames[t], "fleet-twin") for t in TENANTS}
        for t in TENANTS:
            check(workers[coord.owner(t)].signature(t) == graph_signature(twins[t].graph), f"{t} differs from its twin")
        tenant_edges = {t: int(twins[t].graph.n_edges) for t in TENANTS}
        exports = [workers[coord.owner(t)].export_edges(t) for t in TENANTS]
        aggregate = EndpointGraph(device=device, tenant="fleet-aggregate")
        t0 = time.perf_counter()
        folded = coord.fold(list(TENANTS), aggregate)
        torch.cuda.synchronize()
        out["fold_ms"] = (time.perf_counter() - t0) * 1e3
        cpu_agg = EndpointGraph(device="cpu", tenant="fleet-aggregate-cpu")
        cpu_folded = sum(cpu_agg.fold_named_edges(e) for e in exports)
        check(folded == cpu_folded == aggregate.n_edges == sum(tenant_edges.values()), f"fold {folded} edges")
        check(graph_signature(aggregate) == graph_signature(cpu_agg), "the card fold's signature differs from the CPU's")
        check(aggregate.export_named_edges() == cpu_agg.export_named_edges(), "the card fold's edges differ from the CPU's")
        out["aggregate"] = {
            "edges": int(aggregate.n_edges),
            "endpoints": len(aggregate.interner.endpoints),
            "capacity": int(aggregate.capacity),
            "device_bytes": sum(aggregate.arena_bytes().values()),
        }
        del cpu_agg
        log("   (a) " + json.dumps(out))

        # (b) live migration of the tenant the placement names
        plan = placement.rebalance_plan(ring, TENANTS, overrides=coord.snapshot()["overrides"])
        if plan:
            tenant, source, target = plan[0]
        else:
            tenant, source = "t0", coord.owner("t0")
            target = placement.pick_target(ring, tenant, TENANTS)
            if target == source:
                target = next(w for w in ring.workers if w != source)
        pre = workers[source].signature(tenant)
        mid = mid_frame(tenant, 0)
        result, walls = migrate_with_frame(coord, tenant, target, mid, migrate_tenant)
        twins[tenant].ingest_raw_window(mid)
        check(result["signature"] == pre, f"{tenant}: the replay differs from the pre-drain signature")
        check(workers[target].signature(tenant) == graph_signature(twins[tenant].graph), f"{tenant} differs after the flip")
        landed = set(workers[target].processor(tenant)._processed)
        lost = len(set(twins[tenant]._processed) - landed)
        check(lost == 0, f"{lost} traces of {tenant} lost in the migration")
        check(tenant not in workers[source].tenants(), f"{source} kept {tenant}")
        out["migration"] = {"plan": [list(m) for m in plan], "tenant": tenant, "source": source, "target": target,
                            "records": result["records"], "lost_traces": lost, **walls}
        log("   (b) " + json.dumps(out["migration"]))
        del workers, coord, twins, aggregate

        # (c) four worker processes behind an HTTPTransport, two tenants each
        served = {w: f.result() for w, f in booting.items()}
        procs_out = {"ring_seed": seed, "placement": ring2.assignment(TENANTS), "boot_ms": {w: round(p.boot_ms, 1) for w, p in served.items()}}
        try:
            for w, p in served.items():
                check(p.health["device"].startswith("cuda"), f"worker {w} serves on {p.health['device']}")
            procs_out["gpu_memory_used_mib"] = {
                "before_phase": mem_before,
                "four_up": gpu_memory_used_mib(),
                "by_process": gpu_memory_by_process_mib(),
            }
            endpoints = {w: f"http://127.0.0.1:{port}" for w, port in ports.items()}
            transport = HTTPTransport(endpoints, timeout_s=300)
            coord2 = FleetCoordinator(ring2, transport)
            t0 = time.perf_counter()
            for k in range(FLEET_PROC_FRAMES):
                for t in TENANTS:
                    coord2.route_ingest(t, frames[t][k])
            procs_out["route_s"] = time.perf_counter() - t0
            tenant2 = "t1"
            source2 = coord2.owner(tenant2)
            target2 = placement.pick_target(ring2, tenant2, TENANTS)
            if target2 == source2:
                target2 = next(w for w in FLEET_WORKERS if w != source2)
            pre2 = transport.signature(source2, tenant2)
            mid2 = mid_frame(tenant2, 1)
            result2, walls2 = migrate_with_frame(coord2, tenant2, target2, mid2, migrate_tenant)
            twin2 = twin_of(tenant2, [*frames[tenant2][:FLEET_PROC_FRAMES], mid2], "fleet-proc-twin")
            check(result2["signature"] == pre2, f"{tenant2}: the replay over HTTP differs from the pre-drain signature")
            check(transport.signature(target2, tenant2) == graph_signature(twin2.graph), f"{tenant2} differs after the flip over HTTP")
            check(transport.drop_tenant(source2, tenant2)["dropped"] is False, f"{source2} kept {tenant2}")
            procs_out["migration"] = {"tenant": tenant2, "source": source2, "target": target2, "records": result2["records"], **walls2}
            pages = fleetscrape.scrape_workers(endpoints)
            merged = fleetscrape.aggregate(pages)
            page = fleetscrape.render(pages)
            payloads = merged["kmamiz_ingest_payloads_total"]
            per = {w: payloads.get(f'worker="{w}"', 0.0) for w in FLEET_WORKERS}
            check(all(per.values()) and payloads[""] == sum(per.values()), f"scraped payloads {payloads}")
            check(all(f'kmamiz_ingest_payloads_total{{worker="{w}"}}' in page for w in FLEET_WORKERS), "per-worker series missing")
            procs_out["scrape"] = {"payloads_total": payloads[""], "payloads_by_worker": per, "page_lines": page.count("\n")}
            # the fleet bench over the same four processes (tenants of its
            # own on ring2): one worker against four, then a migration with
            # a frame racing the handoff; the efficiency recorded, not gated
            t0 = time.perf_counter()
            bench = fleet_bench.scorecard(transport, ring2, FLEET_BENCH_FRAMES)
            bench["wall_s"] = time.perf_counter() - t0
            procs_out["fleet_bench"] = bench
            check("fleet_bench_error" not in bench, f"fleet bench: {bench.get('fleet_bench_error')}")
            check(
                bench["fleet_migration_pass"] is True and bench["fleet_migration_lost_spans"] == 0,
                f"fleet bench migration {bench}",
            )
        finally:
            for p in served.values():
                p.stop(15)
        out["processes"] = procs_out
        log("   (c) " + json.dumps(procs_out))

        # (d) the runner on the card
        names = [name for name, _ in ARCHETYPES]
        cards = {}
        for arch in RUNNER_ARCHETYPES:
            spec = build_scenario(arch, 0, names.index(arch), DEFAULT_TICKS)
            # the fleet-migration card with the runner's lock witness armed
            witnessed = arch == "fleet-migration"
            with tempfile.TemporaryDirectory(prefix="chip_smoke_scn_") as tmp, env_set(
                KMAMIZ_LOCK_WITNESS="1" if witnessed else None
            ):
                card = run_scenario(spec, tmpdir=tmp, device=device)
            cards[arch] = {k: card[k] for k in ("wall_s", "p50_tick_ms", "p99_tick_ms", "posts", "lost_spans")}
            check(card["pass"], f"{arch}: {card['gates']} {card['errors']}")
            check(card["lost_spans"] == 0 and card["gates"]["bit_exact"], f"{arch}: lost {card['lost_spans']}")
            if witnessed:
                gates = card["gates"]
                check(
                    gates.get("lock_witness_acyclic") is True and gates.get("lock_witness_covered") is True,
                    f"{arch}: lock witness gates {gates} {card['lock_witness']}",
                )
                cards[arch]["lock_witness"] = {k: card["lock_witness"][k] for k in ("edges", "acquires")}
        cf = run_counterfactual(seed=0, n_ticks=COUNTERFACTUAL_TICKS, device=device)
        check(cf["pass"] and cf["slo_violations_prevented"] >= 1, f"counterfactual {cf['gates']}")
        cards["counterfactual"] = {"wall_s": cf["wall_s"], "prevented": cf["slo_violations_prevented"]}
        out["runner"] = cards
        log("   (d) " + json.dumps(cards))

        # the fold's device time, last: a profiler session slows the host's
        # later launches
        def fold_all():
            g = EndpointGraph(device=device, tenant="fleet-fold-probe")
            for e in exports:
                g.fold_named_edges(e)
            return g

        events = traced(torch, fold_all)
        out["fold_device_ms"] = (
            sum(e.time_range.end - e.time_range.start for e in events) / 1e3 if events is not None else None
        )
        out["fold_device_events"] = len(events) if events is not None else None
        log("   fold " + json.dumps({k: out[k] for k in ("fold_ms", "fold_device_ms", "fold_device_events")}))
    finally:
        for pending in booting.values():
            try:
                pending.result().stop(15)
            except Exception:  # noqa: BLE001 - a boot that failed has nothing to stop
                pass
        boots.shutdown()
        root.cleanup()
    out["launches"] = read_counts(torch, counters)
    check(not any(out["launches"].values()), f"phase 23 launched {out['launches']}")
    return out


#: (a): the JAX package's acceptance sweep has 200 cells; depth cut to 6
#: seeds of each of the 8 archetypes (the least the sweep keeps) to hold
#: the whole run near 900 s
SOAK_CELLS = 48
SOAK_TICKS = 4
SOAK_WORKERS = 4
SOAK_RESUME_CELLS = 12  # (b): the JAX kill-and-resume test's sweep
SOAK_RESUME_AFTER = 3  # results landed before the kill
SOAK_MATRIX = 3  # (c)
SOAK_MATRIX_TICKS = 6
PROF_CAPTURE_TICKS = 4  # (d)
#: the report fields a resumed sweep must reproduce (tests/test_graftsoak.py)
SOAK_DETERMINISTIC = ("cells", "bugs", "pass_rate", "triaged_fraction", "poison_cells", "soak_pass", "cells_total")


class MemorySampler:
    """The card's memory in use (nvidia-smi, every process's), sampled on a
    thread until stopped: the peak, in MiB. With `minus` (bytes, read at
    each sample: this process's caching allocator's reserve), the card's
    memory less that: what the other processes and this one's fixed
    context hold, while this process allocates beside them."""

    def __init__(self, period_s: float = 0.5, minus=None) -> None:
        import threading

        self._minus = minus
        self.peak = self._sample()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(period_s,), daemon=True)
        self._thread.start()

    def _sample(self) -> int:
        used = gpu_memory_used_mib()
        return used - (self._minus() >> 20 if self._minus else 0)

    def _run(self, period_s: float) -> None:
        while not self._stop.wait(period_s):
            self.peak = max(self.peak, self._sample())

    def stop(self) -> int:
        self._stop.set()
        self._thread.join()
        return self.peak


def graftsoak_args(cells: int, soak_dir: str, poison: int) -> list:
    return [
        "--cells", str(cells), "--ticks", str(SOAK_TICKS), "--workers", str(SOAK_WORKERS),
        "--poison", str(poison), "--soak-dir", soak_dir,
    ]


def graftsoak_cmd(cells: int, soak_dir: str, poison: int) -> list:
    return [sys.executable, "-m", "kmamiz_tpu_torch.tools.graftsoak", *graftsoak_args(cells, soak_dir, poison)]


class SweepProcess:
    """Phase 24 (a)'s graftsoak process (SOAK_CELLS cells, one poison),
    started beside phase 16 and read in phase 24: its wall from the start
    to the process's end, and the card's memory meanwhile less this
    process's allocator's reserve (MemorySampler's `minus`: phase 16
    allocates beside the workers). Killed with its workers if the run
    ends first."""

    def __init__(self, torch, root: str) -> None:
        import threading

        self.dir = os.path.join(root, "sweep")
        self.log_path = os.path.join(root, "graftsoak.log")
        self.mem = MemorySampler(minus=torch.cuda.memory_reserved)
        self.mem_before = self.mem.peak
        self._err = open(self.log_path, "a")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            graftsoak_cmd(SOAK_CELLS, self.dir, 1), cwd=REPO, stdout=subprocess.PIPE, stderr=self._err,
            text=True, start_new_session=True,
        )
        atexit.register(self.kill)
        self._out: list = []
        self._waiter = threading.Thread(target=self._wait, daemon=True)
        self._waiter.start()

    def _wait(self) -> None:
        self._out.append(self.proc.communicate()[0])
        self.wall = time.perf_counter() - self.t0
        self.mem_peak = self.mem.stop()

    def kill(self) -> None:
        import signal

        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()

    def join(self) -> None:
        self._waiter.join()
        self._err.close()

    def result(self) -> tuple:
        """(exit code, its report, host wall s) once joined."""
        lines = [ln for ln in self._out[0].splitlines() if ln.strip()]
        check(bool(lines), f"graftsoak printed no report (exit {self.proc.returncode}); see {self.log_path}")
        return self.proc.returncode, json.loads(lines[-1]), self.wall


def tool_main(main, argv) -> tuple:
    """A tool's main(argv) in this process: (exit code, its last stdout
    line as JSON)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    return code, json.loads(lines[-1])


def serve_soak(torch, device, counters, sweep: SweepProcess = None) -> dict:
    """Phase 24, the soak sweep: (a) graftsoak's acceptance sweep (SOAK_CELLS
    cells) with four worker processes on the card (`sweep`, started beside
    phase 16; started here and joined without it); (b) a 12-cell sweep killed
    mid-run and resumed twice; (c) scenario_soak's 3-scenario matrix on
    the card; (d) graftprof's capture on the card (kernel 1's launches
    counted, the raw-ingest leg checked) against a CPU capture, and its --diff blame over (a)'s
    poison cell."""
    import signal

    from kmamiz_tpu_torch.soak import SoakManifest
    from kmamiz_tpu_torch.tools import graftprof, graftsoak, scenario_soak

    out: dict = {}
    root = tempfile.TemporaryDirectory(prefix="chip_smoke_soak_")
    try:
        # (a) the acceptance sweep
        if sweep is None:
            sweep = SweepProcess(torch, root.name)
            sweep.join()
        code, report, wall = sweep.result()
        sweep_dir, log_path = sweep.dir, sweep.log_path
        mem_before, mem_peak = sweep.mem_before, sweep.mem_peak
        results = SoakManifest(sweep_dir).load_results()
        p99 = sorted(r["p99_tick_ms"] for r in results.values() if not r["poison"])
        sweep = {
            "cells_total": report["cells_total"],
            "cells_executed": report["cells_executed"],
            "pass_rate": report["pass_rate"],
            "triaged_fraction": report["triaged_fraction"],
            "soak_pass": report["soak_pass"],
            "exit_code": code,
            "poison_cells": report["poison_cells"],
            "bugs": [{k: b[k] for k in ("signature", "count", "cells")} for b in report["bugs"]],
            "wall_s": report["wall_s"],
            "host_wall_s": round(wall, 2),
            "cells_per_min": report["cells_per_min"],
            "p99_tick_ms": {"min": p99[0], "median": statistics.median(p99), "max": p99[-1]} if p99 else None,
            "cell_wall_s": statistics.median(r["wall_s"] for r in results.values()) if results else None,
            "gpu_memory_used_mib": {"before": mem_before, "peak_with_workers": mem_peak},
        }
        out["sweep"] = sweep
        log("   (a) " + json.dumps(sweep))
        check(report["complete"] and report["cells_total"] == SOAK_CELLS, f"sweep incomplete: {report['cells_finished']}/{report['cells_total']}")
        check(report["pass_rate"] >= 0.9999, f"pass rate {report['pass_rate']}: {report['failures']}")
        check(report["triaged_fraction"] == 1.0, f"triaged fraction {report['triaged_fraction']}")
        check(len(report["poison_cells"]) == 1, f"poison cells {report['poison_cells']}")
        poison_bug = [b for b in report["bugs"] if b["blamed_gate"] == "soak_poison"]
        check(bool(poison_bug) and poison_bug[0]["cells"] == report["poison_cells"], f"poison bug {report['bugs']}")
        check((code == 0) == report["soak_pass"] and report["soak_pass"], f"exit {code}, soak_pass {report['soak_pass']}")
        check(mem_peak - mem_before >= 1024, f"the workers held {mem_peak - mem_before} MiB of the card")

        # (b) kill -9 mid-sweep, then resume
        resume_dir = os.path.join(root.name, "resume")
        with open(log_path, "a") as err:
            killed = subprocess.Popen(
                graftsoak_cmd(SOAK_RESUME_CELLS, resume_dir, 0), cwd=REPO,
                stdout=subprocess.DEVNULL, stderr=err, start_new_session=True,
            )
        man = SoakManifest(resume_dir)
        deadline = time.time() + 240
        try:
            while time.time() < deadline and len(man.load_results()) < SOAK_RESUME_AFTER and killed.poll() is None:
                time.sleep(0.1)
        finally:
            os.killpg(killed.pid, signal.SIGKILL)
            killed.wait()
        done_before = set(man.load_results())
        in_flight = len(os.listdir(man.claims_dir)) - len(done_before)
        check(SOAK_RESUME_AFTER <= len(done_before) < SOAK_RESUME_CELLS, f"{len(done_before)} cells before the kill")
        # the resume and the third run through the tool's main() in this
        # process (its workers are processes of their own): no interpreter
        # start of their own
        t0 = time.perf_counter()
        code, resumed = tool_main(graftsoak.main, graftsoak_args(SOAK_RESUME_CELLS, resume_dir, 0))
        resume_wall = time.perf_counter() - t0
        check(code == 0 and resumed["complete"] and resumed["cells_total"] == SOAK_RESUME_CELLS, f"resume: exit {code}")
        check(resumed["cells_executed"] == SOAK_RESUME_CELLS - len(done_before), f"resume executed {resumed['cells_executed']}")
        after = man.load_results()
        check(all(after[c]["run_id"] != resumed["run_id"] for c in done_before), "the resume re-ran a finished cell")
        t0 = time.perf_counter()
        code, again = tool_main(graftsoak.main, graftsoak_args(SOAK_RESUME_CELLS, resume_dir, 0))
        again_wall = time.perf_counter() - t0
        check(code == 0 and again["cells_executed"] == 0, f"third run: exit {code}, executed {again['cells_executed']}")
        for key in SOAK_DETERMINISTIC:
            check(again[key] == resumed[key], f"the third run's {key} differs")
        out["resume"] = {
            "done_before_kill": len(done_before),
            "in_flight_at_kill": in_flight,
            "resume_executed": resumed["cells_executed"],
            "third_executed": again["cells_executed"],
            "resume_wall_s": round(resume_wall, 2),
            "third_wall_s": round(again_wall, 2),
        }
        log("   (b) " + json.dumps(out["resume"]))

        # (c) the scenario matrix on the card
        t0 = time.perf_counter()
        code, matrix = tool_main(scenario_soak.main, ["--matrix", str(SOAK_MATRIX), "--ticks", str(SOAK_MATRIX_TICKS)])
        out["matrix"] = {
            "exit_code": code,
            "wall_s": round(time.perf_counter() - t0, 2),
            **{k: v for k, v in matrix.items() if k != "scenarios"},
            "cards": {c["name"]: {k: c[k] for k in ("wall_s", "p99_tick_ms", "posts")} for c in matrix["scenarios"]},
        }
        log("   (c) " + json.dumps(out["matrix"]))
        check(code == 0 and matrix["scenario_matrix_pass"], f"scenario matrix: {[c['gates'] for c in matrix['scenarios']]}")
        check(matrix["scenario_lost_spans"] == 0 and len(matrix["scenarios"]) == SOAK_MATRIX, f"matrix lost {matrix['scenario_lost_spans']}")

        # (d) graftprof: the capture on the card, its answers against a CPU
        # capture's, and the diffs
        cap = os.path.join(root.name, "capture.json")
        answers, cpu_answers, ingest, cpu_ingest = [], [], [], []
        zero_counts(counters)
        t0 = time.perf_counter()
        profile = graftprof.capture(cap, ticks=PROF_CAPTURE_TICKS, device=device, answers=answers, ingest=ingest)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        launches = read_counts(torch, counters)
        graftprof.capture(
            os.path.join(root.name, "capture_cpu.json"), ticks=PROF_CAPTURE_TICKS, device="cpu",
            answers=cpu_answers, ingest=cpu_ingest,
        )
        check(len(answers) == len(cpu_answers) == PROF_CAPTURE_TICKS, f"{len(answers)} capture answers")
        for got, want in zip(answers, cpu_answers):
            compare_ticks(got, want)
        # the raw-ingest leg ran on the card (the tool skips it on a
        # ValueError), counted what the CPU's counted, and is profiled
        check(len(ingest) == len(cpu_ingest) == 1, f"the raw-ingest leg was skipped: {len(ingest)}/{len(cpu_ingest)} summaries")
        leg = {k: v for k, v in ingest[0].items() if k != "ms"}
        check(leg["spans"] > 0 and "quarantined" not in leg, f"the raw-ingest leg: {ingest[0]}")
        check(leg == {k: v for k, v in cpu_ingest[0].items() if k != "ms"}, f"the raw-ingest leg {ingest[0]} against the CPU's {cpu_ingest[0]}")
        check(profile["ticks"] == PROF_CAPTURE_TICKS + 1, f"the capture profiled {profile['ticks']} ticks")
        check({"dp-ingest", "native-merge"} <= set(profile["phases"]), f"the capture's phases: {sorted(profile['phases'])}")
        self_code, self_diff = tool_main(graftprof.main, ["--diff", cap, cap])
        poison_id = report["poison_cells"][0]
        poison = results[poison_id]
        baseline = SoakManifest(sweep_dir).baseline_path(poison["archetype"])
        blame_code, blame = tool_main(graftprof.main, ["--diff", baseline, poison["flight_artifact"]])
        out["graftprof"] = {
            "ticks": profile["ticks"],
            "wall_ms": profile["wall_ms"],
            "attribution_ratio": profile["attribution_ratio"],
            "capture_s": round(capture_s, 3),
            "ingest": ingest[0],
            "launches": launches,
            "self_diff_exit": self_code,
            "blame_exit": blame_code,
            "blame": blame.get("blame"),
            "regressions": len(blame["regressions"]),
        }
        log("   (d) " + json.dumps(out["graftprof"]))
        check(profile["attribution_ratio"] >= 0.90, f"attribution {profile['attribution_ratio']}")
        check(launches["segment_stats"] == 2 * PROF_CAPTURE_TICKS, f"the capture launched segment_stats {launches['segment_stats']} times")
        check(not any(v for k, v in launches.items() if k != "segment_stats"), f"the capture launched {launches}")
        check(self_code == 0 and self_diff["regressions"] == [], f"the capture's self-diff: {self_diff}")
        check(
            blame.get("blame", {}).get("blamed_gate") == "soak_poison" and blame["blame"]["blamed_phase"] == "poison",
            f"the poison cell's blame: {blame}",
        )
    finally:
        root.cleanup()
    out["launches"] = out["graftprof"]["launches"]
    return out


MESH_SHARDS = 8  # phase 25: virtual shards of the one card
MESH_GRID = (2, 4)  # the ('host', 'spans') grid of the hierarchical merge
MESH_MERGES = ("psum", "ring", "hierarchical")
MESH_STREAM_CHUNKS = 4  # (c): ingest_raw_stream's chunks
MESH_STREAM_TRACES = 12_500  # (c): traces a chunk, at the BASELINE mesh
MESH_STAGE_CAP = 256  # (c): the stage cap that forces every shard to re-walk
MESH_SLOTS = 8  # (e): the slot batch, one slot a shard
STAT_COLUMNS = ("endpoint_id", "status_id", "status_class", "latency_ms", "timestamp_rel", "valid_server")


class VirtualShards:
    """parallel/mesh.process_devices, the mesh's one test seam, answering
    `n` copies of one card for the block: active_mesh("cuda") is then the
    mesh of n virtual shards that a host with n cards would give, and every
    deployed caller shards over it. The patch goes when the block ends."""

    def __init__(self, torch, pmesh, card, n: int = MESH_SHARDS) -> None:
        self.torch, self.pmesh, self.card, self.n = torch, pmesh, card, n

    def __enter__(self):
        self.saved = self.pmesh.process_devices
        saved, torch = self.saved, self.torch

        def devices(device):
            return [self.card] * self.n if torch.device(device).type == self.card.type else saved(device)

        self.pmesh.process_devices = devices
        self.env = env_set(KMAMIZ_MESH=None, KMAMIZ_MESH_DEVICES=None, KMAMIZ_TENANT_SHARD=None)
        self.env.__enter__()
        return self

    def __exit__(self, *exc):
        self.env.__exit__(*exc)
        self.pmesh.process_devices = self.saved
        return False


class CallCount:
    """Counts the calls of a module's function during the block (through
    the module attribute, as its callers reach it)."""

    def __init__(self, module, name: str) -> None:
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def counted(*a, **kw):
            self.calls += 1
            return self.real(*a, **kw)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


def synced_s(torch, fn):
    """(fn()'s result, its wall in s from an idle card to a synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_stats(torch, got, want, what: str) -> dict:
    """The tick's tolerances between two WindowStats on the card: counts,
    4xx/5xx and timestamps equal; latency mean rel 1e-5 / abs 1e-6; cv rel
    1e-3 / abs 1e-5. Returns the largest differences of the two floats."""
    for name in ("count", "error_4xx", "error_5xx", "latest_timestamp_rel"):
        check(torch.equal(getattr(got, name), getattr(want, name)), f"{what}: {name} differs")
    out = {}
    for name, rtol, atol in (("latency_mean", 1e-5, 1e-6), ("latency_cv", 1e-3, 1e-5)):
        g, w = getattr(got, name), getattr(want, name)
        check(torch.allclose(g, w, rtol=rtol, atol=atol), f"{what}: {name} off by {float((g - w).abs().max())}")
        out[name] = float((g - w).abs().max())
    return out


def serve_mesh(torch, device, counters, proc, tenant_stack=None) -> dict:
    """Phase 25, the device mesh (parallel/mesh.py) on MESH_SHARDS (8)
    virtual shards of the one card: (a) sharded_window_stats under psum,
    ring and hierarchical (a 2 x 4 ('host', 'spans') grid) against
    window_stats on the card, at the production window and at a
    2,500-trace tick, kernel 1 launching 2 x 8 times a call; (b) a collect
    tick with the mesh and one without, both from phase 4's graph carried
    by name; (c) ingest_raw_stream of 4 chunks of 12,500 traces at the
    BASELINE mesh with the mesh and without, and once more with a stage
    cap of 256 rows that makes every shard re-walk; (d)
    sharded_service_scores on phase 4's graph against the single-device
    scorer; (e) one make_sharded_slot_grad step of GraphSAGE (hidden 64, 18
    features, the phase-11 slots, 8 of them) against the per-slot loop;
    (f) phase 22's last stacked merge, its eight tenant lanes sharded one a
    device, against serial merges (None: not carried, recorded). Every
    wall is printed beside the mesh's devices: it is launch cost on one
    card, not scaling across cards."""
    import contextlib

    import numpy as np

    from kmamiz_tpu_torch.graph import store as store_mod
    from kmamiz_tpu_torch.graph.convert import graph_from_export
    from kmamiz_tpu_torch.graph.store import _merge_edges, graph_signature
    from kmamiz_tpu_torch.models import common, graphsage, stacked
    from kmamiz_tpu_torch.ops import scorers as scorer_ops
    from kmamiz_tpu_torch.ops import segment_stats as ss
    from kmamiz_tpu_torch.ops import sparse
    from kmamiz_tpu_torch.ops import window as window_ops
    from kmamiz_tpu_torch.parallel import mesh as pmesh
    from kmamiz_tpu_torch.server.processor import DataProcessor
    from kmamiz_tpu_torch.tenancy import batch

    card = torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda" else device
    shards = [card] * MESH_SHARDS
    label = f"{MESH_SHARDS} x {card}"
    mesh = pmesh.make_mesh(devices=shards)
    grid = pmesh.Mesh(np.array(shards, dtype=object).reshape(MESH_GRID), ("host", "spans"))
    seg, fwd = ss.segment_stats.__name__, sparse.fused_sddmm_spmm.__name__
    bwd, rows = sparse.fused_backward.__name__, sparse.fused_sddmm_spmm_grad_rows.__name__
    launches = {c.__name__: 0 for c in counters}
    out: dict = {"mesh": label, "grid": f"{MESH_GRID[0]} x {MESH_GRID[1]} ('host', 'spans') of {card}"}

    def counted(fn):
        zero_counts(counters)
        result, wall = synced_s(torch, fn)
        got = read_counts(torch, counters)
        for k, v in got.items():
            launches[k] += v
        return result, wall, got

    def virtual():
        return VirtualShards(torch, pmesh, card)

    # (a) the sharded stats against window_stats on the card
    stats_rows = []
    tick_groups = synth_groups(TICK_TRACES, STATE_TRACES * 3, "meshstats")
    for name, arrays, ne, ns in stat_windows(tick_groups):
        cols = [torch.from_numpy(arrays[k]).to(device) for k in STAT_COLUMNS]
        window_ops.window_stats(*cols, num_endpoints=ne, num_statuses=ns)  # warm: the timed call below is steady
        want, single_s = synced_s(torch, lambda: window_ops.window_stats(*cols, num_endpoints=ne, num_statuses=ns))
        for merge in MESH_MERGES:
            m = grid if merge == "hierarchical" else mesh

            def run(m=m, merge=merge):
                return pmesh.sharded_window_stats(m, *cols, num_endpoints=ne, num_statuses=ns, merge=merge)

            got, first_s, got_launches = counted(run)
            check(got_launches[seg] == 2 * MESH_SHARDS, f"(a) {name} {merge}: segment_stats launched {got_launches[seg]} times")
            _again, wall_s, _l = counted(run)
            row = {
                "window": name, "spans": int(cols[0].shape[0]), "segments": ne * ns, "merge": merge, "mesh": label,
                "launches": got_launches[seg], "first_ms": round(first_s * 1e3, 3), "wall_ms": round(wall_s * 1e3, 3),
                "single_device_ms": round(single_s * 1e3, 3), **check_stats(torch, got, want, f"(a) {name} {merge}"),
            }
            stats_rows.append(row)
            log("   (a) " + json.dumps(row))
    out["stats"] = stats_rows

    # (b) a collect tick with the mesh and one without, from the carried graph
    export = proc.graph.export_named_edges()
    groups = synth_groups(TICK_TRACES, STATE_TRACES * 3 + TICK_TRACES, "meshtick")
    ticks = {}
    for name, ctx in (("single", contextlib.nullcontext), ("mesh", virtual)):
        p = DataProcessor(trace_source=lambda lb, t, lim: groups, device=device, graph=graph_from_export(export, device))
        with ctx():
            resp, wall, got = counted(lambda: p.collect({"uniqueId": "mesh", "lookBack": 30_000}))
        ticks[name] = (resp, graph_signature(p.graph), wall, got[seg])
    compare_ticks(ticks["mesh"][0], ticks["single"][0])
    check(ticks["mesh"][1] == ticks["single"][1], "(b) graph signatures differ")
    check(ticks["single"][3] == 2 and ticks["mesh"][3] == 2 * MESH_SHARDS, f"(b) launches {ticks['single'][3]}, {ticks['mesh'][3]}")
    # the single-device tick is the reference: its launches stay out of the count
    launches[seg] -= ticks["single"][3]
    out["tick"] = {
        "mesh": label, "combined": len(ticks["mesh"][0]["combined"]), "dependencies": len(ticks["mesh"][0]["dependencies"]),
        "mesh_tick_ms": round(ticks["mesh"][2] * 1e3, 3), "single_tick_ms": round(ticks["single"][2] * 1e3, 3),
        "mesh_launches": ticks["mesh"][3], "single_launches": ticks["single"][3],
    }
    log("   (b) " + json.dumps(out["tick"]))

    # (c) the streamed ingest with the mesh and without, and the re-walk
    chunks = raw_windows(
        dict(n_traces=MESH_STREAM_TRACES, spans_per=SPANS_PER_TRACE, t_start=c * MESH_STREAM_TRACES, trace_prefix="mesh", **BASELINE)
        for c in range(MESH_STREAM_CHUNKS)
    )
    streams = {}
    # in turns: the single-device stream before and after the mesh's two
    runs = (("single", False, None), ("mesh", True, None), ("mesh, re-walk", True, MESH_STAGE_CAP), ("single again", False, None))
    for name, on, cap in runs:
        p = DataProcessor(trace_source=TickFeed(), device=device, max_payload_bytes=RAW_CAP)
        with contextlib.ExitStack() as stack:
            if on:
                stack.enter_context(virtual())
            staged = stack.enter_context(CallCount(pmesh, "sharded_window_edges_compact"))
            rewalks = stack.enter_context(CallCount(pmesh, "sharded_dependency_edges_packed"))
            if cap is not None:
                stack.enter_context(AttrSet(store_mod, "STAGE_CAP", cap))
            summary, wall = synced_s(torch, lambda: p.ingest_raw_stream(list(chunks)))
            signature = graph_signature(p.graph)
        streams[name] = {
            "mesh": label if on else "1 x " + str(card), "wall_ms": round(wall * 1e3, 3),
            "spans_per_s": round(summary["spans"] / wall, 1), "sharded_stages": staged.calls, "sharded_rewalks": rewalks.calls,
            **{k: summary[k] for k in ("spans", "traces", "endpoints", "edges")}, "signature": signature,
        }
        log("   (c) " + json.dumps({"run": name, **streams[name]}))
    for name in ("mesh", "mesh, re-walk", "single again"):
        for k in ("spans", "traces", "endpoints", "edges", "signature"):
            check(streams[name][k] == streams["single"][k], f"(c) {name}: {k} differs from the single-device stream")
    check(streams["mesh"]["sharded_stages"] == MESH_STREAM_CHUNKS and streams["single"]["sharded_stages"] == 0, f"(c) stages {streams}")
    check(streams["mesh, re-walk"]["sharded_rewalks"] >= 1 and streams["mesh"]["sharded_rewalks"] == 0, f"(c) re-walks {streams}")
    out["stream"] = streams

    # (d) the sharded scorer on phase 4's graph
    snap, num_services, dist_bits = store_snapshot(torch, proc.graph, device)
    cap = int(snap[0].shape[0])
    check(cap % MESH_SHARDS == 0, f"(d) capacity {cap} does not shard")
    single = lambda: scorer_ops.service_scores(*snap, num_services=num_services, dist_bits=dist_bits)  # noqa: E731
    legacy = lambda: scorer_ops.service_scores(*snap, num_services=num_services)  # noqa: E731
    sharded_scores = lambda: pmesh.sharded_service_scores(mesh, *snap, num_services=num_services)  # noqa: E731
    got, first_s = synced_s(torch, sharded_scores)
    want, single_first_s = synced_s(torch, single)
    synced_s(torch, legacy)  # warm: each path's steady call is timed below
    _single, single_s = synced_s(torch, single)
    _legacy, legacy_s = synced_s(torch, legacy)
    got, mesh_s = synced_s(torch, sharded_scores)
    out["scores"] = {
        "mesh": label, "edges": proc.graph.n_edges, "capacity": cap, "services": num_services,
        "rf_max_rel": assert_scores_match(got, want, "(d) sharded scores"),
        "first_ms": round(first_s * 1e3, 3), "mesh_ms": round(mesh_s * 1e3, 3),
        "single_device_first_ms": round(single_first_s * 1e3, 3), "single_device_ms": round(single_s * 1e3, 3),
        "single_device_legacy_ms": round(legacy_s * 1e3, 3),
    }
    log("   (d) " + json.dumps(out["scores"]))

    # (e) one sharded slot-grad step of GraphSAGE against the per-slot loop
    ds = training_dataset(torch, proc.graph, MESH_SLOTS)
    st = stacked.stack_dataset(ds, device)
    params = graphsage.init_params(
        torch.Generator().manual_seed(SEED), hidden=SAGE_HIDDEN, num_features=SAGE_FEATURES, device=device
    )
    loss_fn = common.make_loss_fn(graphsage.forward, 4.0)
    feats, tl, ta, nm, w = (x[0] for x in stacked.batch_slots_arrays(st, MESH_SLOTS))
    edges = (st.src, st.dst, st.edge_mask)
    grad = pmesh.make_sharded_slot_grad(pmesh.make_mesh(devices=shards, axis="slots"), loss_fn, axis="slots")
    step = lambda: grad(params, feats, tl, ta, nm, *edges, w, st.index)  # noqa: E731
    (g_mesh, losses), first, got = counted(step)
    check(got[fwd] == 2 * MESH_SLOTS, f"(e) forward launches {got}")
    check(got[bwd] == MESH_SLOTS and got[rows] == MESH_SLOTS, f"(e) backward launches {got}")
    _again, wall, _again_got = counted(step)

    def per_slot():
        total, loss_sum = None, 0.0
        for i in range(MESH_SLOTS):
            loss, _aux, g = common.value_and_grad(loss_fn, params, feats[i], *edges, tl[i], ta[i], nm[i], index=st.index)
            total = list(g) if total is None else [None if a is None else a + b for a, b in zip(total, g)]
            loss_sum = loss_sum + loss
        return [None if a is None else a / MESH_SLOTS for a in total], loss_sum / MESH_SLOTS

    (g_ref, loss_ref), loop_s = synced_s(torch, per_slot)
    err = 0.0
    for name, a, b in zip(g_mesh._fields, g_mesh, g_ref):
        if a is None:
            continue
        check(torch.allclose(a, b, rtol=1e-5, atol=1e-6), f"(e) grad {name} off by {float((a - b).abs().max())}")
        err = max(err, float((a - b).abs().max()))
    check(math.isclose(float(losses[0]), float(loss_ref), rel_tol=1e-5), f"(e) loss {float(losses[0])} against {float(loss_ref)}")
    out["slot_grad"] = {
        "mesh": label, "slots": MESH_SLOTS, "hidden": SAGE_HIDDEN, "features": SAGE_FEATURES, "nodes": st.bucket_nodes,
        "first_ms": round(first * 1e3, 3), "wall_ms": round(wall * 1e3, 3), "per_slot_loop_ms": round(loop_s * 1e3, 3),
        "max_abs_err": err,
        "launches": {fwd: got[fwd], bwd: got[bwd], rows: got[rows]},
    }
    log("   (e) " + json.dumps(out["slot_grad"]))

    # (f) phase 22's last stacked merge, its lanes sharded one a device
    if tenant_stack is None:
        out["tenant_merge"] = "not carried: phase 22 did not run in this process"
    else:
        stack_cols, win_cols, counts = tenant_stack
        lanes = int(stack_cols[0].shape[0])
        check(lanes % MESH_SHARDS == 0, f"(f) {lanes} lanes do not shard")
        sharded = lambda: batch.sharded_merge_edges(  # noqa: E731
            tuple(pmesh.shard(c, shards) for c in stack_cols), tuple(pmesh.shard(c, shards) for c in win_cols)
        )
        (s, d, ds, c), wall = synced_s(torch, sharded)
        _again, wall = synced_s(torch, sharded)
        per = lanes // MESH_SHARDS
        serial_s = 0.0
        for lane in range(lanes):
            n = int(win_cols[3][lane].sum())
            width = 1 << max(0, (n - 1).bit_length())
            args = [col[lane] for col in stack_cols] + [col[lane, :width] for col in win_cols[:3]] + [win_cols[3][lane, :width]]
            (s1, d1, ds1, v1), lane_s = synced_s(torch, lambda args=args: _merge_edges(*args))
            serial_s += lane_s
            k = int(v1.sum())
            g, j = lane // per, lane % per
            check(k == counts[lane] == int(c[g][j]), f"(f) lane {lane}: counts differ")
            for a, b in zip((s[g][j], d[g][j], ds[g][j]), (s1, d1, ds1)):
                check(torch.equal(a[:k], b[:k]), f"(f) lane {lane}: the sharded union differs from the serial one")
        out["tenant_merge"] = {
            "mesh": label, "lanes": lanes, "capacity": int(stack_cols[0].shape[1]), "window": int(win_cols[0].shape[1]),
            "sharded_ms": round(wall * 1e3, 3), "serial_ms": round(serial_s * 1e3, 3),
        }
    log("   (f) " + json.dumps(out["tenant_merge"]))
    out["launches"] = launches
    return out


# -- phase 27: the chaos probe ------------------------------------------------

CHAOS_SEED = 0
#: pillar 3's ticks that complete on its DP server: the warm tick, the
#: straggler past the deadline (once it lands) and the recovered tick
CHAOS_TICKS = 3


def serve_chaos(torch, device, counters) -> dict:
    """Phase 27: the port's chaos_probe pillars in this process on the card
    (the crash child of pillar 4 a process of its own on the card), every
    launch counter zeroed just before and read just after: every pillar
    holds, the segment-stats kernel launched twice for each of pillar 3's
    ticks (its processor's device statistics on) and nothing else launched
    (pillars 1 and 4 run with device statistics off)."""
    from kmamiz_tpu_torch.ops import segment_stats as ss
    from kmamiz_tpu_torch.tools import chaos_probe

    zero_counts(counters)
    t0 = time.perf_counter()
    results = chaos_probe.probe(CHAOS_SEED, None, device)
    wall_s = time.perf_counter() - t0
    launches = read_counts(torch, counters)
    for p in chaos_probe.PILLARS:
        detail = {k: v for k, v in results[p].items() if k not in ("signature", "snapshot")}
        log(f"   {p}: " + json.dumps(detail))
    failed = [p for p in chaos_probe.PILLARS if not results[p]["ok"]]
    check(not failed and results["ok"] is True, f"chaos pillars failed: {failed}")
    want = {c.__name__: 0 for c in counters}
    want[ss.segment_stats.__name__] = 2 * CHAOS_TICKS
    check(launches == want, f"the chaos probe launched {launches}, {want} expected")
    out = {
        "seed": CHAOS_SEED,
        "wall_s": wall_s,
        "chaos_recovery_ms": results["chaos_recovery_ms"],
        "degraded_serve_ms": results["degraded_serve_ms"],
        "pillars": {p: results[p] for p in chaos_probe.PILLARS},
        "launches": launches,
    }
    log("   " + json.dumps({k: out[k] for k in ("wall_s", "chaos_recovery_ms", "degraded_serve_ms", "launches")}))
    return out


# -- phase 28: restart warmth ------------------------------------------------

#: the libraries of the port's main paths: the host library and both kernels'
LIBRARIES = {"kmamiz_native", "segment_stats", "fused_sddmm_spmm"}
PREBUILD_TIMEOUT_S = 600
PROBE_TIMEOUT_S = 600


def run_prebuild() -> dict:
    """Phase 2's builds as an image's build step makes them: `python -m
    kmamiz_tpu_torch.core.compile_cache --prebuild` in a process that sees
    no card (CUDA_VISIBLE_DEVICES=""), into the checkout's csrc/build/.
    Its JSON line."""
    env = {k: v for k, v in os.environ.items() if k != "KMAMIZ_COMPILE_CACHE_DIR"}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "kmamiz_tpu_torch.core.compile_cache", "--prebuild"],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=PREBUILD_TIMEOUT_S,
    )
    check(proc.returncode == 0, f"the prebuild exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def package_copy(root: str) -> None:
    """The checkout's kmamiz_tpu_torch/ copied under `root`, without
    csrc/build/: a fresh image's package before its build step."""
    import shutil

    src = os.path.join(REPO, "kmamiz_tpu_torch")
    build = os.path.join(src, "csrc", "build")
    shutil.copytree(
        src,
        os.path.join(root, "kmamiz_tpu_torch"),
        ignore=lambda d, names: [n for n in names if n == "__pycache__" or os.path.join(d, n) == build],
    )


class RestartProbe:
    """`python -m kmamiz_tpu_torch.tools.warm_boot_probe` on the card, in a
    process of its own, over the package copied under `root` with
    KMAMIZ_COMPILE_CACHE_DIR at `cache` (no other KMAMIZ_ variable of this
    process); its per-library table goes to a file."""

    def __init__(self, root: str, cache: str, label: str) -> None:
        env = {k: v for k, v in os.environ.items() if not k.startswith("KMAMIZ_")}
        env.update(PYTHONPATH=root, KMAMIZ_COMPILE_CACHE_DIR=cache)
        self.label, self.cache = label, cache
        self.err_path = os.path.join(root, f"{label}.stderr")
        self.err = open(self.err_path, "wb")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kmamiz_tpu_torch.tools.warm_boot_probe"],
            cwd=root,
            env=env,
            stdout=subprocess.PIPE,
            stderr=self.err,
        )

    def stop(self) -> None:
        """End it unread (a run that stops before phase 28)."""
        self.proc.kill()
        self.proc.communicate()
        self.err.close()

    def result(self) -> dict:
        """Its JSON line (with the process's wall and the table's last
        lines), once it has exited 0."""
        try:
            stdout, _ = self.proc.communicate(timeout=PROBE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise AssertionError(f"the {self.label} probe did not end in {PROBE_TIMEOUT_S} s")
        finally:
            self.err.close()
        wall = time.perf_counter() - self.t0
        with open(self.err_path, "rb") as f:
            table = f.read().decode("utf-8", "replace")
        check(self.proc.returncode == 0, f"the {self.label} probe exited {self.proc.returncode}: {table[-3000:]}")
        line = json.loads(stdout.decode().strip().splitlines()[-1])
        line["process_wall_s"] = wall
        line["table"] = table.strip().splitlines()[-5:]
        return line

    def check(self, line: dict, cold: bool) -> None:
        """Phase 28's gates: every library in the plan, each built inside
        it (cold) or none built anywhere (warm), in the cache directory,
        and no library built or first loaded inside either timed tick."""
        what = f"the {self.label} probe"
        programs = line["programs"]
        check(line["device"].startswith("cuda"), f"{what} ran on {line['device']}")
        check(set(programs) == LIBRARIES, f"{what} loaded {sorted(programs)}")
        check(all(p["prewarmed"] for p in programs.values()), f"{what}: a library outside the prewarm: {programs}")
        check(all(p["built"] is cold for p in programs.values()), f"{what}: built {programs}")
        report = line["prewarm_report"]
        check(report["builtInPlan"] == (len(LIBRARIES) if cold else 0), f"{what}: {report['builtInPlan']} built")
        check(report["kernel2Launches"] == 6, f"{what}: kernel 2 launched {report['kernel2Launches']} times")
        for name, lib in report["libraries"].items():
            check(os.path.dirname(lib["path"]) == self.cache, f"{what}: {name} at {lib['path']}")
        check(
            line["first_tick_new_compiles"] == 0 and line["second_tick_new_compiles"] == 0,
            f"{what}: {line['first_tick_new_compiles']} and {line['second_tick_new_compiles']} "
            "libraries built or loaded inside the timed ticks",
        )


def restart_warmth(cold: RestartProbe, root: str) -> dict:
    """Phase 28 (b), started before phase 1 and joined here, then (c)
    alone against (b)'s directory."""
    out = {}
    for label, probe in (("cold", cold), ("warm", None)):
        if probe is None:
            probe = RestartProbe(root, cold.cache, label)
        line = probe.result()
        probe.check(line, cold=label == "cold")
        out[label] = {
            k: line[k]
            for k in (
                "prewarm_s",
                "prewarm_programs",
                "first_tick_ms",
                "second_tick_ms",
                "first_tick_new_compiles",
                "second_tick_new_compiles",
                "process_wall_s",
                "programs",
            )
        }
        out[label]["kernel2_ms"] = line["prewarm_report"]["kernel2Ms"]
        out[label]["warm_up_ms"] = line["prewarm_report"]["warmUpMs"]
        log(f"   ({'b' if label == 'cold' else 'c'}) {label}: " + json.dumps(out[label]))
        for row in line["table"]:
            log(f"       {row}")
    return out


# -- this run's processes -----------------------------------------------------

#: the environment variable that marks this run's processes, orphans too
RUN_MARK = "CHIP_SMOKE_RUN"


def live_processes() -> dict:
    """This run's processes still alive, this one aside: its descendants by
    parent pid, and any process whose environment carries RUN_MARK's
    value (an orphan, whose parent is gone); zombies are dead and left
    out. Read from /proc. pid -> (seconds after this process started,
    command line)."""
    me = os.getpid()
    mark = f"{RUN_MARK}={os.environ[RUN_MARK]}".encode()
    parent, state, started = {}, {}, {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat", "rb") as f:
                fields = f.read().rsplit(b")", 1)[1].split()
        except (OSError, IndexError):
            continue
        pid = int(entry)
        state[pid], parent[pid], started[pid] = fields[0], int(fields[1]), int(fields[19])
    ours, grew = {me}, True
    while grew:
        grew = False
        for pid, ppid in parent.items():
            if ppid in ours and pid not in ours:
                ours.add(pid)
                grew = True
    for pid in parent:
        if pid not in ours:
            try:
                with open(f"/proc/{pid}/environ", "rb") as f:
                    if mark in f.read().split(b"\0"):
                        ours.add(pid)
            except OSError:
                pass
    ours.discard(me)
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for pid in sorted(ours):
        if state.get(pid) in (b"Z", b"X"):
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode("utf-8", "replace").strip()
        except OSError:
            continue
        out[pid] = (round((started[pid] - started.get(me, started[pid])) / tick, 2), cmd[:300])
    return out


def end_processes() -> dict:
    """Before the result line: stop multiprocessing's resource tracker
    (started with the first spawned pool; it lives until its pipe closes),
    then end whatever else of this run is still alive (SIGTERM, 5 s,
    SIGKILL), each logged, and check that nothing is left. Returns what
    was found and ended."""
    import signal
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    tracker_pid = getattr(tracker, "_pid", None)
    stopper = threading.Thread(target=tracker._stop, daemon=True)
    stopper.start()
    stopper.join(10)
    left = live_processes()
    for pid, (after_s, cmd) in left.items():
        log(f"   left running: pid {pid}, started {after_s} s into the run: {cmd}")
    for sig, wait_s in ((signal.SIGTERM, 5.0), (signal.SIGKILL, 5.0)):
        for pid in live_processes():
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + wait_s
        while live_processes() and time.monotonic() < deadline:
            time.sleep(0.1)
    alive = live_processes()
    check(not alive, f"processes of this run still alive: {alive}")
    return {
        "resource_tracker_stopped": tracker_pid is not None and not stopper.is_alive(),
        "ended": {str(pid): list(v) for pid, v in left.items()},
    }


class AttrSet:
    """An attribute of a module set for a with-block, then restored."""

    def __init__(self, module, name: str, value) -> None:
        self.module, self.name, self.value = module, name, value

    def __enter__(self):
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, self.value)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)
        return False


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
        "--eval-only",
        action="store_true",
        help="phases 1-2, then phase 21 (a) (the simulation) and phase 26 (model "
        "evaluation), then the report",
    )
    parser.add_argument(
        "--tenancy-only",
        action="store_true",
        help="phases 1-2, then phase 22 (multi-tenant serving), then the device times and the report",
    )
    parser.add_argument(
        "--fleet-only",
        action="store_true",
        help="phases 1-2, then phase 23 (the fleet and the scenario runner) over "
        "tenant windows made here, then the report",
    )
    parser.add_argument(
        "--soak-only",
        action="store_true",
        help="phases 1-2, then phase 24 (the soak sweep, the scenario matrix and "
        "graftprof over the port), then the report",
    )
    parser.add_argument(
        "--mesh-only",
        action="store_true",
        help="phases 1-2 and 4, then phase 25 (the device mesh on virtual shards of "
        "the card) without its part (f), which needs phase 22's stacked merge",
    )
    parser.add_argument(
        "--chaos-only",
        action="store_true",
        help="phases 1-2, then phase 27 (the chaos probe's pillars on the card), then the report",
    )
    parser.add_argument(
        "--cluster-only",
        action="store_true",
        help="phases 1-2, then phase 19 (the in-cluster deployment), then the "
        "report: for working on the deployment's path alone",
    )
    parser.add_argument(
        "--restart-only",
        action="store_true",
        help="phases 1-2 with phase 28 (b) beside them, then phase 28 (the "
        "restart probes: cold, then warm), then the report",
    )
    args = parser.parse_args(argv)
    # every process this run starts inherits the mark, so that
    # end_processes finds them, orphans too
    os.environ[RUN_MARK] = f"{os.getpid()}-{time.time_ns()}"
    partial = any(
        getattr(args, mode)
        for mode in (
            "kernels_only", "zeroing", "backward_of", "backward_variants", "telemetry_only", "simulator_only",
            "eval_only", "tenancy_only", "fleet_only", "soak_only", "mesh_only", "chaos_only", "cluster_only",
        )
    )
    restart_root = None
    if args.restart_only or not partial:
        # phase 28 (b): the cold restart's probe over a copy of the package
        # without csrc/build/, started first so that it runs beside this
        # process's own start and phase 2
        restart_root = tempfile.TemporaryDirectory(prefix="chip_smoke_restart_")
        package_copy(restart_root.name)
        cold_probe = RestartProbe(restart_root.name, os.path.join(restart_root.name, "cache"), "cold")

    import torch

    if not torch.cuda.is_available():
        if restart_root is not None:
            cold_probe.stop()
            restart_root.cleanup()
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
        report["processes"] = end_processes()
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"backward_of": report["backward_of"]}))
        return 0

    with Phase("build", walls):
        # the host library (g++) builds beside the kernels (nvcc), so that
        # the first served tick's body fold does not pay for it: as the
        # image's build step makes them, in a process with no card
        from kmamiz_tpu_torch import native
        from kmamiz_tpu_torch.ops import host_build

        build = {
            "built_in_this_run": not host_build.library_path(native.NAME, native.SOURCES).exists()
        }
        # and the port's own lint over the tree this run builds
        lint = start_lint()
        report["prebuild"] = run_prebuild()
        check(
            {lib["library"] for lib in report["prebuild"]["libraries"]} == LIBRARIES,
            f"the prebuild built {report['prebuild']['libraries']}",
        )
        prebuilt = {os.path.realpath(lib["path"]) for lib in report["prebuild"]["libraries"]}
        for path in cuda_build.build_all(kernel_names) + [native.library_path()]:
            check(os.path.realpath(path) in prebuilt, f"{path} is not the prebuild's")
            log(f"   built {os.path.relpath(path)}")
        log(f"   prebuild (no card visible): {report['prebuild']['seconds']:.2f} s")
        report["lint"] = finish_lint(lint)
        log("   lint " + json.dumps(report["lint"]))

    if restart_root is not None:
        with Phase("restart warmth", walls):
            report["restart"] = restart_warmth(cold_probe, restart_root.name)
        restart_root.cleanup()

    if args.restart_only:
        quarantine_root.cleanup()
        report["processes"] = end_processes()
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"restart": report["restart"]}))
        return 0

    if args.telemetry_only:
        from kmamiz_tpu_torch.server.processor import DataProcessor

        feed = TickFeed()
        proc = DataProcessor(trace_source=feed, device=device, wal=None)
        feed.groups = synth_groups(TICK_TRACES, 0, "warm")
        proc.collect({"uniqueId": "warm", "lookBack": 30_000})
        with Phase("telemetry", walls):
            report["telemetry"] = serve_telemetry(torch, device, proc, feed)
        quarantine_root.cleanup()
        report["processes"] = end_processes()
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"telemetry": report["telemetry"]}))
        return 0

    if args.simulator_only:
        with Phase("simulator", walls):
            sim_yaml = mesh_yaml()
            sim_root = tempfile.TemporaryDirectory(prefix="chip_smoke_simapp_")
            sim_app = SimulatorApp(sim_yaml, sim_root.name)
            atexit.register(sim_app.kill)
            report["simulator"] = simulate(torch, device, jobs, sim_app, sim_yaml)[0]
            sim_root.cleanup()
        with Phase("device times", walls):
            report["profiler_lost_sessions"] = device_times(torch, jobs)
        quarantine_root.cleanup()
        report["processes"] = end_processes()
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"simulator": report["simulator"]}))
        return 0

    if args.eval_only:
        with Phase("simulation", walls):
            report["simulator"] = {}
            sim_result, sim_dataset = simulate_mesh(report["simulator"], mesh_yaml())
        with Phase("model evaluation", walls):
            report["model_eval"] = evaluate_models(torch, device, counters, sim_result, sim_dataset)
        quarantine_root.cleanup()
        report["processes"] = end_processes()
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"model_eval": report["model_eval"]}))
        return 0

    if args.tenancy_only:
        with Phase("multi-tenant serving", walls):
            report["tenancy"] = serve_tenancy(torch, device, counters, jobs)
        with Phase("device times", walls):
            report["profiler_lost_sessions"] = device_times(torch, jobs)
        quarantine_root.cleanup()
        report["processes"] = end_processes()
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"tenancy": {k: v for k, v in report["tenancy"].items() if k != "rounds"}}))
        return 0

    if args.fleet_only:
        with Phase("fleet and scenario runner", walls):
            report["fleet"] = serve_fleet(torch, device, counters, tenant_state_windows())
        quarantine_root.cleanup()
        report["processes"] = end_processes()
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"fleet": report["fleet"]}))
        return 0

    if args.soak_only:
        with Phase("soak sweep", walls):
            report["soak"] = serve_soak(torch, device, counters)
        quarantine_root.cleanup()
        report["processes"] = end_processes()
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"soak": report["soak"]}))
        return 0

    if args.chaos_only:
        with Phase("chaos probe", walls):
            report["chaos"] = serve_chaos(torch, device, counters)
        quarantine_root.cleanup()
        report["processes"] = end_processes()
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"chaos": {k: v for k, v in report["chaos"].items() if k != "pillars"}}))
        return 0

    if args.cluster_only:
        with Phase("in-cluster deployment", walls):
            report["in_cluster"] = serve_in_cluster(torch, device, counters)
        quarantine_root.cleanup()
        report["processes"] = end_processes()
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"in_cluster": {k: v for k, v in report["in_cluster"].items() if k != "ticks"}}))
        return 0

    if args.mesh_only:
        with Phase("state load", walls):
            proc, _feed = load_state(device)
        with Phase("mesh", walls):
            report["mesh"] = serve_mesh(torch, device, counters, proc)
        quarantine_root.cleanup()
        report["processes"] = end_processes()
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"mesh": {k: v for k, v in report["mesh"].items() if k != "stats"}}))
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
        report["processes"] = end_processes()
        report["walls_s"] = walls
        write_report(args.report, report)
        log(json.dumps({"zeroing": report["zeroing"]}))
        return 0

    with Phase("state load", walls):
        t0 = time.perf_counter()
        proc, feed = load_state(device)
        merge_s = time.perf_counter() - t0
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
            "merge_s": merge_s,
        }
        # phase 17's processor starts from this graph, carried by name:
        # taken before phase 7's ticks grow it
        state_carry = carry_state(proc.graph, report["state"]["signature"])

    if args.backward_variants:
        with Phase("backward variants", walls):
            report["backward_variants"] = backward_variants(torch, proc.graph)
        report["processes"] = end_processes()
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
        report["processes"] = end_processes()
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

    # phase 17's store seed: phase 4's traces' dependency records, made
    # and written by a process of its own (no card) beside phases 15 and
    # 16 (their walls recorded, their gates parity only); phase 17 waits
    # for it
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    seed_store = tempfile.TemporaryDirectory(prefix="chip_smoke_store_")
    seeding = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    seeded = seeding.submit(write_seed_store, seed_store.name, state_windows())
    # and phase 21's YAML after it, made once for its simulator
    # application (started before phase 17) and its (a)
    sim_yaml_job = seeding.submit(mesh_yaml)

    # phase 15 runs here, before phase 14's profiler sessions (which slow
    # every later launch on the host) and the device times
    with Phase("raw ingest", walls):
        report["raw_ingest"], raw_cases, raw = raw_ingest(
            torch, device, counters, report["state"], report["ticks"], build, jobs
        )

    # phase 24 (a)'s sweep starts now, its four worker processes on the
    # card beside phase 16 (whose walls are recorded, its gates parity
    # only); joined before phase 17
    sweep_root = tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_")
    sweep = SweepProcess(torch, sweep_root.name)

    # phase 16 too: the same window, streamed
    with Phase("streaming ingest", walls):
        report["stream_ingest"] = stream_ingest(
            torch, device, counters, report["raw_ingest"]["one_shot"], raw
        )
        del raw

    # phase 24 (a)'s sweep ends before phase 17, whose walls are held to
    # 5,000 ms: the wait is phase 24's
    with Phase("soak sweep (a)", walls):
        sweep.join()

    # phase 21's application in simulator mode starts now, in a process of
    # its own that boots on a thread of this one: its startSimulation (the
    # simulation and its hourly slots' aggregations, host work on one
    # core) runs beside phases 17-20, and phase 21 reads its answers
    with Phase("simulator app start", walls):
        sim_yaml = sim_yaml_job.result()
        sim_root = tempfile.TemporaryDirectory(prefix="chip_smoke_simapp_")
        sim_app = SimulatorApp(sim_yaml, sim_root.name)
        atexit.register(sim_app.kill)

    # phases 17 and 18 too: the application, then the GAT head (whose own
    # profiler session comes last in it)
    with Phase("application", walls):
        # boot 1 folds an hour: without the STLGT hook, as in phase 13
        stlgt_env = os.environ.pop("KMAMIZ_STLGT", None)
        try:
            report["application"] = serve_application(
                torch, device, counters, STATE_TRACES + (TICKS + 30) * TICK_TRACES, state_carry, seed_store, seeded
            )
        finally:
            if stlgt_env is not None:
                os.environ["KMAMIZ_STLGT"] = stlgt_env
        seeding.shutdown()
        del state_carry
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

    # and phase 21, the simulator, whose application has been simulating
    # since before phase 17
    with Phase("simulator", walls):
        report["simulator"], sim_result, sim_dataset = simulate(torch, device, jobs, sim_app, sim_yaml)
    sim_root.cleanup()
    del sim_yaml

    # and phase 26, model evaluation, over phase 21's simulation
    with Phase("model evaluation", walls):
        report["model_eval"] = evaluate_models(torch, device, counters, sim_result, sim_dataset)
        eval_launches = report["model_eval"]["launches"]
        del sim_result, sim_dataset

    # and phase 22, multi-tenant serving (its control folds use phase 12's
    # STLGT head)
    tenant_windows: dict = {}
    tenant_stack: dict = {}
    with Phase("multi-tenant serving", walls):
        stlgt_env = os.environ.pop("KMAMIZ_STLGT", None)
        try:
            report["tenancy"] = serve_tenancy(
                torch, device, counters, jobs, windows_out=tenant_windows, stack_out=tenant_stack
            )
        finally:
            if stlgt_env is not None:
                os.environ["KMAMIZ_STLGT"] = stlgt_env
        tenancy_launches = report["tenancy"]["launches"]

    # and phase 23, the fleet and the scenario runner, over phase 22's
    # tenant windows (its ticks fold no hour with STLGT either)
    with Phase("fleet and scenario runner", walls):
        stlgt_env = os.environ.pop("KMAMIZ_STLGT", None)
        try:
            report["fleet"] = serve_fleet(torch, device, counters, tenant_windows)
        finally:
            if stlgt_env is not None:
                os.environ["KMAMIZ_STLGT"] = stlgt_env
        del tenant_windows

    # and phase 24, the soak sweep (its scenarios fold no hour with STLGT)
    with Phase("soak sweep", walls):
        stlgt_env = os.environ.pop("KMAMIZ_STLGT", None)
        try:
            report["soak"] = serve_soak(torch, device, counters, sweep)
        finally:
            if stlgt_env is not None:
                os.environ["KMAMIZ_STLGT"] = stlgt_env
        sweep_root.cleanup()
        soak_launches = report["soak"]["launches"]

    # and phase 25, the device mesh on virtual shards of the card (over
    # phase 4's graph, grown by the ticks since, and phase 22's last
    # stacked merge)
    with Phase("mesh", walls):
        report["mesh"] = serve_mesh(torch, device, counters, proc, tenant_stack.pop("inputs"))
        mesh_launches = report["mesh"]["launches"]
        del tenant_stack

    # and phase 27, the chaos probe's pillars (its DP's tick folds no hour
    # with STLGT either)
    with Phase("chaos probe", walls):
        with env_set(KMAMIZ_STLGT=None):
            report["chaos"] = serve_chaos(torch, device, counters)
        chaos_launches = report["chaos"]["launches"]

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
    # ticks, phase 22's gathered rounds and fold ticks, phase 24's
    # graftprof capture, phase 25's sharded stats and mesh tick and phase
    # 27's degraded-serve ticks), the
    # fused kernel on the forecast path (phase 9, phase 22's control folds),
    # phase 25's sharded slot grads and phase 26's model evaluation, the
    # backward's row pass on the GraphSAGE training path (phases 11, 25 and
    # 26) and its SDDMM on the STLGT path (phases 12 and 26); the shown
    # times are the
    # tick's first pass, GraphSAGE's second layer (H = 64) forward and
    # backward, and STLGT's gated backward (H = 32)
    line = {
        "kernels": [
            entry(
                *kernels[0],
                launches[ss.segment_stats.__name__]
                + tenancy_launches[ss.segment_stats.__name__]
                + soak_launches[ss.segment_stats.__name__]
                + mesh_launches[ss.segment_stats.__name__]
                + chaos_launches[ss.segment_stats.__name__],
                cases + raw_cases,
                cases[2],
            ),
            entry(
                *kernels[1],
                forecast_launches[sparse.fused_sddmm_spmm.__name__]
                + tenancy_launches[sparse.fused_sddmm_spmm.__name__]
                + mesh_launches[sparse.fused_sddmm_spmm.__name__]
                + eval_launches[sparse.fused_sddmm_spmm.__name__],
                f_cases,
                f_cases[1],
            ),
            entry(
                *kernels[2],
                stlgt_launches[sparse.fused_sddmm_spmm_grad_edges.__name__]
                + eval_launches[sparse.fused_sddmm_spmm_grad_edges.__name__],
                edges_cases,
                edges_cases[0],
            ),
            entry(
                *kernels[3],
                train_launches[sparse.fused_sddmm_spmm_grad_rows.__name__]
                + mesh_launches[sparse.fused_sddmm_spmm_grad_rows.__name__]
                + eval_launches[sparse.fused_sddmm_spmm_grad_rows.__name__],
                rows_cases,
                rows_cases[1],
            ),
        ]
    }
    # phase 28 (d): the restart path in phases 17 and 19
    report["restart"]["dp_prewarm"] = report["in_cluster"]["prewarm"]
    report["restart"]["first_forecast_libraries_loaded"] = report["application"]["first_forecast_libraries_loaded"]
    log("   restart warmth: " + json.dumps({k: report["restart"][k] for k in ("cold", "warm")}, default=str)[:2000])
    report["processes"] = end_processes()
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
