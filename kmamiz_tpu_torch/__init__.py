"""kmamiz-tpu on PyTorch and CUDA, on one GPU.

The port of the `kmamiz_tpu` package, module for module, to PyTorch with
hand-written CUDA kernels for Hopper (H100). It imports neither JAX nor
the `kmamiz_tpu` package; host code it shares with that package is copied
here. Entry points run on the card unless the caller passes
`device="cpu"`.

Layout:
  core/      host-side ingestion: string interning, SoA span batches
             (from dicts and from raw bytes), the KMZC wire codec,
             URL/JSON-schema utilities (copies of the JAX package's)
  native/    ctypes binding of the native host library (raw span parse,
             body fold), built from csrc/*.cpp with g++ at first use
  domain/    domain data model with reference-parity JSON output (copies)
  analytics/ risk analyzer and normalizers (copies)
  ops/       tensor code of the window pipeline, sort/unique, the graph
             scorers, and the wrappers of the CUDA kernels
  csrc/      the CUDA kernels' sources, built with nvcc at first use, and
             the host C++ (copies of the JAX package's native/)
  graph/     the device-resident endpoint-graph store and its scorer caches
  models/    the model plane: GraphSAGE, STLGT, training and serving
  server/    the Data Processor tick, its HTTP server, the caches and the
             realtime operator
  api/       the REST API: the model and graph routes
  resilience/ quarantine, WAL, watchdog, breakers and retries, counters
  telemetry/ the metrics registry (GET /metrics), tick span traces, the
             SLO scorecard, freshness, device gauges, torch.profiler
             captures and the profiler's event ring and flight recorder
  analysis/  the sync guard around a hot section
"""

__version__ = "0.1.0"
