"""Command-line tools over the port, each run as
``python -m kmamiz_tpu_torch.tools.<name>``: the counterparts of the
repo's ``tools/graftsoak.py``, ``tools/scenario_soak.py``,
``tools/graftprof.py``, ``tools/eval_models.py``,
``tools/eval_models_large.py``, ``tools/eval_stlgt.py``,
``tools/chaos_probe.py`` and ``tools/fleet_bench.py``, with the same
output, last lines and exit codes, and a ``--device`` option (default:
the card); and of ``tools/graftlint.py``, ``tools/graftrace.py`` and
``tools/profile_parse.py``, which need no device.

- `graftsoak` — the (archetype, seed) soak sweep and its report.
- `scenario_soak` — the seeded scenario matrix, or the control plane's
  counterfactual, against a real in-process server.
- `graftprof` — render, diff (with a failed cell's flight-box blame) and
  capture hot-path attribution profiles.
- `eval_models` — the GraphSAGE and GAT heads on a small faulted mesh
  against the persistence and naive baselines.
- `eval_models_large` — both heads at BASELINE.json's scale, with
  ROC-AUC, PR-AUC and onset recall; the held-out-endpoint protocol
  (``--inductive``) and its checkpoint.
- `eval_stlgt` — STLGT's prequential replay against the GraphSAGE
  baseline; its exit code is STLGT's acceptance gate.
- `chaos_probe` — the resilience layer's four pillars under a seeded
  fault plan: quarantine bit-exactness, the breaker, degraded serving,
  kill -9 WAL recovery; exit 0 iff every pillar holds.
- `fleet_bench` — ingest through one worker process against four, and a
  live migration with a frame racing the handoff.
- `profile_parse` — the native span parse's walls and phases at the
  bench's window across thread counts (host only).
- `graftlint` — the port's static rules over ``kmamiz_tpu_torch/``.
- `graftrace` — its lock model: the concurrency rules, the lock table and
  the acquisition-order graph.
"""
