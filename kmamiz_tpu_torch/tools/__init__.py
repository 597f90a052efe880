"""Command-line tools over the port, each run as
``python -m kmamiz_tpu_torch.tools.<name>``: the counterparts of the
repo's ``tools/graftsoak.py``, ``tools/scenario_soak.py`` and
``tools/graftprof.py``, with the same last JSON line and exit codes, and a
``--device`` option (default: the card); and of ``tools/graftlint.py`` and
``tools/graftrace.py``, which lint the port's tree and need no device.

- `graftsoak` — the (archetype, seed) soak sweep and its report.
- `scenario_soak` — the seeded scenario matrix, or the control plane's
  counterfactual, against a real in-process server.
- `graftprof` — render, diff (with a failed cell's flight-box blame) and
  capture hot-path attribution profiles.
- `graftlint` — the port's static rules over ``kmamiz_tpu_torch/``.
- `graftrace` — its lock model: the concurrency rules, the lock table and
  the acquisition-order graph.
"""
