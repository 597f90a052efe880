"""Command-line tools over the port, each run as
``python -m kmamiz_tpu_torch.tools.<name>``: the counterparts of the
repo's ``tools/graftsoak.py``, ``tools/scenario_soak.py`` and
``tools/graftprof.py``, with the same last JSON line and exit codes, and a
``--device`` option (default: the card).

- `graftsoak` — the (archetype, seed) soak sweep and its report.
- `scenario_soak` — the seeded scenario matrix, or the control plane's
  counterfactual, against a real in-process server.
- `graftprof` — render, diff (with a failed cell's flight-box blame) and
  capture hot-path attribution profiles.
"""
