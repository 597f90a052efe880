"""graftlint over the port: static analysis of the hot path's invariants,
and the runtime checks beside it.

Counterpart of kmamiz_tpu/analysis/:

- :mod:`framework` — AST lint engine: rule registry, per-line
  suppressions (``# graftlint: disable=<rule> -- reason``), text/JSON
  reporters;
- :mod:`callgraph` — lightweight import+call-graph walk that decides
  which functions are reachable from the tick/serve entry points;
- :mod:`rules` — seven rules: unregistered-jit (no torch.compile or
  TorchScript), host-sync-in-hot-path (the synchronising torch calls),
  dtype-drift, unguarded-shared-state, hot-path-metric-label,
  hot-path-clock, prof-counter-wire. The JAX package's shape-hazard and
  donation-miss guard XLA retraces and buffer donation, which eager
  PyTorch does not have;
- :mod:`concurrency` — graftrace: the static lock model, its three rules
  (lock-order-cycle, blocking-call-under-lock, inconsistent-guard) and
  the runtime lock witness (``KMAMIZ_LOCK_WITNESS=1``);
- :mod:`guards` — the RUNTIME accounting of a tick's synchronising CUDA
  calls (``KMAMIZ_TRANSFER_GUARD``).

Run it via ``python -m kmamiz_tpu_torch.tools.graftlint [--strict]`` and
``python -m kmamiz_tpu_torch.tools.graftrace``. This module never imports
torch: the CLI lints the tree without initialising a card.
"""
from kmamiz_tpu_torch.analysis.framework import (  # noqa: F401
    Finding,
    LintContext,
    Rule,
    all_rules,
    lint_paths,
    lint_repo,
    render_json,
    render_text,
)
