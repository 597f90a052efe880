"""graftsoak: recorded WAL windows as a scenario source.

Counterpart of the WAL-replay part of kmamiz_tpu/soak/: a recorded WAL v2
window replayed through a live server as archetype 11 (``wal-replay``),
held bit-exact to a reference built from the same records
(:mod:`.walreplay`), and the capture that records such a bundle from a
WAL directory or a live server (``python -m kmamiz_tpu_torch.soak.capture``).
The JAX package's sweep engine, manifest, cells and triage are not in the
port yet.
"""
from kmamiz_tpu_torch.soak.walreplay import (
    load_bundle_records,
    read_bundle_meta,
    run_wal_replay_scenario,
    synthesize_bundle,
)

__all__ = [
    "load_bundle_records",
    "read_bundle_meta",
    "run_wal_replay_scenario",
    "synthesize_bundle",
]
