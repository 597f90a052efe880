"""Runtime accounting of a hot section's synchronising CUDA calls.

Counterpart of kmamiz_tpu/analysis/guards.py. The JAX guard wraps a tick
in ``jax.transfer_guard(level)``, which forbids only IMPLICIT host<->device
transfers, and diffs the program registry's compile counters across it.
The port's guard runs the section under
``torch.cuda.set_sync_debug_mode("warn")``, which flags EVERY call that
synchronises with the card, the tick's deliberate reads (the packed
stats' copy back, the merge's count) included. So it counts them:

- on a CUDA device, `hot_path_guard` records each synchronising call's
  warning into `GuardReport.syncs`; at level ``disallow`` it raises
  `SyncsOverBudget` only when the caller passed the number of syncs the
  section is designed to make (`expected_syncs`) and more happened; at
  ``log``/``log_explicit`` it logs the count; ``allow`` counts only. The
  ``*_explicit`` levels act as their plain forms: torch does not tell
  an implicit sync from an explicit one;
- on a CPU device it does nothing and reports 0 (`set_sync_debug_mode`
  raises on a build without CUDA);
- PyTorch compiles nothing per shape, so there is nothing to count for
  ``require_no_recompile``: `new_compiles` stays empty and the argument
  only checks that.

The warnings are caught process-wide while the section runs, so a sync
another thread makes meanwhile counts too. ``KMAMIZ_TRANSFER_GUARD``
turns the guard on in the serving process (the DP server wraps each
tick in `maybe_guarded_tick`): ``1``/``on``/``true`` is ``disallow``,
a level name passes through, ``0``/unset leaves the tick unguarded.
"""
from __future__ import annotations

import logging
import warnings
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional

from kmamiz_tpu_torch.config import transfer_guard

log = logging.getLogger("kmamiz_tpu_torch.guards")

_LEVELS = {"allow", "log", "disallow", "log_explicit", "disallow_explicit"}


def transfer_guard_level(default: Optional[str] = None) -> Optional[str]:
    """Map KMAMIZ_TRANSFER_GUARD to a guard level (or `default` when
    guarding is off), as the JAX package parses it."""
    raw = transfer_guard()
    if raw in ("", "0", "off", "false"):
        return default
    if raw in ("1", "on", "true"):
        return "disallow"
    if raw in _LEVELS:
        return raw
    log.warning("unrecognized KMAMIZ_TRANSFER_GUARD=%r; guarding off", raw)
    return default


class SyncsOverBudget(RuntimeError):
    """A guarded section made more synchronising calls than it is
    designed to."""


class RecompileInGuardedSection(RuntimeError):
    """A program recompiled inside a guarded section (never, in the port)."""


@dataclass
class GuardReport:
    level: str
    syncs: int = 0
    new_compiles: Dict[str, int] = field(default_factory=dict)

    @property
    def recompiled(self) -> bool:
        return bool(self.new_compiles)


@contextmanager
def hot_path_guard(
    level: Optional[str] = None,
    *,
    device=None,
    expected_syncs: Optional[int] = None,
    require_no_recompile: bool = False,
):
    """Run a hot section on `device` (a torch.device; None or a CPU
    device: no accounting) with its synchronising calls counted into the
    yielded GuardReport's `syncs`."""
    resolved = level or transfer_guard_level("disallow") or "disallow"
    report = GuardReport(level=resolved)
    if device is None or device.type != "cuda":
        yield report
    else:
        import torch

        previous = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield report
            finally:
                torch.cuda.set_sync_debug_mode(previous)
                report.syncs = sum("synchroniz" in str(w.message) for w in caught)
    if report.recompiled and require_no_recompile:
        raise RecompileInGuardedSection(f"programs recompiled under guard: {report.new_compiles}")
    base = resolved.replace("_explicit", "")
    if base == "disallow" and expected_syncs is not None and report.syncs > expected_syncs:
        raise SyncsOverBudget(f"{report.syncs} synchronising calls, {expected_syncs} expected")
    if base == "log" and report.syncs:
        log.warning("guarded section made %d synchronising calls", report.syncs)


@contextmanager
def maybe_guarded_tick(device=None):
    """The serving-process form: count the tick's synchronising calls on
    `device` only when KMAMIZ_TRANSFER_GUARD asks for it, otherwise run
    unwrapped (yields None)."""
    lvl = transfer_guard_level()
    if lvl is None:
        yield None
        return
    with hot_path_guard(lvl, device=device) as report:
        yield report
