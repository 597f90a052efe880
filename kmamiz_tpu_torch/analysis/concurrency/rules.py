"""The three graftrace rules, registered into the graftlint framework.

They share one LockModel per lint context (built lazily, cached), and
they are deliberately NOT hot-path gated: a deadlock on a cold admin
route hangs the process just as hard as one on the tick path.

Suppression uses the same `# graftlint: disable=<rule> -- reason`
comments as every other rule; `--strict` enforces the reason.

Counterpart of kmamiz_tpu/analysis/concurrency/rules.py. The JAX rule's
"device sync" (``block_until_ready``) and "jitted-program dispatch" are
one reason here, "device sync": the synchronising torch calls
(``torch.cuda.synchronize``, ``Event.synchronize``,
``Stream.synchronize``, ``.item()``, ``.cpu()``, ``.tolist()``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from kmamiz_tpu_torch.analysis.framework import (
    Finding,
    LintContext,
    ModuleInfo,
    rule,
)
from kmamiz_tpu_torch.analysis.concurrency import locks as _locks
from kmamiz_tpu_torch.analysis.concurrency.locks import CallRec, LockModel

# ---------------------------------------------------------------------------
# rule 10: lock-order-cycle
# ---------------------------------------------------------------------------


@rule(
    "lock-order-cycle",
    "the interprocedural lock-acquisition-order graph must stay acyclic; "
    "a cycle is a potential deadlock, reported as the full cycle path",
)
def check_lock_order_cycle(
    mod: ModuleInfo, ctx: LintContext
) -> List[Finding]:
    model = _locks.build_model(ctx)
    findings: List[Finding] = []
    for cyc in _locks.find_cycles(model):
        anchor = cyc[0]  # edges are sorted; first is the smallest site
        if anchor.rel_path != mod.rel_path:
            continue
        path = "; ".join(
            f"{e.src} -> {e.dst} at {e.rel_path}:{e.line} in {e.fn.split(':', 1)[1]}"
            for e in cyc
        )
        findings.append(
            Finding(
                "lock-order-cycle",
                mod.rel_path,
                anchor.line,
                f"lock acquisition order cycle (potential deadlock): {path}",
            )
        )
    for src, dst, reason in model.stale_declared:
        if src.split(":", 1)[0] != mod.rel_path:
            continue
        findings.append(
            Finding(
                "lock-order-cycle",
                mod.rel_path,
                1,
                f"DECLARED_EDGES entry {src} -> {dst} ({reason}) names a "
                "lock the extractor does not know — stale declaration",
            )
        )
    return findings


# ---------------------------------------------------------------------------
# rule 11: blocking-call-under-lock
# ---------------------------------------------------------------------------

_BLOCKING_CHAINS: Dict[Tuple[str, ...], str] = {
    ("time", "sleep"): "time.sleep",
    ("os", "fsync"): "os.fsync",
    ("os", "fdatasync"): "os.fdatasync",
    ("socket", "create_connection"): "socket connect",
    ("urllib", "request", "urlopen"): "HTTP request",
}
_SUBPROCESS_CALLS = {"run", "call", "check_call", "check_output", "Popen"}
_BLOCKING_BASENAMES = {
    "fsync": "os.fsync",
    "fdatasync": "os.fdatasync",
    "urlopen": "HTTP request",
    "create_connection": "socket connect",
    # torch.cuda.synchronize, Event.synchronize, Stream.synchronize, and
    # the copies back of a tensor (each waits for the card's queue)
    "synchronize": "device sync",
    "item": "device sync",
    "cpu": "device sync",
    "tolist": "device sync",
}
_QUEUE_VERBS = {"get", "put"}

# Single-writer design table: these locks exist precisely to serialize
# device mutation, so a device sync while holding ONLY them is the
# module's documented contract (EndpointGraph is a single-writer store;
# every merge/fold/score reads its counts back under its RLock by
# design). A sync while holding any OTHER lock on top still reports.
_OWN_LOCK_DISPATCH_OK = frozenset(
    {
        "kmamiz_tpu_torch/graph/store.py:EndpointGraph._lock",
    }
)


def _receiver_segments(chain: Tuple[str, ...]) -> Tuple[str, ...]:
    return chain[:-1] if len(chain) > 1 else ()


def _blocking_reason(
    call: CallRec, model: LockModel, ctx: LintContext
) -> Optional[str]:
    chain = call.chain
    if not chain:
        return None
    base = chain[-1]
    if chain in _BLOCKING_CHAINS:
        return _BLOCKING_CHAINS[chain]
    if len(chain) == 2 and chain[0] == "subprocess" and base in _SUBPROCESS_CALLS:
        return f"subprocess.{base}"
    if base in _BLOCKING_BASENAMES and len(chain) > 1:
        return _BLOCKING_BASENAMES[base]
    if base in ("wait", "wait_for"):
        # Condition.wait releases its own lock while waiting — only the
        # *other* held locks stall anyone (the caller filters for that)
        return "blocking wait"
    if base in _QUEUE_VERBS and not call.nonblocking_kw:
        recv = _receiver_segments(chain)
        if recv and ("queue" in recv[-1].lower() or recv[-1] == "q"):
            return f"queue.{base}"
    if call.thread_join or (
        base == "join"
        and any("thread" in s.lower() for s in _receiver_segments(chain))
    ):
        return "thread join"
    if any("transport" in s.lower() for s in _receiver_segments(chain)):
        return "transport send"
    if base == "call" and any(
        "breaker" in s.lower() for s in _receiver_segments(chain)
    ):
        return "breaker-wrapped I/O"
    return None


@rule(
    "blocking-call-under-lock",
    "transport/HTTP sends, fsync, queue waits, device syncs, sleeps, "
    "subprocess and breaker-wrapped I/O must not run while a lock is held",
)
def check_blocking_call_under_lock(
    mod: ModuleInfo, ctx: LintContext
) -> List[Finding]:
    model = _locks.build_model(ctx)
    findings: List[Finding] = []
    seen: Set[Tuple[int, str]] = set()
    for call in model.calls:
        if call.fn.split(":", 1)[0] != mod.rel_path:
            continue
        held = set(call.held) | model.entry_must.get(call.fn, frozenset())
        # locks nobody ever blocks on (try-lock-only) cannot stall a peer
        held -= model.trylock_only
        if not held:
            continue
        reason = _blocking_reason(call, model, ctx)
        if reason is None:
            continue
        if reason == "device sync" and held <= _OWN_LOCK_DISPATCH_OK:
            continue
        if reason == "blocking wait" and call.recv_lock is not None:
            # waiting on a condition releases its underlying lock
            held = held - {call.recv_lock}
            if not held:
                continue
        held_s = ", ".join(sorted(held))
        key = (call.line, reason)
        if key in seen:
            continue
        seen.add(key)
        findings.append(
            Finding(
                "blocking-call-under-lock",
                mod.rel_path,
                call.line,
                f"{reason} while holding {held_s} — move the blocking "
                "call outside the lock (snapshot under the lock, act after)",
            )
        )
    return findings


# ---------------------------------------------------------------------------
# rule 12: inconsistent-guard
# ---------------------------------------------------------------------------


@rule(
    "inconsistent-guard",
    "a shared mutable guarded by one lock at most access sites must not "
    "be touched under a different lock or none (guarded-by inference)",
)
def check_inconsistent_guard(
    mod: ModuleInfo, ctx: LintContext
) -> List[Finding]:
    model = _locks.build_model(ctx)
    by_key: Dict[Tuple[str, ...], List] = {}
    for acc in model.accesses:
        by_key.setdefault(acc.key, []).append(acc)
    findings: List[Finding] = []
    for key, sites in sorted(by_key.items()):
        if key[0] != mod.rel_path:
            continue
        counted = []
        for acc in sites:
            fn_base = acc.fn.rsplit(".", 1)[-1]
            if fn_base.endswith("_locked") or fn_base == "__init__":
                continue  # trusted helper / single-threaded construction
            held = set(acc.held) | model.entry_must.get(acc.fn, frozenset())
            counted.append((acc, held))
        total = len(counted)
        if total < 2:
            continue
        votes: Dict[str, int] = {}
        for _, held in counted:
            for lid in held:
                votes[lid] = votes.get(lid, 0) + 1
        if not votes:
            continue
        guard = max(sorted(votes), key=lambda lid: votes[lid])
        n = votes[guard]
        if n < 2 or 2 * n <= total:
            continue  # no majority guard — unguarded-shared-state's turf
        name = key[-1] if len(key) == 2 else f"{key[1]}.{key[2]}"
        for acc, held in counted:
            if guard in held:
                continue
            others = ", ".join(sorted(held)) or "no lock"
            findings.append(
                Finding(
                    "inconsistent-guard",
                    mod.rel_path,
                    acc.line,
                    f"'{name}' is guarded by {guard} at {n}/{total} access "
                    f"sites but this access holds {others}",
                )
            )
    findings.sort(key=lambda f: (f.line, f.message))
    # one finding per line: several mentions of the same name on a line
    # collapse (dict/loop expressions mention a var more than once)
    out: List[Finding] = []
    seen: Set[Tuple[int, str]] = set()
    for f in findings:
        if (f.line, f.message) not in seen:
            seen.add((f.line, f.message))
            out.append(f)
    return out
