"""Poison-input quarantine: divert malformed ingest payloads, keep going.

Counterpart of kmamiz_tpu/resilience/quarantine.py. With the quarantine
on (the default; KMAMIZ_QUARANTINE=0 turns it off), the raw-ingest paths
classify a payload the native parser rejected, write it to a bounded
on-disk directory with a reason code, and go on with the payloads that
parse: the window answers a zero-span summary, a stream skips the chunk.

Reason codes, the JAX package's:

- ``trace-bomb``     payload over the size cap (MAX_PAYLOAD_BYTES);
- ``garbage-utf8``   bytes that do not decode as UTF-8;
- ``truncated-json`` UTF-8 but not valid JSON (truncation, corruption);
- ``schema-drift``   valid JSON that is not a Zipkin trace-group list;
- ``parse-error``    structurally sound but rejected by the span parser.

Each payload lands as ``<millis>-<seq>-<reason>.bin`` plus a
``.meta.json`` sidecar ({reason, source, bytes, sha256, at}); the
directory is bounded by MAX_BYTES and MAX_FILES (the JAX defaults) with
oldest-first eviction. Totals surface in /health's `resilience` section.
The directory is ``KMAMIZ_QUARANTINE_DIR`` (``./kmamiz-data/quarantine``),
read when the process first diverts a payload. A non-default tenant's
payloads go to a bounded directory of its own, ``<dir>/tenants/<tenant>``
(`quarantine_for`), so they never count against another tenant's budget.
"""
from __future__ import annotations

import hashlib
import json
import logging
import threading
import time
from pathlib import Path
from typing import Optional

from kmamiz_tpu_torch import config
from kmamiz_tpu_torch.core import wire

logger = logging.getLogger("kmamiz_tpu_torch.resilience.quarantine")

REASON_TRACE_BOMB = "trace-bomb"
REASON_GARBAGE_UTF8 = "garbage-utf8"
REASON_TRUNCATED_JSON = "truncated-json"
REASON_SCHEMA_DRIFT = "schema-drift"
REASON_PARSE_ERROR = "parse-error"

#: per-payload size cap: 256 MiB of raw Zipkin bytes (the JAX default). A
#: tick's window is ~10 MB of JSON; bench.py's one-shot window of 1.05M
#: spans, a 609 MB body, is past it
MAX_PAYLOAD_BYTES = 256 * 1024 * 1024
#: the directory's bounds
MAX_BYTES = 64 * 1024 * 1024
MAX_FILES = 256

#: KMAMIZ_QUARANTINE=0 restores the abort-the-call behaviour (ValueError)
enabled = config.quarantine_enabled


def classify_payload(raw: bytes, size_cap: int = MAX_PAYLOAD_BYTES) -> Optional[str]:
    """Reason code for a malformed raw Zipkin payload, or None when it is
    structurally sound (a list of trace groups of span dicts with trace
    and span ids). Runs on the failure path only, and as the size gate
    (`size_cap` bytes; 0 = no cap)."""
    cap = size_cap
    if cap > 0 and len(raw) > cap:
        return REASON_TRACE_BOMB
    if wire.is_columnar(raw):
        # a frame the reference codec cannot decode lands as a parser
        # rejection, as a rejected JSON payload does
        return REASON_PARSE_ERROR if wire.decode_groups(raw) is None else None
    try:
        text = raw.decode("utf-8")
    except UnicodeDecodeError:
        return REASON_GARBAGE_UTF8
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        return REASON_TRUNCATED_JSON
    if not isinstance(data, list) or not all(
        isinstance(group, list) and all(isinstance(span, dict) for span in group)
        for group in data
    ):
        return REASON_SCHEMA_DRIFT
    for group in data:
        for span in group:
            if "traceId" not in span or "id" not in span:
                return REASON_SCHEMA_DRIFT
    return None


class Quarantine:
    """Bounded on-disk quarantine with oldest-first eviction."""

    def __init__(
        self,
        directory: Optional[str] = None,
        max_bytes: int = MAX_BYTES,
        max_files: int = MAX_FILES,
    ) -> None:
        self._dir = Path(directory if directory is not None else config.quarantine_dir())
        self._max_bytes = max_bytes
        self._max_files = max_files
        self._lock = threading.Lock()
        self._seq = 0
        # byReason counts every diversion of this process; files and
        # bytes are what is on disk now
        self._by_reason: dict = {}
        self._total = 0

    @property
    def directory(self) -> Path:
        return self._dir

    def put(self, raw: bytes, reason: str, source: str = "") -> Optional[Path]:
        """Divert one payload. Never raises: a failed write (full disk,
        permissions) logs and returns None; the payload is out of the
        pipeline either way."""
        from kmamiz_tpu_torch.resilience import metrics

        with self._lock:
            self._seq += 1
            seq = self._seq
            self._by_reason[reason] = self._by_reason.get(reason, 0) + 1
            self._total += 1
        metrics.incr("quarantined")
        metrics.incr(f"quarantined.{reason}")
        try:
            self._dir.mkdir(parents=True, exist_ok=True)
            stamp = int(time.time() * 1000)
            path = self._dir / f"{stamp}-{seq:04d}-{reason}.bin"
            path.write_bytes(raw)
            meta = {
                "reason": reason,
                "source": source,
                "bytes": len(raw),
                "sha256": hashlib.sha256(raw).hexdigest(),
                "at": stamp,
            }
            path.with_suffix(".meta.json").write_text(json.dumps(meta))
            with self._lock:
                self._evict_locked()
            logger.warning(
                "quarantined %d-byte payload from %s as %s -> %s",
                len(raw),
                source or "<unknown>",
                reason,
                path.name,
            )
            return path
        except OSError as err:
            logger.error("quarantine write failed (%s); payload dropped", err)
            return None

    def _entries_locked(self):
        try:
            return sorted(p for p in self._dir.glob("*.bin") if p.is_file())
        except OSError:
            return []

    def _evict_locked(self) -> None:
        entries = self._entries_locked()
        sizes = {}
        for p in entries:
            try:
                sizes[p] = p.stat().st_size
            except OSError:
                sizes[p] = 0
        total = sum(sizes.values())
        while entries and (
            len(entries) > self._max_files
            or (self._max_bytes > 0 and total > self._max_bytes)
        ):
            victim = entries.pop(0)  # lexicographic == oldest (ms prefix)
            total -= sizes.get(victim, 0)
            for path in (victim, victim.with_suffix(".meta.json")):
                try:
                    path.unlink()
                except OSError:
                    pass

    def stats(self) -> dict:
        with self._lock:
            by_reason = dict(self._by_reason)
            total = self._total
            entries = self._entries_locked()
        on_disk = 0
        for p in entries:
            try:
                on_disk += p.stat().st_size
            except OSError:
                pass
        return {
            "count": total,
            "byReason": by_reason,
            "files": len(entries),
            "bytes": on_disk,
            "dir": str(self._dir),
        }


_DEFAULT_LOCK = threading.Lock()
_DEFAULT: dict = {"instance": None}
# the tenants' quarantines: tenant -> Quarantine bound to
# <dir>/tenants/<tenant>, created at the tenant's first diversion
_TENANT_INSTANCES: dict = {}


def default_quarantine() -> Quarantine:
    """The process's quarantine, bound to the env-configured directory on
    first use."""
    with _DEFAULT_LOCK:
        if _DEFAULT["instance"] is None:
            _DEFAULT["instance"] = Quarantine()
        return _DEFAULT["instance"]


def quarantine_for(tenant: str = "default") -> Quarantine:
    """The tenant's quarantine: the default tenant's is the plain
    directory, any other tenant's ``<dir>/tenants/<tenant>``. The name is
    checked again here: it becomes a path component."""
    if tenant in (None, "", "default"):
        return default_quarantine()
    from kmamiz_tpu_torch.tenancy.arena import TenantNameError, valid_tenant

    if not valid_tenant(tenant):
        raise TenantNameError(f"invalid tenant name: {tenant!r}")
    with _DEFAULT_LOCK:
        instance = _TENANT_INSTANCES.get(tenant)
        if instance is None:
            instance = Quarantine(directory=str(Path(config.quarantine_dir()) / "tenants" / tenant))
            _TENANT_INSTANCES[tenant] = instance
    return instance


def drop_tenant(tenant: str) -> None:
    """Forget one tenant's quarantine binding (its files stay on disk; a
    new binding counts them again)."""
    with _DEFAULT_LOCK:
        _TENANT_INSTANCES.pop(tenant, None)


def tenant_quarantine_stats() -> dict:
    """Every non-default tenant's quarantine stats, by tenant."""
    with _DEFAULT_LOCK:
        instances = dict(_TENANT_INSTANCES)
    return {tenant: q.stats() for tenant, q in sorted(instances.items())}


def quarantine_stats() -> dict:
    with _DEFAULT_LOCK:
        instance = _DEFAULT["instance"]
    if instance is None:
        return {"count": 0, "byReason": {}, "files": 0, "bytes": 0, "dir": None}
    return instance.stats()


def reset_for_tests() -> None:
    with _DEFAULT_LOCK:
        _DEFAULT["instance"] = None
        _TENANT_INSTANCES.clear()
