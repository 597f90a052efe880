"""On-disk sweep manifest: atomic per-cell records, crash-safe resume.

Counterpart of kmamiz_tpu/soak/manifest.py, with the same on-disk format:
a sweep directory that one package wrote, the other reads.

Layout under the sweep directory (``KMAMIZ_SOAK_DIR``):

    manifest.json            the planned cell list (cost-ordered)
    results/<cell>.json      one atomic record per finished cell
    claims/<cell>.claim      O_EXCL worker claims (in-flight cells)
    baselines/<arch>.json    last passing flight profile per archetype
    flights/                 per-cell flight boxes (KMAMIZ_PROF_FLIGHT_DIR)

Every write is tmp + ``os.replace`` so a kill -9 at any instant leaves
either the old record or the new one, never a torn file. A claim is a
single ``O_CREAT|O_EXCL`` create — the only cross-process mutual
exclusion the sweep needs; workers that die leave a stale claim with no
result, and ``clear_stale_claims`` (called by the engine before workers
exist) releases them so a resumed sweep re-runs exactly the unfinished
cells.
"""
from __future__ import annotations

import errno
import json
import os
from typing import Dict, List, Optional

MANIFEST_KIND = "kmamiz-soak-manifest"
MANIFEST_VERSION = 1


def default_soak_dir() -> str:
    return os.environ.get("KMAMIZ_SOAK_DIR") or os.path.join(
        "kmamiz-data", "soak"
    )


def write_json_atomic(path: str, doc: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, separators=(",", ":"), sort_keys=True)
    os.replace(tmp, path)


def read_json(path: str) -> Optional[dict]:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class SoakManifest:
    """One sweep directory: the cell plan plus its mutable on-disk
    state. Safe for concurrent use by N worker processes."""

    def __init__(self, root: Optional[str] = None) -> None:
        self.root = root or default_soak_dir()

    # -- paths ---------------------------------------------------------------

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root, "manifest.json")

    @property
    def results_dir(self) -> str:
        return os.path.join(self.root, "results")

    @property
    def claims_dir(self) -> str:
        return os.path.join(self.root, "claims")

    @property
    def baselines_dir(self) -> str:
        return os.path.join(self.root, "baselines")

    @property
    def flights_dir(self) -> str:
        return os.path.join(self.root, "flights")

    def result_path(self, cell_id: str) -> str:
        return os.path.join(self.results_dir, f"{cell_id}.json")

    def baseline_path(self, archetype: str) -> str:
        return os.path.join(self.baselines_dir, f"{archetype}.json")

    # -- manifest ------------------------------------------------------------

    def write(self, doc: dict) -> None:
        doc = {"kind": MANIFEST_KIND, "version": MANIFEST_VERSION, **doc}
        for sub in (
            self.results_dir,
            self.claims_dir,
            self.baselines_dir,
            self.flights_dir,
        ):
            os.makedirs(sub, exist_ok=True)
        write_json_atomic(self.manifest_path, doc)

    def load(self) -> Optional[dict]:
        doc = read_json(self.manifest_path)
        if doc is None or doc.get("kind") != MANIFEST_KIND:
            return None
        return doc

    # -- per-cell records ----------------------------------------------------

    def record_result(self, cell_id: str, doc: dict) -> None:
        write_json_atomic(self.result_path(cell_id), doc)

    def load_results(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        try:
            names = os.listdir(self.results_dir)
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            doc = read_json(os.path.join(self.results_dir, name))
            if doc is not None:
                out[name[: -len(".json")]] = doc
        return out

    def drop_result(self, cell_id: str) -> None:
        try:
            os.remove(self.result_path(cell_id))
        except OSError:
            pass

    # -- claims --------------------------------------------------------------

    def claim(self, cell_id: str) -> bool:
        """Atomically claim a cell for this process. True iff won."""
        os.makedirs(self.claims_dir, exist_ok=True)
        path = os.path.join(self.claims_dir, f"{cell_id}.claim")
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except OSError as exc:
            if exc.errno == errno.EEXIST:
                return False
            raise
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(str(os.getpid()))
        return True

    def clear_stale_claims(self) -> List[str]:
        """Release claims that have no finished result — the in-flight
        cells of a killed sweep. Only the engine calls this, before any
        worker of the new run exists, so no live claim can be cleared."""
        cleared: List[str] = []
        try:
            names = os.listdir(self.claims_dir)
        except OSError:
            return cleared
        for name in names:
            if not name.endswith(".claim"):
                continue
            cell_id = name[: -len(".claim")]
            if os.path.exists(self.result_path(cell_id)):
                continue
            try:
                os.remove(os.path.join(self.claims_dir, name))
                cleared.append(cell_id)
            except OSError:
                pass
        return cleared

    # -- incremental planning ------------------------------------------------

    def pending_cells(self, rerun_failed: bool = True) -> List[dict]:
        """Manifest cells still needing execution, in manifest (cost)
        order: no result yet, a result from a different plan (the
        manifest was re-planned with e.g. another tick count — a stale
        record must not pass for the new cell), or a failed result when
        ``rerun_failed``. Superseded records are dropped so the
        worker's claim/record cycle stays uniform."""
        doc = self.load()
        if doc is None:
            return []
        results = self.load_results()
        pending = []
        for cell in doc.get("cells", []):
            rec = results.get(cell["id"])
            stale = rec is not None and rec.get("ticks") != cell.get("ticks")
            if rec is not None and (
                stale or (rerun_failed and not rec.get("pass"))
            ):
                self.drop_result(cell["id"])
                try:
                    os.remove(
                        os.path.join(self.claims_dir, f"{cell['id']}.claim")
                    )
                except OSError:
                    pass
                rec = None
            if rec is None:
                pending.append(cell)
        return pending
