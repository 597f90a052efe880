"""Snapshot a WAL into a replayable scenario bundle.

Counterpart of kmamiz_tpu/soak/capture.py::

    # from a running server (the tenant's WAL over HTTP: the /fleet/wal
    # handoff blob the migration ships)
    python -m kmamiz_tpu_torch.soak.capture --url http://127.0.0.1:8600 --out bundle/

    # from a WAL directory on disk (segment files copied verbatim, so v1
    # frames stay v1 and the replay reads both framings)
    python -m kmamiz_tpu_torch.soak.capture --wal-dir kmamiz-data/wal --out bundle/

The bundle is a directory: ``bundle.json`` and ``wal/`` with real WAL
segments. Point ``KMAMIZ_SOAK_BUNDLE`` at it and the ``wal-replay``
archetype replays the recording through a live server, held bit-exact to
a reference built from the same records. The capture itself needs no
card and boots no server.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
import urllib.request

from kmamiz_tpu_torch.resilience.wal import IngestWAL
from kmamiz_tpu_torch.soak.walreplay import bundle_wal_dir, write_bundle_meta


def capture_from_wal_dir(wal_dir: str, out_dir: str) -> dict:
    """Copy the WAL's segment files verbatim (frame versions intact),
    count the durable records via the stop-clean replay iterator."""
    src = IngestWAL(wal_dir)
    try:
        records = sum(1 for _ in src.replay_records())
    finally:
        src.close()
    dest = bundle_wal_dir(out_dir)
    os.makedirs(dest, exist_ok=True)
    copied = 0
    for name in sorted(os.listdir(wal_dir)):
        if name.endswith(".wal"):
            shutil.copy2(os.path.join(wal_dir, name), os.path.join(dest, name))
            copied += 1
    return write_bundle_meta(
        out_dir,
        records=records,
        segments=copied,
        source=f"wal-dir:{os.path.abspath(wal_dir)}",
        created_unix=int(time.time()),
    )


def capture_from_url(url: str, out_dir: str, tenant: str = "default") -> dict:
    """Fetch the live server's WAL namespace as one handoff blob
    (GET /fleet/wal) and import it into the bundle's own WAL."""
    prefix = "" if tenant == "default" else f"/t/{tenant}"
    req = urllib.request.Request(f"{url.rstrip('/')}{prefix}/fleet/wal")
    with urllib.request.urlopen(req, timeout=60) as resp:
        blob = resp.read()
    dest = IngestWAL(bundle_wal_dir(out_dir), fsync=False)
    try:
        records = dest.import_handoff(blob)
    finally:
        dest.close()
    return write_bundle_meta(
        out_dir,
        records=records,
        tenant=tenant,
        source=f"url:{url}",
        created_unix=int(time.time()),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="bundle directory to write")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--url", help="live server base URL (GET /fleet/wal)")
    src.add_argument("--wal-dir", help="WAL directory on disk")
    ap.add_argument("--tenant", default="default", help="tenant namespace")
    args = ap.parse_args(argv)

    if args.wal_dir:
        meta = capture_from_wal_dir(args.wal_dir, args.out)
    else:
        meta = capture_from_url(args.url, args.out, args.tenant)
    print(
        f"captured {meta['records']} records -> {args.out}", file=sys.stderr
    )
    print(json.dumps({"bundle": args.out, **meta}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
