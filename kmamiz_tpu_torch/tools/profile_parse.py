"""Profiling harness for the native span parse, over the port.

Counterpart of the repo's tools/profile_parse.py: times the port's
kmamiz_tpu_torch.native.parse_spans on the bench's synthetic window
(synth.make_raw_window at the BASELINE mesh, 1k services x 10 urls, so
the profiled parse IS the headline parse) across thread counts, printing
per-rep walls plus the native phase breakdown, min and median. Host code
only: no device, no torch import.

The port's native library is always there (a failed build raises), so a
parse that answers None is a malformed payload, and the tool raises on
it where the JAX tool printed "native loader unavailable".

Usage: python -m kmamiz_tpu_torch.tools.profile_parse [n_traces [reps
       [threads,...]]]   (defaults: 150000 5 1,2,4)
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional

from kmamiz_tpu_torch import native as native_mod
from kmamiz_tpu_torch.synth import make_raw_window


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    n_traces = int(argv[0]) if len(argv) > 0 else 150_000
    reps = int(argv[1]) if len(argv) > 1 else 5
    threads = [int(t) for t in argv[2].split(",")] if len(argv) > 2 else [1, 2, 4]
    t0 = time.perf_counter()
    # the bench headline's BASELINE workload shape (1k svc / 10 urls
    # each) so the profiled parse IS the headline parse
    raw = make_raw_window(n_traces, 7, n_services=1000, urls_per_service=10)
    print(f"window: {n_traces * 7} spans, {len(raw)/1e6:.1f} MB " f"(gen {time.perf_counter()-t0:.1f}s)")
    for T in threads:
        walls, tms = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = native_mod.parse_spans(raw, threads=T)
            walls.append((time.perf_counter() - t0) * 1000)
            if out is None:
                raise ValueError("the native parser rejected the synthetic window as malformed")
            tms.append(out["timings"])
        walls_s = sorted(walls)
        best = walls.index(min(walls))
        tm = tms[best]
        print(
            f"t{T}: min {walls_s[0]:7.1f} ms  med {walls_s[len(walls_s)//2]:7.1f}"
            f"  max {walls_s[-1]:7.1f}  | best rep: prescan {tm['prescan_us']/1000:6.1f}"
            f"  parse {tm['parse_us']/1000:6.1f}  merge {tm['merge_us']/1000:6.1f}"
            f"  (native threads {tm['threads']})"
        )
        print(f"     reps: {[round(w) for w in walls]}")


if __name__ == "__main__":
    main()
