"""Restart-warmth probe: boot a fresh processor, prewarm, time the first tick.

Counterpart of the repo's tools/warm_boot_probe.py, over the port, with
``--device`` (the card when not given; without one the tool raises before
it boots anything). Run it twice against one KMAMIZ_COMPILE_CACHE_DIR to
measure a deployment's restart:

  run 1 (cold: an empty cache directory and no prebuilt libraries): the
  boot prewarm plan (core/prewarm.py) pays every build, g++ for the host
  library and nvcc for each kernel library, once, into the directory;
  run 2 (warm): the plan finds every library there (core/compile_cache.py)
  and only loads them.

Either way the two timed ticks must build or first load no library: the
contract is 0 for both counts.

stdout carries ONE JSON line with the JAX tool's keys, in the port's
meaning: {"prewarm_s": the plan's wall, "prewarm_programs": the libraries
the plan built or loaded, "prewarm_report": its report, "first_tick_ms":
..., "second_tick_ms": ..., "first_tick_new_compiles" and
"second_tick_new_compiles": libraries built or first loaded inside each
timed tick (compile_cache.loads after a snapshot: a real count), "programs": one
entry per library this process loaded}, plus "device". The per-library
table goes to stderr.

Usage: KMAMIZ_COMPILE_CACHE_DIR=/var/cache/kmamiz python -m
       kmamiz_tpu_torch.tools.warm_boot_probe [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from kmamiz_tpu_torch.core import compile_cache, prewarm
from kmamiz_tpu_torch.device import DeviceLike, resolve_device

#: the reference-cadence tick: 2,500 traces x 7 spans
TICK_TRACES = 2_500


def _print_library_table(programs: dict) -> None:
    """Per-library build and load telemetry, aligned, on stderr (stdout
    is the one-JSON-line machine contract)."""
    if not programs:
        return
    width = max(len(name) for name in programs)
    print(f"{'library':<{width}}  kind  built  build_ms  load_ms  prewarmed", file=sys.stderr)
    for name, st in programs.items():
        build_ms = "-" if st["buildMs"] is None else f"{st['buildMs']:.1f}"
        print(
            f"{name:<{width}}  {st['kind']:<4}  {str(st['built']):<5}  {build_ms:>8}  "
            f"{st['loadMs']:>7.1f}  {str(st['prewarmed']):>9}",
            file=sys.stderr,
        )
    built = sum(st["built"] for st in programs.values())
    print(f"total: {len(programs)} libraries, {built} built", file=sys.stderr)


def probe(device: DeviceLike = None) -> dict:
    """The probe's result line (see the module docstring), on `device`."""
    from kmamiz_tpu_torch.server.processor import DataProcessor
    from kmamiz_tpu_torch.synth import make_raw_window

    compile_cache.enable_from_env()
    device = resolve_device(device)
    window = json.loads(make_raw_window(TICK_TRACES, 7))
    dp = DataProcessor(trace_source=lambda lb, t, lim: window, device=device)

    # the boot prewarm plan, as the server mains dispatch it
    mark = compile_cache.snapshot()
    t0 = time.perf_counter()
    report = prewarm.run_prewarm(dp)
    prewarm_s = time.perf_counter() - t0
    in_plan = compile_cache.loads(mark)

    snap = compile_cache.snapshot()
    t0 = time.perf_counter()
    dp.collect({"uniqueId": "warm-1", "lookBack": 30_000, "time": 1_000_000})
    dp.graph.n_edges  # the merge's device work inside the timer
    first_tick_ms = (time.perf_counter() - t0) * 1000
    first_tick_new = compile_cache.loads(snap)

    window2 = json.loads(make_raw_window(TICK_TRACES, 7, t_start=10_000))
    dp2 = DataProcessor(trace_source=lambda lb, t, lim: window2, device=device)
    snap = compile_cache.snapshot()
    t0 = time.perf_counter()
    dp2.collect({"uniqueId": "warm-2", "lookBack": 30_000, "time": 2_000_000})
    dp2.graph.n_edges
    second_tick_ms = (time.perf_counter() - t0) * 1000
    second_tick_new = compile_cache.loads(snap)

    planned = {entry["library"] for entry in in_plan}
    programs = {
        entry["library"]: {
            "kind": entry["kind"],
            "built": entry["built"],
            "buildMs": entry["buildMs"],
            "loadMs": entry["loadMs"],
            "prewarmed": entry["library"] in planned,
        }
        for entry in compile_cache.loads()
    }
    return {
        "device": str(device),
        "prewarm_s": prewarm_s,
        "prewarm_programs": len(in_plan),
        "prewarm_report": report,
        "first_tick_ms": first_tick_ms,
        "second_tick_ms": second_tick_ms,
        "first_tick_new_compiles": len(first_tick_new),
        "second_tick_new_compiles": len(second_tick_new),
        "programs": programs,
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    args = parser.parse_args(argv)
    result = probe(args.device)
    _print_library_table(result["programs"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
