"""Where the port's compiled libraries are built, found and kept across restarts.

Counterpart of kmamiz_tpu/core/compile_cache.py. The JAX package points
XLA's persistent compilation cache at KMAMIZ_COMPILE_CACHE_DIR, so that
a restart reloads its compiled programs from disk. PyTorch compiles
nothing per shape, but the port compiles per source, at first use: nvcc
builds each csrc/*.cu (ops/cuda_build.py) and g++ the host library
(ops/host_build.py). Each library's file name carries a hash of what went
into it (the source, its macros and flags; the host library also this
CPU's signature), so a directory of builds is a cache: a name that exists
is current.

Lookup order of a library's file, with the variable read at each call,
never at import:

1. KMAMIZ_COMPILE_CACHE_DIR, when set: the directory a deployment keeps
   across container restarts (a pod-lifetime volume);
2. the package's csrc/build/, where an image's build step puts the
   libraries it prebuilds (``python -m kmamiz_tpu_torch.core.compile_cache
   --prebuild``), as the JAX image puts native/build/;
3. found in neither, the library is built into KMAMIZ_COMPILE_CACHE_DIR,
   or into csrc/build/ when the variable is unset: then nothing differs
   from a checkout without a cache directory.

A failed build raises, as it always did; there is no fallback.

The module also keeps this process's record of library loads (`loads`,
`snapshot`): one entry per library, saying whether this process built it
and its build and load milliseconds. The boot prewarm (core/prewarm.py)
reports it, and tools/warm_boot_probe.py counts the loads that land
inside its timed ticks.

    python -m kmamiz_tpu_torch.core.compile_cache --prebuild

builds every kernel library a main path launches (nvcc for sm_90a needs
no card) and the host library, all at once, where the lookup order
finds or builds them (an image's build step runs it with the variable
unset: into csrc/build/), and prints one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import logging
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, List, Optional, Tuple

logger = logging.getLogger("kmamiz_tpu_torch.compile_cache")

ENV = "KMAMIZ_COMPILE_CACHE_DIR"
PACKAGE_BUILD = Path(__file__).resolve().parent.parent / "csrc" / "build"

_lock = threading.Lock()
_loads: List[dict] = []


def cache_dir() -> Optional[Path]:
    """KMAMIZ_COMPILE_CACHE_DIR as a path, or None when it is unset."""
    directory = os.environ.get(ENV)
    return Path(directory) if directory else None


def build_dir() -> Path:
    """Where a library found nowhere is built."""
    return cache_dir() or PACKAGE_BUILD


def search_dirs() -> List[Path]:
    """The directories a library is looked up in, in order."""
    first = cache_dir()
    if first is None or first.resolve() == PACKAGE_BUILD:
        return [PACKAGE_BUILD]
    return [first, PACKAGE_BUILD]


def locate(file_name: str) -> Path:
    """The first existing `file_name` in the lookup order, else the path
    it would be built at."""
    for directory in search_dirs():
        path = directory / file_name
        if path.exists():
            return path
    return build_dir() / file_name


def enable_from_env() -> bool:
    """Create KMAMIZ_COMPILE_CACHE_DIR when it is set, so the first build
    can write there; the server mains call it before anything loads.
    Returns whether a cache directory is in use."""
    directory = cache_dir()
    if directory is None:
        return False
    directory.mkdir(parents=True, exist_ok=True)
    logger.info("library build cache at %s", directory)
    return True


# -- the process's library loads ----------------------------------------------


def record_load(
    library: str, kind: str, path: Path, built: bool, build_ms: Optional[float], load_ms: float
) -> None:
    """Note that this process loaded `library` (kind "cuda" or "host") from
    `path`, building it first when `built`."""
    with _lock:
        _loads.append(
            {
                "library": library,
                "kind": kind,
                "path": str(path),
                "built": built,
                "buildMs": build_ms,
                "loadMs": load_ms,
            }
        )


def load_library(library: str, kind: str, ensure: Callable[[], Tuple[Path, bool]]) -> Tuple[Path, ctypes.CDLL]:
    """(path, ctypes handle) of the library that `ensure()` finds or
    builds (it returns (path, built)), the load recorded."""
    # imported here: the telemetry package imports the native library,
    # whose build resolves through this module
    from kmamiz_tpu_torch.telemetry.profiling.events import now_ms

    t0 = now_ms()
    path, built = ensure()
    t1 = now_ms()
    lib = ctypes.CDLL(str(path))
    record_load(library, kind, path, built, t1 - t0 if built else None, now_ms() - t1)
    return path, lib


def loads(since: int = 0) -> List[dict]:
    """The library loads of this process after the mark `since` (a
    snapshot()), in order; all of them by default."""
    with _lock:
        return [dict(entry) for entry in _loads[since:]]


def snapshot() -> int:
    """A mark for loads(since=)."""
    with _lock:
        return len(_loads)


# -- the prebuild entry -------------------------------------------------------


def main_path_kernels() -> List[str]:
    """The kernel sources a main path launches (csrc/<name>.cu), in their
    shipped variant: no tuning macros."""
    from kmamiz_tpu_torch.ops import segment_stats, sparse

    return [segment_stats.KERNEL, sparse.KERNEL]


def prebuild() -> dict:
    """Find or build every main-path kernel library and the host library
    in the lookup order, at once: one nvcc per source beside one g++.
    Needs no card. Raises when a build fails."""
    from kmamiz_tpu_torch import native
    from kmamiz_tpu_torch.ops import cuda_build, host_build

    t0 = time.perf_counter()

    def timed(kind, name, ensure):
        t = time.perf_counter()
        path, built = ensure()
        return {"library": name, "kind": kind, "path": str(path), "built": built, "seconds": time.perf_counter() - t}

    jobs = [("cuda", name, lambda name=name: cuda_build.ensure(name)) for name in main_path_kernels()]
    jobs.append(("host", native.NAME, lambda: host_build.ensure(native.NAME, native.SOURCES)))
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        libraries = list(pool.map(lambda job: timed(*job), jobs))
    return {"dir": str(build_dir()), "libraries": libraries, "seconds": time.perf_counter() - t0}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--prebuild",
        action="store_true",
        help="build every main-path kernel library and the host library now",
    )
    args = parser.parse_args(argv)
    if not args.prebuild:
        parser.print_usage(sys.stderr)
        return 2
    print(json.dumps(prebuild()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
