"""Build and locate the port's host C++ library with g++.

The sources are `kmamiz_tpu_torch/csrc/*.cpp` (standard library only, no
CUDA): they compile with the host compiler, never with nvcc, into one
shared library, looked up and built where core/compile_cache.py says: in
KMAMIZ_COMPILE_CACHE_DIR when it is set, then in the ignored
`kmamiz_tpu_torch/csrc/build/`, built into the first (the second when the
variable is unset). The library's file name carries a hash of its sources, the compiler flags and
this host's ISA signature, so an edited source or a build made for
another CPU (the flags start with `-march=native`) is never loaded. The
first caller builds it; concurrent callers (test workers, server threads)
wait on a file lock and then load the finished file, which appears
atomically.

A failed build raises RuntimeError with the compiler's output. There is
no pure-Python fallback.
"""
from __future__ import annotations

import fcntl
import hashlib
import json
import os
import platform
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

from kmamiz_tpu_torch.core import compile_cache

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: the package's own build directory (compile_cache.PACKAGE_BUILD)
BUILD_DIR = compile_cache.PACKAGE_BUILD
FLAGS = ["-shared", "-fPIC", "-pthread", "-std=c++17"]
# -march=native first (the library is built on the host that runs it), a
# generic build when the compiler refuses it
ARCHES = (("native", ["-march=native"]), ("generic", []))
BUILD_TIMEOUT_S = 600


def cpu_signature() -> str:
    """Fingerprint of this host's ISA (the cpu flags line of
    /proc/cpuinfo): part of the library's key, since a -march=native
    build can fault on a CPU with a smaller instruction set."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha256(line.encode()).hexdigest()
    except OSError:
        pass
    return platform.machine()


def library_name(name: str, sources: Sequence[Path]) -> str:
    """The file name of the current build of `sources` on this host."""
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update(json.dumps([FLAGS, ARCHES]).encode())
    h.update(cpu_signature().encode())
    return f"lib{name}-{h.hexdigest()[:16]}.so"


def library_path(name: str, sources: Sequence[Path], build_dir: Optional[Path] = None) -> Path:
    """Where the current build of `sources` lives (built or not): in
    `build_dir` when given, else the first found in the lookup order, else
    where it would be built."""
    file_name = library_name(name, sources)
    if build_dir is None:
        return compile_cache.locate(file_name)
    return Path(build_dir) / file_name


def build_info(lib: Path) -> dict:
    """What the build of `lib` recorded: the -march it took, the compiler
    and its wall seconds."""
    return json.loads(lib.with_suffix(".json").read_text())


def ensure(
    name: str, sources: Sequence[Path], build_dir: Optional[Path] = None
) -> Tuple[Path, bool]:
    """(library path, whether this call built it) of `sources`: found as
    library_path finds it, else compiled there. Raises RuntimeError with
    the compiler's output when neither -march=native nor the generic build
    compiles."""
    out = library_path(name, sources, build_dir)
    if out.exists():
        return out, False
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / f"lib{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while we waited
            return out, False
        return _compile_locked(out, sources), True


def build(name: str, sources: Sequence[Path], build_dir: Optional[Path] = None) -> Path:
    """Compile `sources` into one shared library unless its current build
    exists; returns the library path (see ensure)."""
    return ensure(name, sources, build_dir)[0]


def _compile_locked(out: Path, sources: Sequence[Path]) -> Path:
    cxx = os.environ.get("CXX", "g++")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    errors = []
    for label, arch in ARCHES:
        cmd = [cxx, "-O3", *arch, *FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        err: Optional[str] = None
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S
            )
            if proc.returncode != 0:
                err = f"exit {proc.returncode}:\n{proc.stderr}"
        except (OSError, subprocess.TimeoutExpired) as e:
            err = str(e)
        if err is None:
            info = {
                "march": label,
                "compiler": cxx,
                "seconds": time.perf_counter() - t0,
                "cmd": cmd,
            }
            info_tmp = tmp.with_suffix(".json.tmp")
            info_tmp.write_text(json.dumps(info))
            os.replace(info_tmp, out.with_suffix(".json"))
            os.replace(tmp, out)  # atomic: no reader sees half a library
            return out
        errors.append(f"{' '.join(cmd)}\n{err}")
        tmp.unlink(missing_ok=True)
    raise RuntimeError(f"host build of {out.name} failed:\n" + "\n\n".join(errors))
