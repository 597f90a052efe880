"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `kmamiz_tpu_torch/csrc/<name>.cu` file with a plain C
interface. It is compiled with nvcc for Hopper (`sm_90a`) into a shared
library and loaded with ctypes; the library's file name carries a hash of
its source, so an edited source is never served by a stale build. Where
the library is looked up and built is core/compile_cache.py's: in
KMAMIZ_COMPILE_CACHE_DIR when it is set, then in the ignored
`kmamiz_tpu_torch/csrc/build/`, built into the first (the second when the
variable is unset). Nothing here runs at import time: the first launch of
a kernel builds it, and `build_all` lets a caller build every kernel up
front (in parallel, one nvcc per source). Each load is recorded with
compile_cache.record_load.

A failed build raises. There is no fallback to the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from kmamiz_tpu_torch.core import compile_cache

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: the package's own build directory (compile_cache.PACKAGE_BUILD)
BUILD_DIR = compile_cache.PACKAGE_BUILD
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_name(name: str, defines: Sequence[str] = ()) -> str:
    """The file name of csrc/<name>.cu's build with `defines`."""
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + "\0".join(defines).encode()).hexdigest()
    return f"lib{name}-{digest[:16]}.so"


def ensure(name: str, defines: Sequence[str] = ()) -> Tuple[Path, bool]:
    """(library path, whether it was built now) of csrc/<name>.cu with
    `defines`: found in the lookup order, else compiled where it puts new
    builds. Raises RuntimeError with nvcc's output on failure."""
    out = compile_cache.locate(library_name(name, defines))
    if out.exists():
        return out, False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [
        _nvcc(),
        *ARCH_FLAGS,
        "-std=c++17",
        "-O3",
        "-shared",
        "-Xcompiler",
        "-fPIC",
        "-Xptxas",
        "-v",
        *(f"-D{d}" for d in defines),
        "-o",
        str(tmp),
        str(CSRC / f"{name}.cu"),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu ({proc.returncode}):\n{proc.stderr}"
        )
    variant = "".join(f".{d}" for d in defines)
    (out.parent / f"{name}{variant}.ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, True


def build(name: str, defines: Sequence[str] = ()) -> Path:
    """Compile csrc/<name>.cu unless its current build exists; returns
    the library path. `defines` are preprocessor macros (-D) that select a
    variant of the source, built apart. Raises RuntimeError with nvcc's
    output on failure."""
    return ensure(name, defines)[0]


def build_all(names: Iterable[str]) -> List[Path]:
    """Build several kernels at once, one nvcc process per source."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _path, lib = compile_cache.load_library(name, "cuda", lambda: ensure(name))
            _loaded[name] = lib
        return lib


def launch(fn, args, device: torch.device) -> int:
    """Call a kernel's C entry with args and the current stream of `device`
    (a CUDA device with its index) appended, with that device current;
    returns the entry's cudaError code."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    # the raw stream pointer, without building a torch.cuda.Stream object
    return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
