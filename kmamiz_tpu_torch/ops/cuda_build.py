"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `kmamiz_tpu_torch/csrc/<name>.cu` file with a plain C
interface. It is compiled with nvcc for Hopper (`sm_90a`) into a shared
library under `kmamiz_tpu_torch/csrc/build/` and loaded with ctypes; the
library's file name carries a hash of its source, so an edited source is
never served by a stale build. Nothing here runs at import time: the first
launch of a kernel builds it, and `build_all` lets a caller build every
kernel up front (in parallel, one nvcc per source).

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
from typing import Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(name: str, defines: Sequence[str] = ()) -> Path:
    """Compile csrc/<name>.cu unless its current build exists; returns
    the library path. `defines` are preprocessor macros (-D) that select a
    variant of the source, built apart. Raises RuntimeError with nvcc's
    output on failure."""
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + "\0".join(defines).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
    (BUILD_DIR / f"{name}{variant}.ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


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
            lib = ctypes.CDLL(str(build(name)))
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
