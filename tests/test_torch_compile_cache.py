"""The port's library build cache (kmamiz_tpu_torch/core/compile_cache.py)
and its prebuild entry, on the CPU: the lookup order, the default with
KMAMIZ_COMPILE_CACHE_DIR unset, the record of loads, and the prebuild's
nvcc and g++ command lines with the compilers stubbed (no toolchain runs).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from kmamiz_tpu_torch import native
from kmamiz_tpu_torch.core import compile_cache
from kmamiz_tpu_torch.ops import cuda_build, host_build


@pytest.fixture
def package_build(tmp_path, monkeypatch):
    """The package's build directory moved under tmp_path (nothing of the
    checkout's csrc/build/ is read or written)."""
    pkg = tmp_path / "pkg-build"
    pkg.mkdir()
    monkeypatch.setattr(compile_cache, "PACKAGE_BUILD", pkg)
    return pkg


class StubCompilers:
    """subprocess.run of cuda_build and host_build replaced: each call is
    recorded and writes the file named after -o, as a compiler would."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(cuda_build, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
        monkeypatch.setattr(cuda_build.subprocess, "run", self.run)

    def run(self, cmd, **kw):
        self.calls.append(list(cmd))
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"\x7fELF stub")
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info: stub")

    def nvcc(self):
        return [c for c in self.calls if c[0].endswith("nvcc")]

    def cxx(self):
        return [c for c in self.calls if not c[0].endswith("nvcc")]


@pytest.fixture
def compilers(monkeypatch):
    # cuda_build and host_build share the subprocess module: one stub
    # catches both compilers
    return StubCompilers(monkeypatch)


def test_unset_builds_and_looks_up_in_the_package_build(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.cache_dir() is None
    assert compile_cache.build_dir() == compile_cache.PACKAGE_BUILD
    assert compile_cache.search_dirs() == [compile_cache.PACKAGE_BUILD]
    assert compile_cache.PACKAGE_BUILD == cuda_build.BUILD_DIR == host_build.BUILD_DIR
    assert compile_cache.PACKAGE_BUILD == Path(native.__file__).resolve().parent.parent / "csrc" / "build"
    # the paths every earlier caller saw
    name = host_build.library_name(native.NAME, native.SOURCES)
    assert host_build.library_path(native.NAME, native.SOURCES) == host_build.BUILD_DIR / name
    kernel = cuda_build.library_name("segment_stats")
    assert compile_cache.locate(kernel) == cuda_build.BUILD_DIR / kernel
    assert compile_cache.enable_from_env() is False


def test_unset_matches_the_jax_package(monkeypatch):
    from kmamiz_tpu.core import compile_cache as jax_cache

    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.enable_from_env() is jax_cache.enable_from_env() is False


def test_the_variable_is_read_at_each_call(tmp_path, monkeypatch, package_build):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.build_dir() == package_build
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "cache"))
    assert compile_cache.build_dir() == tmp_path / "cache"
    assert compile_cache.search_dirs() == [tmp_path / "cache", package_build]
    assert compile_cache.enable_from_env() is True
    assert (tmp_path / "cache").is_dir()


def test_lookup_order_cache_dir_then_package_then_build_into_cache(tmp_path, monkeypatch, package_build):
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv(compile_cache.ENV, str(cache))
    # found nowhere: built into the cache directory
    assert compile_cache.locate("liba.so") == cache / "liba.so"
    # only the image's prebuilt copy: that one
    (package_build / "liba.so").write_bytes(b"pkg")
    assert compile_cache.locate("liba.so") == package_build / "liba.so"
    # in both: the cache directory's
    (cache / "liba.so").write_bytes(b"cache")
    assert compile_cache.locate("liba.so") == cache / "liba.so"


def test_a_cache_dir_naming_the_package_build_is_searched_once(monkeypatch, package_build):
    monkeypatch.setenv(compile_cache.ENV, str(package_build))
    assert compile_cache.search_dirs() == [package_build]


def test_host_build_finds_the_prebuilt_library_and_builds_the_rest_into_the_cache(
    tmp_path, monkeypatch, package_build, compilers
):
    src = tmp_path / "a.cpp"
    src.write_text("int f() { return 1; }\n")
    cache = tmp_path / "cache"
    monkeypatch.setenv(compile_cache.ENV, str(cache))
    name = host_build.library_name("a", [src])
    (package_build / name).write_bytes(b"prebuilt")
    assert host_build.ensure("a", [src]) == (package_build / name, False)
    assert compilers.calls == []
    (package_build / name).unlink()
    path, built = host_build.ensure("a", [src])
    assert (path, built) == (cache / name, True)
    assert compilers.cxx()[0][:3] == [os.environ.get("CXX", "g++"), "-O3", "-march=native"]
    assert host_build.build_info(path)["march"] == "native"
    assert host_build.ensure("a", [src]) == (cache / name, False)
    assert len(compilers.calls) == 1


def test_prebuild_runs_one_nvcc_per_main_path_kernel_for_sm90a_and_one_gxx(tmp_path, compilers, monkeypatch):
    # an image's build step: the variable unset, an empty csrc/build/
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    target = tmp_path / "image-build"
    monkeypatch.setattr(compile_cache, "PACKAGE_BUILD", target)
    result = compile_cache.prebuild()
    assert result["dir"] == str(target)
    kernels = compile_cache.main_path_kernels()
    assert kernels == ["segment_stats", "fused_sddmm_spmm"]
    nvcc = sorted(compilers.nvcc(), key=lambda c: c[-1])
    assert [Path(c[-1]).name for c in nvcc] == sorted(f"{k}.cu" for k in kernels)
    for cmd in nvcc:
        name = Path(cmd[-1]).stem
        assert cmd[0] == "/usr/local/cuda/bin/nvcc"
        assert cmd[1:3] == ["-gencode", "arch=compute_90a,code=sm_90a"]
        assert {"-std=c++17", "-O3", "-shared", "-fPIC"} <= set(cmd)
        assert not any(arg.startswith("-D") for arg in cmd)  # the shipped variant
        assert Path(cmd[-1]) == cuda_build.CSRC / f"{name}.cu"
        out = Path(cmd[cmd.index("-o") + 1])
        assert out.parent == target and out.name.startswith(cuda_build.library_name(name))
        assert (target / cuda_build.library_name(name)).exists()
        assert (target / f"{name}.ptxas.txt").read_text() == "ptxas info: stub"
    (cxx,) = compilers.cxx()
    assert cxx[2] == "-march=native"
    assert [Path(s) for s in cxx[-3:]] == native.SOURCES
    assert (target / host_build.library_name(native.NAME, native.SOURCES)).exists()
    assert sorted(lib["library"] for lib in result["libraries"]) == sorted(kernels + [native.NAME])
    assert all(lib["built"] for lib in result["libraries"])
    # a second prebuild keeps what is there
    again = compile_cache.prebuild()
    assert len(compilers.calls) == 3
    assert not any(lib["built"] for lib in again["libraries"])


def test_prebuild_cli_prints_one_json_line(tmp_path, compilers, capsys, monkeypatch, package_build):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "cache"))
    assert compile_cache.main(["--prebuild"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["dir"] == str(tmp_path / "cache")
    assert sorted(lib["kind"] for lib in line["libraries"]) == ["cuda", "cuda", "host"]
    # built into the cache directory, as the lookup order builds
    assert all(Path(lib["path"]).parent == tmp_path / "cache" for lib in line["libraries"])
    assert compile_cache.main([]) == 2


def test_prebuild_keeps_a_library_the_package_build_has(tmp_path, compilers, monkeypatch, package_build):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "cache"))
    name = cuda_build.library_name("segment_stats")
    (package_build / name).write_bytes(b"prebuilt")
    result = compile_cache.prebuild()
    (kernel,) = [lib for lib in result["libraries"] if lib["library"] == "segment_stats"]
    assert kernel == {**kernel, "path": str(package_build / name), "built": False}
    assert len(compilers.nvcc()) == 1 and len(compilers.cxx()) == 1


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    monkeypatch.setattr(
        cuda_build.subprocess, "run", lambda cmd, **kw: subprocess.CompletedProcess(cmd, 2, "", "error: stub")
    )
    with pytest.raises(RuntimeError, match="nvcc failed for segment_stats.cu"):
        cuda_build.ensure("segment_stats")
    assert list(tmp_path.iterdir()) == []


def test_cuda_build_load_records_the_build_and_the_load(tmp_path, compilers, monkeypatch):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: ("lib", path))
    mark = compile_cache.snapshot()
    assert cuda_build.load("segment_stats") == ("lib", str(tmp_path / cuda_build.library_name("segment_stats")))
    cuda_build.load("segment_stats")  # loaded once a process
    (entry,) = compile_cache.loads(mark)
    assert entry["library"] == "segment_stats" and entry["kind"] == "cuda"
    assert entry["built"] is True and entry["buildMs"] >= 0 and entry["loadMs"] >= 0
    assert compile_cache.loads()[-1] == entry


@pytest.mark.parametrize(
    "module",
    [
        "kmamiz_tpu_torch.core.compile_cache",
        "kmamiz_tpu_torch.core.prewarm",
        "kmamiz_tpu_torch.ops.cuda_build",
        "kmamiz_tpu_torch.ops.host_build",
        "kmamiz_tpu_torch.native",
        "kmamiz_tpu_torch.tools.warm_boot_probe",
    ],
)
def test_each_module_imports_first_in_a_fresh_process(module):
    """The build modules, the telemetry package and the native library
    import one another: each must import first in a process (chip_smoke
    imports ops.cuda_build first, the image's build step the cache)."""
    proc = subprocess.run(
        [sys.executable, "-c", f"import {module}"],
        cwd=Path(__file__).resolve().parent.parent,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
