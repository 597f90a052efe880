"""The port's image and manifest (Dockerfile.torch,
deploy/kmamiz-tpu-torch.yaml), checked for structure on the CPU: every
COPY source exists, the CMD module and the prebuild module import, the pod
asks for one GPU, and every env key is one the port reads or one of the
global env ConfigMap's keys.
"""
from __future__ import annotations

import importlib
import json
import re
import shlex
from pathlib import Path

import pytest
import yaml

REPO = Path(__file__).resolve().parent.parent
DOCKERFILE = REPO / "Dockerfile.torch"
MANIFEST = REPO / "deploy" / "kmamiz-tpu-torch.yaml"
GLOBAL_ENV = REPO / "deploy" / "kmamiz-tpu-global-env.yaml"
PACKAGE = REPO / "kmamiz_tpu_torch"


def _instructions():
    """(instruction, argument text) of each Dockerfile line, continuations
    joined and comments dropped."""
    text = re.sub(r"\\\n", " ", DOCKERFILE.read_text())
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            word, _, rest = line.partition(" ")
            yield word.upper(), rest.strip()


def _documents():
    return [d for d in yaml.safe_load_all(MANIFEST.read_text()) if d]


def _container():
    (deployment,) = [d for d in _documents() if d["kind"] == "Deployment"]
    (container,) = deployment["spec"]["template"]["spec"]["containers"]
    return deployment, container


def test_every_copy_source_exists():
    copies = [shlex.split(rest) for word, rest in _instructions() if word == "COPY"]
    assert copies
    for args in copies:
        for source in args[:-1]:
            assert (REPO / source).exists(), source
    sources = {s.rstrip("/") for args in copies for s in args[:-1]}
    assert {"kmamiz_tpu_torch", "envoy", "dist", "tools/wasm_asm.py", "tools/build_wasm_filter.py"} <= sources
    assert not any(s.startswith("kmamiz_tpu/") or s == "kmamiz_tpu" for s in sources)


def test_the_image_prebuilds_and_runs_the_port():
    instructions = list(_instructions())
    base = [rest for word, rest in instructions if word == "FROM"]
    assert base == ["nvidia/cuda:12.8.1-devel-ubuntu24.04"]
    runs = " ".join(rest for word, rest in instructions if word == "RUN")
    assert "python -m kmamiz_tpu_torch.core.compile_cache --prebuild" in runs
    assert "python3.12" in runs and "g++" in runs and "whl/cu128" in DOCKERFILE.read_text()
    (cmd,) = [json.loads(rest) for word, rest in instructions if word == "CMD"]
    assert cmd == ["python", "-m", "kmamiz_tpu_torch.api.app"]
    # the CMD module and the prebuild module import
    app = importlib.import_module(cmd[2])
    assert callable(app.main)
    cache = importlib.import_module("kmamiz_tpu_torch.core.compile_cache")
    assert callable(cache.main)


def test_the_pod_asks_for_one_gpu_and_keeps_the_build_cache_on_its_volume():
    deployment, container = _container()
    assert container["resources"]["limits"]["nvidia.com/gpu"] == 1
    env = {e["name"]: e["value"] for e in container["env"]}
    mounts = {m["name"]: m["mountPath"] for m in container["volumeMounts"]}
    assert env["KMAMIZ_COMPILE_CACHE_DIR"].startswith(mounts["data"] + "/")
    assert "data" in {v["name"] for v in deployment["spec"]["template"]["spec"]["volumes"]}
    assert env["KMAMIZ_PREWARM"] not in ("0", "sync")  # background behind the gate
    probe = container["readinessProbe"]
    assert probe["httpGet"] == {"path": "/api/v1/health", "port": 3000}
    assert probe["periodSeconds"] * probe["failureThreshold"] >= 120


def _port_reads(name: str) -> bool:
    """Whether a module of the port names the variable in a string."""
    return any(f'"{name}"' in p.read_text() for p in PACKAGE.rglob("*.py"))


def test_every_env_key_is_read_by_the_port_or_global():
    _, container = _container()
    (config_map,) = [
        d for d in yaml.safe_load_all(GLOBAL_ENV.read_text()) if d and d["kind"] == "ConfigMap"
    ]
    assert [r["configMapRef"]["name"] for r in container["envFrom"]] == [config_map["metadata"]["name"]]
    global_keys = set(config_map["data"])
    image_env = " ".join(rest for word, rest in _instructions() if word == "ENV")
    keys = [e["name"] for e in container["env"]] + re.findall(r"([A-Z_]+)=", image_env)
    assert keys
    for key in keys:
        assert key in global_keys or key in ("PATH", "CUDA_HOME", "PYTHONPATH") or _port_reads(key), key


@pytest.mark.parametrize("key", ["KMAMIZ_COMPILE_CACHE_DIR", "KMAMIZ_PREWARM", "KMAMIZ_PREWARM_READY_GATE"])
def test_the_restart_keys_are_the_port_modules(key):
    assert _port_reads(key)
