"""The port stands alone: no module of kmamiz_tpu_torch imports jax or the
kmamiz_tpu package, its native host library is its own build, and its
entry points refuse to run on a CUDA device that is not there instead of
dropping to the CPU."""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["kmamiz_tpu"] = None   # and so does any `import kmamiz_tpu...`
import kmamiz_tpu_torch
names = ["kmamiz_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(kmamiz_tpu_torch.__path__, "kmamiz_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
leaked = sorted(
    m for m, mod in sys.modules.items()
    if mod is not None and (m == "jax" or m.startswith(("jax.", "kmamiz_tpu.")))
)
assert not leaked, leaked
# the native host library the port loads is its own build, never the JAX
# package's native/build/
from kmamiz_tpu_torch import native
native.available()
maps = open("/proc/self/maps").read()
assert str(native.library_path()) in maps
assert "/native/build/" not in maps
print(" ".join(names))
"""


def test_every_module_imports_without_jax_or_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 140
    assert {
        "kmamiz_tpu_torch.native",
        "kmamiz_tpu_torch.ops.host_build",
        "kmamiz_tpu_torch.core.wire",
        "kmamiz_tpu_torch.ops.double_buffer",
        "kmamiz_tpu_torch.ingestion",
        "kmamiz_tpu_torch.ingestion.zipkin",
        "kmamiz_tpu_torch.tenancy.arena",
        "kmamiz_tpu_torch.tenancy.batch",
        "kmamiz_tpu_torch.tenancy.isolation",
        "kmamiz_tpu_torch.tenancy.router",
        "kmamiz_tpu_torch.control.admission",
        "kmamiz_tpu_torch.control.policy",
        "kmamiz_tpu_torch.control.warmup",
        "kmamiz_tpu_torch.scenarios.topology",
        "kmamiz_tpu_torch.scenarios.traffic",
        "kmamiz_tpu_torch.scenarios.storyline",
        "kmamiz_tpu_torch.scenarios.factory",
        "kmamiz_tpu_torch.scenarios.labeled",
        "kmamiz_tpu_torch.scenarios.runner",
    } <= set(names)


def test_no_source_mentions_an_import_of_the_reference():
    pattern = (
        "import jax",
        "from jax",
        "import kmamiz_tpu\n",
        "from kmamiz_tpu ",
        "from kmamiz_tpu.",
    )
    for path in (REPO / "kmamiz_tpu_torch").rglob("*.py"):
        text = path.read_text()
        for p in pattern:
            assert p not in text, f"{path.relative_to(REPO)}: {p!r}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    from kmamiz_tpu_torch.graph.convert import graph_from_export
    from kmamiz_tpu_torch.graph.store import EndpointGraph
    from kmamiz_tpu_torch.server.processor import DataProcessor

    with pytest.raises(RuntimeError, match="CUDA"):
        DataProcessor(trace_source=lambda lb, t, lim: [])
    with pytest.raises(RuntimeError, match="CUDA"):
        EndpointGraph()
    with pytest.raises(RuntimeError, match="CUDA"):
        graph_from_export({"names": [], "src": [], "dst": [], "dist": []})
    # asking for the CPU is the only way onto it
    assert DataProcessor(trace_source=lambda lb, t, lim: [], device="cpu").device.type == "cpu"


def test_processor_refuses_a_cluster_source():
    """A cluster source is accepted when it can answer the tick's cluster
    fetch, and refused when it cannot."""
    from kmamiz_tpu_torch.ingestion import KubernetesClient
    from kmamiz_tpu_torch.server.processor import DataProcessor

    with pytest.raises(TypeError, match="get_replicas_and_joinable_logs"):
        DataProcessor(lambda lb, t, lim: [], k8s_source=object(), device="cpu")
    client = KubernetesClient("http://127.0.0.1:9")
    assert DataProcessor(lambda lb, t, lim: [], k8s_source=client, device="cpu")._k8s is client


def test_training_entry_points_raise_without_a_card(no_card):
    import numpy as np

    from kmamiz_tpu_torch.models import stacked, trainer
    from kmamiz_tpu_torch.models.stlgt.trainer import ContinualTrainer

    ds = trainer.GraphDataset(
        endpoint_names=["a", "b"],
        src=np.zeros(1, dtype=np.int32),
        dst=np.ones(1, dtype=np.int32),
        edge_mask=np.ones(1, dtype=bool),
        features=[np.ones((2, 10), dtype=np.float32)],
        target_latency=[np.zeros(2, dtype=np.float32)],
        target_anomaly=[np.zeros(2, dtype=np.float32)],
        node_mask=[np.ones(2, dtype=bool)],
        slot_keys=["0-0-0"],
    )
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.train(ds, epochs=1, hidden=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        stacked.stack_dataset(ds)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinualTrainer()
    assert ContinualTrainer(device="cpu").device.type == "cpu"
