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
sys.modules["bench"] = None        # nor the repo's bench.py
sys.modules["tools"] = None        # nor the JAX package's tools/
import kmamiz_tpu_torch
names = ["kmamiz_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(kmamiz_tpu_torch.__path__, "kmamiz_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
leaked = sorted(
    m for m, mod in sys.modules.items()
    if mod is not None and (m in ("jax", "bench", "tools") or m.startswith(("jax.", "kmamiz_tpu.", "tools.")))
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
    assert len(names) >= 162
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
        "kmamiz_tpu_torch.fleet",
        "kmamiz_tpu_torch.fleet.ring",
        "kmamiz_tpu_torch.fleet.worker",
        "kmamiz_tpu_torch.fleet.coordinator",
        "kmamiz_tpu_torch.fleet.migration",
        "kmamiz_tpu_torch.fleet.placement",
        "kmamiz_tpu_torch.fleet.soak",
        "kmamiz_tpu_torch.soak",
        "kmamiz_tpu_torch.soak.walreplay",
        "kmamiz_tpu_torch.soak.capture",
        "kmamiz_tpu_torch.telemetry.fleetscrape",
        "kmamiz_tpu_torch.cost",
        "kmamiz_tpu_torch.cost.scenario",
        "kmamiz_tpu_torch.soak.cells",
        "kmamiz_tpu_torch.soak.engine",
        "kmamiz_tpu_torch.soak.manifest",
        "kmamiz_tpu_torch.soak.triage",
        "kmamiz_tpu_torch.soak.worker",
        "kmamiz_tpu_torch.tools",
        "kmamiz_tpu_torch.tools.graftsoak",
        "kmamiz_tpu_torch.tools.scenario_soak",
        "kmamiz_tpu_torch.tools.graftprof",
        "kmamiz_tpu_torch.tools.eval_models",
        "kmamiz_tpu_torch.tools.eval_models_large",
        "kmamiz_tpu_torch.tools.eval_stlgt",
        "kmamiz_tpu_torch.tools.chaos_probe",
        "kmamiz_tpu_torch.tools.fleet_bench",
        "kmamiz_tpu_torch.tools.profile_parse",
        "kmamiz_tpu_torch.tools.warm_boot_probe",
        "kmamiz_tpu_torch.core.compile_cache",
        "kmamiz_tpu_torch.core.prewarm",
        "kmamiz_tpu_torch.analysis",
        "kmamiz_tpu_torch.analysis.framework",
        "kmamiz_tpu_torch.analysis.callgraph",
        "kmamiz_tpu_torch.analysis.rules",
        "kmamiz_tpu_torch.analysis.guards",
        "kmamiz_tpu_torch.analysis.concurrency",
        "kmamiz_tpu_torch.analysis.concurrency.locks",
        "kmamiz_tpu_torch.analysis.concurrency.rules",
        "kmamiz_tpu_torch.analysis.concurrency.witness",
        "kmamiz_tpu_torch.tools.graftlint",
        "kmamiz_tpu_torch.tools.graftrace",
        "kmamiz_tpu_torch.parallel",
        "kmamiz_tpu_torch.parallel.mesh",
    } <= set(names)


_IMPORT_LINT = """
import sys
sys.modules["torch"] = None        # linting needs no torch (and no card)
sys.modules["jax"] = None
sys.modules["kmamiz_tpu"] = None
import kmamiz_tpu_torch.analysis.concurrency.witness
import kmamiz_tpu_torch.tools.graftlint
import kmamiz_tpu_torch.tools.graftrace
from kmamiz_tpu_torch.analysis import framework
framework.all_rules()
leaked = sorted(
    m for m, mod in sys.modules.items()
    if mod is not None and (m in ("torch", "jax") or m.startswith(("torch.", "jax.", "kmamiz_tpu.")))
)
assert not leaked, leaked
"""


def test_lint_tools_and_witness_import_neither_torch_nor_the_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_LINT],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr


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


def test_fleet_and_runner_entry_points_raise_without_a_card(no_card, tmp_path):
    from kmamiz_tpu_torch.fleet import worker
    from kmamiz_tpu_torch.scenarios import build_scenario, run_counterfactual, run_scenario

    with pytest.raises(RuntimeError, match="CUDA"):
        worker.FleetWorker("w0", wal_root=str(tmp_path)).processor("alpha")
    with pytest.raises(RuntimeError, match="CUDA"):
        worker.main(["--worker-id", "w0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario(build_scenario("steady-chain", 0, 0, 2), tmpdir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_counterfactual(n_ticks=2)
    assert worker.FleetWorker("w0", device="cpu").processor("alpha").device.type == "cpu"
