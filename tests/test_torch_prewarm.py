"""The port's boot prewarm and readiness gate (kmamiz_tpu_torch/core/prewarm.py)
against the JAX package's (kmamiz_tpu/core/programs.py), on the CPU:
KMAMIZ_PREWARM at 0, sync and background, the ready gate on and off, a
failed prewarm, the plan's steps, and the health route and the DP
server's GET / while warming and when ready, beside the JAX handlers'.
"""
from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from kmamiz_tpu_torch.core import compile_cache, prewarm


@pytest.fixture
def fresh(monkeypatch):
    """Both packages' warm states isolated from other tests; the JAX
    plan stubbed (its real one compiles XLA programs)."""
    from kmamiz_tpu.core import programs

    monkeypatch.setattr(programs, "_warm", {"status": "cold"})
    monkeypatch.setattr(programs, "_warm_thread", None)
    monkeypatch.setattr(prewarm, "_warm", {"status": "cold"})
    monkeypatch.setattr(prewarm, "_warm_thread", None)
    monkeypatch.delenv("KMAMIZ_PREWARM_READY_GATE", raising=False)
    return programs


class Gate:
    """A plan that blocks until released (or raises `error`)."""

    def __init__(self, error=None):
        self.started, self.release, self.error = threading.Event(), threading.Event(), error

    def __call__(self, *args, **kwargs):
        self.started.set()
        assert self.release.wait(30)
        if self.error is not None:
            raise self.error
        return {"stub": True}


def _both(fresh, monkeypatch, plan_jax, plan_port):
    monkeypatch.setattr(fresh, "run_prewarm", plan_jax)
    monkeypatch.setattr(prewarm, "run_prewarm", plan_port)


def test_disabled_as_jax(fresh, monkeypatch):
    _both(fresh, monkeypatch, Gate(), Gate())
    monkeypatch.setenv("KMAMIZ_PREWARM", "0")
    fresh.boot_prewarm_from_env()
    assert prewarm.boot_prewarm_from_env() is None
    assert prewarm.warm_state() == fresh.warm_state() == {"status": "disabled"}
    assert not prewarm.serving_blocked()


def test_sync_blocks_and_reports_ready_as_jax(fresh, monkeypatch):
    _both(fresh, monkeypatch, lambda **kw: {"stub": True}, lambda processor=None: {"stub": True})
    monkeypatch.setenv("KMAMIZ_PREWARM", "sync")
    fresh.boot_prewarm_from_env()
    assert prewarm.boot_prewarm_from_env() is None
    for state in (prewarm.warm_state(), fresh.warm_state()):
        assert state["status"] == "ready" and state["report"] == {"stub": True}
    assert set(prewarm.warm_state()) == set(fresh.warm_state())


@pytest.mark.parametrize("gate", ["1", "0"])
def test_background_warms_then_is_ready_as_jax(fresh, monkeypatch, gate):
    jax_plan, port_plan = Gate(), Gate()
    _both(fresh, monkeypatch, jax_plan, port_plan)
    monkeypatch.delenv("KMAMIZ_PREWARM", raising=False)  # the default: background
    monkeypatch.setenv("KMAMIZ_PREWARM_READY_GATE", gate)
    fresh.boot_prewarm_from_env()
    thread = prewarm.boot_prewarm_from_env()
    assert jax_plan.started.wait(30) and port_plan.started.wait(30)
    assert prewarm.warm_state()["status"] == fresh.warm_state()["status"] == "warming"
    assert fresh.is_warming()
    assert prewarm.ready_gate_enabled() is fresh.ready_gate_enabled() is (gate == "1")
    assert prewarm.serving_blocked() is (gate == "1")
    assert prewarm.start_background_prewarm() is thread  # no restart
    jax_plan.release.set()
    port_plan.release.set()
    thread.join(30)
    fresh._warm_thread.join(30)
    assert prewarm.warm_state()["status"] == fresh.warm_state()["status"] == "ready"
    assert prewarm.warm_state()["report"] == {"stub": True}
    assert not prewarm.serving_blocked()
    assert prewarm.start_background_prewarm() is thread


def test_a_failed_background_prewarm_reports_error_and_keeps_the_gate_shut(fresh, monkeypatch):
    jax_plan, port_plan = Gate(RuntimeError("nvcc failed")), Gate(RuntimeError("nvcc failed"))
    jax_plan.release.set()
    port_plan.release.set()
    _both(fresh, monkeypatch, jax_plan, port_plan)
    fresh.start_background_prewarm().join(30)
    prewarm.start_background_prewarm().join(30)
    for state in (prewarm.warm_state(), fresh.warm_state()):
        assert state["status"] == "error" and state["report"] == {"error": "nvcc failed"}
    # the deliberate difference: the port answers 503 on error, JAX 200
    assert prewarm.serving_blocked()
    monkeypatch.setenv("KMAMIZ_PREWARM_READY_GATE", "0")
    assert not prewarm.serving_blocked()


def test_the_plan_on_a_card_loads_every_library_then_warms_then_launches_kernel_2(monkeypatch):
    """The plan's steps in order, with the card's parts stubbed."""
    from kmamiz_tpu_torch import native
    from kmamiz_tpu_torch.ops import cuda_build

    steps = []
    lock = threading.Lock()

    def loaded(name, kind):
        def load(*args):
            with lock:
                steps.append(("load", name))
            compile_cache.record_load(name, kind, f"/x/lib{name}.so", True, 1.0, 0.5)

        return load

    monkeypatch.setattr(native, "available", loaded(native.NAME, "host"))
    monkeypatch.setattr(cuda_build, "load", lambda name: loaded(name, "cuda")())
    monkeypatch.setattr(prewarm, "_launch_kernel_2", lambda device: steps.append(("kernel 2", str(device))) or 6)

    class Processor:
        device = torch.device("cuda")

        def warm_up(self):
            steps.append(("warm_up",))

    report = prewarm.run_prewarm(Processor())
    loads = {s for s in steps[:3]}
    assert loads == {("load", "kmamiz_native"), ("load", "segment_stats"), ("load", "fused_sddmm_spmm")}
    assert steps[3:] == [("warm_up",), ("kernel 2", "cuda")]
    assert report["device"] == "cuda" and report["kernel2Launches"] == 6
    assert report["loadedInPlan"] == 3 and report["builtInPlan"] == 3
    for name in ("kmamiz_native", "segment_stats", "fused_sddmm_spmm"):
        lib = report["libraries"][name]
        assert lib["inPlan"] and lib["built"] and lib["buildMs"] == 1.0 and lib["loadMs"] == 0.5


def test_the_plan_on_the_cpu_loads_the_host_library_only(monkeypatch):
    from kmamiz_tpu_torch.ops import cuda_build
    from kmamiz_tpu_torch.server.processor import DataProcessor

    monkeypatch.setattr(cuda_build, "load", lambda name: pytest.fail("a kernel library on the CPU"))
    monkeypatch.setattr(prewarm, "_launch_kernel_2", lambda device: pytest.fail("kernel 2 on the CPU"))
    dp = DataProcessor(trace_source=lambda lb, t, lim: [], device="cpu", wal=None)
    report = prewarm.run_prewarm(dp)
    assert report["device"] == "cpu"
    assert "kmamiz_native" in report["libraries"]
    assert report["libraries"]["kmamiz_native"]["kind"] == "host"
    assert "kernel2Launches" not in report
    assert set(report["libraries"]) <= {"kmamiz_native", "segment_stats", "fused_sddmm_spmm"}


def test_the_plan_without_a_processor_loads_nothing():
    mark = compile_cache.snapshot()
    report = prewarm.run_prewarm(None)
    assert report["device"] is None and report["loadedInPlan"] == 0
    assert compile_cache.snapshot() == mark


# -- the health routes ----------------------------------------------------------


def _health(router_mod, handler_mod):
    router = router_mod.Router()
    router.add_handler(handler_mod.HealthHandler(None))
    resp = router.dispatch("GET", "/api/v1/health")
    return resp.status, resp.payload


def _get(port):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def dp_servers():
    """A JAX and a port DataProcessorServer on the CPU."""
    from kmamiz_tpu.server.dp_server import DataProcessorServer as JaxServer
    from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor
    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer
    from kmamiz_tpu_torch.server.processor import DataProcessor

    jax_srv = JaxServer(JaxProcessor(trace_source=lambda lb, t, lim: [], wal=None), host="127.0.0.1", port=0)
    port_srv = DataProcessorServer(
        DataProcessor(trace_source=lambda lb, t, lim: [], device="cpu", wal=None), host="127.0.0.1", port=0
    )
    for srv in (jax_srv, port_srv):
        srv.start()
    yield jax_srv.port, port_srv.port
    for srv in (jax_srv, port_srv):
        srv.stop()


def _set_state(fresh, state):
    fresh._warm.clear()
    fresh._warm.update(state)
    prewarm._warm.clear()
    prewarm._warm.update(state)


WARMING = {"status": "warming", "startedAt": 1.0}
READY = {"status": "ready", "report": {}}


def test_health_answers_as_jax_while_warming_and_when_ready(fresh, monkeypatch):
    from kmamiz_tpu.api import router as jax_router
    from kmamiz_tpu.api.handlers import health as jax_health
    from kmamiz_tpu_torch.api import router as port_router
    from kmamiz_tpu_torch.api.handlers import health as port_health

    for state, code in ((WARMING, 503), (READY, 200), ({"status": "cold"}, 200), ({"status": "disabled"}, 200)):
        _set_state(fresh, state)
        jax_status, jax_body = _health(jax_router, jax_health)
        status, body = _health(port_router, port_health)
        assert status == jax_status == code
        assert set(body) == set(jax_body)
        assert body["status"] == jax_body["status"] == ("WARMING" if code == 503 else "UP")
        assert body["prewarm"] == jax_body["prewarm"] == state
    # the gate off: 200 while warming, as JAX
    monkeypatch.setenv("KMAMIZ_PREWARM_READY_GATE", "0")
    _set_state(fresh, WARMING)
    assert _health(port_router, port_health)[0] == _health(jax_router, jax_health)[0] == 200


def test_health_answers_503_after_a_failed_prewarm_where_jax_answers_200(fresh):
    from kmamiz_tpu.api import router as jax_router
    from kmamiz_tpu.api.handlers import health as jax_health
    from kmamiz_tpu_torch.api import router as port_router
    from kmamiz_tpu_torch.api.handlers import health as port_health

    _set_state(fresh, {"status": "error", "report": {"error": "nvcc failed"}})
    assert _health(jax_router, jax_health)[0] == 200
    status, body = _health(port_router, port_health)
    assert status == 503 and body["status"] == "ERROR" and body["prewarm"]["report"]["error"] == "nvcc failed"


def test_dp_get_answers_as_jax_while_warming_and_when_ready(fresh, dp_servers, monkeypatch):
    jax_port, port = dp_servers
    _set_state(fresh, WARMING)
    (jax_status, jax_body), (status, body) = _get(jax_port), _get(port)
    assert status == jax_status == 503
    assert set(body) == set(jax_body) == {"status", "prewarm"}
    assert body["status"] == jax_body["status"] == "WARMING"
    assert body["prewarm"] == jax_body["prewarm"] == WARMING
    _set_state(fresh, READY)
    (jax_status, jax_body), (status, body) = _get(jax_port), _get(port)
    assert status == jax_status == 200
    assert set(jax_body) <= set(body)
    assert body["status"] == jax_body["status"] == "UP"
    assert body["prewarm"] == jax_body["prewarm"] == READY
    monkeypatch.setenv("KMAMIZ_PREWARM_READY_GATE", "0")
    _set_state(fresh, WARMING)
    assert _get(port)[0] == _get(jax_port)[0] == 200
    monkeypatch.delenv("KMAMIZ_PREWARM_READY_GATE")
    _set_state(fresh, {"status": "error", "report": {"error": "x"}})
    assert _get(jax_port)[0] == 200
    status, body = _get(port)
    assert status == 503 and body["status"] == "ERROR"


# -- build_server and build_production_context ------------------------------


def test_build_server_and_context_leave_the_warm_up_to_the_prewarm_when_asked(monkeypatch):
    from kmamiz_tpu_torch import native
    from kmamiz_tpu_torch.api import app
    from kmamiz_tpu_torch.config import Settings
    from kmamiz_tpu_torch.ingestion.kubernetes import KubernetesClient
    from kmamiz_tpu_torch.server import dp_server
    from kmamiz_tpu_torch.server.processor import DataProcessor

    calls = []
    monkeypatch.setattr(native, "available", lambda: calls.append("native") or True)
    monkeypatch.setattr(DataProcessor, "warm_up", lambda self: calls.append("warm_up"))
    monkeypatch.setattr(KubernetesClient, "warm_up", lambda self: calls.append("k8s"))
    monkeypatch.setenv("ZIPKIN_URL", "http://127.0.0.1:9")
    monkeypatch.setenv("KUBEAPI_HOST", "http://127.0.0.1:9")
    monkeypatch.setenv("DP_PORT", "0")
    monkeypatch.setenv("BIND_IP", "127.0.0.1")
    monkeypatch.delenv("KMAMIZ_WAL", raising=False)
    server, _ = dp_server.build_server(device="cpu", warm=False)
    server.stop()
    assert calls == ["k8s"]
    server, _ = dp_server.build_server(device="cpu")
    server.stop()
    assert calls == ["k8s", "native", "k8s", "warm_up"]
    calls.clear()
    s = Settings()
    s.zipkin_url = s.kube_api_host = "http://127.0.0.1:9"
    app.build_production_context(s, device="cpu", warm=False)
    assert calls == ["k8s"]
    app.build_production_context(s, device="cpu")
    assert calls == ["k8s", "native", "k8s", "warm_up"]
