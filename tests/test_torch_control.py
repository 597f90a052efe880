"""The port's control plane against kmamiz_tpu/control/ on the CPU.

The cases of tests/test_control.py that need no scenario runner:

- the admission core: decision traces equal to the JAX package's (in
  process, and in a fresh interpreter that loads the port's admission.py
  by path), hysteresis, mode normalisation;
- breaker warm-up: the unit semantics and the controller-driven warm ->
  revert cycle, with the same verdicts as the JAX controller;
- the scheduling policy and the cost table;
- the serving edge over a real DataProcessorServer of each package, the
  same request sequence: two-tenant defer and recovery, high priority,
  shed (429), /timings, the switch off;
- the horizon clamp, `view_from_forecast` on the same arrays, and
  `on_fold` over a seeded STLGT head, the controller's decisions equal
  to the JAX controller's (p99 within the STLGT forward's rtol 1e-5).

The JAX package reads the SLO, hysteresis and probe values from
KMAMIZ_CONTROL_*; the port takes them through `control.configure`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from kmamiz_tpu import control as jax_control
from kmamiz_tpu.control import admission as jax_admission
from kmamiz_tpu.control import policy as jax_policy
from kmamiz_tpu.control import warmup as jax_warmup
from kmamiz_tpu_torch import control, telemetry, tenancy
from kmamiz_tpu_torch.control import admission, policy, warmup
from kmamiz_tpu_torch.resilience import breaker as breaker_mod
from kmamiz_tpu_torch.resilience import metrics, quarantine

from conftest import prefixed_trace_source

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = dict(slo_ms=250.0, hysteresis=2, mode="defer")
SEQ = [100.0, 300.0, 260.0, 251.0, 240.0, 500.0, 100.0, 90.0, 80.0, 400.0]


@pytest.fixture(autouse=True)
def _port_state(monkeypatch, tmp_path):
    monkeypatch.setenv("KMAMIZ_SEGMENT_BACKEND", "pallas_interpret")
    monkeypatch.setenv("KMAMIZ_PROF_FLIGHT_DIR", str(tmp_path / "flight"))
    mods = (telemetry, tenancy, breaker_mod, metrics, quarantine, control)
    for mod in mods:
        mod.reset_for_tests()
    yield
    for mod in mods:
        mod.reset_for_tests()


# -- the admission core -----------------------------------------------------------


class TestAdmissionCore:
    @pytest.mark.parametrize(
        "seq, cfg",
        [
            (SEQ, CFG),
            (SEQ, dict(slo_ms=250.0, hysteresis=1, mode="shed")),
            ([300.0 if i % 2 == 0 else 100.0 for i in range(40)], CFG),
            ([300.0, 300.0, 300.0, 100.0, 100.0, 100.0], CFG),
            ([50.0], dict(slo_ms=10.0, hysteresis=0, mode="wat")),
        ],
    )
    def test_decision_trace_equals_jax(self, seq, cfg):
        got = admission.decision_trace(seq, admission.AdmissionConfig(**cfg))
        want = jax_admission.decision_trace(seq, jax_admission.AdmissionConfig(**cfg))
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)

    def test_decision_trace_deterministic_across_processes(self):
        """A fresh interpreter loading the port's admission.py by path
        emits the JAX package's trace, bit for bit."""
        child_src = (
            "import importlib.util, json, sys\n"
            "spec = importlib.util.spec_from_file_location('adm', sys.argv[1])\n"
            "adm = importlib.util.module_from_spec(spec)\n"
            "sys.modules['adm'] = adm\n"
            "spec.loader.exec_module(adm)\n"
            f"cfg = adm.AdmissionConfig(**{CFG!r})\n"
            f"print(json.dumps(adm.decision_trace({SEQ!r}, cfg), sort_keys=True))\n"
        )
        out = subprocess.run(
            [sys.executable, "-c", child_src, os.path.join(REPO_ROOT, "kmamiz_tpu_torch", "control", "admission.py")],
            capture_output=True,
            text=True,
            timeout=60,
        )
        assert out.returncode == 0, out.stderr
        want = json.dumps(jax_admission.decision_trace(SEQ, jax_admission.AdmissionConfig(**CFG)), sort_keys=True)
        assert out.stdout.strip() == want

    def test_hysteresis_enter_and_leave_streaks(self):
        trace = admission.decision_trace([300.0, 300.0, 300.0, 100.0, 100.0, 100.0], admission.AdmissionConfig(**CFG))
        assert [d["active"] for d in trace] == [False, True, True, True, False, False]
        assert trace[-1]["transitions"] == 2 and trace[1]["action"] == admission.DEFER


# -- breaker warm-up -------------------------------------------------------------------


class TestWarmup:
    def test_evaluate_equals_jax(self):
        attrs = [("a", "b", 0.6), ("c", "d", 0.9), ("e", "f", 0.2)]
        for gate in (0.5, 0.95):
            got = warmup.evaluate(attrs, warmup.WarmupConfig(gate_threshold=gate, probe_cooldown_s=0.1))
            want = jax_warmup.evaluate(attrs, jax_warmup.WarmupConfig(gate_threshold=gate, probe_cooldown_s=0.1))
            assert (got.warm, got.mass, got.blamed) == (want.warm, want.mass, want.blamed)

    def test_breaker_warm_up_and_revert_unit(self):
        brk = breaker_mod.get_breaker("ctl-warm-unit", threshold=5, cooldown_s=30.0)
        assert brk.warm_up(0.05) is True
        snap = brk.snapshot()
        assert snap["state"] == "half-open" and snap["warmed"] and snap["warmUps"] == 1
        assert brk.cooldown_s == pytest.approx(0.05)
        assert brk.warm_up(0.05) is False
        brk.revert_warm_up()
        snap = brk.snapshot()
        assert snap["state"] == "closed" and not snap["warmed"]
        assert brk.cooldown_s == pytest.approx(30.0)

    def test_warmed_breaker_trips_on_single_failure(self):
        brk = breaker_mod.get_breaker("ctl-warm-trip", threshold=5, cooldown_s=30.0)
        brk.warm_up(5.0)

        def boom():
            raise ConnectionError("x")

        with pytest.raises(ConnectionError):
            brk.call(boom)
        assert brk.snapshot()["state"] == "open"

    def test_controller_drives_warm_then_auto_revert(self, monkeypatch):
        from kmamiz_tpu.resilience import breaker as jax_breaker

        monkeypatch.setenv("KMAMIZ_CONTROL", "1")
        monkeypatch.setenv("KMAMIZ_CONTROL_PROBE_S", "0.05")
        control.configure(probe_s=0.05)
        brk = breaker_mod.get_breaker("upstream", tenant="t1", threshold=5, cooldown_s=30.0)
        jax_breaker.get_breaker("upstream", tenant="t1", threshold=5, cooldown_s=30.0)
        views = [
            dict(tenant="t1", p99_ms=10.0, cost_ms=10.0, attributions=(("svc-a", "svc-b", 0.9),)),
            dict(tenant="t1", p99_ms=10.0, cost_ms=10.0),
        ]
        got = [control.ingest_forecast(control.ForecastView(**v)) for v in views[:1]]
        assert got[0]["warmed"] == ["t1:upstream"] and brk.snapshot()["warmed"]
        got.append(control.ingest_forecast(control.ForecastView(**views[1])))
        want = [jax_control.ingest_forecast(jax_control.ForecastView(**v)) for v in views]
        assert got == want
        snap = brk.snapshot()
        assert not snap["warmed"] and snap["state"] == "closed" and brk.cooldown_s == pytest.approx(30.0)


# -- the scheduling policy ----------------------------------------------------------------


class TestPolicy:
    def test_order_batch_equals_jax(self):
        items = [("b", 0), ("a", 1), ("c", 2), ("a", 3)]
        costs = {"a": 5.0, "b": 50.0}
        got = policy.order_batch(items, costs, lambda it: it[0])
        assert got == jax_policy.order_batch(items, costs, lambda it: it[0])
        assert got == [("c", 2), ("a", 1), ("a", 3), ("b", 0)] and items[0] == ("b", 0)
        assert policy.predicted_cost_ms([1.5, 2.25]) == jax_policy.predicted_cost_ms([1.5, 2.25])

    def test_controller_publishes_cost_table(self, monkeypatch):
        monkeypatch.setenv("KMAMIZ_CONTROL", "1")
        assert control.predicted_costs() == {}
        control.ingest_forecast(control.ForecastView(tenant="a", p99_ms=1.0, cost_ms=42.5))
        assert control.predicted_costs() == {"a": 42.5}

    def test_tenant_slo_override(self, monkeypatch):
        """The JAX package's KMAMIZ_CONTROL_SLO_MS_<TENANT> is the
        controller's tenant_slo_ms here."""
        monkeypatch.setenv("KMAMIZ_CONTROL_SLO_MS", "100")
        monkeypatch.setenv("KMAMIZ_CONTROL_SLO_MS_GOLD", "7")
        control.configure(slo_ms=100.0, tenant_slo_ms={"gold": 7.0})
        assert control.slo_ms("gold") == jax_control.slo_ms("gold") == 7.0
        assert control.slo_ms("other") == jax_control.slo_ms("other") == 100.0


# -- the serving edge, both packages -------------------------------------------------------


def _post(base, unique_id, path="", extra=None):
    body = {"uniqueId": unique_id, "lookBack": 30_000, "time": int(time.time() * 1000), **(extra or {})}
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), resp.headers.get("X-KMamiz-Control")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("X-KMamiz-Control")


def _outcome(status, body, header):
    """What a tick's answer says about admission, without its payload."""
    return (status, bool(body.get("deferred")), (body.get("control") or {}).get("action"), header, bool(body.get("stale")))


@pytest.fixture
def servers(pdas_traces):
    """A JAX and a port DataProcessorServer over the same fixture ticks."""
    from kmamiz_tpu.server.dp_server import DataProcessorServer as JaxServer
    from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor
    from kmamiz_tpu_torch.server.dp_server import DataProcessorServer
    from kmamiz_tpu_torch.server.processor import DataProcessor

    jax_srv = JaxServer(
        JaxProcessor(trace_source=prefixed_trace_source(pdas_traces, "jctl"), use_device_stats=False),
        host="127.0.0.1",
        port=0,
    )
    port_srv = DataProcessorServer(
        DataProcessor(trace_source=prefixed_trace_source(pdas_traces, "pctl"), device="cpu", use_device_stats=False),
        host="127.0.0.1",
        port=0,
    )
    for srv in (jax_srv, port_srv):
        srv.start()
    yield {
        "jax": (f"http://127.0.0.1:{jax_srv.port}", jax_control),
        "port": (f"http://127.0.0.1:{port_srv.port}", control),
    }
    for srv in (jax_srv, port_srv):
        srv.stop()


@pytest.fixture
def control_env(monkeypatch):
    monkeypatch.setenv("KMAMIZ_CONTROL", "1")
    monkeypatch.setenv("KMAMIZ_CONTROL_SLO_MS", "5")
    monkeypatch.setenv("KMAMIZ_CONTROL_HYSTERESIS", "1")
    monkeypatch.setenv("KMAMIZ_CONTROL_MODE", "defer")
    control.configure(slo_ms=5.0, hysteresis=1)


def _breach(ctl, tenant):
    return ctl.ingest_forecast(ctl.ForecastView(tenant=tenant, p99_ms=50.0, cost_ms=100.0))


def _clear(ctl, tenant):
    return ctl.ingest_forecast(ctl.ForecastView(tenant=tenant, p99_ms=1.0, cost_ms=2.0))


class TestAdmissionHTTP:
    def _defer_and_recover(self, base, ctl):
        out = [_outcome(*_post(base, "a1", "/t/alpha/")), _outcome(*_post(base, "b1", "/t/beta/"))]
        _breach(ctl, "alpha")
        status, body, header = _post(base, "a2", "/t/alpha/")
        out.append(_outcome(status, body, header))
        assert "deferredAgeMs" in body and not body.get("stale")
        out.append(_outcome(*_post(base, "b2", "/t/beta/")))
        out.append(_outcome(*_post(base, "a3", "/t/alpha/", {"priority": "high"})))
        _clear(ctl, "alpha")
        out.append(_outcome(*_post(base, "a4", "/t/alpha/")))
        return out

    def test_two_tenant_isolation_defer_and_recovery(self, servers, control_env):
        got = self._defer_and_recover(*servers["port"])
        assert got == self._defer_and_recover(*servers["jax"])
        fresh = (200, False, None, None, False)
        assert got == [fresh, fresh, (200, True, "defer", "defer", False), fresh, fresh, fresh]

    def test_shed_mode_returns_429(self, servers, control_env, monkeypatch):
        outcomes = {}
        for name, (base, ctl) in servers.items():
            assert _post(base, "s1", "/t/alpha/")[0] == 200
            monkeypatch.setenv("KMAMIZ_CONTROL_MODE", "shed")
            _breach(ctl, "alpha")
            status, body, header = _post(base, "s2", "/t/alpha/")
            assert "shed" in body["error"]
            outcomes[name] = _outcome(status, body, header)
            monkeypatch.setenv("KMAMIZ_CONTROL_MODE", "defer")
        assert outcomes["port"] == outcomes["jax"] == (429, False, "shed", "shed", False)

    def test_timings_exposes_control_snapshot(self, servers, control_env):
        base, ctl = servers["port"]
        _post(base, "t1", "/t/alpha/")
        _breach(ctl, "alpha")
        with urllib.request.urlopen(base + "/timings", timeout=60) as resp:
            ctl_snap = json.loads(resp.read())["control"]
        assert ctl_snap["enabled"] is True and ctl_snap["tenants"]["alpha"]["active"] is True
        j_base, j_ctl = servers["jax"]
        _breach(j_ctl, "alpha")
        with urllib.request.urlopen(j_base + "/timings", timeout=60) as resp:
            j_snap = json.loads(resp.read())["control"]
        assert ctl_snap == j_snap

    def test_disabled_control_never_defers(self, servers, monkeypatch):
        monkeypatch.setenv("KMAMIZ_CONTROL", "0")
        control.configure(slo_ms=5.0)
        base, ctl = servers["port"]
        _post(base, "d1", "/t/alpha/")
        _breach(ctl, "alpha")
        status, body, _ = _post(base, "d2", "/t/alpha/")
        assert status == 200 and "deferred" not in body

    def test_metrics_count_admission(self, servers, control_env):
        base, ctl = servers["port"]
        _post(base, "m1", "/t/alpha/")
        _breach(ctl, "alpha")
        _post(base, "m2", "/t/alpha/")
        text = urllib.request.urlopen(base + "/metrics", timeout=30).read().decode()
        assert 'kmamiz_control_admission_total{action="defer"} 1' in text
        assert "kmamiz_control_shedding_tenants 1" in text


# -- the horizon, the forecast view and the fold hook -----------------------------------------


class TestForecastView:
    def test_horizon_clamp(self, monkeypatch):
        monkeypatch.setenv("KMAMIZ_STLGT_HORIZON_MAX", "5")
        monkeypatch.setenv("KMAMIZ_CONTROL_HORIZON", "9")
        control.configure(horizon=9)
        assert control.control_horizon() == jax_control.control_horizon() == 5
        monkeypatch.setenv("KMAMIZ_CONTROL_HORIZON", "3")
        control.configure(horizon=3)
        assert control.control_horizon() == jax_control.control_horizon() == 3

    @pytest.mark.parametrize("horizon", [1, 4])
    def test_view_from_forecast_equals_jax(self, horizon):
        rng = np.random.default_rng(horizon)
        n, e = 12, 40
        q = np.sort(rng.random((n, 3)).astype(np.float32) * 300.0, axis=1)
        gate = rng.random(e).astype(np.float32)
        snap = {
            "names": [f"svc{i}\tns\tv1\tGET\t/api/{i}" for i in range(n)],
            "src": rng.integers(0, n + 2, e).astype(np.int32),
            "dst": rng.integers(0, n, e).astype(np.int32),
            "mask": rng.random(e) < 0.8,
        }
        got = control.view_from_forecast("t", q, gate, snap, version=4, horizon=horizon)
        want = jax_control.view_from_forecast("t", q, gate, snap, version=4, horizon=horizon)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)

    def test_on_fold_with_a_seeded_stlgt(self, pdas_traces, monkeypatch):
        """Both processors fold an hour with the same STLGT params live:
        each controller decides from its own forward. Same action; p99
        and cost within the STLGT forward's rtol 1e-5."""
        import jax
        from kmamiz_tpu.models import stlgt as jax_stlgt_pkg
        from kmamiz_tpu.models.stlgt import model as jax_stlgt
        from kmamiz_tpu_torch.models import checkpoint
        from kmamiz_tpu_torch.models import stlgt as stlgt_pkg
        from kmamiz_tpu_torch.models.stlgt import model as stlgt
        from test_torch_forecast import _pair

        jp = jax_stlgt.init_params(jax.random.PRNGKey(11), hidden=32, num_features=18)
        params = checkpoint.params_from_numpy(
            stlgt, {k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu"
        )
        monkeypatch.setattr(jax_stlgt_pkg, "serving_params", lambda: {"params": jp, "version": 3, "model": jax_stlgt})
        monkeypatch.setattr(stlgt_pkg, "serving_params", lambda: {"params": params, "version": 3, "model": stlgt})
        monkeypatch.setenv("KMAMIZ_CONTROL", "1")
        monkeypatch.setenv("KMAMIZ_CONTROL_HYSTERESIS", "1")
        control.configure(hysteresis=1)
        decided = []
        real = control.ingest_forecast
        monkeypatch.setattr(control, "ingest_forecast", lambda view: decided.append(view) or real(view))
        jax_dp, port_dp = _pair(pdas_traces, [910, 911])
        assert port_dp.fold_errors == {"stlgtFoldErrors": 0, "controlFoldErrors": 0}
        got = control.snapshot()["tenants"]["default"]
        want = jax_control.snapshot()["tenants"]["default"]
        assert got["action"] == want["action"] and got["active"] == want["active"]
        assert got["forecast_p99_ms"] == pytest.approx(want["forecast_p99_ms"], rel=1e-5, abs=1e-5)
        assert got["predictedCostMs"] == pytest.approx(want["predictedCostMs"], rel=1e-5, abs=1e-3)
        view = decided[-1]
        assert view.version == 3 and {(s, d) for s, d, _ in view.attributions}
        # a second controller with the SLO under the forecast: defer
        control.reset_for_tests()
        control.configure(hysteresis=1, tenant_slo_ms={"default": view.p99_ms / 2})
        assert real(view)["action"] == "defer"


class TestControlTickContract:
    def test_admission_read_is_cheap(self, monkeypatch):
        monkeypatch.setenv("KMAMIZ_CONTROL", "1")
        control.configure(slo_ms=5.0)
        control.ingest_forecast(control.ForecastView(tenant="bench", p99_ms=50.0, cost_ms=10.0))
        request = {"uniqueId": "x", "lookBack": 30_000}
        control.admission_verdict("bench", request)
        reads = 2_000
        t0 = time.perf_counter()
        for _ in range(reads):
            control.admission_verdict("bench", request)
        mean_ms = (time.perf_counter() - t0) * 1000 / reads
        assert mean_ms < 0.2, f"admission read {mean_ms:.4f} ms/call"
