"""The port's simulator against the JAX package's, both on the CPU.

The simulator is host numpy code that each package draws from an explicit
np.random.Generator: the same YAML and the same seeded generator must give
the same output, bit for bit (no float tolerance). The cases mirror
tests/test_simulator.py: the config manager on valid and malformed YAMLs
(the same parsed config, the same validation message), the body
preprocessor, the dependency builder, the propagator, faults and the
overload model, the load handler, the whole simulation on three meshes
(tests/test_simulator.py's LOAD_YAML, tests/test_trainer.py's FAULT_YAML
and a seeded 20-service mesh of tools/eval_models_large.py's generator),
and the static-config generator.

`train_on_simulation` (device="cpu") is held to the JAX function on
FAULT_YAML with both heads, from the same initial weights (JAX's, handed
to the port; GAT's perturbed as in tests/test_torch_gat.py), with
tests/test_torch_training.py's tolerances: losses rtol 1e-4 / atol 1e-5,
params rtol 1e-3 / atol 1e-5; the threshold and the evaluation metrics
equal.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kmamiz_tpu.models import gat as jax_gat
from kmamiz_tpu.models import graphsage as jax_sage
from kmamiz_tpu.models import trainer as jax_trainer
from kmamiz_tpu.simulator import bodies as jax_bodies
from kmamiz_tpu.simulator import config_generator as jax_config_generator
from kmamiz_tpu.simulator import dependency_builder as jax_dependency_builder
from kmamiz_tpu.simulator import faults as jax_faults
from kmamiz_tpu.simulator import load_handler as jax_load_handler
from kmamiz_tpu.simulator import naming as jax_naming
from kmamiz_tpu.simulator import overload as jax_overload
from kmamiz_tpu.simulator import propagator as jax_propagator
from kmamiz_tpu.simulator import slot_metrics as jax_slot_metrics
from kmamiz_tpu.simulator.config import SimulationConfigManager as JaxConfigManager
from kmamiz_tpu.simulator.simulator import Simulator as JaxSimulator
from kmamiz_tpu_torch.core import desensitize
from kmamiz_tpu_torch.models import checkpoint, gat, graphsage, trainer
from kmamiz_tpu_torch.simulator import (
    bodies,
    config_generator,
    dependency_builder,
    faults,
    load_handler,
    naming,
    overload,
    propagator,
    slot_metrics,
)
from kmamiz_tpu_torch.simulator.config import SimulationConfigManager
from kmamiz_tpu_torch.simulator.simulator import Simulator
from test_simulator import BASIC_YAML, LOAD_YAML
from test_torch_cuda import FAULT_YAML
from test_trainer import FAULT_YAML as JAX_FAULT_YAML

REPO = Path(__file__).resolve().parent.parent
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
SIM_DATE_MS = 1_700_000_000_000.0


def _mesh_tool(monkeypatch):
    """tools/eval_models_large.py, whose make_mesh_config chip_smoke.py copies
    (it imports its sibling tools/eval_models.py)."""
    monkeypatch.syspath_prepend(str(REPO / "tools"))
    spec = importlib.util.spec_from_file_location("eval_models_large", REPO / "tools" / "eval_models_large.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _mesh_yaml(n_services=20, days=1, seed=3):
    import chip_smoke

    return chip_smoke.make_mesh_config(n_services, 10, days, np.random.default_rng(seed), 0.08)


MESHES = {
    "load": LOAD_YAML,
    "fault": FAULT_YAML,
    "mesh20": _mesh_yaml(),
}


def test_the_fault_yaml_copy_is_the_trainer_tests_own():
    assert FAULT_YAML == JAX_FAULT_YAML


@pytest.mark.parametrize("days,seed", [(1, 3), (2, 0)])
def test_chip_smokes_mesh_generator_is_the_tools_own(monkeypatch, days, seed):
    want = _mesh_tool(monkeypatch).make_mesh_config(20, 10, days, np.random.default_rng(seed), 0.08)
    assert _mesh_yaml(20, days, seed) == want


# -- config ------------------------------------------------------------------

MALFORMED = {
    "empty": "  ",
    "nonsense": "nonsense: true",
    "not_yaml": "servicesInfo: [unclosed",
    "duplicate_endpoint_id": BASIC_YAML.replace("rt-get", "rv-get"),
    "unknown_dependency_target": BASIC_YAML.replace(
        "dependOn:\n      - endpointId: rt-get", "dependOn:\n      - endpointId: nope"
    ),
    "cycle": BASIC_YAML + "  - endpointId: rt-get\n    dependOn:\n      - endpointId: pp-get\n",
    "oneof_probability_sum": BASIC_YAML.replace(
        "dependOn:\n      - endpointId: rv-get",
        "dependOn:\n      - oneOf:\n"
        "        - { endpointId: rv-get, callProbability: 70 }\n"
        "        - { endpointId: rt-get, callProbability: 60 }",
    ),
    "system_generated_field": BASIC_YAML.replace(
        "- endpointId: rt-get\n                endpointInfo:",
        "- endpointId: rt-get\n                uniqueEndpointName: hacked\n                endpointInfo:",
    ),
    "unrecognized_key": BASIC_YAML + "\nbogusKey: 1\n",
    "negative_replica": BASIC_YAML.replace("replica: 2", "replica: -1"),
    "bad_method": BASIC_YAML.replace("method: get }", "method: fetch }", 1),
    "missing_services_info": "endpointDependencies: []\n",
    "wrong_type": BASIC_YAML.replace("replica: 2", "replica: two"),
    "fault_unknown_target": FAULT_YAML.replace("          - endpointId: back-get\n      timePeriods", "          - endpointId: nope\n      timePeriods"),
    "fault_bad_hour": FAULT_YAML.replace("{ day: 1, hour: 6 }", "{ day: 1, hour: 25 }"),
    "load_unknown_metric": LOAD_YAML.replace("    - endpointId: rt-get\n      delay", "    - endpointId: zz-get\n      delay"),
}


@pytest.mark.parametrize("name", [*MESHES, "basic", *MALFORMED])
def test_handle_sim_config_matches_jax(name):
    text = MALFORMED.get(name) or MESHES.get(name) or BASIC_YAML
    want = JaxConfigManager().handle_sim_config(text)
    got = SimulationConfigManager().handle_sim_config(text)
    assert got == want
    if name in MALFORMED and name != "empty":
        assert got[1] is None and got[0]  # every malformed case is refused with a message


@pytest.mark.parametrize(
    "body",
    [
        "{ name: string, age: number, tags: string[] }",
        '{"title": "x", "pages": 3, "nested": {"a": [1, 2], "b": null, "c": true}}',
        "{ id: number, items: { sku: string, qty: number }[], ok?: boolean }",
        "not a body",
        "",
        "[1, 2, 3]",
    ],
)
def test_body_preprocessing_matches_jax(body):
    assert bodies.preprocess_json_body(body) == jax_bodies.preprocess_json_body(body)


def test_desensitize_and_naming_match_jax():
    from kmamiz_tpu.core import desensitize as jax_desensitize

    for value in ({"a": "x", "b": 3, "c": [True, None, {"d": 1.5}]}, "s", 7, None, [[]]):
        assert desensitize.deidentify_sample(value) == jax_desensitize.deidentify_sample(value)
    for value in ({"a": "string", "b": "number", "c": ["boolean"], "d": {"e": "Date"}}, "string", ["number"]):
        assert desensitize.deidentify_type_definition(value) == jax_desensitize.deidentify_type_definition(value)
    for args in (("svc", "ns", "v1"), ("a-b", "x", "latest")):
        assert naming.generate_unique_service_name(*args) == jax_naming.generate_unique_service_name(*args)
    name = jax_naming.generate_unique_endpoint_name("svc", "ns", "v1", "get", "/a/b?c=1")
    assert naming.generate_unique_endpoint_name("svc", "ns", "v1", "get", "/a/b?c=1") == name
    assert naming.split_unique_service_name("svc\tns\tv1") == jax_naming.split_unique_service_name("svc\tns\tv1")
    assert naming.extract_unique_service_name(name) == jax_naming.extract_unique_service_name(name)
    assert naming.get_path_from_url("http://a.b/x/y?q=1") == jax_naming.get_path_from_url("http://a.b/x/y?q=1")
    assert slot_metrics.slot_key(1, 2) == jax_slot_metrics.slot_key(1, 2)
    assert slot_metrics.parse_slot_key("3-4-0") == jax_slot_metrics.parse_slot_key("3-4-0")


# -- dependency builder, propagator, faults, overload, load handler ----------


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dependency_builder_matches_jax(mesh):
    config = SimulationConfigManager().handle_sim_config(MESHES[mesh])[1]
    jax_config = JaxConfigManager().handle_sim_config(MESHES[mesh])[1]
    got = dependency_builder.build_endpoint_dependencies(config, SIM_DATE_MS)
    want = jax_dependency_builder.build_endpoint_dependencies(jax_config, SIM_DATE_MS)
    assert got == want


A, B, C, D = (f"svc-{x}\tns\tv1\tGET\thttp://{x}/x" for x in "abcd")


def _slot(pkg, counts, errors=None, delays=None, replicas=None):
    metrics = pkg.SlotMetrics()
    metrics.entry_request_counts = dict(counts)
    if errors is not None:
        metrics.endpoint_error_rate = dict(errors)
    if delays is not None:
        metrics.endpoint_delay = dict(delays)
    if replicas is not None:
        metrics.service_replicas = dict(replicas)
    return metrics


def _fallbacks(strategies):
    return [{"uniqueEndpointName": n, "fallbackStrategy": s} for n, s in strategies.items()]


CHAIN = {A: [[(B, 100.0)]], B: [[(C, 100.0)]], C: []}
CHAIN_DELAYS = {A: (10.0, 0.0), B: (5.0, 0.0), C: (2.0, 0.0)}
ANY = "failIfAnyDependentFail"
#: name -> (groups, fallbacks, SlotMetrics fields, compute_latency): the
#: scenarios of tests/test_simulator.py's TestPropagator, jitter added
PROPAGATION = {
    "no_error_chain": (CHAIN, {A: ANY, B: ANY, C: ANY}, dict(counts={A: 100}, errors={A: 0, B: 0, C: 0}, delays=CHAIN_DELAYS), True),
    "leaf_failure": (CHAIN, {A: ANY, B: ANY, C: ANY}, dict(counts={A: 100}, errors={A: 0, B: 0, C: 1.0}, delays=CHAIN_DELAYS), True),
    "ignore_dependent_fail": (
        CHAIN,
        {n: "ignoreDependentFail" for n in (A, B, C)},
        dict(counts={A: 100}, errors={A: 0, B: 0, C: 1.0}, delays=CHAIN_DELAYS),
        True,
    ),
    "fail_if_all": (
        {A: [[(B, 100.0)], [(C, 100.0)]], B: [], C: []},
        {A: "failIfAllDependentFail", B: ANY, C: ANY},
        dict(counts={A: 50}, errors={A: 0.0, B: 1.0, C: 0.0}),
        False,
    ),
    "replica_zero": (
        CHAIN,
        {A: ANY, B: ANY, C: ANY},
        dict(counts={A: 100}, errors={A: 0, B: 0, C: 0}, delays=CHAIN_DELAYS, replicas={"svc-c\tns\tv1": 0}),
        True,
    ),
    "oneof": ({A: [[(B, 30.0), (C, 30.0)]], B: [], C: []}, {A: ANY, B: ANY, C: ANY}, dict(counts={A: 20_000}), False),
    "diamond": (
        {A: [[(B, 100.0)], [(C, 100.0)]], B: [[(D, 100.0)]], C: [[(D, 100.0)]], D: []},
        {n: ANY for n in (A, B, C, D)},
        dict(counts={A: 100}),
        False,
    ),
    "jitter_partial_errors": (
        {A: [[(B, 80.0)], [(C, 100.0)]], B: [[(D, 50.0)]], C: [], D: []},
        {A: ANY, B: "failIfAllDependentFail", C: "ignoreDependentFail", D: ANY},
        dict(
            counts={A: 5_000, C: 700},
            errors={A: 0.02, B: 0.1, C: 0.05, D: 0.3},
            delays={A: (100.0, 50.0), B: (20.0, 5.0), C: (7.0, 3.0), D: (1.0, 1.0)},
        ),
        True,
    ),
}


@pytest.mark.parametrize("name", list(PROPAGATION))
@pytest.mark.parametrize("seed", [0, 11])
def test_propagation_matches_jax(name, seed):
    groups, strategies, fields, latency = PROPAGATION[name]
    slots = ("0-0-0", "0-1-0")
    got = propagator.simulate_propagation(
        _fallbacks(strategies), groups, {k: _slot(slot_metrics, **fields) for k in slots}, latency,
        np.random.default_rng(seed),
    )
    want = jax_propagator.simulate_propagation(
        _fallbacks(strategies), groups, {k: _slot(jax_slot_metrics, **fields) for k in slots}, latency,
        np.random.default_rng(seed),
    )
    assert got == want


def _fault_load(fault):
    return {
        "config": {"simulationDurationInDays": 2, "overloadErrorRateIncreaseFactor": 3},
        "serviceMetrics": [],
        "endpointMetrics": [],
        "faultInjection": [fault],
    }


def _window(day, hour, dur, prob=100):
    return {"startTime": {"day": day, "hour": hour}, "durationHours": dur, "probabilityPercent": prob}


EP = {"endpointId": "a", "uniqueEndpointName": "a\tns\tv1\tGET\thttp://a/x"}
SVC = {"serviceName": "a", "namespace": "ns", "version": "v1", "uniqueServiceName": "a\tns\tv1"}
FAULTS = {
    "increase_latency": {
        "type": "increase-latency",
        "targets": {"services": [], "endpoints": [EP]},
        "timePeriods": [_window(1, 2, 2), _window(2, 22, 4, 50)],
        "increaseLatencyMs": 500.0,
    },
    "increase_error_rate": {
        "type": "increase-error-rate",
        "targets": {"services": [SVC], "endpoints": []},
        "timePeriods": [_window(1, 0, 3, 80), _window(1, 2, 2, 60)],
        "increaseErrorRatePercent": 40,
    },
    "reduce_instance": {
        "type": "reduce-instance",
        "targets": {"services": [SVC], "endpoints": []},
        "timePeriods": [_window(1, 0, 1)],
        "reduceCount": 2,
    },
    "inject_traffic": {
        "type": "inject-traffic",
        "targets": {"services": [], "endpoints": [EP]},
        "timePeriods": [_window(2, 8, 3, 70)],
        "increaseRequestCount": 4000,
    },
}


def _slots(pkg):
    metrics = {pkg.slot_key(d, h): pkg.SlotMetrics() for d in range(2) for h in range(24)}
    for m in metrics.values():
        m.service_replicas["a\tns\tv1"] = 3
        m.entry_request_counts[EP["uniqueEndpointName"]] = 10
    return metrics


@pytest.mark.parametrize("name", list(FAULTS))
def test_fault_injection_matches_jax(name):
    got, want = _slots(slot_metrics), _slots(jax_slot_metrics)
    faults.inject_faults(_fault_load(FAULTS[name]), got, np.random.default_rng(5))
    jax_faults.inject_faults(_fault_load(FAULTS[name]), want, np.random.default_rng(5))
    assert {k: vars(v) for k, v in got.items()} == {k: vars(v) for k, v in want.items()}
    assert faults._fault_probability_per_slot(FAULTS[name]) == jax_faults._fault_probability_per_slot(FAULTS[name])


@pytest.mark.parametrize(
    "args",
    [(200, 1, 100, 0.1, 3.0), (50, 1, 100, 0.1, 3.0), (50, 0, 100, 0.1, 3.0), (1e6, 3, 0.01, 0.0, 1.5), (0, 2, 10, 0.5, 3.0)],
)
def test_overload_error_rate_matches_jax(args):
    assert overload.estimate_error_rate_with_overload(*args) == jax_overload.estimate_error_rate_with_overload(*args)


def test_overload_adjustment_matches_jax():
    def run(pkg, adjust):
        metrics = pkg.SlotMetrics()
        metrics.endpoint_error_rate = {A: 0.0, B: 0.2}
        metrics.service_replicas = {"svc-a\tns\tv1": 1, "svc-b\tns\tv1": 2}
        metrics.service_capacity_per_replica = {"svc-a\tns\tv1": 0.01, "svc-b\tns\tv1": 5.0}
        adjust(3.0, {"0-0-0": {A: {"requestCount": 3600}, B: {"requestCount": 36_000}}}, {"0-0-0": metrics})
        return vars(metrics)

    assert run(slot_metrics, overload.adjust_error_rates_by_overload) == run(
        jax_slot_metrics, jax_overload.adjust_error_rates_by_overload
    )


@pytest.mark.parametrize("total,slots", [(10_007, 24), (2400, 24), (5, 24), (0, 24)])
def test_daily_request_split_matches_jax(total, slots):
    got = load_handler.distribute_daily_request_count(total, slots, np.random.default_rng(1))
    want = jax_load_handler.distribute_daily_request_count(total, slots, np.random.default_rng(1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_combined_realtime_data_map_matches_jax(mesh):
    def run(manager, builder, simulator, handler):
        config = manager().handle_sim_config(MESHES[mesh])[1]
        _, groups = builder.build_endpoint_dependencies(config, 0.0)
        sample = simulator.collect_sample_data(config["servicesInfo"], 0.0)
        return handler.generate_combined_realtime_data_map(
            config["loadSimulation"], groups, sample["replicaCounts"], sample["baseDataMap"],
            simulate_date_ms=0.0, rng=np.random.default_rng(0),
        )

    got = run(SimulationConfigManager, dependency_builder, Simulator, load_handler)
    want = run(JaxConfigManager, jax_dependency_builder, JaxSimulator, jax_load_handler)
    assert got == want and got


# -- the whole simulation, the static config -------------------------------


def _simulate(mesh, seed=0):
    got = Simulator().generate_simulation_data(MESHES[mesh], SIM_DATE_MS, rng=np.random.default_rng(seed))
    want = JaxSimulator().generate_simulation_data(MESHES[mesh], SIM_DATE_MS, rng=np.random.default_rng(seed))
    return got, want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_simulation_matches_jax(mesh):
    got, want = _simulate(mesh)
    assert got.validation_error_message == want.validation_error_message == ""
    assert got.converting_error_message == want.converting_error_message == ""
    assert got.endpoint_dependencies == want.endpoint_dependencies
    assert [d.to_json() for d in got.data_types] == [d.to_json() for d in want.data_types]
    assert got.replica_counts == want.replica_counts
    assert got.realtime_data_per_slot == want.realtime_data_per_slot
    assert got.realtime_data_per_slot  # every mesh declares traffic


def test_simulation_merges_existing_dependencies_as_jax():
    existing = JaxSimulator().generate_simulation_data(BASIC_YAML, 0.0).endpoint_dependencies
    got = Simulator().generate_simulation_data(LOAD_YAML, SIM_DATE_MS, existing, np.random.default_rng(2))
    want = JaxSimulator().generate_simulation_data(LOAD_YAML, SIM_DATE_MS, existing, np.random.default_rng(2))
    assert got.endpoint_dependencies == want.endpoint_dependencies


@pytest.mark.parametrize("name", ["nonsense", "cycle", "unrecognized_key"])
def test_simulation_reports_the_validation_error_as_jax(name):
    got = Simulator().generate_simulation_data(MALFORMED[name], 0.0)
    want = JaxSimulator().generate_simulation_data(MALFORMED[name], 0.0)
    assert got.validation_error_message == want.validation_error_message != ""
    assert got.endpoint_dependencies == want.endpoint_dependencies == []


@pytest.mark.parametrize("mesh", list(MESHES))
def test_static_config_is_byte_equal(mesh):
    got, want = _simulate(mesh)
    args = ([d.to_json() for d in want.data_types], want.replica_counts, want.endpoint_dependencies)
    text = config_generator.generate_sim_config_from_static_data(*args)
    assert text == jax_config_generator.generate_sim_config_from_static_data(*args)
    # and the generated YAML is a valid config of both managers, parsed alike
    assert SimulationConfigManager().handle_sim_config(text) == JaxConfigManager().handle_sim_config(text)


# -- train_on_simulation -------------------------------------------------------


def _numpy(params):
    return {k: None if v is None else np.asarray(v) for k, v in params._asdict().items()}


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return {
        k: None if v is None else v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
        for k, v in _numpy(params).items()
    }


@pytest.fixture
def same_init(monkeypatch):
    """Both heads of the port draw JAX's initial weights for the seed (GAT's
    with every leaf perturbed: from the bare init its attention grads are
    float noise that the two packages round apart, tests/test_torch_gat.py)."""
    sage_init, gat_init = jax_sage.init_params, jax_gat.init_params

    def jax_gat_init(rng, hidden=64, num_features=10, num_nodes=0):
        jp = gat_init(rng, hidden=hidden, num_features=num_features, num_nodes=num_nodes)
        return jax_gat.GatParams(**{k: None if v is None else jnp.asarray(v) for k, v in _perturbed(jp, 7).items()})

    def port_init(model, jax_init):
        def init(generator, hidden=64, num_features=10, num_nodes=0, device=None):
            jp = jax_init(
                jax.random.PRNGKey(int(generator.initial_seed())),
                hidden=hidden,
                num_features=num_features,
                num_nodes=num_nodes,
            )
            return checkpoint.params_from_numpy(model, _numpy(jp), device=device)

        return init

    monkeypatch.setattr(jax_gat, "init_params", jax_gat_init)
    monkeypatch.setattr(graphsage, "init_params", port_init(graphsage, sage_init))
    monkeypatch.setattr(gat, "init_params", port_init(gat, jax_gat_init))


def _simulated_args():
    result = JaxSimulator().generate_simulation_data(FAULT_YAML, 0.0, rng=np.random.default_rng(7))
    return result.endpoint_dependencies, result.realtime_data_per_slot, result.replica_counts


def _assert_same_dataset(got, want):
    assert got.endpoint_names == want.endpoint_names
    np.testing.assert_array_equal(got.src, np.asarray(want.src))
    np.testing.assert_array_equal(got.dst, np.asarray(want.dst))
    assert got.slot_keys == want.slot_keys
    for key in ("features", "target_latency", "target_anomaly", "node_mask"):
        for a, b in zip(getattr(got, key), getattr(want, key)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=key)


def test_train_on_simulation_matches_jax(same_init):
    """GraphSAGE: losses and params within the training tolerances, the
    threshold and the classification metrics equal, the latency metrics
    (sums of float predictions) at the losses' tolerance."""
    args = _simulated_args()
    kw = dict(epochs=4, hidden=8, seed=1)
    want, want_metrics, want_ds = jax_trainer.train_on_simulation(*args, model=jax_sage, **kw)
    got, got_metrics, got_ds = trainer.train_on_simulation(*args, model=graphsage, device="cpu", **kw)
    _assert_same_dataset(got_ds, want_ds)
    for key in ("losses", "latency_losses", "anomaly_losses"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key), err_msg=key, **LOSS_TOL)
    for name, a, b in zip(got.params._fields, got.params, want.params):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **PARAM_TOL)
    for key in (
        "threshold", "anomaly_accuracy", "anomaly_precision", "anomaly_recall", "anomaly_base_rate",
        "anomaly_f1", "per_slot_flagged", "in_sample",
    ):
        assert getattr(got_metrics, key) == getattr(want_metrics, key), key
    for key in ("latency_mse", "latency_mae_ms"):
        np.testing.assert_allclose(getattr(got_metrics, key), getattr(want_metrics, key), err_msg=key, **LOSS_TOL)


GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def test_train_on_simulation_gat_matches_jax_over_its_first_epoch(same_init):
    """GAT: the same dataset, the first epoch's loss within the losses'
    tolerance, and from the same params every training slot's loss (with
    its latency and anomaly terms) within tests/test_torch_gat.py's
    one-step tolerance. The run's later epochs part: FAULT_YAML's unscaled
    request counts drive two of the eight layer-2 units to pre-activations
    of -17 to -31, where ELU's grad is exp(x) in the port (torch's elu
    backward: 1e-8 to 1e-14) and expm1(x) + 1 in JAX (0, or a multiple of
    6e-8 that a last-bit change of x flips); AdamW divides a grad by its
    own scale, so each of these becomes a step of size lr, and w_2 parts by
    ~1e-2 within the first epoch. The 4-epoch run's losses are finite on
    both sides."""
    args = _simulated_args()
    kw = dict(epochs=4, hidden=8, seed=1)
    want, want_metrics, want_ds = jax_trainer.train_on_simulation(*args, model=jax_gat, **kw)
    got, got_metrics, got_ds = trainer.train_on_simulation(*args, model=gat, device="cpu", **kw)
    _assert_same_dataset(got_ds, want_ds)
    np.testing.assert_allclose(got.losses[0], want.losses[0], **LOSS_TOL)
    assert np.isfinite(got.losses).all() and np.isfinite(want.losses).all()
    assert 0.0 < got_metrics.threshold < 1.0 and 0.0 < want_metrics.threshold < 1.0

    import torch

    from kmamiz_tpu_torch.models import common

    train_set = trainer.temporal_split(got_ds)[0]
    jp = jax_gat.init_params(jax.random.PRNGKey(1), hidden=8)
    params = checkpoint.params_from_numpy(gat, _numpy(jp), device="cpu")
    for i in range(len(train_set.features)):
        batch = (
            np.asarray(train_set.features[i], np.float32),
            np.asarray(train_set.src, np.int32),
            np.asarray(train_set.dst, np.int32),
            np.asarray(train_set.edge_mask, bool),
            np.asarray(train_set.target_latency[i], np.float32),
            np.asarray(train_set.target_anomaly[i], np.float32),
            np.asarray(train_set.node_mask[i], bool),
        )
        (want_loss, want_aux), _ = jax.value_and_grad(jax_gat.loss_fn, has_aux=True)(jp, *map(jnp.asarray, batch))
        loss, aux, _ = common.value_and_grad(gat.loss_fn, params, *map(torch.from_numpy, batch))
        np.testing.assert_allclose(float(loss), float(want_loss), err_msg=f"slot {i}", **GRAD_TOL)
        for a, b in zip(aux, want_aux):
            np.testing.assert_allclose(float(a), float(b), err_msg=f"slot {i}", **GRAD_TOL)
