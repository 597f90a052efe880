"""The port's scenario factory against kmamiz_tpu/scenarios/ on the CPU.

The compose-time cases of tests/test_scenarios.py, each held to the JAX
package: `spec_signature` of every archetype at several seeds, the
specs themselves, the topologies' YAML bytes, the span emission of
`tick_groups`, the storyline filter (the JAX package's
KMAMIZ_SCENARIO_STORYLINES, an argument here), poison-storm payloads,
the traffic curves, `labeled_windows`, and the port's copy of the
runner's two storyline-view helpers. The closed-loop runner waits for
the port's harnesses.
"""
from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest

from kmamiz_tpu.scenarios import factory as jax_factory
from kmamiz_tpu.scenarios import labeled as jax_labeled
from kmamiz_tpu.scenarios import runner as jax_runner
from kmamiz_tpu.scenarios import storyline as jax_storyline
from kmamiz_tpu.scenarios import topology as jax_topology
from kmamiz_tpu.scenarios import traffic as jax_traffic
from kmamiz_tpu_torch.scenarios import (
    ARCHETYPES,
    STORYLINE_KINDS,
    TRAFFIC_KINDS,
    build_scenario,
    enabled_storylines,
    labeled_windows,
    scenario_matrix,
    spec_signature,
)
from kmamiz_tpu_torch.scenarios import runner, storyline, topology, traffic

NAMES = [name for name, _ in ARCHETYPES]


def _plain(obj):
    """A spec (or part) as nested plain tuples, comparable across the two
    packages' dataclasses."""
    if dataclasses.is_dataclass(obj):
        return tuple(_plain(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return tuple(_plain(x) for x in obj)
    if isinstance(obj, (set, frozenset)):
        return tuple(sorted(_plain(x) for x in obj))
    return obj


@pytest.mark.parametrize("archetype", NAMES)
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_spec_signature_equals_jax(archetype, seed):
    got = build_scenario(archetype, seed, 2, 10)
    want = jax_factory.build_scenario(archetype, seed, 2, 10)
    assert spec_signature(got) == jax_factory.spec_signature(want)
    assert _plain(got) == _plain(want)


def test_matrix_equals_jax_and_is_deterministic():
    a = scenario_matrix(5, 7, 8)
    assert a == scenario_matrix(5, 7, 8)
    assert [spec_signature(s) for s in a] == [jax_factory.spec_signature(s) for s in jax_factory.scenario_matrix(5, 7, 8)]
    b = scenario_matrix(1, 7, 8)
    assert all(spec_signature(x) != spec_signature(y) for x, y in zip(a, b))
    cycled = scenario_matrix(0, len(ARCHETYPES) + 2, 6)
    assert cycled[len(ARCHETYPES)].archetype == ARCHETYPES[0][0]
    assert spec_signature(cycled[len(ARCHETYPES)]) != spec_signature(cycled[0])


def test_matrix_defaults_are_the_jax_defaults():
    got = scenario_matrix()
    want = jax_factory.scenario_matrix()
    assert [spec_signature(s) for s in got] == [jax_factory.spec_signature(s) for s in want]


@pytest.mark.parametrize("kind", topology.TOPOLOGY_KINDS)
def test_topology_yaml_byte_equal(kind):
    for seed in (3, 42):
        got = topology.sample_topology(kind, random.Random(seed), "ns")
        want = jax_topology.sample_topology(kind, random.Random(seed), "ns")
        assert _plain(got) == _plain(want)
        assert topology.sim_config_yaml(got) == jax_topology.sim_config_yaml(want)
        assert topology.topology_digest(got) == jax_topology.topology_digest(want)
        assert all(0 <= hop < len(got.services) for p in got.paths for hop in p)


@pytest.mark.parametrize("kind", topology.TOPOLOGY_KINDS)
def test_tick_groups_equal_jax(kind):
    topo = topology.sample_topology(kind, random.Random(7), "ns")
    jtopo = jax_topology.sample_topology(kind, random.Random(7), "ns")
    for tick in (0, 3):
        kw = dict(tick=tick, count=4)
        assert topology.tick_groups(topo, "x", **kw) == jax_topology.tick_groups(jtopo, "x", **kw)
        assert topology.tick_groups(topo, "x", **kw) == topology.tick_groups(topo, "x", **kw)
    svc = frozenset(topo.services[:1])
    kw = dict(tick=2, count=5, drop_services=svc, error_services=svc, latency_boost_us=5000)
    assert topology.tick_groups(topo, "y", **kw) == jax_topology.tick_groups(jtopo, "y", **kw)


def test_storyline_filter_equals_the_jax_env_toggle(monkeypatch):
    monkeypatch.setenv("KMAMIZ_SCENARIO_STORYLINES", "cascade,tick-stall")
    assert enabled_storylines("cascade,tick-stall") == jax_storyline.enabled_storylines() == ("cascade", "tick-stall")
    monkeypatch.setenv("KMAMIZ_SCENARIO_STORYLINES", "all")
    assert enabled_storylines() == jax_storyline.enabled_storylines() == STORYLINE_KINDS


@pytest.mark.parametrize("filt", ["tick-stall", "rolling-deploy", "cascade,poison-storm"])
def test_filtered_storylines_equal_jax(filt, monkeypatch):
    monkeypatch.setenv("KMAMIZ_SCENARIO_STORYLINES", filt)
    for name in ("rolling-deploy-mesh", "multi-tenant-mix", "cascade-fanout"):
        got = build_scenario(name, 3, 0, 10, storylines=filt)
        want = jax_factory.build_scenario(name, 3, 0, 10)
        assert spec_signature(got) == jax_factory.spec_signature(want)
    full = build_scenario("rolling-deploy-mesh", 3, 0, 10)
    only_stall = build_scenario("rolling-deploy-mesh", 3, 0, 10, storylines="tick-stall")
    # dropping rolling-deploy leaves tick-stall's child stream untouched
    assert [e for _t, e in only_stall.events() if e.kind == "tick-stall"] == [
        e for _t, e in full.events() if e.kind == "tick-stall"
    ]
    assert not only_stall.has_event("rolling-deploy")


def test_poison_storm_payloads_equal_jax():
    topo = topology.sample_topology("chain", random.Random(1), "ns")
    jtopo = jax_topology.sample_topology("chain", random.Random(1), "ns")
    ev = storyline.compose_poison_storm(topo, random.Random(9), 10)
    jev = jax_storyline.compose_poison_storm(jtopo, random.Random(9), 10)
    assert ev.key() == jev.key()
    per_tick, kinds, _seed = ev.params
    assert per_tick >= 1 and len(kinds) == ev.duration * per_tick
    assert set(kinds) <= {"truncate", "corrupt", "schema", "bomb"}
    clean = b'[[{"traceId": "t", "id": "s"}]]'
    for tick in range(ev.at_tick, ev.at_tick + ev.duration):
        got = storyline.poison_payloads_for(ev, topo, tick, clean)
        assert got == jax_storyline.poison_payloads_for(jev, jtopo, tick, clean) and got


@pytest.mark.parametrize("kind", TRAFFIC_KINDS)
def test_traffic_curves_equal_jax(kind):
    for seed in (2, 4):
        curve = traffic.sample_traffic(kind, 12, random.Random(seed))
        assert curve == jax_traffic.sample_traffic(kind, 12, random.Random(seed))
        assert len(curve) == 12 and all(1 <= c <= traffic.MAX_TRACES_PER_TICK for c in curve)
    ramp = traffic.sample_traffic("ramp", 10, random.Random(2))
    assert list(ramp) == sorted(ramp) and ramp[-1] > ramp[0]


@pytest.mark.parametrize("archetype, tenant", [("multi-tenant-mix", 0), ("multi-tenant-mix", 1), ("rolling-deploy-mesh", 0), ("cascade-fanout", 0)])
def test_runner_views_equal_jax(archetype, tenant):
    spec = build_scenario(archetype, 0, 1, 12)
    jspec = jax_factory.build_scenario(archetype, 0, 1, 12)
    plan, jplan = spec.tenants[tenant], jspec.tenants[tenant]
    for tick in range(12):
        assert runner._tick_view(plan, tick).keys() == jax_runner._tick_view(jplan, tick).keys()
        got, want = runner._tick_view(plan, tick), jax_runner._tick_view(jplan, tick)
        for key in ("flap", "stall", "drop", "error", "latency_us"):
            assert got[key] == want[key], (tick, key)
        assert [e.key() for e in got["poisons"]] == [e.key() for e in want["poisons"]]
        fn, jfn = runner._deploy_version_fn(plan, tick), jax_runner._deploy_version_fn(jplan, tick)
        assert [fn(s) for s in plan.topology.services] == [jfn(s) for s in jplan.topology.services]


@pytest.mark.parametrize("archetype, tenant", [("multi-tenant-mix", 0), ("multi-tenant-mix", 1), ("cascade-fanout", 0), ("rolling-deploy-mesh", 0)])
def test_labeled_windows_equal_jax(archetype, tenant):
    got = labeled_windows(build_scenario(archetype, 0, 2, 8), tenant)
    want = jax_labeled.labeled_windows(jax_factory.build_scenario(archetype, 0, 2, 8), tenant)
    assert got["names"] == want["names"] and got["services"] == want["services"]
    for key in ("service_of", "src", "dst", "mask"):
        np.testing.assert_array_equal(got[key], want[key])
    assert len(got["windows"]) == len(want["windows"]) == 8
    for g, w in zip(got["windows"], want["windows"]):
        assert g.keys() == w.keys()
        for key in g:
            if isinstance(g[key], np.ndarray):
                np.testing.assert_array_equal(g[key], w[key])
            else:
                assert g[key] == w[key], key
