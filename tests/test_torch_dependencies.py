"""The port's EndpointDependencies merge against the JAX package's.

The realtime tick combines the window's dependency records with the
cache's and trims the result. The port hands the records over as objects
in-process (`handed_over`), builds combine_with's key sets lazily, and
trims a combine_with result by its trim hint; each must give the JAX
package's records exactly: the same records in the same order, with the
same entries in the same order. The records here repeat endpoint names
and entry keys with differing values, so that which duplicate survives
shows, and some carry store ids, which a hand-over strips.
"""
from __future__ import annotations

import copy
import random

import pytest

from kmamiz_tpu.domain.endpoint_dependencies import EndpointDependencies as JaxDependencies
from kmamiz_tpu_torch.domain.endpoint_dependencies import EndpointDependencies


def _endpoint(name: str, rng: random.Random) -> dict:
    return {
        "uniqueEndpointName": name,
        "uniqueServiceName": name.rsplit("\t", 2)[0],
        "timestamp": rng.randrange(1_000),
    }


def _records(rng: random.Random, n: int, ids: bool) -> list:
    names = [f"svc{i % 4}\tns\tv1\tGET\thttp://svc{i % 4}/ep{i}" for i in range(12)]
    out = []
    for k in range(n):
        rec = {
            "endpoint": _endpoint(rng.choice(names), rng),
            "lastUsageTimestamp": rng.randrange(1_000),
            "isDependedByExternal": rng.random() < 0.5,
        }
        for side in ("dependingBy", "dependingOn"):
            rec[side] = [
                {
                    "endpoint": _endpoint(rng.choice(names), rng),
                    "distance": rng.randrange(1, 4),
                    "type": side[9:].upper(),
                    **({"_id": f"e{k}{side}{j}"} if ids and rng.random() < 0.3 else {}),
                }
                for j in range(rng.randrange(0, 7))
            ]
        if ids:
            rec["_id"] = f"r{k}"
        out.append(rec)
    return out


def _both(records: list, clean: bool = False, trimmed: bool = False):
    port = EndpointDependencies(copy.deepcopy(records), now_ms=0)
    port._clean = clean  # as Traces marks its own records
    jax = JaxDependencies(copy.deepcopy(records), now_ms=0)
    if trimmed:
        port, jax = port.trim(), jax.trim()
    return port, jax


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("trimmed", [False, True], ids=["raw-cache", "trimmed-cache"])
def test_tick_merge_matches_jax(seed, trimmed):
    """The tick's path, the DP protocol's JSON on the JAX side and the
    port's hand-over of objects: combine, hand back, trim."""
    rng = random.Random(seed)
    window = _records(rng, 30, ids=False)
    existing = _records(rng, 40, ids=seed % 2 == 1)
    port_w, jax_w = _both(window, clean=True)
    port_e, jax_e = _both(existing, trimmed=trimmed)
    port_c = port_w.combine_with(port_e.handed_over(now_ms=0))
    jax_c = jax_w.combine_with(JaxDependencies(jax_e.to_json(), now_ms=0))
    assert port_c.to_json() == jax_c.to_json()
    assert port_c.trim().to_json() == jax_c.trim().to_json()
    got = port_c.handed_over(now_ms=0).trim()
    want = JaxDependencies(jax_c.to_json(), now_ms=0).trim()
    assert got.to_json() == want.to_json()
    # the trimmed result merges again as the next tick's cache
    port_n, jax_n = _both(_records(rng, 30, ids=False), clean=True)
    assert port_n.combine_with(got.handed_over(now_ms=0)).trim().to_json() == jax_n.combine_with(
        JaxDependencies(want.to_json(), now_ms=0)
    ).trim().to_json()


@pytest.mark.parametrize("seed", range(4))
def test_combine_without_hand_over_matches_jax(seed):
    """combine_with of the records as they are (store ids kept, the other
    side untrimmed, names repeated on both sides) and its trim."""
    rng = random.Random(100 + seed)
    port_a, jax_a = _both(_records(rng, 25, ids=True))
    port_b, jax_b = _both(_records(rng, 25, ids=True))
    port_c, jax_c = port_a.combine_with(port_b), jax_a.combine_with(jax_b)
    assert port_c.to_json() == jax_c.to_json()
    assert port_c.trim().to_json() == jax_c.trim().to_json()


def test_hand_over_strips_store_ids_as_json_does():
    rng = random.Random(7)
    port, jax = _both(_records(rng, 20, ids=True))
    assert any("_id" in d for d in port.dependencies)
    handed = port.handed_over(now_ms=0)
    assert handed.dependencies == JaxDependencies(jax.to_json(), now_ms=0).dependencies
    assert not any("_id" in d for d in handed.dependencies)
