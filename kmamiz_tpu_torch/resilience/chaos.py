"""Deterministic chaos harness: seeded fault plans for the resilience layer.

Counterpart of kmamiz_tpu/resilience/chaos.py (the same draws for the
same seed): infrastructure faults, malformed bytes and failing upstreams,
that the pipeline must survive.

- `FaultPlan(seed)`: a seeded schedule assigning each ingest payload a
  fault kind (`none`, `drop`, `truncate`, `corrupt`, `schema`, `bomb`)
  and each upstream call an action (`ok`, `fail`, `delay`, `hang`);
- `mutate_payload(raw, kind, rng)`: a clean raw Zipkin payload turned
  into the requested poison (None for `drop`), each kind landing in its
  own quarantine reason code;
- `chaos_chunks(chunks, plan)`: a clean chunk sequence poisoned per the
  plan, with the indices of the chunks delivered untouched (the oracle:
  ingesting only those must give the chaos run's graph);
- `ChaosUpstream(fn, actions)`: an upstream callable with scheduled
  failures, delays and hangs;
- `graph_signature`: the store's own (graph/store.py), re-exported.
"""
from __future__ import annotations

import json
import random
import time
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

from kmamiz_tpu_torch.graph.store import graph_signature  # noqa: F401

PAYLOAD_FAULTS = ("none", "drop", "truncate", "corrupt", "schema", "bomb")
UPSTREAM_ACTIONS = ("ok", "fail", "delay", "hang")


class FaultPlan:
    """Seeded fault schedule. The payload faults and the upstream actions
    draw from two streams of the seed, so adding upstream calls never
    reshuffles a scenario's payload faults."""

    def __init__(
        self,
        seed: int,
        payload_weights: Optional[dict] = None,
        upstream_weights: Optional[dict] = None,
    ) -> None:
        self.seed = seed
        self._payload_weights = payload_weights or {
            "none": 0.55,
            "drop": 0.09,
            "truncate": 0.09,
            "corrupt": 0.09,
            "schema": 0.09,
            "bomb": 0.09,
        }
        self._upstream_weights = upstream_weights or {
            "ok": 0.6,
            "fail": 0.25,
            "delay": 0.1,
            "hang": 0.05,
        }
        self._payload_rng = random.Random((seed << 1) ^ 0x9E3779B9)
        self._upstream_rng = random.Random((seed << 1) | 1)
        self.mutation_rng = random.Random(seed ^ 0x5DEECE66D)

    @staticmethod
    def _draw(rng: random.Random, weights: dict) -> str:
        kinds = list(weights.keys())
        return rng.choices(kinds, weights=[weights[k] for k in kinds], k=1)[0]

    def payload_faults(self, n: int) -> List[str]:
        return [self._draw(self._payload_rng, self._payload_weights) for _ in range(n)]

    def upstream_actions(self, n: int) -> List[str]:
        return [self._draw(self._upstream_rng, self._upstream_weights) for _ in range(n)]


def mutate_payload(raw: bytes, kind: str, rng: random.Random) -> Optional[bytes]:
    """One fault kind applied to a clean payload: the poisoned bytes, or
    None for `drop` (the payload never arrives)."""
    if kind == "none":
        return raw
    if kind == "drop":
        return None
    if kind == "truncate":
        # cut mid-document: a valid UTF-8 prefix, invalid JSON
        cut = rng.randint(1, max(1, len(raw) - 1))
        return raw[:cut].decode("utf-8", errors="ignore").encode("utf-8")
    if kind == "corrupt":
        # invalid UTF-8 spliced into the document's structural prefix (a
        # splice inside a string value could be salvaged by the lenient
        # native parser); the draw stays in the stream so the other kinds'
        # bytes do not change for a seed
        pos = min(rng.randint(0, len(raw)), 1)
        return raw[:pos] + b"\xff\xfe\xfd\xfc" + raw[pos:]
    if kind == "schema":
        # valid JSON of a foreign shape (a metrics export, not trace groups)
        return json.dumps({"metrics": [rng.random() for _ in range(4)], "v": 2}).encode("utf-8")
    if kind == "bomb":
        # structurally fine but past the ingest size cap that a test sets
        return b'[[{"pad": "' + b"A" * 4096 + b'"}]]'
    raise ValueError(f"unknown payload fault kind: {kind}")


def chaos_chunks(chunks: Sequence[bytes], plan: FaultPlan) -> Tuple[List[bytes], List[int]]:
    """(delivered chunks, indices of the chunks delivered untouched)."""
    faults = plan.payload_faults(len(chunks))
    delivered: List[bytes] = []
    clean_indices: List[int] = []
    for index, (chunk, kind) in enumerate(zip(chunks, faults)):
        mutated = mutate_payload(chunk, kind, plan.mutation_rng)
        if mutated is None:
            continue
        delivered.append(mutated)
        if kind == "none":
            clean_indices.append(index)
    return delivered, clean_indices


class ChaosUpstream:
    """An upstream callable with a scheduled action per call: `fail`
    raises ConnectionError, `delay` sleeps `delay_s` then succeeds, `hang`
    sleeps `hang_s`, `ok` passes through; calls past the schedule
    succeed. `calls` records the actions taken."""

    def __init__(
        self,
        fn: Callable,
        actions: Iterable[str],
        delay_s: float = 0.05,
        hang_s: float = 5.0,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self._fn = fn
        self._actions: Iterator[str] = iter(actions)
        self._delay_s = delay_s
        self._hang_s = hang_s
        self._sleep = sleep
        self.calls: List[str] = []

    def __call__(self, *args, **kwargs):
        action = next(self._actions, "ok")
        self.calls.append(action)
        if action == "fail":
            raise ConnectionError("chaos: upstream failure injected")
        if action == "delay":
            self._sleep(self._delay_s)
        elif action == "hang":
            self._sleep(self._hang_s)
        return self._fn(*args, **kwargs)
