"""Tick router: tenant resolution, per-tenant runtimes, stacked dispatch.

Counterpart of kmamiz_tpu/tenancy/router.py. The DP server asks three
things of it:

1. **Whose request is this?** `resolve_tenant` reads the tenant header
   (TENANT_HEADER, the JAX package's KMAMIZ_TENANT_HEADER default
   ``x-kmamiz-tenant``) or a ``/t/<tenant>/...`` path prefix (the prefix
   wins), checks the name against the arena's safe charset, and hands
   back the route without the prefix.

2. **The tenant's serving state.** `TickRouter.runtime` creates one
   :class:`TenantRuntime` per tenant, on first use, through the DP
   server's factory: its own DataProcessor (graph, WAL namespace, dedup
   map), last-good payload, watchdog and encoded-payload cache.

3. **Batch what can batch.** `batched_collect` runs N tenants' ticks with
   the host stages per tenant and the graph merge stacked: same-bucket
   tenants' windows union in one tenancy.batch.batched_merge_edges call
   over the arena's ``[T, cap]`` stack, with the ``[T]`` counts read back
   once for the batch (on a device mesh, batch.sharded_merge_edges over
   the arena's per-device lane groups, each adopted lane copied back to
   its tenant's device). A tenant that cannot join a stack (a bucket of its
   own, no host edge set, a graph the arena does not hold under its
   name) merges serially, as the JAX router does. `submit` adds the
   leader-elected gather window (`batch_window_ms`, 0 by default: every
   tick direct) that coalesces concurrent HTTP ticks into one batch.

The processors' tick locks are taken in one order (sorted tenant names)
for the whole batch, so two batches and a follower's direct tick cannot
deadlock.

Deliberate difference from the JAX router: its stacked dispatch catches
every exception and merges serially instead. Here only StoreVersionDrift
(a merge landed between the stack's snapshot and the adopt) re-merges
serially, which is a set union and so exact; any other error raises and
the DP answers it as a failed tick. The JAX submit's graftcost lookup
waits for the cost model's port.
"""
from __future__ import annotations

import contextlib
import logging
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kmamiz_tpu_torch.parallel import mesh as pmesh
from kmamiz_tpu_torch.tenancy.arena import DEFAULT_TENANT, TenantNameError, default_arena, valid_tenant
from kmamiz_tpu_torch.telemetry.profiling import events as prof_events

logger = logging.getLogger("kmamiz_tpu_torch.tenancy.router")

#: the header that carries the tenant (KMAMIZ_TENANT_HEADER's default;
#: looked up case-insensitively in HTTP headers)
TENANT_HEADER = "x-kmamiz-tenant"
#: the gather window that coalesces concurrent ticks, ms
#: (KMAMIZ_TENANT_BATCH_WINDOW_MS's default: 0, every tick direct)
BATCH_WINDOW_MS = 0.0
#: window columns of a stack pad to at least this many rows
MIN_WINDOW_ROWS = 64


def tenant_header() -> str:
    return TENANT_HEADER


class TenantResolutionError(ValueError):
    """An unroutable request: a malformed tenant name."""


def resolve_tenant(headers, path: str, header: Optional[str] = None) -> Tuple[str, str]:
    """(tenant, the path without its prefix) for a request.
    ``/t/<tenant>/...`` wins over the header (`header`, TENANT_HEADER by
    default); no signal is the default tenant. Raises
    TenantResolutionError for a name outside the safe charset."""
    tenant: Optional[str] = None
    if path.startswith("/t/"):
        tenant, _, tail = path[3:].partition("/")
        path = "/" + tail
        if not tenant:
            raise TenantResolutionError("empty tenant in /t/ route")
    else:
        try:
            tenant = headers.get(header or tenant_header())
        except AttributeError:
            tenant = None
    if tenant is None or tenant == "":
        return DEFAULT_TENANT, path
    if not valid_tenant(tenant):
        raise TenantResolutionError(f"invalid tenant name: {tenant!r}")
    return tenant, path


class TenantRuntime:
    """One tenant's serving state: its processor and its edge layers (the
    DP server's factory makes the last-good, watchdog and cache objects)."""

    __slots__ = ("tenant", "processor", "last_good", "watchdog", "encoded_cache")

    def __init__(self, tenant, processor, last_good=None, watchdog=None, encoded_cache=None) -> None:
        self.tenant = tenant
        self.processor = processor
        self.last_good = last_good
        self.watchdog = watchdog
        self.encoded_cache = encoded_cache


class _PendingTick:
    __slots__ = ("tenant", "request", "done", "result", "error")

    def __init__(self, tenant: str, request: dict) -> None:
        self.tenant = tenant
        self.request = request
        self.done = threading.Event()
        self.result: Optional[dict] = None
        self.error: Optional[BaseException] = None


class TickRouter:
    """Tenant -> runtime registry and the stacked tick dispatcher.
    `batch_window_ms` is the gather window of `submit`."""

    def __init__(
        self,
        runtime_factory: Callable[[str], TenantRuntime],
        default_runtime: Optional[TenantRuntime] = None,
        batch_window_ms: float = BATCH_WINDOW_MS,
    ) -> None:
        self._factory = runtime_factory
        self.batch_window_ms = max(0.0, float(batch_window_ms))
        self._lock = threading.RLock()
        self._runtimes: Dict[str, TenantRuntime] = {}
        if default_runtime is not None:
            self._runtimes[DEFAULT_TENANT] = default_runtime
        # the gather queue of submit; leader-elected
        self._q_lock = threading.Lock()
        self._queue: List[_PendingTick] = []
        self._leader_active = False
        self._stats_lock = threading.Lock()
        self._stats = {"batches": 0, "stackedMerges": 0, "stackedLanes": 0, "driftRemerges": 0, "serialMerges": 0}
        #: with keep_inputs set, the last stacked merge's inputs (the
        #: store stack, the window stack, the counts; the stacks' columns
        #: are sharded values on a mesh), for measuring it again
        self.keep_inputs = False
        self.last_stack_inputs: Optional[tuple] = None
        #: host wall of the last stacked merge, its read-back included, ms
        self.last_batch_merge_ms = 0.0

    def runtime(self, tenant: str) -> TenantRuntime:
        """The tenant's runtime, created on first use under the registry
        lock (creation replays the tenant's WAL and admits its graph)."""
        if tenant != DEFAULT_TENANT and not valid_tenant(tenant):
            raise TenantNameError(f"invalid tenant name: {tenant!r}")
        with self._lock:
            rt = self._runtimes.get(tenant)
            if rt is None:
                rt = self._factory(tenant)
                self._runtimes[tenant] = rt
            return rt

    def install_runtime(self, tenant: str, runtime: TenantRuntime) -> None:
        """Replace (or create) a tenant's runtime in one step."""
        if tenant != DEFAULT_TENANT and not valid_tenant(tenant):
            raise TenantNameError(f"invalid tenant name: {tenant!r}")
        with self._lock:
            self._runtimes[tenant] = runtime

    def drop_runtime(self, tenant: str) -> bool:
        """Forget a tenant's runtime (its WAL directory stays on disk; the
        open handle closes). Returns whether one existed."""
        with self._lock:
            rt = self._runtimes.pop(tenant, None)
        if rt is not None and rt.processor.wal is not None:
            rt.processor.wal.close()
        return rt is not None

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._runtimes)

    def summary(self) -> dict:
        return {
            "tenants": self.tenants(),
            "batchWindowMs": self.batch_window_ms,
            "arena": default_arena().summary(),
        }

    def stats(self) -> dict:
        """Counters of the stacked dispatch: batches, stacked merges and
        their lanes, drift re-merges, serial merges."""
        with self._stats_lock:
            return dict(self._stats)

    def _count(self, **by) -> None:
        with self._stats_lock:
            for k, v in by.items():
                self._stats[k] += v

    # -- stacked dispatch ----------------------------------------------------

    def batched_collect(self, requests: Sequence[Tuple[str, dict]]) -> List[dict]:
        """Run every (tenant, request) tick, stacking same-bucket merges
        into one batched program. Answers in request order; each tenant's
        graph is bit-equal to its serial path's. The tenants' tick locks
        are held, in sorted-name order, for the whole batch."""
        from kmamiz_tpu_torch.telemetry.tracing import TRACER

        runtimes = [self.runtime(t) for t, _ in requests]
        by_name = {rt.tenant: rt for rt in runtimes}
        with contextlib.ExitStack() as held:
            for name in sorted(by_name):
                held.enter_context(by_name[name].processor.tick_lock)
            with TRACER.tick():
                return self._batched_locked(runtimes, [r for _, r in requests])

    def _batched_locked(self, runtimes, requests) -> List[dict]:
        arena = default_arena()
        entries = [(rt, rt.processor.prepare_tick(req)) for rt, req in zip(runtimes, requests)]
        groups: Dict[int, List[int]] = {}
        merge_cols: Dict[int, tuple] = {}
        serial: List[int] = []
        for i, (rt, prep) in enumerate(entries):
            cols = rt.processor.prepare_batched_merge(prep)
            if cols is None or arena.get(rt.tenant) is not rt.processor.graph:
                serial.append(i)
            else:
                merge_cols[i] = cols
                groups.setdefault(rt.processor.graph.capacity, []).append(i)
        stacked_lanes: List[int] = []
        drift = 0
        for _cap, idxs in sorted(groups.items()):
            if len(idxs) < 2:
                serial.extend(idxs)
                continue
            leftover = self._dispatch_stacked([entries[i] for i in idxs], [merge_cols[i] for i in idxs])
            stacked_lanes.append(len(idxs))
            drift += len(leftover)
            serial.extend(idxs[j] for j in leftover)
        for i in serial:
            rt, prep = entries[i]
            rt.processor.merge_prepared(prep)
        out = []
        for rt, prep in entries:
            out.append(rt.processor.finish_tick(prep))
            rt.processor.last_stage_ms = dict(prep.stages)
        self._count(
            batches=1,
            stackedMerges=len(stacked_lanes),
            stackedLanes=sum(stacked_lanes),
            driftRemerges=drift,
            serialMerges=len(serial),
        )
        return out

    def _dispatch_stacked(self, group, cols_list) -> List[int]:
        """One stacked merge over a same-capacity group; returns the
        group-local indices that must merge serially: the lanes whose
        store moved past the stack's snapshot (StoreVersionDrift). Any
        other error raises."""
        from kmamiz_tpu_torch.core.spans import _pad_size as _pow2
        from kmamiz_tpu_torch.graph.store import StoreVersionDrift
        from kmamiz_tpu_torch.ops.sortutil import SENTINEL
        from kmamiz_tpu_torch.tenancy import batch as batch_ops

        stack, views = default_arena().stacked_edges([rt.tenant for rt, _ in group])
        n = len(group)
        wcap = _pow2(max(len(c[0]) for c in cols_list), minimum=MIN_WINDOW_ROWS)
        win = np.full((3, n, wcap), SENTINEL, dtype=np.int32)
        for i, cols in enumerate(cols_list):
            for k in range(3):
                win[k, i, : len(cols[k])] = cols[k]
        sharded = not isinstance(stack[0], torch.Tensor)
        if sharded:
            # the tenant axis sharded over a mesh: each device merges its
            # group of lanes, and each adopted lane lands back on its
            # tenant's device
            devices = [g.device for g in stack[0]]
            w = [pmesh.shard(win[k], devices) for k in range(3)]
            w_cols = (*w, tuple(x != SENTINEL for x in w[0]))
        else:
            w = torch.from_numpy(win).to(stack[0].device)
            w_cols = (w[0], w[1], w[2], w[0] != SENTINEL)
        t0 = prof_events.now_ms()
        if sharded:
            s, d, ds, counts = batch_ops.sharded_merge_edges(stack, w_cols)
            counts = pmesh.unshard(counts, views[0].src.device)
            per = n // len(devices)
            lanes = [
                tuple(c[i // per][i % per].to(rt.processor.graph.device, non_blocking=True) for c in (s, d, ds))
                for i, (rt, _prep) in enumerate(group)
            ]
        else:
            s, d, ds, _valid, counts = batch_ops.batched_merge_edges(*stack, *w_cols)
            lanes = [(s[i], d[i], ds[i]) for i in range(n)]
        # the batch's one read-back: every lane's valid count
        counts = counts.tolist()
        self.last_batch_merge_ms = prof_events.now_ms() - t0
        if self.keep_inputs:
            self.last_stack_inputs = (stack, w_cols, list(counts))
        leftover: List[int] = []
        for i, (rt, prep) in enumerate(group):
            try:
                rt.processor.adopt_batched_merge(
                    prep, *lanes[i], counts[i], cols_list[i], expected_version=views[i].version
                )
            except StoreVersionDrift:
                # a merge landed between the snapshot and the adopt: this
                # lane is stale; the serial union over the current store
                # gives the same edge set
                leftover.append(i)
        return leftover

    def batched_service_scores(self, tenants: Sequence[str]):
        """The service scorers of same-bucket tenants in one batched
        program. Returns the stacked ServiceScores (fields
        ``[T, num_services]``) and each tenant's service capacity, for
        slicing its lane."""
        from kmamiz_tpu_torch.core.spans import _pad_size as _pow2
        from kmamiz_tpu_torch.tenancy import batch as batch_ops

        inputs = [self.runtime(t).processor.graph._scorer_inputs() for t in tenants]
        caps = {int(i[0].shape[0]) for i in inputs}
        if len(caps) != 1:
            raise ValueError(f"tenants span capacity buckets: {sorted(caps)}")
        ep_cap = max(int(i[4].shape[0]) for i in inputs)
        svc_cap = _pow2(max(int(i[7]) for i in inputs))
        svc_caps = [int(i[7]) for i in inputs]
        device = inputs[0][0].device

        def table(k, fill, dtype):
            out = np.full((len(inputs), ep_cap), fill, dtype=dtype)
            for lane, i in enumerate(inputs):
                a = np.asarray(i[k])
                out[lane, : a.shape[0]] = a
            return torch.from_numpy(out).to(device)

        src, dst, dist, mask = (torch.stack([i[k] for i in inputs]) for k in range(4))
        scores = batch_ops.batched_service_scores(
            src, dst, dist, mask,
            table(4, 0, np.int32), table(5, 0, np.int32), table(6, False, bool),
            num_services=svc_cap,
        )
        return scores, svc_caps

    # -- gather-window micro-batching (HTTP coalescing) ----------------------

    def _direct_tick(self, tenant: str, request: dict) -> dict:
        """One tenant's tick on its own: a micro-tick of the stream engine
        with KMAMIZ_STREAM on, the serial collect otherwise."""
        from kmamiz_tpu_torch.server import stream as stream_mod

        rt = self.runtime(tenant)
        if stream_mod.stream_enabled():
            eng = stream_mod.engine_for(rt.processor, rt.watchdog)
            eng.note_micro_tick()
            return eng.collect(request)
        return rt.processor.collect(request)

    def submit(self, tenant: str, request: dict) -> dict:
        """One tick, coalesced with concurrent submits while the gather
        window is on: the first arrival leads, sleeps the window out and
        runs everything queued behind it as one batched_collect (ordered
        cheap-first by the control plane's predicted costs when it is on).
        A window of 0 is the tenant's direct tick."""
        window = self.batch_window_ms
        if window <= 0:
            return self._direct_tick(tenant, request)
        item = _PendingTick(tenant, request)
        with self._q_lock:
            self._queue.append(item)
            lead = not self._leader_active
            if lead:
                self._leader_active = True
        if lead:
            threading.Event().wait(window / 1000.0)
            with self._q_lock:
                batch, self._queue = self._queue, []
                self._leader_active = False
            if len(batch) > 1:
                from kmamiz_tpu_torch import control

                if control.enabled():
                    batch = control.policy.order_batch(batch, control.predicted_costs(), lambda it: it.tenant)
            try:
                results = self.batched_collect([(it.tenant, it.request) for it in batch])
                for it, res in zip(batch, results):
                    it.result = res
            except BaseException as e:  # noqa: BLE001 - every waiter gets the error
                for it in batch:
                    it.error = e
            finally:
                for it in batch:
                    it.done.set()
        elif not item.done.wait(timeout=window / 1000.0 + 30.0):
            # a leader that died must not wedge its followers: serve alone
            # (the tick lock orders this after any batch holding it)
            return self._direct_tick(tenant, request)
        if item.error is not None:
            raise item.error
        if item.result is None:
            return self._direct_tick(tenant, request)
        return item.result
