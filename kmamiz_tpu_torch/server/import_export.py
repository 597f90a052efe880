"""Full-state snapshot: export / import.

Equivalent of KMamiz src/services/ImportExportHandler.ts: a
snapshot is a JSON list of [cacheName, data] pairs for every exportable
cache plus the AggregatedData and HistoricalData collections; the wire
format is a .tgz containing that JSON (served by the data handler). Import
clears the database, rebuilds the cache registry from the pairs, re-inserts
the persisted collections, and refreshes the label map.

A copy of kmamiz_tpu/server/import_export.py without the simulator's
caches and its clone-from-production path, which wait for the
simulator's port.
"""
from __future__ import annotations

import io
import json
import logging
import tarfile
from typing import Any, List, Optional, Tuple

from kmamiz_tpu_torch.domain.endpoint_data_type import EndpointDataType
from kmamiz_tpu_torch.server.cache import Cacheable
from kmamiz_tpu_torch.server.cacheables import (
    CCombinedRealtimeData,
    CEndpointDataType,
    CEndpointDependencies,
    CLabelMapping,
    CLabeledEndpointDependencies,
    CLookBackRealtimeData,
    CModelHistoryState,
    CReplicas,
    CTaggedDiffData,
    CTaggedInterfaces,
    CTaggedSwaggers,
    CUserDefinedLabel,
)
from kmamiz_tpu_torch.server.initializer import AppContext

logger = logging.getLogger("kmamiz_tpu_torch.import_export")

EXPORT_MEMBER_NAME = "export.json"


class ImportExportHandler:
    def __init__(self, ctx: AppContext, now_ms: Optional[object] = None) -> None:
        import time

        self._ctx = ctx
        self._now_ms = now_ms or (lambda: time.time() * 1000)

    # -- export (ImportExportHandler.ts:34-46) -------------------------------

    def export_data(self) -> List[Tuple[str, Any]]:
        pairs = self._ctx.cache.export()
        pairs.append(("AggregatedData", self._ctx.store.get_aggregated_data()))
        pairs.append(
            (
                "HistoricalData",
                self._ctx.store.get_historical_data(now_ms=self._now_ms()),
            )
        )
        return pairs

    def export_tgz(self) -> bytes:
        payload = json.dumps(self.export_data()).encode()
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tar:
            info = tarfile.TarInfo(EXPORT_MEMBER_NAME)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
        return buf.getvalue()

    @staticmethod
    def read_tgz(blob: bytes) -> List[Tuple[str, Any]]:
        with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tar:
            member = tar.getmembers()[0]
            fh = tar.extractfile(member)
            assert fh is not None
            return json.loads(fh.read())

    # -- clear (ImportExportHandler.ts:48-71) --------------------------------

    def clear_data(self) -> None:
        from kmamiz_tpu_torch.server.initializer import Initializer

        self._ctx.cache.clear()
        Initializer(self._ctx).register_data_caches()
        self._ctx.store.clear_database()

    # -- import (ImportExportHandler.ts:73-114) ------------------------------

    def _cacheable_factory(self, name: str, init: Any) -> Optional[Cacheable]:
        ctx = self._ctx
        sim = ctx.settings.simulator_mode
        store = ctx.store
        builders = {
            "LabelMapping": lambda: CLabelMapping(init_data=init),
            "EndpointDataType": lambda: CEndpointDataType(
                init_data=init, store=store, simulator_mode=sim
            ),
            "CombinedRealtimeData": lambda: CCombinedRealtimeData(
                init_data=init, store=store, simulator_mode=sim
            ),
            "EndpointDependencies": lambda: CEndpointDependencies(
                init_data=init, store=store, simulator_mode=sim
            ),
            "ReplicaCounts": lambda: CReplicas(init_data=init),
            "TaggedInterfaces": lambda: CTaggedInterfaces(
                init_data=init, store=store, simulator_mode=sim
            ),
            "TaggedSwaggers": lambda: CTaggedSwaggers(
                init_data=init, store=store, simulator_mode=sim
            ),
            "TaggedDiffDatas": lambda: CTaggedDiffData(
                init_data=init, store=store, simulator_mode=sim
            ),
            "LabeledEndpointDependencies": lambda: CLabeledEndpointDependencies(
                init_data=init,
                get_label=lambda n: ctx.cache.get("LabelMapping").get_label(n),
                label_version=lambda: ctx.cache.get("LabelMapping").version,
            ),
            "UserDefinedLabel": lambda: CUserDefinedLabel(
                init_data=init, store=store, simulator_mode=sim
            ),
        }
        builder = builders.get(name)
        return builder() if builder else None

    def import_data(
        self,
        import_pairs: List[Tuple[str, Any]],
        skip_collections: bool = False,
    ) -> bool:
        if not import_pairs:
            return False
        ctx = self._ctx
        # hold the dispatch-rotation lock across the whole swap: a tick
        # landing between clear_database and the registry rebuild would
        # flush a PRE-import cache into the cleared store
        with ctx.dispatch.paused():
            return self._import_data_locked(ctx, import_pairs, skip_collections)

    def _import_data_locked(
        self, ctx, import_pairs, skip_collections: bool
    ) -> bool:
        ctx.store.clear_database()

        pairs = [tuple(p) for p in import_pairs]
        cache_pairs = [
            (name, data)
            for name, data in pairs
            if name not in ("AggregatedData", "HistoricalData")
        ]
        ctx.cache.import_data(cache_pairs, self._cacheable_factory)
        # non-exportable caches are absent from the pairs; re-register
        # them or the rebuilt registry silently drops their sync hooks
        # (the dispatch rotation would never flush them again)
        extra: List[Any] = [
            CLookBackRealtimeData(
                store=ctx.store, simulator_mode=ctx.settings.simulator_mode
            )
        ]
        if ctx.processor is not None and hasattr(
            ctx.processor, "snapshot_history"
        ):
            extra.append(
                CModelHistoryState(
                    store=ctx.store,
                    processor=ctx.processor,
                    simulator_mode=ctx.settings.simulator_mode,
                )
            )
        ctx.cache.register(extra)

        if not skip_collections:
            aggregated = next(
                (d for n, d in pairs if n == "AggregatedData"), None
            )
            historical = next(
                (d for n, d in pairs if n == "HistoricalData"), None
            )
            if aggregated:
                ctx.store.save("AggregatedData", aggregated)
            ctx.dispatch.sync_all()
            if historical:
                ctx.store.insert_many("HistoricalData", historical)

        ctx.service_utils.update_label()
        return True
