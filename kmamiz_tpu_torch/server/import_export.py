"""Full-state snapshot: export / import / clone-from-production.

Equivalent of KMamiz src/services/ImportExportHandler.ts: a
snapshot is a JSON list of [cacheName, data] pairs for every exportable
cache plus the AggregatedData and HistoricalData collections; the wire
format is a .tgz containing that JSON (served by the data handler). Import
clears the database, rebuilds the cache registry from the pairs, re-inserts
the persisted collections, and refreshes the label map.
"""
from __future__ import annotations

import gzip
import io
import json
import logging
import tarfile
import urllib.request
from typing import Any, List, Optional, Tuple

from kmamiz_tpu_torch.domain.endpoint_data_type import EndpointDataType
from kmamiz_tpu_torch.domain.historical import HistoricalData
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
    CSimulatedHistoricalData,
    CTaggedDiffData,
    CTaggedInterfaces,
    CTaggedSimulationYAML,
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
            "TaggedSimulationYAML": lambda: CTaggedSimulationYAML(init_data=init),
            "SimulatedHistoricalData": lambda: CSimulatedHistoricalData(
                init_data=init
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
            if not ctx.settings.simulator_mode:
                if aggregated:
                    ctx.store.save("AggregatedData", aggregated)
                ctx.dispatch.sync_all()
            elif aggregated:
                ctx.cache.get("SimulatedHistoricalData").insert_one(
                    HistoricalData(aggregated)
                )
            if historical:
                ctx.store.insert_many("HistoricalData", historical)

        ctx.service_utils.update_label()
        return True

    # -- clone from production (ImportExportHandler.ts:116-190) --------------

    def import_data_from_production_environment(
        self, import_pairs: List[Tuple[str, Any]]
    ) -> bool:
        """HistoricalData and AggregatedData are not imported."""
        return self.import_data(import_pairs, skip_collections=True)

    def clone_data_from_production_service(self, base_url: str) -> dict:
        try:
            req = urllib.request.Request(
                f"{base_url}/api/v1/data/export",
                headers={"Accept": "application/x-tar+gzip"},
            )
            with urllib.request.urlopen(req, timeout=60) as res:
                blob = res.read()
                if res.headers.get("Content-Encoding") == "gzip":
                    blob = gzip.decompress(blob)
        except Exception:  # noqa: BLE001 - network failure => clean error
            logger.exception("Failed to reach the production environment")
            return {
                "isSuccess": False,
                "message": (
                    "Failed to reach the KMamiz production environment. "
                    "No response received."
                ),
            }
        try:
            pairs = self.read_tgz(blob)
            self.import_data_from_production_environment(pairs)
            return {"isSuccess": True, "message": "ok"}
        except Exception:  # noqa: BLE001 - malformed snapshot => clean error
            logger.exception("Failed to clone data from production service")
            return {
                "isSuccess": False,
                "message": (
                    "An error occurred while cloning data from the KMamiz "
                    "production service. See the simulator logs for more "
                    "information."
                ),
            }
