"""Round-robin partial cache->store sync.

Parity with KMamiz src/services/DispatchStorage.ts: each dispatch
tick flushes ONE store-backed cache (alphabetical rotation) so the periodic
write load is spread out; syncAll() flushes everything at shutdown. The
boolean-lock + spin-wait of the reference becomes a real threading.Lock.

A copy of kmamiz_tpu/server/dispatch.py, importing the port's modules.
"""
from __future__ import annotations

import logging
import threading
from typing import List

from kmamiz_tpu_torch.server.cache import DataCache

logger = logging.getLogger("kmamiz_tpu_torch.dispatch")


class DispatchStorage:
    def __init__(self, cache: DataCache) -> None:
        self._cache = cache
        # reentrant: import_data holds paused() around a registry swap
        # that itself ends in sync_all()
        self._lock = threading.RLock()
        self._sync_type = 0

    @property
    def sync_strategies(self) -> List:
        entries = [
            (name, c.sync)
            for name, c in self._cache.get_all().items()
            if c.sync is not None
        ]
        entries.sort(key=lambda e: e[0])
        return entries

    def sync(self) -> None:
        """Flush the next cache in rotation (one per dispatch tick). A
        failing flush logs and leaves the rotation intact — the cache
        retries on its next turn."""
        strategies = self.sync_strategies
        if not strategies:
            return
        with self._lock:
            self._sync_type = (self._sync_type + 1) % len(strategies)
            name, sync_fn = strategies[self._sync_type]
            try:
                sync_fn()
            except Exception:  # noqa: BLE001 - one cache must not wedge the cron
                logger.exception("dispatch sync of %s failed", name)

    def paused(self):
        """Hold the sync lock across a multi-step state swap: the import
        path clears the store and rebuilds the cache registry, and a
        dispatch tick interleaving mid-swap would flush a PRE-import
        cache into the freshly cleared store, resurrecting old documents. Usage: `with ctx.dispatch.paused(): ...`."""
        return self._lock

    def sync_all(self) -> None:
        """Flush every cache (graceful-shutdown path). Per-cache error
        isolation: one failing flush (e.g. a store rejecting an
        oversized document) must not abort the loop and silently drop
        every cache sorted after it."""
        with self._lock:
            for name, sync_fn in self.sync_strategies:
                try:
                    sync_fn()
                except Exception:  # noqa: BLE001 - flush the rest regardless
                    logger.exception("shutdown sync of %s failed", name)
