"""In-memory cache registry: the live state of the system.

A copy of kmamiz_tpu/server/cache.py (KMamiz src/services/DataCache.ts and
classes/Cacheable/Cacheable.ts): named caches with optional init (load
from store at startup) and sync (flush to store) hooks, import/export for
snapshots, and simulator mode disabling persistence hooks. The port has
no store yet, so its caches set no hooks.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


class Cacheable:
    can_export: bool = True

    def __init__(self, name: str, init_data: Any = None) -> None:
        self._name = name
        self._data = init_data
        self._init: Optional[Callable[[], None]] = None
        self._sync: Optional[Callable[[], None]] = None
        self._last_update = time.time() * 1000
        # monotonic change counter: bumps on every set_data/clear, so
        # derived caches (e.g. the labeled dependency view) can key
        # skip-if-unchanged checks on it instead of re-deriving per read
        self._version = 0
        # serializes compound read-modify-write updates (tag/label CRUD
        # rebuilds a list from get_data and set_datas it back). The
        # reference is safe on Node's single event loop; this port
        # serves every request on its own thread, where two concurrent
        # updates would silently drop one (review r5). Plain get/set
        # stays lock-free: _data swaps are atomic under the GIL.
        self._update_lock = threading.RLock()

    @property
    def name(self) -> str:
        return self._name

    @property
    def last_update(self) -> float:
        return self._last_update

    @property
    def version(self) -> int:
        return self._version

    @property
    def init(self) -> Optional[Callable[[], None]]:
        return self._init

    @property
    def sync(self) -> Optional[Callable[[], None]]:
        return self._sync

    def _set_init(self, f: Callable[[], None], simulator_mode: bool = False) -> None:
        self._init = (lambda: None) if simulator_mode else f

    def _set_sync(self, f: Callable[[], None], simulator_mode: bool = False) -> None:
        self._sync = (lambda: None) if simulator_mode else f

    def get_data(self, *args: Any) -> Any:
        return self._data

    def set_data(self, update: Any, *args: Any) -> None:
        self._touch()
        self._data = update

    def clear(self) -> None:
        self._touch()
        self._data = None

    def _touch(self) -> None:
        self._last_update = time.time() * 1000
        self._version += 1

    def to_json(self) -> Any:
        data = self._data
        if hasattr(data, "to_json"):
            return data.to_json()
        if isinstance(data, list):
            return [
                d.to_json() if hasattr(d, "to_json") else d for d in data
            ]
        return data


class DataCache:
    """Registry of named Cacheables (reference DataCache.ts)."""

    _instance: Optional["DataCache"] = None

    @classmethod
    def get_instance(cls) -> "DataCache":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @classmethod
    def reset_instance(cls) -> None:
        cls._instance = None

    def __init__(self) -> None:
        self._caches: List[Cacheable] = []
        self._cache_map: Dict[str, Cacheable] = {}

    def register(self, caches: List[Cacheable]) -> None:
        for c in caches:
            self._cache_map[c.name] = c
        self._caches = list(self._cache_map.values())

    def get_all(self) -> Dict[str, Cacheable]:
        return self._cache_map

    def get(self, name: str) -> Cacheable:
        return self._cache_map[name]

    def load_base_data(self) -> None:
        for c in self._caches:
            if c.init:
                c.init()

    def clear(self) -> None:
        self._caches = []
        self._cache_map.clear()

    def export(self) -> List[Tuple[str, Any]]:
        return [(c.name, c.to_json()) for c in self._caches if c.can_export]

    def import_data(
        self,
        caches: List[Tuple[str, Any]],
        factory: Callable[[str, Any], Optional[Cacheable]],
    ) -> None:
        self.clear()
        rebuilt = []
        for name, init in caches:
            cache = factory(name, init)
            if cache is not None:
                rebuilt.append(cache)
        self.register(rebuilt)
