"""Seeded violation: `_routes` is guarded by `_lock` at most access
sites, but one reader holds the unrelated `_aux` lock instead — that
lock orders nothing against the writers."""
import threading


class Router:
    def __init__(self):
        self._lock = threading.Lock()
        self._aux = threading.Lock()
        self._routes = {}

    def add(self, key, worker):
        with self._lock:
            self._routes[key] = worker

    def drop(self, key):
        with self._lock:
            self._routes.pop(key, None)

    def peek(self, key):
        with self._aux:
            return self._routes.get(key)  # EXPECT: inconsistent-guard
