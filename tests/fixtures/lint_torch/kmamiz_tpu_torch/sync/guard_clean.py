"""Clean twin of guard.py: every `_routes` access — writers and the
reader — holds the same `_lock`."""
import threading


class Router:
    def __init__(self):
        self._lock = threading.Lock()
        self._routes = {}

    def add(self, key, worker):
        with self._lock:
            self._routes[key] = worker

    def drop(self, key):
        with self._lock:
            self._routes.pop(key, None)

    def peek(self, key):
        with self._lock:
            return self._routes.get(key)
