"""graftlint fixture — shared-state locking discipline in server/."""
import threading

_lock = threading.Lock()
_CACHE = {}
_EVENTS = []


def record(key, value):
    _CACHE[key] = value  # EXPECT: unguarded-shared-state


def record_append(evt):
    _EVENTS.append(evt)  # EXPECT: unguarded-shared-state


def record_under_lock(key, value):
    with _lock:
        _CACHE[key] = value  # clean: lock held


def _append_locked(evt):
    _EVENTS.append(evt)  # clean: *_locked helper contract


def record_suppressed(key, value):
    _CACHE[key] = value  # graftlint: disable=unguarded-shared-state
