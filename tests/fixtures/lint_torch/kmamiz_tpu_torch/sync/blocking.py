"""Seeded violation: a sleep while holding the module lock — every
other thread touching the counter stalls for the full sleep."""
import threading
import time

_lock = threading.Lock()
_beats = []


def heartbeat():
    with _lock:
        _beats.append(1)
        time.sleep(0.01)  # EXPECT: blocking-call-under-lock
