"""Clean twin of blocking.py: the sleep happens outside the critical
section, so the lock is held only for the list append."""
import threading
import time

_lock = threading.Lock()
_beats = []


def heartbeat():
    with _lock:
        _beats.append(1)
    time.sleep(0.01)
