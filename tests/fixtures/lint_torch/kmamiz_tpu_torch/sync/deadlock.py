"""Seeded violation: two threads acquire the same pair of locks in
opposite orders — the acquisition-order graph has a 2-cycle."""
import threading

_ingest_lock = threading.Lock()
_publish_lock = threading.Lock()


def ingest_then_publish():
    with _ingest_lock:
        with _publish_lock:  # EXPECT: lock-order-cycle
            pass


def publish_then_ingest():
    with _publish_lock:
        with _ingest_lock:
            pass
