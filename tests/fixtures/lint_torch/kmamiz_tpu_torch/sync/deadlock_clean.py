"""Clean twin of deadlock.py: both blocking paths honour the same
global acquisition order (ingest before publish), so the graph is
acyclic; the one reverse-order nest only ever TRIES the inner lock."""
import threading

_ingest_lock = threading.Lock()
_publish_lock = threading.Lock()


def ingest_then_publish():
    with _ingest_lock:
        with _publish_lock:
            pass


def publish_after_ingest():
    with _ingest_lock:
        with _publish_lock:
            pass


def try_reverse_is_fine():
    # reverse-order nest, but the inner lock is only TRIED: a failed
    # try-lock backs off instead of waiting, so this edge cannot close
    # a deadlock cycle
    with _publish_lock:
        if _ingest_lock.acquire(blocking=False):
            try:
                pass
            finally:
                _ingest_lock.release()
