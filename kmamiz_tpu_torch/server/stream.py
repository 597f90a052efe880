"""The overlapped micro-tick pipeline (KMAMIZ_STREAM).

Counterpart of kmamiz_tpu/server/stream.py over the port's
prepare_tick / merge_prepared / finish_tick. The serial tick runs parse
-> merge -> score as one wall; this engine pipelines across tick windows:
while window N merges and scores on the device, window N+1 parses on the
host.

    producer thread    |  caller thread (consumer)
    -------------------+---------------------------------
    prepare_tick(N+1)  |  merge_prepared(N)
      parse / dedup    |  graph.stage_fence()   <- hand-off
      WAL append       |  finish_tick(N)        <- score/serve
      span batch       |

Why it gives the serial tick's results (tests/test_torch_stream.py holds
it to the JAX package's contract, with device stats off):

- every endpoint interning happens inside prepare_tick, which the
  producer runs strictly in request order: ids are the serial path's;
- the WAL appends and the dedup-map updates live in prepare_tick too;
- the merge side only looks up interner state (merge_window_edges
  returns False before any mutation on a miss), under the store's lock;
- merges run on the consumer in order, and `stage_fence()` retires every
  upload and staged merge before the score stage reads the graph.

The watchdog is not weakened: an overrunning micro-tick trips with the
reason ``stream-overrun``, and the deadline's env read is cached per
stream epoch (EPOCH_TICKS micro-ticks). ``KMAMIZ_STREAM=0`` (the
default) keeps the serial tick. The hand-off queue holds DEPTH prepared
ticks. Both are the JAX defaults; an engine takes others as arguments.

Both paths hold the processor's tick_lock, as collect() does, so a
scheduled tick and a stream never interleave.

Each micro-tick's finish_tick observes its arrival-to-visible wall on the
telemetry's freshness plane (telemetry/freshness.py), stamped when its
prepare stage started: under run_stream, prepare(N+1) overlaps merge(N),
so the plane sees the overlap. A micro-tick opens no span trace of its
own, as in the JAX engine.
"""
from __future__ import annotations

import queue
import threading
from typing import List, Sequence

from kmamiz_tpu_torch.config import stream_enabled  # noqa: F401 - the DP server's switch

#: the watchdog's trip reason for an overrunning micro-tick
REASON_STREAM_OVERRUN = "stream-overrun"

#: prepared ticks the hand-off queue holds (clamped to [1, MAX_DEPTH])
DEPTH = 2
MAX_DEPTH = 8
#: micro-ticks per stream epoch: how often the watchdog reads
#: KMAMIZ_TICK_DEADLINE_MS (floor 1)
EPOCH_TICKS = 32


_stats_lock = threading.Lock()
_stats = {"micro_ticks": 0, "streams": 0, "fences": 0, "queue_high_water": 0}


def stats() -> dict:
    with _stats_lock:
        return dict(_stats)


def _note(key: str, value: int = 1, high_water: bool = False) -> None:
    with _stats_lock:
        _stats[key] = max(_stats[key], value) if high_water else _stats[key] + value


def reset_for_tests() -> None:
    with _stats_lock:
        for key in _stats:
            _stats[key] = 0


class StreamEngine:
    """Micro-tick driver for one DataProcessor.

    `collect(request)` is the DP server's entry: the serial tick's stages
    with the explicit stage fence. `run_stream(requests)` drives a known
    request sequence with the producer/consumer overlap."""

    def __init__(self, processor, watchdog=None, depth: int = DEPTH, epoch_ticks: int = EPOCH_TICKS) -> None:
        self.processor = processor
        self.watchdog = watchdog
        self.depth = max(1, min(MAX_DEPTH, depth))
        self.epoch_ticks = max(1, epoch_ticks)
        self._tick_no = 0
        self._epoch_lock = threading.Lock()

    def note_micro_tick(self) -> int:
        """Count one micro-tick; at every epoch boundary (the first tick
        included) refresh the watchdog's cached deadline."""
        with self._epoch_lock:
            boundary = self._tick_no % self.epoch_ticks == 0
            self._tick_no += 1
            n = self._tick_no
        _note("micro_ticks")
        if boundary and self.watchdog is not None:
            self.watchdog.begin_stream_epoch()
        return n

    def collect(self, request: dict) -> dict:
        """One micro-tick, in the serial tick's stage order with the
        merge -> score fence. The epoch accounting is the driver's (the
        DP server calls note_micro_tick before the watchdog reads its
        deadline)."""
        proc = self.processor
        with proc.tick_lock:
            prep = proc.prepare_tick(request)
            proc.merge_prepared(prep)
            proc.graph.stage_fence()
            _note("fences")
            return proc.finish_tick(prep)

    def run_stream(self, requests: Sequence[dict]) -> List[dict]:
        """Drive the request sequence through the pipeline. Responses come
        back in request order; the graph and the WAL are those of the same
        sequence through the serial tick."""
        proc = self.processor
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded hand-off that notices the consumer's death (a
            # plain blocking put would hang with the queue full)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                for request in requests:
                    # parse/dedup/WAL/intern in request order on this one
                    # thread: the ordering half of the contract
                    if not put(("tick", proc.prepare_tick(request))):
                        return
            except BaseException as err:  # noqa: BLE001 - re-raised by the consumer
                put(("error", err))
                return
            put(("end", None))

        responses: List[dict] = []
        with proc.tick_lock:
            producer = threading.Thread(target=produce, name="kmamiz-stream-prepare", daemon=True)
            producer.start()
            _note("streams")
            try:
                while True:
                    _note("queue_high_water", q.qsize(), high_water=True)
                    tag, payload = q.get()
                    if tag == "end":
                        break
                    if tag == "error":
                        raise payload
                    self.note_micro_tick()
                    proc.merge_prepared(payload)
                    proc.graph.stage_fence()
                    _note("fences")
                    responses.append(proc.finish_tick(payload))
            finally:
                stop.set()
                producer.join(timeout=5.0)
                if self.watchdog is not None:
                    self.watchdog.end_stream_epoch()
        return responses


def engine_for(processor, watchdog=None) -> StreamEngine:
    """The processor's engine, attached on first use; a watchdog given
    later fills an engine that has none."""
    eng = getattr(processor, "_stream_engine", None)
    if eng is None:
        eng = StreamEngine(processor, watchdog=watchdog)
        processor._stream_engine = eng
    elif watchdog is not None and eng.watchdog is None:
        eng.watchdog = watchdog
    return eng
