"""The port's stream engine (server/stream.py) against the JAX package's
contract, on the CPU.

The cases of tests/test_stream.py, with device stats off in both
packages (the JAX contract's own setting): a request sequence through
`StreamEngine.run_stream`, or micro-tick by micro-tick through
`engine.collect`, answers bit for bit as the serial tick does (the
responses' JSON equal, the `log` free text aside) with an equal graph
signature, at every queue depth, and equal to the JAX package's serial
and streamed answers. The knobs, the watchdog's per-epoch deadline read,
the stream-overrun stale serve over HTTP and the engine's plumbing as in
the JAX file.
"""
from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from kmamiz_tpu.resilience.chaos import graph_signature as jax_signature
from kmamiz_tpu.server import stream as jax_stream
from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor
from kmamiz_tpu_torch import synth
from kmamiz_tpu_torch.graph.store import graph_signature
from kmamiz_tpu_torch.resilience import metrics
from kmamiz_tpu_torch.resilience.watchdog import (
    REASON_IN_FLIGHT,
    TickDeadlineExceeded,
    TickWatchdog,
)
from kmamiz_tpu_torch.server import stream
from kmamiz_tpu_torch.server.processor import DataProcessor


@pytest.fixture(autouse=True)
def _clean():
    stream.reset_for_tests()
    metrics.reset_for_tests()
    yield
    stream.reset_for_tests()
    metrics.reset_for_tests()


def _canon(response: dict) -> str:
    out = dict(response)
    out.pop("log", None)
    return json.dumps(out, sort_keys=True, default=str)


def _feed(n_windows: int, prefix: str, traces: int = 24, spans: int = 4):
    return [
        json.loads(synth.make_raw_window(traces, spans, t_start=i * 10_000, trace_prefix=f"{prefix}{i}"))
        for i in range(n_windows)
    ]


def _requests(n: int, prefix: str):
    return [{"uniqueId": f"{prefix}{i}", "lookBack": 30_000, "time": 1_000_000 + i * 10_000} for i in range(n)]


def _popping_source(feed):
    return lambda _lb, _t, _lim: feed.pop(0)


def _port(feed):
    return DataProcessor(trace_source=_popping_source(feed), device="cpu", use_device_stats=False)


def _jax(feed):
    return JaxProcessor(trace_source=_popping_source(feed), use_device_stats=False)


# -- knobs ------------------------------------------------------------------------


class TestKnobs:
    @pytest.mark.parametrize("raw", [None, "0", "false", "", "1", "true"])
    def test_stream_switch(self, monkeypatch, raw):
        if raw is None:
            monkeypatch.delenv("KMAMIZ_STREAM", raising=False)
        else:
            monkeypatch.setenv("KMAMIZ_STREAM", raw)
        assert stream.stream_enabled() == jax_stream.stream_enabled() == (raw in ("1", "true"))

    @pytest.mark.parametrize("raw", [None, "0", "99", "not-a-number", "5"])
    def test_depth_and_epoch_ticks(self, monkeypatch, raw):
        """The port's engine takes as arguments (defaults DEPTH and
        EPOCH_TICKS) what the JAX engine reads from KMAMIZ_STREAM_DEPTH and
        KMAMIZ_STREAM_EPOCH_TICKS, and clamps them alike."""
        for name in ("KMAMIZ_STREAM_DEPTH", "KMAMIZ_STREAM_EPOCH_TICKS"):
            if raw is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, raw)
        given = {"depth": int(raw), "epoch_ticks": int(raw)} if raw and raw.isdigit() else {}
        engine = stream.StreamEngine(None, **given)
        assert engine.depth == jax_stream.stream_depth()
        assert engine.epoch_ticks == jax_stream.stream_epoch_ticks()

    def test_config_mirrors_stream_knobs(self, monkeypatch):
        """Settings carries the stream's switch, read by the same function
        as the DP server's; the depth and epoch are constants."""
        from kmamiz_tpu_torch.config import Settings

        for raw, want in (("1", True), ("0", False)):
            monkeypatch.setenv("KMAMIZ_STREAM", raw)
            assert Settings().stream_enabled is stream.stream_enabled() is want
        assert not hasattr(Settings(), "stream_depth") and not hasattr(Settings(), "stream_epoch_ticks")


# -- bit-exact parity with the serial tick ------------------------------------------


class TestBitExactParity:
    def test_run_stream_matches_serial_and_jax(self):
        n = 6
        requests = _requests(n, "par")
        serial_dp = _port(_feed(n, "par"))
        serial = [serial_dp.collect(dict(r)) for r in requests]
        stream_dp = _port(_feed(n, "par"))
        streamed = stream.StreamEngine(stream_dp).run_stream([dict(r) for r in requests])
        jax_dp = _jax(_feed(n, "par"))
        jax_streamed = jax_stream.StreamEngine(jax_dp).run_stream([dict(r) for r in requests])
        assert len(streamed) == len(serial) == n
        for got, want, ref in zip(streamed, serial, jax_streamed):
            assert _canon(got) == _canon(want) == _canon(ref)
        assert graph_signature(stream_dp.graph) == graph_signature(serial_dp.graph) == jax_signature(jax_dp.graph)

    def test_collect_micro_tick_matches_serial(self):
        requests = _requests(3, "mic")
        serial_dp = _port(_feed(3, "mic"))
        serial = [serial_dp.collect(dict(r)) for r in requests]
        stream_dp = _port(_feed(3, "mic"))
        engine = stream.engine_for(stream_dp)
        streamed = [engine.collect(dict(r)) for r in requests]
        for got, want in zip(streamed, serial):
            assert _canon(got) == _canon(want)
        assert graph_signature(stream_dp.graph) == graph_signature(serial_dp.graph)

    @pytest.mark.parametrize("depth", [1, 8])
    def test_parity_holds_at_every_depth(self, depth):
        n = 4
        requests = _requests(n, f"dep{depth}-")
        serial_dp = _port(_feed(n, f"dep{depth}-"))
        for r in requests:
            serial_dp.collect(dict(r))
        stream_dp = _port(_feed(n, f"dep{depth}-"))
        stream.StreamEngine(stream_dp, depth=depth).run_stream([dict(r) for r in requests])
        assert graph_signature(stream_dp.graph) == graph_signature(serial_dp.graph)

    def test_the_wal_keeps_the_serial_order(self, monkeypatch, tmp_path):
        """prepare_tick appends each window's kept groups on the producer,
        in request order: the streamed WAL is the serial one, byte for
        byte."""
        from kmamiz_tpu_torch.resilience.wal import IngestWAL

        monkeypatch.setenv("KMAMIZ_WAL", "1")
        n = 4
        requests = _requests(n, "wal")
        monkeypatch.setenv("KMAMIZ_WAL_DIR", str(tmp_path / "serial"))
        serial_dp = _port(_feed(n, "wal"))
        for r in requests:
            serial_dp.collect(dict(r))
        monkeypatch.setenv("KMAMIZ_WAL_DIR", str(tmp_path / "stream"))
        stream_dp = _port(_feed(n, "wal"))
        stream.StreamEngine(stream_dp).run_stream([dict(r) for r in requests])
        serial_dp.wal.close()
        stream_dp.wal.close()
        got = list(IngestWAL(str(tmp_path / "stream")).replay())
        assert len(got) == n and got == list(IngestWAL(str(tmp_path / "serial")).replay())


# -- the watchdog: per-epoch deadline read, stream-overrun --------------------------


class TestWatchdogStreamEpoch:
    def test_mid_epoch_env_change_lands_at_next_boundary(self, monkeypatch):
        monkeypatch.setenv("KMAMIZ_TICK_DEADLINE_MS", "50")
        watchdog = TickWatchdog()
        assert watchdog.begin_stream_epoch() == 50.0
        monkeypatch.setenv("KMAMIZ_TICK_DEADLINE_MS", "75")
        assert watchdog.deadline_ms == 50.0
        assert watchdog.begin_stream_epoch() == 75.0
        watchdog.end_stream_epoch()
        monkeypatch.setenv("KMAMIZ_TICK_DEADLINE_MS", "10")
        assert watchdog.deadline_ms == 10.0

    def test_ctor_pin_beats_epoch_cache(self, monkeypatch):
        monkeypatch.setenv("KMAMIZ_TICK_DEADLINE_MS", "50")
        watchdog = TickWatchdog(deadline_ms=10)
        watchdog.begin_stream_epoch()
        assert watchdog.deadline_ms == 10

    def test_engine_epoch_accounting_drives_the_cache(self, monkeypatch):
        monkeypatch.setenv("KMAMIZ_TICK_DEADLINE_MS", "40")
        watchdog = TickWatchdog()
        engine = stream.StreamEngine(processor=None, watchdog=watchdog, epoch_ticks=2)
        engine.note_micro_tick()  # tick 0: a boundary, caches 40
        monkeypatch.setenv("KMAMIZ_TICK_DEADLINE_MS", "90")
        engine.note_micro_tick()  # tick 1: mid-epoch
        assert watchdog.deadline_ms == 40.0
        engine.note_micro_tick()  # tick 2: the next boundary
        assert watchdog.deadline_ms == 90.0

    def test_overrun_renamed_stream_overrun_in_flight_kept(self):
        watchdog = TickWatchdog(deadline_ms=50)
        release = threading.Event()
        try:
            with pytest.raises(TickDeadlineExceeded) as err:
                watchdog.run(lambda: release.wait(5.0), overrun_reason=stream.REASON_STREAM_OVERRUN)
            assert err.value.reason == stream.REASON_STREAM_OVERRUN == jax_stream.REASON_STREAM_OVERRUN
            with pytest.raises(TickDeadlineExceeded) as err:
                watchdog.run(lambda: "never", overrun_reason=stream.REASON_STREAM_OVERRUN)
            assert err.value.reason == REASON_IN_FLIGHT
            assert metrics.watchdog_state()["byReason"][stream.REASON_STREAM_OVERRUN] == 1
        finally:
            release.set()

    def test_overrun_serves_last_good_with_stream_reason(self, monkeypatch):
        """An overrunning micro-tick over HTTP: 200, the last good payload,
        staleReason stream-overrun."""
        from kmamiz_tpu_torch.server.dp_server import DataProcessorServer

        monkeypatch.setenv("KMAMIZ_STREAM", "1")
        monkeypatch.delenv("KMAMIZ_TICK_DEADLINE_MS", raising=False)
        gate = {"stall_s": 0.0, "n": 0}

        def source(_lb, _t, _lim):
            if gate["stall_s"]:
                time.sleep(gate["stall_s"])
            gate["n"] += 1
            return json.loads(synth.make_raw_window(24, 3, t_start=gate["n"] * 10_000, trace_prefix=f"so{gate['n']}"))

        dp = DataProcessor(trace_source=source, device="cpu")
        # an epoch of one micro-tick: the deadline set below is read at
        # the next tick (the server's engine_for keeps this engine)
        stream.engine_for(dp).epoch_ticks = 1
        server = DataProcessorServer(dp, host="127.0.0.1", port=0)
        server.start()

        def tick(unique_id):
            body = json.dumps({"uniqueId": unique_id, "lookBack": 30_000, "time": int(time.time() * 1000)})
            req = urllib.request.Request(f"http://127.0.0.1:{server.port}/", data=body.encode())
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        try:
            for uid in ("so-warm1", "so-warm2"):
                status, body = tick(uid)
                assert status == 200 and not body.get("stale")
            gate["stall_s"] = 0.5
            monkeypatch.setenv("KMAMIZ_TICK_DEADLINE_MS", "50")
            status, body = tick("so-stalled")
            assert status == 200 and body["stale"] is True
            assert body["staleReason"] == "stream-overrun"
            assert stream.stats()["micro_ticks"] == 3
        finally:
            gate["stall_s"] = 0.0
            server.stop()
            # the abandoned straggler finishes before the next test
            deadline = time.monotonic() + 10
            time.sleep(0.05)
            while dp.tick_lock.locked() and time.monotonic() < deadline:
                time.sleep(0.01)


# -- plumbing ----------------------------------------------------------------------


class TestEnginePlumbing:
    def test_engine_for_attaches_once_and_backfills_watchdog(self):
        dp = DataProcessor(trace_source=lambda *a: [], device="cpu", use_device_stats=False)
        engine = stream.engine_for(dp)
        assert stream.engine_for(dp) is engine and engine.watchdog is None
        watchdog = TickWatchdog(deadline_ms=1_000)
        assert stream.engine_for(dp, watchdog).watchdog is watchdog
        assert stream.engine_for(dp, TickWatchdog()).watchdog is watchdog

    def test_run_stream_propagates_prepare_error(self, monkeypatch):
        dp = DataProcessor(trace_source=lambda *a: [], device="cpu", use_device_stats=False)

        def boom(_request):
            raise RuntimeError("prepare exploded")

        monkeypatch.setattr(dp, "prepare_tick", boom)
        with pytest.raises(RuntimeError, match="prepare exploded"):
            stream.StreamEngine(dp).run_stream(_requests(2, "err"))
        assert not dp.tick_lock.locked()

    def test_module_stats_track_and_reset(self):
        dp = _port(_feed(2, "st"))
        stream.StreamEngine(dp).run_stream(_requests(2, "st"))
        assert stream.stats() == {"micro_ticks": 2, "streams": 1, "fences": 2, "queue_high_water": stream.stats()["queue_high_water"]}
        stream.reset_for_tests()
        assert all(v == 0 for v in stream.stats().values())
