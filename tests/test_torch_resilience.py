"""The port's resilience layer against the JAX package, on the CPU.

Both packages parse with their own native library. The cases of
tests/test_resilience.py, held to kmamiz_tpu:

- the quarantine (on by default in both): every chaos fixture and every
  `mutate_payload` kind gets JAX's reason code, a zero-span summary equal
  to JAX's, one file in the quarantine directory and an untouched graph;
  a poisoned stream goes on past the poison; a chaos run's graph equals
  the clean chunks' (equal graph signatures, exact); KMAMIZ_QUARANTINE=0
  restores the ValueError;
- the WAL: the JAX segment format byte for byte, torn tails, rotation,
  v1 segments, kind bytes; a WAL that either package wrote replays in
  the other to an equal graph signature; a kill between the append and
  the merge replays to the graph of a run that never crashed;
- the watchdog and the DP server's stale serving: passthrough when off,
  deadline trips with the late result delivered, tick-in-flight without
  blocking on a straggler's tick lock, and a faulted or overrun tick
  answered with the last good payload marked stale (500/503 only before
  the first good tick), as the JAX server answers;
- the counters of resilience/metrics.py (job streaks, the summary).
"""
from __future__ import annotations

import json
import random
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib
from pathlib import Path

import pytest

from kmamiz_tpu.resilience import chaos as jax_chaos
from kmamiz_tpu.resilience import quarantine as jax_quarantine
from kmamiz_tpu.resilience.chaos import graph_signature as jax_signature
from kmamiz_tpu.resilience.wal import IngestWAL as JaxWAL
from kmamiz_tpu.server.processor import DataProcessor as JaxProcessor
from kmamiz_tpu_torch.core import wire
from kmamiz_tpu_torch.graph.store import graph_signature
from kmamiz_tpu_torch.resilience import breaker, chaos, metrics, quarantine
from kmamiz_tpu_torch.resilience.wal import KIND_COLUMNAR, KIND_JSON, IngestWAL
from kmamiz_tpu_torch.resilience.watchdog import (
    REASON_DEADLINE,
    REASON_FAULT,
    REASON_IN_FLIGHT,
    TickDeadlineExceeded,
    TickWatchdog,
)
from kmamiz_tpu_torch.server.dp_server import DataProcessorServer
from kmamiz_tpu_torch.server.processor import DataProcessor

CHAOS_FIXTURES = Path(__file__).parent / "fixtures" / "chaos"


@pytest.fixture(autouse=True)
def _port_state():
    """The port's process-wide registries start and end clean."""
    for mod in (breaker, metrics, quarantine):
        mod.reset_for_tests()
    yield
    for mod in (breaker, metrics, quarantine):
        mod.reset_for_tests()


def mk_span(tid, sid, parent=None, svc="svc", url=None):
    return {
        "traceId": tid,
        "id": sid,
        "parentId": parent,
        "kind": "SERVER",
        "name": f"{svc}.ns.svc.cluster.local:80/*",
        "timestamp": 1_700_000_000_000_000,
        "duration": 1000,
        "tags": {
            "http.method": "GET",
            "http.status_code": "200",
            "http.url": url or f"http://{svc}.ns/api",
            "istio.canonical_revision": "v1",
            "istio.canonical_service": svc,
            "istio.mesh_id": "cluster.local",
            "istio.namespace": "ns",
        },
    }


def clean_chunks(n_traces=24, per_chunk=2, prefix="t"):
    groups = []
    for t in range(n_traces):
        tid = f"{prefix}{t}"
        parent = mk_span(tid, f"{tid}p")
        child = mk_span(
            tid, f"{tid}c", parent=f"{tid}p", svc=f"down{t % 5}", url=f"http://down{t % 5}.ns/api/{t % 3}"
        )
        groups.append([parent, child])
    return [json.dumps(groups[i : i + per_chunk]).encode() for i in range(0, len(groups), per_chunk)]


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """Separate quarantine directories: the port's default quarantine binds
    on its first diversion, the JAX one on its own (the JAX conftest
    resets it before each test)."""
    out = {"port": tmp_path / "port-q", "jax": tmp_path / "jax-q"}

    def use(which):
        monkeypatch.setenv("KMAMIZ_QUARANTINE_DIR", str(out[which]))

    out["use"] = use
    return out


def _processors(size_cap: int = quarantine.MAX_PAYLOAD_BYTES):
    """A port and a JAX processor; the port's trace-bomb cap is its
    argument, the JAX one's KMAMIZ_INGEST_MAX_BYTES, which the tests that
    pass a cap set to the same value."""
    return (
        DataProcessor(
            trace_source=lambda *a: [], device="cpu", use_device_stats=False, max_payload_bytes=size_cap
        ),
        JaxProcessor(trace_source=lambda *a: [], use_device_stats=False),
    )


def _without_ms(summary):
    return {k: v for k, v in summary.items() if k != "ms"}


def _files(directory):
    return sorted(p.name.split("-", 2)[2] for p in Path(directory).glob("*.bin"))


# -- the quarantine ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["truncated-json", "garbage-utf8", "schema-drift", "trace-bomb", "parse-error"])
def test_fixture_corpus_classification_matches_jax(name, monkeypatch):
    monkeypatch.setenv("KMAMIZ_INGEST_MAX_BYTES", "4096")
    raw = (CHAOS_FIXTURES / f"{name}.bin").read_bytes()
    want = jax_quarantine.classify_payload(raw)
    assert quarantine.classify_payload(raw, 4096) == want
    assert want == (None if name == "parse-error" else name)


@pytest.mark.parametrize("name", ["truncated-json", "garbage-utf8", "schema-drift", "trace-bomb"])
def test_fixture_corpus_quarantined_as_jax(name, monkeypatch, dirs):
    """Repair (a): with KMAMIZ_QUARANTINE unset, a malformed payload is
    diverted with JAX's reason code and summary, not raised."""
    monkeypatch.delenv("KMAMIZ_QUARANTINE", raising=False)
    monkeypatch.setenv("KMAMIZ_INGEST_MAX_BYTES", "4096")
    raw = (CHAOS_FIXTURES / f"{name}.bin").read_bytes()
    port, ref = _processors(4096)
    before = graph_signature(port.graph)
    dirs["use"]("port")
    got = port.ingest_raw_window(raw)
    dirs["use"]("jax")
    want = ref.ingest_raw_window(raw)
    assert _without_ms(got) == _without_ms(want)
    assert got["quarantined"] == 1 and got["spans"] == 0 and got["reason"] == name
    assert graph_signature(port.graph) == before
    assert len(port.graph.interner.endpoints) == 0 and not port._processed
    assert _files(dirs["port"]) == _files(dirs["jax"]) == [f"{name}.bin"]
    (payload_file,) = dirs["port"].glob("*.bin")
    assert payload_file.read_bytes() == raw
    meta = json.loads(payload_file.with_suffix(".meta.json").read_text())
    assert (meta["reason"], meta["source"], meta["bytes"]) == (name, "ingest_raw_window", len(raw))
    stats = quarantine.quarantine_stats()
    assert stats["byReason"] == {name: 1} == jax_quarantine.quarantine_stats()["byReason"]
    assert metrics.get("quarantined") == 1 and metrics.get(f"quarantined.{name}") == 1


def test_a_parser_rejection_is_a_parse_error_as_in_jax(monkeypatch, dirs):
    """A structurally sound payload that the span parser still rejects
    lands as parse-error in both packages (the parsers are stubbed to
    reject it: the real ones salvage the fixture)."""
    from kmamiz_tpu import native as jax_native
    from kmamiz_tpu.core import spans as jax_spans
    from kmamiz_tpu_torch.server import processor as port_processor

    monkeypatch.setattr(port_processor, "raw_spans_to_batch", lambda raw, **kw: None)
    monkeypatch.setattr(jax_spans, "raw_spans_to_batch", lambda raw, **kw: None)
    monkeypatch.setattr(jax_native, "available", lambda: True)
    raw = (CHAOS_FIXTURES / "parse-error.bin").read_bytes()
    port, ref = _processors()
    dirs["use"]("port")
    got = port.ingest_raw_window(raw)
    dirs["use"]("jax")
    want = ref.ingest_raw_window(raw)
    assert _without_ms(got) == _without_ms(want)
    assert got["reason"] == quarantine.REASON_PARSE_ERROR
    assert _files(dirs["port"]) == ["parse-error.bin"]


@pytest.mark.parametrize("kind", ["truncate", "corrupt", "schema", "bomb"])
def test_each_mutation_kind_quarantines_as_jax(kind, monkeypatch, dirs):
    monkeypatch.setenv("KMAMIZ_INGEST_MAX_BYTES", "4096")
    clean = clean_chunks(n_traces=2, per_chunk=2)[0]
    raw = chaos.mutate_payload(clean, kind, random.Random(7))
    assert raw == jax_chaos.mutate_payload(clean, kind, random.Random(7))
    port, ref = _processors(4096)
    port.ingest_raw_window(clean)
    ref.ingest_raw_window(clean)
    before = graph_signature(port.graph)
    dirs["use"]("port")
    got = port.ingest_raw_window(raw)
    dirs["use"]("jax")
    want = ref.ingest_raw_window(raw)
    assert _without_ms(got) == _without_ms(want)
    assert got["reason"] == {
        "truncate": "truncated-json",
        "corrupt": "garbage-utf8",
        "schema": "schema-drift",
        "bomb": "trace-bomb",
    }[kind]
    assert graph_signature(port.graph) == before == jax_signature(ref.graph)
    assert _files(dirs["port"]) == [f"{got['reason']}.bin"]


def test_quarantine_off_restores_the_abort(monkeypatch):
    monkeypatch.setenv("KMAMIZ_QUARANTINE", "0")
    raw = (CHAOS_FIXTURES / "truncated-json.bin").read_bytes()
    for dp in _processors():
        with pytest.raises(ValueError):
            dp.ingest_raw_window(raw)
    assert quarantine.quarantine_stats()["count"] == 0


def test_chaos_run_equals_the_clean_chunks(monkeypatch, dirs):
    """A chaos run's graph equals ingesting only the untouched chunks, in
    the window path and the stream, and equals JAX's chaos run."""
    monkeypatch.setenv("KMAMIZ_INGEST_MAX_BYTES", "4000")
    chunks = clean_chunks()
    delivered, clean_indices = chaos.chaos_chunks(chunks, chaos.FaultPlan(seed=3))
    assert (delivered, clean_indices) == jax_chaos.chaos_chunks(chunks, jax_chaos.FaultPlan(seed=3))
    poisoned = len(delivered) - len(clean_indices)
    assert 0 < len(clean_indices) < len(chunks)
    dirs["use"]("port")
    window, ref = _processors(4000)
    quarantined = sum(window.ingest_raw_window(raw).get("quarantined", 0) for raw in delivered)
    streamed = DataProcessor(trace_source=lambda *a: [], device="cpu", max_payload_bytes=4000)
    summary = streamed.ingest_raw_stream(iter(delivered))
    clean = DataProcessor(trace_source=lambda *a: [], device="cpu", max_payload_bytes=4000)
    for i in clean_indices:
        assert clean.ingest_raw_window(chunks[i]).get("quarantined", 0) == 0
    dirs["use"]("jax")
    for raw in delivered:
        ref.ingest_raw_window(raw)
    assert quarantined == summary["quarantined"] == poisoned
    assert summary["chunks"] == len(clean_indices)
    want = graph_signature(clean.graph)
    assert graph_signature(window.graph) == graph_signature(streamed.graph) == want == jax_signature(ref.graph)
    assert quarantine.quarantine_stats()["count"] == 2 * poisoned


def test_stream_goes_on_past_a_poisoned_chunk_as_jax(dirs):
    chunks = clean_chunks(n_traces=12, per_chunk=3, prefix="s")
    chunks.insert(2, b'[[{"traceId": "x", "id": ')
    port, ref = _processors()
    dirs["use"]("port")
    got = port.ingest_raw_stream(iter(chunks), depth=1)
    dirs["use"]("jax")
    want = ref.ingest_raw_stream(iter(chunks), depth=1)
    keys = ("spans", "traces", "chunks", "quarantined", "endpoints", "edges")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["quarantined"] == 1 and got["chunks"] == 4
    assert graph_signature(port.graph) == jax_signature(ref.graph)


def test_quarantine_eviction_is_bounded(tmp_path):
    q = quarantine.Quarantine(directory=str(tmp_path / "q"), max_bytes=10_000, max_files=3)
    for i in range(6):
        q.put(bytes([i]) * 100, quarantine.REASON_TRUNCATED_JSON)
        time.sleep(0.002)  # distinct millisecond prefixes
    stats = q.stats()
    assert stats["files"] == 3 and stats["count"] == 6
    assert stats["byReason"] == {quarantine.REASON_TRUNCATED_JSON: 6}


def test_fault_plan_draws_equal_jax():
    for seed in (0, 3, 11):
        assert chaos.FaultPlan(seed).payload_faults(40) == jax_chaos.FaultPlan(seed).payload_faults(40)
        assert chaos.FaultPlan(seed).upstream_actions(40) == jax_chaos.FaultPlan(seed).upstream_actions(40)
    up = chaos.ChaosUpstream(lambda: "ok", ["fail", "delay", "ok"], sleep=lambda s: None)
    with pytest.raises(ConnectionError):
        up()
    assert up() == up() == up() == "ok"
    assert up.calls == ["fail", "delay", "ok", "ok"]


# -- the WAL --------------------------------------------------------------------


def test_wal_append_replay_roundtrip_and_format_equal_jax(tmp_path):
    payloads = [f"payload-{i}".encode() for i in range(5)] + [wire.encode_groups([[mk_span("c", "s")]])]
    port, ref = IngestWAL(str(tmp_path / "port")), JaxWAL(str(tmp_path / "jax"))
    for p in payloads:
        port.append(p)
        ref.append(p)
    port.close()
    ref.close()
    assert (tmp_path / "port" / "000000.wal").read_bytes() == (tmp_path / "jax" / "000000.wal").read_bytes()
    assert list(IngestWAL(str(tmp_path / "port")).replay()) == payloads
    assert [k for k, _ in IngestWAL(str(tmp_path / "jax")).replay_records()] == [KIND_JSON] * 5 + [KIND_COLUMNAR]
    assert metrics.get("walRecords") == len(payloads)


def test_wal_replay_stops_at_torn_tail(tmp_path):
    wal = IngestWAL(str(tmp_path / "wal"))
    wal.append(b"alpha")
    wal.append(b"beta")
    wal.close()
    (segment,) = sorted((tmp_path / "wal").glob("*.wal"))
    segment.write_bytes(segment.read_bytes()[:-3])  # kill -9 mid-write
    assert list(IngestWAL(str(tmp_path / "wal")).replay()) == [b"alpha"]
    assert list(JaxWAL(str(tmp_path / "wal")).replay()) == [b"alpha"]


def test_wal_rotation_keeps_newest_segments(tmp_path):
    wal = IngestWAL(str(tmp_path / "wal"), segment_bytes=64, keep_segments=2)
    for i in range(12):
        wal.append(f"record-{i:02d}-{'x' * 40}".encode())
    wal.close()
    assert len(sorted((tmp_path / "wal").glob("*.wal"))) <= 2
    replayed = list(IngestWAL(str(tmp_path / "wal"), segment_bytes=64).replay())
    assert replayed and replayed[-1].startswith(b"record-11")
    assert replayed == list(JaxWAL(str(tmp_path / "wal"), segment_bytes=64).replay())


def test_wal_v1_segment_back_compat(tmp_path):
    wal_dir = tmp_path / "wal"
    wal_dir.mkdir()
    old = b"legacy-payload"
    (wal_dir / "000000.wal").write_bytes(struct.pack("<II", len(old), zlib.crc32(old)) + old)
    wal = IngestWAL(str(wal_dir))
    assert list(wal.replay_records()) == [(KIND_JSON, old)]
    wal.append(b"new-payload")
    wal.close()
    assert len(sorted(wal_dir.glob("*.wal"))) == 2  # v1 history untouched
    assert list(IngestWAL(str(wal_dir)).replay()) == [old, b"new-payload"]
    assert list(JaxWAL(str(wal_dir)).replay()) == [old, b"new-payload"]


def test_wal_kind_byte_contradiction_stops_replay(tmp_path):
    wal = IngestWAL(str(tmp_path / "wal"))
    wal.append(b"first-good")
    wal.close()
    (segment,) = sorted((tmp_path / "wal").glob("*.wal"))
    lie = b"not-a-columnar-frame"
    segment.write_bytes(segment.read_bytes() + struct.pack("<IIB", len(lie), zlib.crc32(lie), KIND_COLUMNAR) + lie)
    assert list(IngestWAL(str(tmp_path / "wal")).replay()) == [b"first-good"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_wal_replays_in_the_other_package(writer, monkeypatch, tmp_path):
    """A WAL written by one package's raw ingest and tick replays in the
    other's processor to an equal graph signature."""
    monkeypatch.setenv("KMAMIZ_WAL", "1")
    monkeypatch.setenv("KMAMIZ_WAL_DIR", str(tmp_path / "wal"))
    chunks = clean_chunks(prefix="x")
    tick_groups = json.loads(clean_chunks(n_traces=4, per_chunk=4, prefix="tick")[0])
    source = lambda lb, t, lim: tick_groups  # noqa: E731
    make = {
        "jax": lambda: JaxProcessor(trace_source=source, use_device_stats=False),
        "port": lambda: DataProcessor(trace_source=source, device="cpu"),
    }
    sig = {"jax": jax_signature, "port": graph_signature}
    reader = "port" if writer == "jax" else "jax"
    crashing = make[writer]()
    for raw in chunks[:6]:
        crashing.ingest_raw_window(raw)
    crashing.ingest_raw_stream(iter(chunks[6:9]))
    crashing.collect({"uniqueId": "w", "time": 0})
    for raw in chunks[9:]:
        crashing.ingest_raw_window(raw)
    want = sig[writer](crashing.graph)
    crashing.wal.close()
    del crashing
    recovered = make[reader]()
    replay = recovered.replay_wal()
    assert replay["replayed"] == len(chunks) + 1 and replay["quarantined"] == 0
    assert sig[reader](recovered.graph) == want


def test_kill_between_wal_append_and_merge_replays_bitexact(monkeypatch, tmp_path):
    chunks = clean_chunks(prefix="w")
    reference = DataProcessor(trace_source=lambda *a: [], device="cpu")
    for raw in chunks:
        reference.ingest_raw_window(raw)
    monkeypatch.setenv("KMAMIZ_WAL", "1")
    monkeypatch.setenv("KMAMIZ_WAL_DIR", str(tmp_path / "wal"))
    crashing = DataProcessor(trace_source=lambda *a: [], device="cpu")
    for raw in chunks[:-1]:
        crashing.ingest_raw_window(raw)
    crashing._wal_append(chunks[-1])  # durably appended, never merged
    del crashing
    recovered = DataProcessor(trace_source=lambda *a: [], device="cpu")
    replay = recovered.replay_wal()
    assert replay == {"replayed": len(chunks), "spans": sum(len(json.loads(c)) * 2 for c in chunks), "quarantined": 0}
    assert graph_signature(recovered.graph) == graph_signature(reference.graph)
    assert metrics.get("walReplays") == 1
    assert recovered.wal.records_appended == 0  # the replay appended nothing


def test_replay_quarantines_a_payload_that_fails_to_parse(monkeypatch, tmp_path, dirs):
    monkeypatch.setenv("KMAMIZ_WAL", "1")
    monkeypatch.setenv("KMAMIZ_WAL_DIR", str(tmp_path / "wal"))
    dirs["use"]("port")
    wal = IngestWAL(str(tmp_path / "wal"))
    wal.append(clean_chunks()[0])
    wal.append(b"[[{")
    wal.close()
    replay = DataProcessor(trace_source=lambda *a: [], device="cpu").replay_wal()
    assert replay == {"replayed": 2, "spans": 4, "quarantined": 1}
    assert _files(dirs["port"]) == ["truncated-json.bin"]


@pytest.mark.parametrize("setting", ["unset", "0", "1"])
def test_wal_switch(setting, monkeypatch, tmp_path):
    if setting == "unset":
        monkeypatch.delenv("KMAMIZ_WAL", raising=False)
    else:
        monkeypatch.setenv("KMAMIZ_WAL", setting)
    monkeypatch.setenv("KMAMIZ_WAL_DIR", str(tmp_path / "wal"))
    dp = DataProcessor(trace_source=lambda *a: [], device="cpu")
    dp.ingest_raw_window(clean_chunks()[0])
    if setting == "1":
        assert dp.wal is not None and dp.wal.records_appended == 1
        assert len(list(IngestWAL(str(tmp_path / "wal")).replay())) == 1
    else:
        assert dp.wal is None and not (tmp_path / "wal").exists()
        assert dp.replay_wal() == {"replayed": 0, "spans": 0, "quarantined": 0}


# -- the watchdog ----------------------------------------------------------------


@pytest.mark.parametrize("setting", ["unset", "0", "5000"])
def test_watchdog_switch(setting, monkeypatch):
    if setting == "unset":
        monkeypatch.delenv("KMAMIZ_TICK_DEADLINE_MS", raising=False)
    else:
        monkeypatch.setenv("KMAMIZ_TICK_DEADLINE_MS", setting)
    watchdog = TickWatchdog()
    assert watchdog.enabled == (setting == "5000")
    caller = threading.get_ident()
    ran_on = []
    assert watchdog.run(lambda: ran_on.append(threading.get_ident()) or 42) == 42
    # off: the tick runs on the caller's thread; on: on the watchdog's
    assert (ran_on[0] == caller) == (setting != "5000")


def test_watchdog_fast_tick_passes_result_and_errors():
    watchdog = TickWatchdog(deadline_ms=5_000)
    assert watchdog.run(lambda: {"ok": True}) == {"ok": True}

    def boom():
        raise RuntimeError("tick fault")

    with pytest.raises(RuntimeError, match="tick fault"):
        watchdog.run(boom)
    assert watchdog.run(lambda: "next") == "next"  # a fault is no overrun


def test_watchdog_deadline_trip_delivers_late_result():
    late, release, delivered = [], threading.Event(), threading.Event()

    def deliver(result):
        late.append(result)
        delivered.set()

    watchdog = TickWatchdog(deadline_ms=50, on_late_result=deliver)
    with pytest.raises(TickDeadlineExceeded) as err:
        watchdog.run(lambda: release.wait(5.0) and "late-graph")
    assert err.value.reason == REASON_DEADLINE
    with pytest.raises(TickDeadlineExceeded) as err:
        watchdog.run(lambda: "never-runs")
    assert err.value.reason == REASON_IN_FLIGHT
    release.set()
    assert delivered.wait(5.0) and late == ["late-graph"]
    assert metrics.watchdog_state()["byReason"] == {REASON_DEADLINE: 1, REASON_IN_FLIGHT: 1}
    assert watchdog.run(lambda: "fresh") == "fresh"


# -- stale serving over HTTP: repair (b) ------------------------------------------


def _post(port: int, unique_id: str):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/",
        data=json.dumps({"uniqueId": unique_id, "lookBack": 30_000, "time": 0}).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


class _Source:
    """A trace source that fails, stalls or serves a fresh window."""

    def __init__(self) -> None:
        self.mode, self.n, self.release = "ok", 0, threading.Event()

    def __call__(self, lb, t, lim):
        if self.mode == "fail":
            raise ConnectionError("upstream down")
        if self.mode == "stall":
            self.release.wait(10.0)
        self.n += 1
        return json.loads(clean_chunks(n_traces=4, per_chunk=4, prefix=f"st{self.n}-")[0])


def _jax_server(processor):
    from kmamiz_tpu.server.dp_server import DataProcessorServer as JaxServer

    return JaxServer(processor, host="127.0.0.1", port=0)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_faulted_tick_serves_the_last_good_payload(package, monkeypatch):
    """Repair (b): a tick that faults after a good tick answers 200 with
    the last good payload marked stale (tick-fault); before the first good
    tick, 500. The same contract in both packages."""
    monkeypatch.delenv("KMAMIZ_TICK_DEADLINE_MS", raising=False)
    source = _Source()
    if package == "port":
        server = DataProcessorServer(DataProcessor(trace_source=source, device="cpu"), host="127.0.0.1", port=0)
    else:
        server = _jax_server(JaxProcessor(trace_source=source, use_device_stats=False))
    server.start()
    try:
        source.mode = "fail"
        status, body, _ = _post(server.port, "first")
        assert status == 500 and "error" in body
        source.mode = "ok"
        status, good, _ = _post(server.port, "good")
        assert status == 200 and "stale" not in good
        source.mode = "fail"
        status, stale, headers = _post(server.port, "faulted")
        assert status == 200
        assert stale["stale"] is True and stale["staleReason"] == REASON_FAULT
        assert stale["uniqueId"] == "faulted" and stale["staleAgeMs"] >= 0
        assert "X-KMamiz-Stale-Age-Ms" in headers
        assert {k: v for k, v in stale.items() if k not in ("uniqueId", "stale", "staleAgeMs", "staleReason")} == {
            k: v for k, v in good.items() if k != "uniqueId"
        }
    finally:
        server.stop()
    if package == "port":
        state = metrics.watchdog_state()
        assert state["byReason"] == {REASON_FAULT: 1} and state["staleServes"] == 1


def test_an_overrun_serves_stale_and_a_straggler_trips_in_flight(monkeypatch):
    """The deadline trips (stale 'deadline'); while the straggler holds the
    processor's tick lock, the next tick trips tick-in-flight at once
    instead of waiting on the lock; the straggler's late result refreshes
    the last good payload."""
    source = _Source()
    dp = DataProcessor(trace_source=source, device="cpu")
    server = DataProcessorServer(dp, host="127.0.0.1", port=0)
    server.start()
    try:
        monkeypatch.delenv("KMAMIZ_TICK_DEADLINE_MS", raising=False)
        status, good, _ = _post(server.port, "good")
        assert status == 200
        good_at = metrics.watchdog_state()["lastGoodAt"]
        monkeypatch.setenv("KMAMIZ_TICK_DEADLINE_MS", "100")
        source.mode = "stall"
        status, stale, _ = _post(server.port, "slow")
        assert status == 200 and stale["staleReason"] == REASON_DEADLINE
        t0 = time.perf_counter()
        status, stale2, _ = _post(server.port, "next")
        assert status == 200 and stale2["staleReason"] == REASON_IN_FLIGHT
        assert time.perf_counter() - t0 < 5.0 and dp.tick_lock.locked()
        source.mode = "ok"
        source.release.set()
        deadline = time.monotonic() + 10
        while dp.tick_lock.locked() and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)  # the late result lands in last_good
        monkeypatch.delenv("KMAMIZ_TICK_DEADLINE_MS")
        source.mode = "fail"
        status, stale3, _ = _post(server.port, "after")
        # the stale payload is now the straggler's
        assert stale3["staleReason"] == REASON_FAULT
        assert metrics.watchdog_state()["lastGoodAt"] > good_at
    finally:
        source.release.set()
        server.stop()


def test_a_deadline_before_any_good_tick_answers_503(monkeypatch):
    monkeypatch.setenv("KMAMIZ_TICK_DEADLINE_MS", "50")
    source = _Source()
    source.mode = "stall"
    server = DataProcessorServer(DataProcessor(trace_source=source, device="cpu"), host="127.0.0.1", port=0)
    server.start()
    try:
        status, body, _ = _post(server.port, "cold")
        assert status == 503 and body["reason"] == REASON_DEADLINE
    finally:
        source.release.set()
        server.stop()


def test_ingest_route_quarantines_a_malformed_payload(dirs):
    dirs["use"]("port")
    server = DataProcessorServer(DataProcessor(trace_source=lambda *a: [], device="cpu"), host="127.0.0.1", port=0)
    server.start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/ingest", data=b'[[{"traceId": ')
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 200
            body = json.loads(resp.read())
        assert body["quarantined"] == 1 and body["reason"] == "truncated-json" and body["spans"] == 0
        assert _files(dirs["port"]) == ["truncated-json.bin"]
    finally:
        server.stop()


# -- the counters -----------------------------------------------------------------


def test_job_failure_streaks_and_reset():
    metrics.job_failed("realtime", RuntimeError("zipkin down"))
    metrics.job_failed("realtime", RuntimeError("zipkin down"))
    state = metrics.job_states()["realtime"]
    assert state["consecutiveFailures"] == 2 and state["totalFailures"] == 2
    assert "zipkin down" in state["lastError"]
    metrics.job_succeeded("realtime")
    state = metrics.job_states()["realtime"]
    assert state["consecutiveFailures"] == 0 and state["totalFailures"] == 2
    metrics.reset_job_streaks(["realtime"])
    assert metrics.job_states() == {}


def test_resilience_summary_shape():
    metrics.incr("ingestDropped")
    metrics.incr("dpFallback", 2)
    breaker.get_breaker("zipkin").record_failure()
    summary = metrics.resilience_summary()
    assert summary["ingestDropped"] == 1 and summary["dpFallback"] == 2
    assert summary["breakers"]["zipkin"]["consecutiveFailures"] == 1
    from kmamiz_tpu.resilience import metrics as jax_metrics

    assert set(summary) == set(jax_metrics.resilience_summary())
    assert set(summary["watchdog"]) == set(jax_metrics.watchdog_state())


def test_scheduler_job_failure_surfaces_in_metrics():
    from kmamiz_tpu_torch.server.scheduler import Job

    fired = threading.Event()

    def flaky_job():
        fired.set()
        raise RuntimeError("job blew up")

    job = Job("flaky", 0.01, flaky_job)
    job.start()
    try:
        assert fired.wait(5.0)
        deadline = time.time() + 5.0
        while time.time() < deadline and not metrics.job_states().get("flaky"):
            time.sleep(0.01)
    finally:
        job.stop()
    state = metrics.job_states()["flaky"]
    assert state["consecutiveFailures"] >= 1 and "job blew up" in state["lastError"]


def test_retries_count_under_the_retriers_name():
    from kmamiz_tpu_torch.resilience.retry import Retrier

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise ConnectionError("blip")
        return "ok"

    assert Retrier("externalDP", attempts=3, sleep=lambda s: None).call(flaky) == "ok"
    assert metrics.get("retry.externalDP") == 1
