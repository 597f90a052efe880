"""The port's Zipkin client under faults, against the JAX client.

Every fetch of the client (the trace list, the raw fetch, the page
feeder and the service list) is one GET under the `zipkin` retrier and
circuit breaker, as kmamiz_tpu/ingestion/zipkin.py wraps it:

- a dead Zipkin opens the breaker, after which a fetch answers the
  reference's []/None without opening a connection (the stub counts its
  accepts);
- a transient transport error is retried, and counted as `retry.zipkin`;
- after the same fault sequence, both packages' `zipkin` breakers are in
  the same state;
- GET /health's `resilience.breakers` carries the `zipkin` entry.
"""
from __future__ import annotations

import json
import socket
import threading

import pytest

from kmamiz_tpu.ingestion.zipkin import ZipkinClient as JaxZipkinClient
from kmamiz_tpu.resilience import breaker as jax_breaker
from kmamiz_tpu_torch.api.handlers.health import HealthHandler
from kmamiz_tpu_torch.api.router import Request
from kmamiz_tpu_torch.ingestion.zipkin import ZipkinClient
from kmamiz_tpu_torch.resilience import breaker, metrics
from kmamiz_tpu_torch.resilience.breaker import THRESHOLD
from kmamiz_tpu_torch.telemetry.profiling import recorder

TRACES = [[{"traceId": "t1", "id": "s1", "kind": "SERVER", "name": "a"}]]


class ZipkinStub:
    """A TCP server on localhost that closes the first `drops` connections
    at once (a transport error for the client) and answers every later
    request with 200 and `body`. `accepts` counts connections."""

    def __init__(self, drops: int, body: bytes = b"[]") -> None:
        self.drops, self.body, self.accepts = drops, body, 0
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.url = f"http://127.0.0.1:{self.sock.getsockname()[1]}"
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.accepts += 1
            with conn:
                if self.accepts <= self.drops:
                    continue
                conn.recv(65536)
                conn.sendall(
                    b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                    + f"Content-Length: {len(self.body)}\r\nConnection: close\r\n\r\n".encode()
                    + self.body
                )

    def close(self) -> None:
        self.sock.close()


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    """Fresh breakers and counters in both packages; the flight artifacts
    that an opening breaker writes go to the test's directory."""
    monkeypatch.setenv("KMAMIZ_PROF_FLIGHT_DIR", str(tmp_path / "flight"))
    for mod in (breaker, metrics, recorder):
        mod.reset_for_tests()
    jax_breaker.reset_for_tests()
    yield
    for mod in (breaker, metrics, recorder):
        mod.reset_for_tests()


@pytest.fixture
def dead():
    stub = ZipkinStub(drops=1 << 30)
    yield stub
    stub.close()


def _open_breaker(client) -> None:
    """Fetch until the `zipkin` breaker opens: each fetch makes the
    retrier's two attempts, each attempt a failure of the breaker."""
    for _ in range(THRESHOLD):
        assert client.get_trace_list(30_000, 1_000) == []


FETCHES = {
    "trace_list": (lambda c: c.get_trace_list(30_000, 1_000), []),
    "raw": (lambda c: c.get_trace_list_raw(30_000, 1_000), None),
    "pages": (lambda c: list(c.iter_trace_pages_raw(30_000, 1_000, pages=3)), []),
    "services": (lambda c: c.get_services(), []),
}


@pytest.mark.parametrize("fetch", sorted(FETCHES))
def test_a_dead_zipkin_opens_the_breaker_and_later_fetches_connect_nowhere(dead, fetch):
    client = ZipkinClient(dead.url)
    _open_breaker(client)
    assert breaker.get_breaker("zipkin").state == breaker.OPEN
    fn, empty = FETCHES[fetch]
    accepts = dead.accepts
    assert fn(client) == empty
    assert dead.accepts == accepts, "a fetch connected while the breaker was open"
    assert breaker.get_breaker("zipkin").snapshot()["shortCircuits"] >= 1


def test_a_transient_transport_error_is_retried():
    stub = ZipkinStub(drops=1, body=json.dumps(TRACES).encode())
    try:
        assert ZipkinClient(stub.url).get_trace_list(30_000, 1_000) == TRACES
        assert stub.accepts == 2
    finally:
        stub.close()
    assert metrics.get("retry.zipkin") == 1
    assert breaker.get_breaker("zipkin").snapshot()["consecutiveFailures"] == 0


@pytest.mark.parametrize("fetches", [1, 2, THRESHOLD])
def test_the_breaker_after_a_fault_sequence_equals_the_jax_clients(dead, fetches):
    port, jax = ZipkinClient(dead.url), JaxZipkinClient(dead.url)
    for _ in range(fetches):
        assert port.get_trace_list(30_000, 1_000) == jax.get_trace_list(30_000, 1_000) == []
    got = breaker.breaker_states()["zipkin"]
    want = jax_breaker.breaker_states()["zipkin"]
    assert got == {k: want[k] for k in got}


def test_health_reports_the_zipkin_breaker(dead):
    ZipkinClient(dead.url).get_trace_list(30_000, 1_000)
    payload = HealthHandler(None)._health(Request(method="get", path="/")).payload
    entry = payload["resilience"]["breakers"]["zipkin"]
    assert entry["failures"] == 2 and entry["state"] == breaker.CLOSED


def test_an_opening_breaker_freezes_a_flight_artifact(dead, tmp_path):
    _open_breaker(ZipkinClient(dead.url))
    dumps = list((tmp_path / "flight").glob("flight-*-breaker-open.json"))
    assert len(dumps) == 1
    assert json.loads(dumps[0].read_text())["detail"] == "zipkin"
