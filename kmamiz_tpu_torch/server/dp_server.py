"""HTTP server speaking the external Data Processor protocol.

Counterpart of kmamiz_tpu/server/dp_server.py for the DP protocol alone,
the sibling of the reference's Rust service
(KMamiz kmamiz_data_processor/src/main.rs:28-79): GET / answers
health, POST / takes a TExternalDataProcessorRequest ({uniqueId,
lookBack, time, existingDep}) and returns a
TExternalDataProcessorResponse ({uniqueId, combined, dependencies,
datatype, log}). POST /ingest takes a raw Zipkin response body (trace
groups, or a KMZC columnar frame) into the processor's graph, uncapped,
and answers the ingest summary; a large JSON body streams through
ingest_raw_stream in chunks of whole trace groups. GET /model/stlgt
answers the STLGT continual trainer's health (ring, stale slots,
refreshes, params version). Gzip request bodies (Content-Encoding: gzip) are accepted;
responses are gzip-compressed when the client sends Accept-Encoding: gzip.
"""
from __future__ import annotations

import gzip
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from kmamiz_tpu_torch import native
from kmamiz_tpu_torch.core import wire
from kmamiz_tpu_torch.server.processor import DEFAULT_STREAM_CHUNKS, DataProcessor

logger = logging.getLogger("kmamiz_tpu_torch.dp_server")

#: decompressed /ingest bodies from this size on stream
#: (KMAMIZ_INGEST_STREAM_BYTES's default): 32 MiB
DEFAULT_STREAM_BYTES = 32 << 20


def make_handler(
    processor: DataProcessor,
    stream_bytes: int = DEFAULT_STREAM_BYTES,
    stream_chunks: int = DEFAULT_STREAM_CHUNKS,
):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt: str, *args) -> None:  # quiet default logs
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _send_json(self, status: int, payload: dict) -> None:
            encoded = "gzip" in self.headers.get("Accept-Encoding", "")
            body = json.dumps(payload).encode()
            if encoded:
                body = gzip.compress(body)
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            if encoded:
                self.send_header("Content-Encoding", "gzip")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # health check (main.rs:28-31)
            path = self.path.split("?", 1)[0].rstrip("/")
            if path == "/model/stlgt":
                from kmamiz_tpu_torch.models.stlgt import trainer as stlgt_trainer

                self._send_json(200, stlgt_trainer.trainer_status())
                return
            if path != "":
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            self._send_json(
                200,
                {
                    "status": "UP",
                    "service": "kmamiz-tpu-torch-data-processor",
                    "device": str(processor.device),
                },
            )

        def do_POST(self) -> None:
            try:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                if self.headers.get("Content-Encoding") == "gzip":
                    raw = gzip.decompress(raw)
            except (ValueError, OSError, EOFError) as e:
                # EOFError: gzip.decompress raises it on a truncated stream
                self._send_json(400, {"error": f"bad request: {e}"})
                return
            path = self.path.split("?", 1)[0].rstrip("/")
            if path == "/ingest":
                self._ingest(raw)
                return
            if path != "":
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            try:
                request = json.loads(raw) if raw else {}
            except ValueError as e:
                self._send_json(400, {"error": f"bad request: {e}"})
                return
            try:
                response = processor.collect(request)
            except Exception as e:  # noqa: BLE001 - answer 500, keep serving
                logger.exception("collect failed")
                self._send_json(500, {"error": str(e)})
                return
            self._send_json(200, response)

        def _ingest(self, raw: bytes) -> None:
            """POST /ingest: the body IS the Zipkin response (or a KMZC
            frame). A decompressed JSON body of at least `stream_bytes`
            splits into `stream_chunks` chunks of whole trace groups and
            streams through processor.ingest_raw_stream (the parse of chunk
            k+1 overlaps the merge of chunk k; span-id maps are scoped per
            chunk); any other body, or one that splits into a single chunk,
            is one window through processor.ingest_raw_window. A malformed
            payload answers 400, any other failure 500. Unlike the JAX
            server, this route has no tenant routing: the tenancy layer is
            not ported."""
            try:
                summary = None
                # a KMZC frame is indivisible: the splitter reads JSON only
                if len(raw) >= stream_bytes and not wire.is_columnar(raw):
                    chunks = native.split_groups(raw, stream_chunks)
                    if chunks is not None and len(chunks) > 1:
                        summary = processor.ingest_raw_stream(chunks)
                if summary is None:
                    summary = processor.ingest_raw_window(raw)
            except ValueError as e:
                self._send_json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 - answer 500, keep serving
                logger.exception("raw ingest failed")
                self._send_json(500, {"error": str(e)})
                return
            self._send_json(200, summary)

    return Handler


class DataProcessorServer:
    """The DP protocol on `host:port` (port 0 picks a free one), served
    from a background thread between start() and stop(). `stream_bytes`
    and `stream_chunks` set when and how POST /ingest streams a body."""

    def __init__(
        self,
        processor: DataProcessor,
        host: str = "0.0.0.0",
        port: int = 8600,
        stream_bytes: int = DEFAULT_STREAM_BYTES,
        stream_chunks: int = DEFAULT_STREAM_CHUNKS,
    ) -> None:
        self._server = ThreadingHTTPServer(
            (host, port), make_handler(processor, stream_bytes, stream_chunks)
        )
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="dp-server", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
