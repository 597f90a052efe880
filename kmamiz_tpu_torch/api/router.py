"""Minimal HTTP routing layer for the REST API.

Counterpart of kmamiz_tpu/api/router.py (the reference's Express stack,
src/routes/Routes.ts + src/entities/TRequestHandler.ts) with the entry
point's static and wasm serving (index.ts:46-53): handlers register (method, path) routes with
`:param` / optional `:param?` segments under /api/v{N}; responses are JSON
by default with a 5-second cache-control, gzip-compressed when the client
accepts it. Built on the stdlib ThreadingHTTPServer.
"""
from __future__ import annotations

import gzip
import json
import logging
import re
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlsplit

logger = logging.getLogger("kmamiz_tpu_torch.api")


@dataclass
class Request:
    method: str
    path: str
    params: Dict[str, str] = field(default_factory=dict)
    query: Dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    def json(self) -> Any:
        if not self.body:
            return None
        try:
            return json.loads(self.body)
        except json.JSONDecodeError:
            return None

    def query_int(self, name: str) -> Optional[int]:
        raw = self.query.get(name)
        try:
            return int(raw) if raw is not None else None
        except ValueError:
            return None


@dataclass
class Response:
    status: int = 200
    payload: Any = None  # JSON-encoded unless raw_body is set
    raw_body: Optional[bytes] = None
    # optional pre-compressed twin of raw_body, for handlers that serve a
    # memoized large body; MUST be gzip.compress(raw_body) or absent
    raw_gzip: Optional[bytes] = None
    content_type: str = "application/json"
    headers: Dict[str, str] = field(default_factory=dict)

    @staticmethod
    def status_only(code: int) -> "Response":
        # Express's res.sendStatus: status text as plain-text body, except
        # 204/304 which must not carry one (RFC 7230 §3.3)
        return Response(
            status=code,
            raw_body=b"" if code in (204, 304) else str(code).encode(),
            content_type="text/plain",
        )


Handler = Callable[[Request], Response]

_PARAM_RE = re.compile(r":([A-Za-z_][A-Za-z0-9_]*)(\?)?")


def compile_path(path: str) -> re.Pattern:
    """'/graph/dependency/endpoint/:namespace?' -> anchored regex with
    named groups; optional params also absorb their leading slash."""
    out = []
    idx = 0
    for m in _PARAM_RE.finditer(path):
        literal = re.escape(path[idx : m.start()])
        name, optional = m.group(1), m.group(2)
        if optional:
            if literal.endswith("/"):
                literal = literal[:-1]
            out.append(literal)
            out.append(f"(?:/(?P<{name}>[^/]+))?")
        else:
            out.append(literal)
            out.append(f"(?P<{name}>[^/]+)")
        idx = m.end()
    out.append(re.escape(path[idx:]))
    return re.compile("^" + "".join(out) + "/?$")


@dataclass
class Route:
    method: str
    pattern: re.Pattern
    handler: Handler
    raw_path: str


_STATIC_TYPES = {
    ".html": "text/html",
    ".js": "application/javascript",
    ".css": "text/css",
    ".json": "application/json",
    ".svg": "image/svg+xml",
    ".png": "image/png",
    ".ico": "image/x-icon",
    ".map": "application/json",
    ".woff2": "font/woff2",
    ".wasm": "application/wasm",
}


class Router:
    """Route table with the reference's /api/v{N} prefix, plus the entry
    point's static serving: the SPA build from static_dir with index.html
    fallback for client-side routes, and the Envoy filter binary at
    /wasm."""

    def __init__(
        self,
        api_version: str = "1",
        static_dir: str = "",
        wasm_path: str = "",
    ) -> None:
        self.prefix = f"/api/v{api_version}"
        self._routes: List[Route] = []
        self.static_dir = static_dir
        self.wasm_path = wasm_path

    def add(self, method: str, path: str, handler: Handler) -> None:
        full = (self.prefix + path).rstrip("/") or "/"
        self._routes.append(Route(method.upper(), compile_path(full), handler, full))

    def add_handler(self, handler_obj: "IRequestHandler") -> None:
        for method, path, fn in handler_obj.routes:
            self.add(method, path, fn)

    @property
    def route_list(self) -> List[str]:
        return [f"[{r.method}] {r.raw_path}" for r in self._routes]

    def dispatch(self, method: str, target: str, body: bytes = b"") -> Response:
        split = urlsplit(target)
        path = split.path
        # parse_qs percent-decodes query values once, as Express does
        query = {k: v[0] for k, v in parse_qs(split.query).items() if v}
        matched_path = False
        for route in self._routes:
            m = route.pattern.match(path)
            if not m:
                continue
            matched_path = True
            if route.method != method.upper():
                continue
            # path params decode twice: Express decodes captured params and
            # every reference handler calls decodeURIComponent on them again
            params = {
                k: unquote(unquote(v)) for k, v in m.groupdict().items() if v is not None
            }
            req = Request(
                method=method.upper(), path=path, params=params, query=query, body=body
            )
            try:
                return route.handler(req)
            except Exception:  # noqa: BLE001 - handler bugs -> 500, not crash
                logger.exception("handler error on %s %s", method, path)
                return Response.status_only(500)
        if matched_path:
            return Response.status_only(405)
        if method.upper() == "GET" and not path.startswith(self.prefix):
            static = self._serve_static(path)
            if static is not None:
                return static
        return Response.status_only(404)

    def _serve_static(self, path: str) -> Optional[Response]:
        import os

        static_cache = {"Cache-Control": "max-age=3600"}  # index.ts:47
        if path == "/wasm" and self.wasm_path and os.path.isfile(self.wasm_path):
            with open(self.wasm_path, "rb") as f:
                return Response(
                    status=200,
                    raw_body=f.read(),
                    content_type="application/wasm",
                    headers=static_cache,
                )
        if not self.static_dir:
            return None
        root = os.path.realpath(self.static_dir)
        if not os.path.isdir(root):
            return None
        rel = unquote(path).lstrip("/") or "index.html"
        candidate = os.path.realpath(os.path.join(root, rel))
        # confine to the static root (no traversal via .. or symlinks out)
        if not (candidate == root or candidate.startswith(root + os.sep)):
            return None
        if not os.path.isfile(candidate):
            # SPA fallback: unknown extension-less paths load the app shell
            if "." in os.path.basename(rel):
                return None
            candidate = os.path.join(root, "index.html")
            if not os.path.isfile(candidate):
                return None
        ext = os.path.splitext(candidate)[1].lower()
        with open(candidate, "rb") as f:
            return Response(
                status=200,
                raw_body=f.read(),
                content_type=_STATIC_TYPES.get(ext, "application/octet-stream"),
                headers=static_cache,
            )


class IRequestHandler:
    """Handler base: collects (method, sub-path, fn) triples under an
    identifier prefix (reference TRequestHandler.ts:4-34)."""

    def __init__(self, identifier: str = "") -> None:
        self._identifier = identifier
        self.routes: List[Tuple[str, str, Handler]] = []

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self.routes.append((method, f"/{self._identifier}{path}", handler))


def make_http_handler(router: Router, cache_max_age: int = 5):
    class ApiHTTPHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt: str, *args) -> None:
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _respond(self, response: Response, head: bool = False) -> None:
            if response.status in (204, 304):  # bodyless statuses (RFC 7230)
                body = b""
            elif response.raw_body is not None:
                body = response.raw_body
            else:
                body = json.dumps(response.payload).encode()
            accept = self.headers.get("Accept-Encoding", "")
            use_gzip = "gzip" in accept and len(body) > 512
            if use_gzip:
                if response.raw_gzip is not None and body is response.raw_body:
                    body = response.raw_gzip
                else:
                    body = gzip.compress(body)
            self.send_response(response.status)
            bodyless = response.status in (204, 304)
            if not bodyless:
                self.send_header("Content-Type", response.content_type)
            if "Cache-Control" not in response.headers:
                self.send_header("Cache-Control", f"max-age={cache_max_age}")
            # the reference mounts cors() on every route (index.ts)
            self.send_header("Access-Control-Allow-Origin", "*")
            if use_gzip:
                self.send_header("Content-Encoding", "gzip")
            for k, v in response.headers.items():
                self.send_header(k, v)
            if not bodyless:
                self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if not bodyless and not head:
                self.wfile.write(body)

        def _read_chunked(self) -> bytes:
            """Minimal Transfer-Encoding: chunked reader (clients that
            stream send chunked request bodies)."""
            out = bytearray()
            while True:
                size_line = self.rfile.readline(65536).strip()
                size = int(size_line.split(b";", 1)[0], 16)
                if size == 0:
                    # drain optional trailers up to the final blank line
                    while True:
                        line = self.rfile.readline(65536)
                        if line in (b"\r\n", b"\n", b""):
                            break
                    return bytes(out)
                out += self.rfile.read(size)
                self.rfile.readline(65536)  # CRLF after each chunk

        def _read_body(self) -> bytes:
            te = (self.headers.get("Transfer-Encoding") or "").lower()
            if "chunked" in te:
                raw = self._read_chunked()
            else:
                length = int(self.headers.get("Content-Length", 0) or 0)
                raw = self.rfile.read(length) if length else b""
            if self.headers.get("Content-Encoding") == "gzip":
                raw = gzip.decompress(raw)
            return raw

        def _handle(self, method: str) -> None:
            try:
                body = self._read_body()
                response = router.dispatch(method, self.path, body)
            except Exception:  # noqa: BLE001
                logger.exception("dispatch error")
                response = Response.status_only(500)
            self._respond(response)

        def do_GET(self) -> None:
            self._handle("GET")

        def do_HEAD(self) -> None:
            # Express answers HEAD like GET: same headers, no body bytes
            try:
                response = router.dispatch("GET", self.path, b"")
            except Exception:  # noqa: BLE001
                logger.exception("dispatch error")
                response = Response.status_only(500)
            self._respond(response, head=True)

        def do_OPTIONS(self) -> None:
            # CORS preflight: the reference mounts cors() globally
            self.send_response(204)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header(
                "Access-Control-Allow-Methods", "GET, POST, PUT, DELETE, OPTIONS"
            )
            self.send_header(
                "Access-Control-Allow-Headers",
                self.headers.get("Access-Control-Request-Headers") or "Content-Type",
            )
            self.end_headers()

        def do_POST(self) -> None:
            self._handle("POST")

        def do_DELETE(self) -> None:
            self._handle("DELETE")

        def do_PUT(self) -> None:
            self._handle("PUT")

    return ApiHTTPHandler


class ApiServer:
    """Threaded HTTP server for the REST API (reference index.ts app.listen)."""

    def __init__(self, router: Router, host: str = "0.0.0.0", port: int = 3000) -> None:
        self._server = ThreadingHTTPServer((host, port), make_http_handler(router))
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="api-server", daemon=True
        )
        self._thread.start()

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join()
