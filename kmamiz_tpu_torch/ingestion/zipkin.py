"""Zipkin v2 API client.

A host copy of kmamiz_tpu/ingestion/zipkin.py (the equivalent of the
reference's ZipkinService.ts and kmamiz_data_processor's zipkin.rs):
trace-list queries rooted at the ingress gateway with lookback/endTs/
limit, gzip accepted, and the paginated raw fetch that feeds
DataProcessor.ingest_raw_stream. Every fetch — the trace list, the raw
fetch, the page feeder's pages and the service list — is one guarded
GET, as in the JAX client: jittered-backoff retries on transport errors
(`Retrier("zipkin", retry_on=(OSError,))`) under the shared `zipkin`
circuit breaker. While Zipkin is down the breaker short-circuits with
BreakerOpenError — no connection, no timeout wait — which the public
methods' error arms turn into the reference's []/None posture, so a dead
Zipkin costs a tick microseconds instead of the 30 s timeout.
"""
from __future__ import annotations

import gzip
import json
import logging
import urllib.request
from typing import List, Optional
from urllib.parse import urlencode

from kmamiz_tpu_torch.resilience.breaker import get_breaker
from kmamiz_tpu_torch.resilience.retry import Retrier
from kmamiz_tpu_torch.telemetry.profiling.events import wall_ms

logger = logging.getLogger("kmamiz_tpu_torch.ingestion.zipkin")

DEFAULT_LOOKBACK_MS = 86_400_000 * 7  # ZipkinService.ts:11
DEFAULT_ROOT_SERVICE = "istio-ingressgateway.istio-system"  # ZipkinService.ts:48


def _http_get_raw(url: str, timeout: float) -> bytes:
    request = urllib.request.Request(
        url,
        headers={"Accept": "application/json", "Accept-Encoding": "gzip"},
    )
    with urllib.request.urlopen(request, timeout=timeout) as response:
        raw = response.read()
        if response.headers.get("Content-Encoding") == "gzip":
            raw = gzip.decompress(raw)
    return raw


class ZipkinClient:
    def __init__(self, zipkin_url: str, timeout: float = 30.0) -> None:
        if not zipkin_url:
            raise ValueError("Variable [ZIPKIN_URL] not set")
        self._base = f"{zipkin_url.rstrip('/')}/zipkin/api/v2"
        self._timeout = timeout

    def _fetch_raw(self, url: str) -> bytes:
        """One guarded Zipkin GET: retries on transport errors under the
        shared `zipkin` breaker (BreakerOpenError while it is open)."""
        retrier = Retrier("zipkin", retry_on=(OSError,))
        return retrier.call(get_breaker("zipkin").call, _http_get_raw, url, self._timeout)

    def _traces_url(self, look_back, end_ts, limit, service_name) -> str:
        if end_ts is None:
            end_ts = wall_ms()
        query = urlencode(
            {
                "serviceName": service_name,
                "endTs": int(end_ts),
                "lookback": int(look_back),
                "limit": limit,
            }
        )
        return f"{self._base}/traces?{query}"

    def get_trace_list(
        self,
        look_back: float = DEFAULT_LOOKBACK_MS,
        end_ts: Optional[float] = None,
        limit: int = 100_000,
        service_name: str = DEFAULT_ROOT_SERVICE,
    ) -> List[List[dict]]:
        """Traces rooted at `service_name`, looking back `look_back` ms from
        `end_ts` (ZipkinService.ts:44-57). Errors log and return [] like the
        reference's AxiosRequest wrapper (Utils.ts:187-200)."""
        url = self._traces_url(look_back, end_ts, limit, service_name)
        try:
            data = json.loads(self._fetch_raw(url))
        except Exception as err:  # noqa: BLE001 - the reference's [] posture
            logger.error("zipkin trace fetch failed: %s", err)
            return []
        return data if isinstance(data, list) else []

    def get_trace_list_raw(
        self,
        look_back: float = DEFAULT_LOOKBACK_MS,
        end_ts: Optional[float] = None,
        limit: int = 100_000,
        service_name: str = DEFAULT_ROOT_SERVICE,
    ) -> Optional[bytes]:
        """Same query as get_trace_list, returning the raw response bytes
        for the native loader (core.spans.raw_spans_to_batch). None on
        error."""
        url = self._traces_url(look_back, end_ts, limit, service_name)
        try:
            return self._fetch_raw(url)
        except Exception as err:  # noqa: BLE001 - the reference's None posture
            logger.error("zipkin raw trace fetch failed: %s", err)
            return None

    def iter_trace_pages_raw(
        self,
        look_back: float = DEFAULT_LOOKBACK_MS,
        end_ts: Optional[float] = None,
        pages: int = 4,
        limit: int = 100_000,
        service_name: str = DEFAULT_ROOT_SERVICE,
    ):
        """Paginated raw fetch: split the look-back window into `pages`
        contiguous endTs/lookback sub-windows (oldest first) and yield each
        page's raw response bytes: the feeder of
        DataProcessor.ingest_raw_stream, where page k+1's fetch and parse
        overlap page k's merge, and the processed-trace dedup absorbs a
        trace that straddles a page boundary (Zipkin returns it in both
        pages).

        Pages are fetched lazily (one request per step); empty and failed
        pages are skipped, as get_trace_list_raw logs and goes on."""
        if end_ts is None:
            end_ts = wall_ms()
        pages = max(1, int(pages))
        page_lb = look_back / pages
        for k in range(pages):
            page_end = end_ts - (pages - 1 - k) * page_lb
            raw = self.get_trace_list_raw(page_lb, page_end, limit, service_name)
            if raw:
                yield raw

    def get_services(self) -> List[str]:
        try:
            data = json.loads(self._fetch_raw(f"{self._base}/services"))
        except Exception as err:  # noqa: BLE001 - the reference's [] posture
            logger.error("zipkin service list failed: %s", err)
            return []
        return data if isinstance(data, list) else []
