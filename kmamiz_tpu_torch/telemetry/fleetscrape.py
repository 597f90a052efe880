"""Fleet scrape aggregation: N workers' /metrics pages -> one exposition.

Counterpart of kmamiz_tpu/telemetry/fleetscrape.py: for the same pages the
rendered exposition is byte-equal to the JAX package's. Each fleet worker
serves its own registry as a Prometheus text page; a fleet wants one
scrape target. Pages merge sample by sample: counters, sums and gauges add
(a fleet-wide queue depth is the sum), and every series is also emitted
per worker under a ``worker`` label, so a dashboard charts per-worker
spans/s beside the fleet total. The input is the exposition text itself,
so the aggregation works alike over HTTP-scraped worker processes and
pages made in process.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s]+)\s*$"
)


def parse_exposition(text: str) -> List[Tuple[str, str, float]]:
    """(metric name, label body, value) samples of one page. Comments,
    HELP/TYPE lines and malformed samples are skipped: a worker mid-restart
    may serve a torn page."""
    samples = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        samples.append((m.group("name"), m.group("labels") or "", value))
    return samples


def _with_worker_label(labels: str, worker: str) -> str:
    tag = f'worker="{worker}"'
    return f"{labels},{tag}" if labels else tag


def aggregate(pages: Dict[str, str]) -> Dict[str, Dict[str, float]]:
    """{metric: {label body: value}} summed across the pages (worker id ->
    exposition text), plus each worker's own series under an added
    ``worker`` label."""
    merged: Dict[str, Dict[str, float]] = {}
    for worker in sorted(pages):
        for name, labels, value in parse_exposition(pages[worker]):
            series = merged.setdefault(name, {})
            series[labels] = series.get(labels, 0.0) + value
            per_worker = _with_worker_label(labels, worker)
            series[per_worker] = series.get(per_worker, 0.0) + value
    return merged


def render(pages: Dict[str, str]) -> str:
    """One merged page: fleet totals and per-worker series. HELP/TYPE
    lines are dropped (the pages differ only in values; a scraper that
    wants them reads any one worker)."""
    merged = aggregate(pages)
    out: List[str] = []
    for name in sorted(merged):
        for labels in sorted(merged[name]):
            suffix = f"{{{labels}}}" if labels else ""
            value = merged[name][labels]
            rendered = repr(value) if value != int(value) else str(int(value))
            out.append(f"{name}{suffix} {rendered}")
    return "\n".join(out) + ("\n" if out else "")


def spans_per_worker(pages: Dict[str, str], metric: str = "kmamiz_ingest_payloads_total") -> Dict[str, float]:
    """Each worker's total of one counter family, over its labels."""
    return {
        worker: sum(value for name, _labels, value in parse_exposition(text) if name == metric)
        for worker, text in pages.items()
    }


def scrape_workers(endpoints: Dict[str, str], timeout_s: float = 10.0) -> Dict[str, str]:
    """Every worker's /metrics page (worker id -> base URL); a dead worker
    gives an empty page: one kill -9 must not fail the fleet's scrape."""
    import urllib.error
    import urllib.request

    pages = {}
    for worker, base in endpoints.items():
        try:
            with urllib.request.urlopen(f"{base.rstrip('/')}/metrics", timeout=timeout_s) as resp:
                pages[worker] = resp.read().decode("utf-8", "replace")
        except (urllib.error.URLError, OSError, TimeoutError):
            pages[worker] = ""
    return pages
