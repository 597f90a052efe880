"""URL parsing utilities.

Behavioral parity with the reference's URL handling
(KMamiz src/utils/Utils.ts:83-106, 242-273 and
KMamiz kmamiz_data_processor/src/http_client/url_matcher.rs):
`explode_url` splits any URL into (host, port, path) and, for Kubernetes
service URLs, additionally (service, namespace, cluster).
"""
from __future__ import annotations

import math
import re
from functools import lru_cache
from typing import List, NamedTuple, Optional

_SCHEME_RE = re.compile(r"[a-z]+://")
_HOST_RE = re.compile(r"://([^:/]*)([:0-9]*)(.*)", re.S)
#: the dot before `svc` is deliberately UNESCAPED — the reference's
#: /(.*).svc[\.]*(.*)/ (Utils.ts:90; url_matcher.rs:9) matches ANY
#: character there, so a host like "books-svc:8080" parses the same way
#: it does upstream (escaping it diverged the service naming
#: for hosts containing "svc" without a literal dot)
_SVC_RE = re.compile(r"(.*).svc[\.]*(.*)")


class ExplodedUrl(NamedTuple):
    host: str
    port: str
    path: str
    service: Optional[str] = None
    namespace: Optional[str] = None
    cluster: Optional[str] = None


@lru_cache(maxsize=1 << 16)
def explode_url(url: str, is_service_url: bool = False) -> ExplodedUrl:
    """Split a URL into meaningful parts.

    Returns (host, port, path[, service, namespace, cluster]); the port keeps
    its leading ':' to match the reference's output shape. Cached: a window
    of spans repeats a small set of URLs thousands of times, and the label
    refresh of each realtime tick reads every endpoint's URL, 10,000 and
    more in a deployment; the result is an immutable tuple of strings.
    """
    if _SCHEME_RE.search(url) is None:
        url = "://" + url
    m = _HOST_RE.search(url)
    host, port, path = (m.group(1), m.group(2), m.group(3)) if m else ("", "", "")
    if not is_service_url:
        return ExplodedUrl(host, port, path)

    service = namespace = cluster = None
    svc_match = _SVC_RE.match(host)
    if svc_match:
        service_full, cluster_part = svc_match.group(1), svc_match.group(2)
        divider = service_full.rfind(".")
        service = service_full[:divider]
        namespace = service_full[divider + 1:]
        cluster = cluster_part or "cluster.local"
    return ExplodedUrl(host, port, path, service, namespace, cluster)


_PARAM_SPLIT_RE = re.compile(r"([?&][^?&]*)")
_PARAM_KV_RE = re.compile(r"[?&]([^=]*)=([^?&]*)")


_FLOAT_PREFIX_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


def _is_finite_number(s: str) -> bool:
    # parseFloat semantics: a leading numeric prefix counts ("12abc" -> 12)
    m = _FLOAT_PREFIX_RE.match(s.strip())
    if not m:
        return False
    try:
        return math.isfinite(float(m.group(0)))
    except ValueError:
        return False


def get_params_from_url(url: str) -> Optional[List[dict]]:
    """Extract GET parameters as [{"param", "type"}] pairs, None if absent."""
    chunks = _PARAM_SPLIT_RE.findall(url)
    if not chunks:
        return None
    pairs = []
    for chunk in chunks:
        kv = _PARAM_KV_RE.match(chunk)
        if kv:
            pairs.append(
                {
                    "param": kv.group(1),
                    "type": "number" if _is_finite_number(kv.group(2)) else "string",
                }
            )
    return unique_params(pairs)


def unique_params(parameters: List[dict]) -> List[dict]:
    """De-duplicate GET parameters; conflicting types degrade to string."""
    merged: dict = {}
    for p in parameters:
        param, ptype = p["param"], p["type"]
        if param in merged and merged[param]["type"] != ptype:
            ptype = "string"
        merged[param] = {"param": merged.get(param, p)["param"], "type": ptype}
    return list(merged.values())
