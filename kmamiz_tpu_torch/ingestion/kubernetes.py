"""Kubernetes API client.

A copy of kmamiz_tpu/ingestion/kubernetes.py (KMamiz
src/services/KubernetesService.ts and kmamiz_data_processor's
kubernetes.rs): in-cluster service-account auth (Bearer token + CA
bundle), pod, service and namespace listings, replica counts from the
Istio canonical-name labels, the istio-proxy envoy-log fetch and parse,
and the handshake that asks the instance being replaced to flush.

Transient API-server failures are retried with exponential backoff. The
DP tick's cluster fetch, `get_replicas_and_joinable_logs` (the JAX
client's get_replicas_and_envoy_logs), runs in two concurrent waves, the
pod listings and then the pod logs, so a tick costs about one pod's fetch,
not the sum (the Rust DP's join_all, data_processor.rs:58-73). Its logs
come back structured and combined as EnvoyLogs.combine_structured does,
each trace reduced to the fields the realtime join reads (`joinable`).

The fetch runs on FANOUT_PROCESSES worker processes: the listings on
the first, then the logs in contiguous shards, each worker with
fanout_workers / FANOUT_PROCESSES fetch threads. A tick reads every pod
of its namespaces, thousands at a mesh's size, and the per-pod HTTP,
parse decoration and structuring are Python, which threads of one
interpreter run one at a time; the caller's process, whose tick walks
its dependencies meanwhile, only waits on the workers' pipes. Given the
window's trace ids, the workers structure and hand back only the
requests that the window's realtime join can read, so the tick's
structuring, transfer and combine follow the window and not the pods'
whole log tails. The workers are plain `python -c` processes that import
this module and not the caller's main module (nor torch); they start at
the first fetch or at warm_up() and end with close(), with the client,
or when the parent's end closes their pipe.
"""
from __future__ import annotations

import http.client
import json
import logging
import os
import pickle
import ssl
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Tuple
from urllib.parse import urlsplit

from kmamiz_tpu_torch import native
from kmamiz_tpu_torch.core.envoy import (
    EnvoyLogs,
    backfill_trace_ids,
    decorate_envoy_records,
    parse_envoy_logs,
    strip_istio_proxy_prefix,
)

logger = logging.getLogger("kmamiz_tpu_torch.ingestion.kubernetes")

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
DEFAULT_LOG_LIMIT = 10_000  # KubernetesService.ts:18
CANONICAL_NAME_LABEL = "service.istio.io/canonical-name"
CANONICAL_REVISION_LABEL = "service.istio.io/canonical-revision"
DEFAULT_FANOUT_WORKERS = 16
#: worker processes of the tick's log fan-out, up to 4: the wave's HTTP and
#: parse are bound by the host's cores, which the serving process's own
#: dependency walk (beside the fetch) and the API server's answers share
FANOUT_PROCESSES = min(4, os.cpu_count() or 1)

#: the package's root directory, on a worker's import path
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_WORKER = "from kmamiz_tpu_torch.ingestion.kubernetes import serve_fanout; serve_fanout()"


def joinable(structured: List[dict]) -> List[dict]:
    """One pod's structured logs with each trace reduced to what
    domain.traces' realtime join and EnvoyLogs.combine_structured read:
    its trace and span ids, isFallback, the request's body, content type
    and timestamp, the response's body and content type."""
    return [
        {
            "requestId": entry["requestId"],
            "traces": [
                {
                    "traceId": t["traceId"],
                    "spanId": t["spanId"],
                    "isFallback": t["isFallback"],
                    "request": {
                        "body": t["request"].get("body"),
                        "contentType": t["request"].get("contentType"),
                        "timestamp": t["request"]["timestamp"],
                    },
                    "response": {
                        "body": t["response"].get("body"),
                        "contentType": t["response"].get("contentType"),
                    },
                }
                for t in entry["traces"]
            ],
        }
        for entry in structured
    ]


class _ParsedPod:
    """One pod's istio-proxy log, fetched and parsed, held by a fan-out
    worker between a call's two steps: its records, each request's
    backfilled traceId, and whether the pod structures in fallback mode
    (a spanId of NO_ID anywhere in its log, as EnvoyLogs.to_structured
    decides)."""

    def __init__(self, client: "KubernetesClient", namespace: str, pod: str, limit: int) -> None:
        raw = client._raw_log(namespace, pod, limit)
        self.namespace, self.pod = namespace, pod
        self.records = native.parse_envoy_lines(strip_istio_proxy_prefix(raw.split("\n")))
        self.id_map = backfill_trace_ids(self.records)
        self.fallback = any(r["spanId"] == "NO_ID" for r in self.records)

    def requests_of(self, trace_ids) -> set:
        """The requestIds whose backfilled traceId is in `trace_ids`."""
        return {request for request, trace in self.id_map.items() if trace in trace_ids}

    def joinable(self, keep: Optional[set]) -> List[dict]:
        """The pod's joinable structured logs, of the requests in `keep`
        only (None: all), structured in the mode of the whole pod."""
        records = self.records
        if keep is not None:
            records = [r for r in records if r["requestId"] in keep]
        logs = decorate_envoy_records(records, self.id_map, self.namespace, self.pod)
        return joinable(logs.to_structured_fallback() if self.fallback else logs.to_structured())


def serve_fanout() -> None:
    """A fan-out worker process's loop. Its standard input carries pickled
    messages: first the client's constructor arguments, then the calls;
    each call's reply, ("ok", value) or ("err", the exception), goes out
    on the standard output, which nothing else writes (stray prints go to
    the standard error). It ends when its input closes. The calls:

    - ("list", namespaces): (replicas, log targets), the pod listings;
    - ("logs", targets, limit, trace_ids): each (namespace, pod) in
      `targets` fetched and parsed on the client's threads and held; the
      requestIds whose traceId is in `trace_ids` (an empty set for None);
    - ("keep", request_ids): the held pods' joinable structured logs, in
      target order, of the requests in `request_ids` only (None: all)."""
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    source = sys.stdin.buffer
    client = KubernetesClient(*pickle.load(source))
    # the fetch threads live as long as the worker, and so do their
    # kept-alive connections
    pool = ThreadPoolExecutor(max_workers=client._fanout_workers)
    held: List[_ParsedPod] = []
    while True:
        try:
            message = pickle.load(source)
        except EOFError:
            return
        try:
            kind = message[0]
            if kind == "list":
                value = client._replicas_and_targets(message[1])
            elif kind == "logs":
                _kind, targets, limit, trace_ids = message
                held = list(pool.map(lambda t: _ParsedPod(client, t[0], t[1], limit), targets))
                value = set() if trace_ids is None else set().union(*(p.requests_of(trace_ids) for p in held))
            else:
                value = [p.joinable(message[1]) for p in held]
                held = []
            reply = pickle.dumps(("ok", value), pickle.HIGHEST_PROTOCOL)
        except Exception as err:  # noqa: BLE001 - the parent raises it
            try:
                reply = pickle.dumps(("err", err), pickle.HIGHEST_PROTOCOL)
            except Exception:  # noqa: BLE001 - an exception that does not pickle
                reply = pickle.dumps(("err", RuntimeError(repr(err))), pickle.HIGHEST_PROTOCOL)
        out.write(reply)
        out.flush()


class _FanoutWorker:
    """The parent's end of one serve_fanout process."""

    def __init__(self, init: tuple) -> None:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _WORKER], stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env
        )
        self.send(init)

    def send(self, message) -> None:
        pickle.dump(message, self.proc.stdin, pickle.HIGHEST_PROTOCOL)
        self.proc.stdin.flush()

    def receive(self):
        return pickle.load(self.proc.stdout)

    def stop(self) -> None:
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.proc.stdout.close()


def _stop_workers(workers: List[_FanoutWorker]) -> None:
    while workers:
        workers.pop().stop()


def _ask(workers: List[_FanoutWorker], messages: list) -> list:
    """One message to each worker, then each worker's reply value, in
    order; every reply is read before the first error is raised, so the
    pipes stay in step."""
    for worker, message in zip(workers, messages):
        worker.send(message)
    replies = [worker.receive() for worker in workers]
    for status, value in replies:
        if status == "err":
            raise value
    return [value for _status, value in replies]


def _exchange(conn: http.client.HTTPConnection, target: str, headers: dict) -> tuple:
    """GET `target` on `conn`: (status, reason, headers, body). The
    connection is closed on any failure, so the next request opens it
    anew."""
    try:
        conn.request("GET", target, headers=headers)
        response = conn.getresponse()
        return response.status, response.reason, response.headers, response.read()
    except BaseException:
        conn.close()
        raise


class KubernetesServiceError(Exception):
    """Raised when required cluster data cannot be fetched; the reference
    treats this as fatal (KubernetesService.ts:54-71)."""


class KubernetesClient:
    def __init__(
        self,
        kube_api_host: str,
        token: Optional[str] = None,
        ca_cert_path: Optional[str] = None,
        current_namespace: str = "",
        timeout: float = 30.0,
        retries: int = 2,
        backoff_s: float = 0.25,
        fanout_workers: int = DEFAULT_FANOUT_WORKERS,
    ) -> None:
        if not kube_api_host:
            raise ValueError("Variable [KUBEAPI_HOST] not set")
        # what a fan-out worker process builds its own client from: its
        # threads split this client's
        self._init_args = (
            kube_api_host,
            token,
            ca_cert_path,
            current_namespace,
            timeout,
            retries,
            backoff_s,
            max(1, fanout_workers // FANOUT_PROCESSES),
        )
        #: the last get_replicas_and_joinable_logs' walls: the pod listings,
        #: the workers' log fan-out, the combine
        self.last_fetch_ms: Dict[str, float] = {}
        self._workers: List[_FanoutWorker] = []
        self._workers_lock = threading.Lock()
        weakref.finalize(self, _stop_workers, self._workers)
        self._base = f"{kube_api_host.rstrip('/')}/api/v1"
        self._token = token
        self._timeout = timeout
        self._retries = retries
        self._backoff_s = backoff_s
        self._fanout_workers = fanout_workers
        self.current_namespace = current_namespace
        self._ssl_context = (
            ssl.create_default_context(cafile=ca_cert_path)
            if ca_cert_path
            else None
        )
        self._split = urlsplit(self._base)
        # each thread's kept-alive connection to the API server
        self._local = threading.local()

    @classmethod
    def from_service_account(
        cls, kube_api_host: str, service_account_dir: Optional[str] = None
    ) -> "KubernetesClient":
        """In-cluster auth from the mounted service account
        (KubernetesService.ts:27-47), in SERVICE_ACCOUNT_DIR unless given."""
        if service_account_dir is None:
            service_account_dir = SERVICE_ACCOUNT_DIR
        with open(f"{service_account_dir}/token") as f:
            token = f.read().strip()
        if not token:
            raise ValueError("token is empty")
        with open(f"{service_account_dir}/namespace") as f:
            namespace = f.read().strip()
        return cls(
            kube_api_host,
            token=token,
            ca_cert_path=f"{service_account_dir}/ca.crt",
            current_namespace=namespace,
        )

    # -- transport -----------------------------------------------------------

    def _connection(self) -> http.client.HTTPConnection:
        """This thread's connection to the API server, kept alive across
        calls (a TLS handshake a call would cost an in-cluster fetch more
        than the call), opened at its first request."""
        conn = getattr(self._local, "conn", None)
        if conn is None:
            split = self._split
            if split.scheme == "https":
                conn = http.client.HTTPSConnection(
                    split.hostname, split.port, timeout=self._timeout, context=self._ssl_context
                )
            else:
                conn = http.client.HTTPConnection(split.hostname, split.port, timeout=self._timeout)
            self._local.conn = conn
        return conn

    def _request_once(self, path: str, as_json: bool = True):
        """One GET over this thread's connection. A status of 400 or more
        raises urllib.error.HTTPError, as urllib's transport did; a
        kept-alive connection that the server had closed is opened anew
        and the request sent once more at once."""
        headers = {"Accept": "application/json" if as_json else "text/plain"}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        conn = self._connection()
        target = self._split.path + path
        reused = conn.sock is not None
        try:
            status, reason, response_headers, raw = _exchange(conn, target, headers)
        except ConnectionError:
            if not reused:
                raise
            status, reason, response_headers, raw = _exchange(conn, target, headers)
        if status >= 400:
            raise urllib.error.HTTPError(self._base + path, status, reason, response_headers, None)
        return json.loads(raw) if as_json else raw.decode("utf-8", "replace")

    def _request(self, path: str, as_json: bool = True):
        """One API call with retry + exponential backoff on transient
        failures (connection resets, timeouts, 5xx). Client errors (4xx)
        are not retried — a missing pod stays missing."""
        attempt = 0
        while True:
            try:
                return self._request_once(path, as_json=as_json)
            except urllib.error.HTTPError as err:
                if err.code < 500 or attempt >= self._retries:
                    raise
            except Exception:  # noqa: BLE001 - URLError, timeout, reset
                if attempt >= self._retries:
                    raise
            delay = self._backoff_s * (2**attempt)
            logger.warning(
                "k8s API request %s failed (attempt %d/%d), retrying in %.2fs",
                path,
                attempt + 1,
                self._retries + 1,
                delay,
            )
            time.sleep(delay)
            attempt += 1

    def _must_request(self, path: str, as_json: bool = True):
        try:
            return self._request(path, as_json=as_json)
        except Exception as err:  # noqa: BLE001
            raise KubernetesServiceError(
                f"Cannot retrieve necessary data from Kubernetes API server: {err}"
            ) from err

    # -- listings ------------------------------------------------------------

    def get_pod_list(self, namespace: str) -> dict:
        return self._must_request(f"/namespaces/{namespace}/pods")

    def get_service_list(self, namespace: str) -> dict:
        return self._must_request(f"/namespaces/{namespace}/services")

    def get_namespaces(self) -> List[str]:
        data = self._must_request("/namespaces")
        return [item["metadata"]["name"] for item in data.get("items", [])]

    def get_pod_names(self, namespace: str) -> List[str]:
        return [
            pod["metadata"]["name"]
            for pod in self.get_pod_list(namespace).get("items", [])
        ]

    # -- replicas from canonical-name labels (KubernetesService.ts:118-146) --

    @staticmethod
    def _replicas_from_items(pod_items: List[dict], namespace: str) -> List[dict]:
        replica_map: Dict[str, dict] = {}
        for pod in pod_items:
            labels = pod.get("metadata", {}).get("labels", {}) or {}
            service = labels.get(CANONICAL_NAME_LABEL)
            version = labels.get(CANONICAL_REVISION_LABEL)
            pod_namespace = pod.get("metadata", {}).get("namespace", namespace)
            unique = f"{service}\t{pod_namespace}\t{version}"
            entry = replica_map.setdefault(
                unique,
                {
                    "uniqueServiceName": unique,
                    "service": service,
                    "namespace": pod_namespace,
                    "version": version,
                    "replicas": 0,
                },
            )
            entry["replicas"] += 1
        return list(replica_map.values())

    def get_replicas_from_pod_list(self, namespace: str) -> List[dict]:
        return self._replicas_from_items(
            self.get_pod_list(namespace).get("items", []), namespace
        )

    def get_replicas(self, namespaces: Optional[Iterable[str]] = None) -> List[dict]:
        if namespaces is None:
            namespaces = self.get_namespaces()
        replicas: List[dict] = []
        for ns in namespaces:
            replicas.extend(self.get_replicas_from_pod_list(ns))
        return replicas

    def get_replicas_all(self) -> List[dict]:
        return self.get_replicas()

    # -- envoy logs (KubernetesService.ts:178-199) ---------------------------

    def _raw_log(self, namespace: str, pod_name: str, limit: int) -> str:
        """A pod's istio-proxy container log, its last `limit` lines."""
        return self._must_request(
            f"/namespaces/{namespace}/pods/{pod_name}/log"
            f"?container=istio-proxy&tailLines={limit}",
            as_json=False,
        )

    def get_envoy_logs(
        self, namespace: str, pod_name: str, limit: int = DEFAULT_LOG_LIMIT
    ) -> EnvoyLogs:
        raw = self._raw_log(namespace, pod_name, limit)
        lines = strip_istio_proxy_prefix(raw.split("\n"))
        return parse_envoy_logs(lines, namespace, pod_name)

    def _replicas_and_targets(
        self, namespaces: List[str]
    ) -> Tuple[List[dict], List[Tuple[str, str]]]:
        """The first wave: one pod listing per namespace, in parallel, read
        for both the replica counts and the log targets."""
        with ThreadPoolExecutor(
            max_workers=min(self._fanout_workers, len(namespaces))
        ) as pool:
            pod_lists = list(pool.map(self.get_pod_list, namespaces))
        replicas: List[dict] = []
        targets: List[Tuple[str, str]] = []
        for ns, pod_list in zip(namespaces, pod_lists):
            items = pod_list.get("items", [])
            replicas.extend(self._replicas_from_items(items, ns))
            targets.extend(
                (ns, pod["metadata"]["name"]) for pod in items
            )
        return replicas, targets

    def get_replicas_and_joinable_logs(
        self,
        namespaces: Iterable[str],
        limit: int = DEFAULT_LOG_LIMIT,
        trace_ids: Optional[Iterable[str]] = None,
    ) -> Tuple[List[dict], List[dict]]:
        """The DP tick's whole cluster-state fetch on the worker processes:
        one pod listing per namespace (in parallel, read for both the
        replica counts and the log targets), then the per-pod log fetch and
        parse, then the structuring. The replicas, and the logs as
        combine_to_structured_envoy_logs gives them, each trace reduced to
        its `joinable` fields (the parent-id fill is left out: the realtime
        join reads no parent id). Given the window's `trace_ids`, only the
        requests with a trace of the window in some pod, each with all its
        pods' traces: the join keys a combined request by its first
        trace's traceId, so it reads no other, and the window's realtime
        records are the same."""
        namespaces = list(namespaces)
        if not namespaces:
            return [], []
        if trace_ids is not None:
            trace_ids = set(trace_ids)
        t0 = time.perf_counter()
        with self._workers_lock:
            workers = self._started_locked()
            try:
                ((replicas, targets),) = _ask(workers[:1], [("list", namespaces)])
                if not targets:
                    return replicas, []
                t1 = time.perf_counter()
                step = -(-len(targets) // len(workers))
                shards = [targets[i : i + step] for i in range(0, len(targets), step)]
                busy = workers[: len(shards)]
                matched = _ask(busy, [("logs", shard, limit, trace_ids) for shard in shards])
                keep = None if trace_ids is None else set().union(*matched)
                t2 = time.perf_counter()
                replies = _ask(busy, [("keep", keep)] * len(busy))
            except (OSError, EOFError, pickle.UnpicklingError) as err:
                _stop_workers(self._workers)
                raise RuntimeError(f"a log fan-out worker process failed: {err!r}") from err
        t3 = time.perf_counter()
        combined = EnvoyLogs.combine_structured([pod for reply in replies for pod in reply])
        self.last_fetch_ms = {
            "listing": (t1 - t0) * 1e3,
            "logs": (t2 - t1) * 1e3,
            "structure": (t3 - t2) * 1e3,
            "combine": (time.perf_counter() - t3) * 1e3,
        }
        return replicas, combined

    def _started_locked(self) -> List[_FanoutWorker]:
        if not self._workers:
            self._workers.extend(
                _FanoutWorker(self._init_args) for _ in range(FANOUT_PROCESSES)
            )
        return self._workers

    def warm_up(self) -> None:
        """Start every fan-out worker process now (a server's boot), so
        the first tick does not pay for their start."""
        with self._workers_lock:
            workers = self._started_locked()
            _ask(workers, [("logs", [], DEFAULT_LOG_LIMIT, None)] * len(workers))

    def close(self) -> None:
        """Stop the fan-out's worker processes."""
        with self._workers_lock:
            _stop_workers(self._workers)

    # -- peer-instance handshake (KubernetesService.ts:96-116,164-176) -------

    def get_production_service_base_url(
        self, namespace: str = "kmamiz-system", service_name: str = "kmamiz"
    ) -> str:
        services = self.get_service_list(namespace)
        port = 80
        for svc in services.get("items", []):
            if svc.get("metadata", {}).get("name") == service_name:
                ports = svc.get("spec", {}).get("ports") or []
                if ports:
                    port = ports[0].get("port", 80)
                break
        return f"http://{service_name}:{port}"

    def force_kmamiz_sync(
        self, service_port: str, api_version: str, simulator_mode: bool = False
    ) -> None:
        """Ask the instance being replaced to flush its caches before this
        one takes over; failures are ignored (KubernetesService.ts:164-176)."""
        svc = "kmamiz-simulator" if simulator_mode else "kmamiz"
        url = (
            f"http://{svc}.{self.current_namespace}.svc:{service_port}"
            f"/api/v{api_version}/data/sync"
        )
        try:
            request = urllib.request.Request(url, method="POST")
            with urllib.request.urlopen(request, timeout=self._timeout) as response:
                if response.status == 200:
                    logger.debug("Notified existing instance to sync.")
        except Exception:  # noqa: BLE001 - best-effort handshake
            pass
