"""Global configuration from environment variables.

The part of kmamiz_tpu/config.py (KMamiz src/GlobalSettings.ts:54-89)
that the port's modules read, with the same environment names and
defaults: the application's port, timezone, log level, store URI,
schedules and startup modes, the cluster's addresses (the Kubernetes API
and Zipkin), the external Data Processor, the static and wasm paths, the
endpoint-lifetime thresholds of the dependency model, the REST API's
version prefix, the forecast route's checkpoint directory, the
switches of the resilience layer and the stream engine, and those of the
telemetry (span tracing, the profiler's event ring and flight recorder,
torch.profiler captures, the SLO window and the sync guard), and the
lock witness's.

The switches of the resilience layer and the stream engine, and their
directories, are read by the functions below, which the modules call at
the moment they need the value (a test or an operator may set them after
import) and which the fields here take as their defaults: one reader per
variable. Their sizes (the trace-bomb cap, the quarantine's and the WAL's
bounds, the stream's depth and epoch) are the modules' constants at the
JAX package's defaults, given as constructor arguments where a caller
needs another value. The telemetry's switches, directories and bounds
are read the same way, one reader each, at the JAX package's defaults,
and so is the lock witness's switch (KMAMIZ_LOCK_WITNESS).
The control plane's switches (KMAMIZ_CONTROL, KMAMIZ_CONTROL_MODE) are
read by control/__init__.py at the call; its tuning values and the
tenancy layer's (the gather window, the tenant limit, the tenant header)
are module constants at the JAX defaults, given as arguments where a
caller needs another value. The JAX package's device, sparse-kernel,
fleet and cost knobs belong to subsystems not ported yet.
"""
from __future__ import annotations

import logging
import os
import re
from dataclasses import dataclass, field
from typing import Optional

logger = logging.getLogger("kmamiz_tpu_torch.config")


def _env_bool(name: str) -> bool:
    return os.environ.get(name) == "true"


def quarantine_enabled() -> bool:
    """KMAMIZ_QUARANTINE: on unless "0" (then a malformed ingest payload
    raises, 400, instead of diverting)."""
    return os.environ.get("KMAMIZ_QUARANTINE", "1") != "0"


def quarantine_dir() -> str:
    return os.environ.get("KMAMIZ_QUARANTINE_DIR", "./kmamiz-data/quarantine")


def tick_deadline_ms() -> float:
    """KMAMIZ_TICK_DEADLINE_MS: 0 (the default, or unparseable) = the
    watchdog off; > 0 = serve the last good tick, stale, past this."""
    try:
        return float(os.environ.get("KMAMIZ_TICK_DEADLINE_MS", 0))
    except ValueError:
        return 0.0


def wal_enabled() -> bool:
    """KMAMIZ_WAL=1 turns the ingest WAL on (off by default)."""
    return os.environ.get("KMAMIZ_WAL", "0") == "1"


def wal_dir() -> str:
    return os.environ.get("KMAMIZ_WAL_DIR", "./kmamiz-data/wal")


def stream_enabled(default: str = "0") -> bool:
    """KMAMIZ_STREAM: overlapped micro-ticks unless unset, "0", "false"
    or empty (the serial tick)."""
    return os.environ.get("KMAMIZ_STREAM", default) not in ("0", "false", "")


def _env_switch(name: str) -> bool:
    """A telemetry switch: on unless "0", "false" or empty."""
    return os.environ.get(name, "1") not in ("0", "false", "")


def _env_number(name: str, default, floor, kind=int):
    try:
        return max(floor, kind(os.environ.get(name, str(default))))
    except ValueError:
        return default


def telemetry_enabled() -> bool:
    """KMAMIZ_TELEMETRY: the tick's span traces, on by default. The
    tracer reads it once per tick."""
    return _env_switch("KMAMIZ_TELEMETRY")


def trace_ring() -> int:
    """KMAMIZ_TRACE_RING: finished tick traces kept (256, floor 1)."""
    return _env_number("KMAMIZ_TRACE_RING", 256, 1)


def prof_enabled() -> bool:
    """KMAMIZ_PROF: the profiler's event ring and flight recorder, on by
    default; read once per tick."""
    return _env_switch("KMAMIZ_PROF")


def prof_ring() -> int:
    """KMAMIZ_PROF_RING: events the profiler's ring holds (4,096, floor 64)."""
    return _env_number("KMAMIZ_PROF_RING", 4096, 64)


def prof_flight_dir() -> str:
    return os.environ.get("KMAMIZ_PROF_FLIGHT_DIR") or os.path.join("kmamiz-data", "flight")


def prof_flight_ticks() -> int:
    """KMAMIZ_PROF_FLIGHT_TICKS: ticks of evidence a flight artifact
    freezes (64, floor 1)."""
    return _env_number("KMAMIZ_PROF_FLIGHT_TICKS", 64, 1)


def prof_flight_max() -> int:
    """KMAMIZ_PROF_FLIGHT_MAX: flight artifacts kept per namespace (16,
    floor 1)."""
    return _env_number("KMAMIZ_PROF_FLIGHT_MAX", 16, 1)


def prof_flight_debounce_s() -> float:
    """KMAMIZ_PROF_FLIGHT_DEBOUNCE_S: the least time between two flight
    artifacts of one namespace (5 s, floor 0)."""
    return _env_number("KMAMIZ_PROF_FLIGHT_DEBOUNCE_S", 5.0, 0.0, float)


def profile_dir() -> Optional[str]:
    """KMAMIZ_PROFILE_DIR: where torch.profiler captures go; unset, the
    tick's capture points capture nothing."""
    return os.environ.get("KMAMIZ_PROFILE_DIR") or None


def profile_count() -> int:
    """KMAMIZ_PROFILE_COUNT: tick captures per process (8; a value that is
    not an integer logs a warning and counts as 8)."""
    raw = os.environ.get("KMAMIZ_PROFILE_COUNT", "8")
    try:
        return max(int(raw), 0)
    except ValueError:
        logger.warning("KMAMIZ_PROFILE_COUNT=%r is not an integer; using 8", raw)
        return 8


def profile_max_s() -> float:
    """KMAMIZ_PROFILE_MAX_S: the longest on-demand capture window (10 s,
    floor 1 ms)."""
    return _env_number("KMAMIZ_PROFILE_MAX_S", 10.0, 0.001, float)


def slo_window() -> int:
    """KMAMIZ_SLO_WINDOW: ticks in the scorecard's rolling window (512,
    floor 8)."""
    return _env_number("KMAMIZ_SLO_WINDOW", 512, 8)


def lock_witness() -> bool:
    """KMAMIZ_LOCK_WITNESS: the runtime lock witness
    (analysis/concurrency/witness.py), off unless set to a value other
    than "0", "false" or empty."""
    return os.environ.get("KMAMIZ_LOCK_WITNESS", "0") not in ("0", "false", "")


def transfer_guard() -> str:
    """KMAMIZ_TRANSFER_GUARD as given (stripped, lower case): the sync
    guard's level (analysis/guards.py parses it)."""
    return os.environ.get("KMAMIZ_TRANSFER_GUARD", "").strip().lower()


@dataclass
class Settings:
    port: str = field(default_factory=lambda: os.environ.get("PORT", "3000"))
    timezone: str = field(default_factory=lambda: os.environ.get("TZ", "Asia/Taipei"))
    api_version: str = field(default_factory=lambda: os.environ.get("API_VERSION", "1"))
    log_level: str = field(default_factory=lambda: os.environ.get("LOG_LEVEL", "info"))
    kube_api_host: str = field(
        default_factory=lambda: os.environ.get("KUBEAPI_HOST", "http://127.0.0.1:8080")
    )
    is_running_in_kubernetes: bool = field(
        default_factory=lambda: _env_bool("IS_RUNNING_IN_K8S")
    )
    zipkin_url: str = field(
        default_factory=lambda: os.environ.get("ZIPKIN_URL", "http://localhost:9411")
    )
    storage_uri: str = field(
        default_factory=lambda: os.environ.get(
            "STORAGE_URI", os.environ.get("MONGODB_URI", "file://./kmamiz-data")
        )
    )
    external_data_processor: str = field(
        default_factory=lambda: os.environ.get("EXTERNAL_DATA_PROCESSOR", "")
    )
    # checkpoint directory of the forecast route (models/checkpoint.py)
    model_dir: str = field(
        default_factory=lambda: os.environ.get("KMAMIZ_MODEL_DIR", "")
    )
    aggregate_interval: str = field(
        default_factory=lambda: os.environ.get("AGGREGATE_INTERVAL", "*/5 * * * *")
    )
    realtime_interval: str = field(
        default_factory=lambda: os.environ.get("REALTIME_INTERVAL", "0/5 * * * *")
    )
    dispatch_interval: str = field(
        default_factory=lambda: os.environ.get("DISPATCH_INTERVAL", "0/30 * * * *")
    )
    # informational: which EnvoyFilter variant the mesh runs (info |
    # warning); the log pull parses telemetry lines at any level
    envoy_log_level: str = field(
        default_factory=lambda: os.environ.get("ENVOY_LOG_LEVEL", "info")
    )
    reset_endpoint_dependencies: bool = field(
        default_factory=lambda: _env_bool("RESET_ENDPOINT_DEPENDENCIES")
    )
    read_only_mode: bool = field(default_factory=lambda: _env_bool("READ_ONLY_MODE"))
    enable_testing_endpoints: bool = field(
        default_factory=lambda: _env_bool("ENABLE_TESTING_ENDPOINTS")
    )
    # the port of the kmamiz service the startup sync handshake calls
    service_port: str = field(
        default_factory=lambda: os.environ.get("SERVICE_PORT", os.environ.get("PORT", "3000"))
    )
    serve_only: bool = field(default_factory=lambda: _env_bool("SERVE_ONLY"))
    inactive_endpoint_threshold: str = field(
        default_factory=lambda: os.environ.get("INACTIVE_ENDPOINT_THRESHOLD", "")
    )
    deprecated_endpoint_threshold: str = field(
        default_factory=lambda: os.environ.get("DEPRECATED_ENDPOINT_THRESHOLD", "")
    )
    simulator_mode: bool = field(default_factory=lambda: _env_bool("SIMULATOR_MODE"))
    # static serving (index.ts:46-53): SPA build dir + Envoy filter binary
    static_dir: str = field(
        default_factory=lambda: os.environ.get("KMAMIZ_STATIC_DIR", "./dist")
    )
    wasm_path: str = field(
        default_factory=lambda: os.environ.get(
            "KMAMIZ_WASM_PATH", "./envoy/filter/kmamiz_filter.wasm"
        )
    )

    # the resilience layer and the stream engine: their switches and
    # directories, read by the functions above
    quarantine_enabled: bool = field(default_factory=quarantine_enabled)
    quarantine_dir: str = field(default_factory=quarantine_dir)
    tick_deadline_ms: float = field(default_factory=tick_deadline_ms)
    wal_enabled: bool = field(default_factory=wal_enabled)
    wal_dir: str = field(default_factory=wal_dir)
    stream_enabled: bool = field(default_factory=stream_enabled)
    # the runtime lock witness's switch, which the witness reads at arm
    # time; the field mirrors it so one `Settings()` dump shows everything
    lock_witness: bool = field(default_factory=lock_witness)

    def __post_init__(self) -> None:
        # in a cluster, the API server's own address (KubernetesService.ts)
        k8s_host = os.environ.get("KUBERNETES_SERVICE_HOST")
        k8s_port = os.environ.get("KUBERNETES_SERVICE_PORT")
        if self.is_running_in_kubernetes and k8s_host and k8s_port:
            self.kube_api_host = f"https://{k8s_host}:{k8s_port}"


_THRESHOLD_RE = re.compile(r"(?:(\d+)d)?(?:(\d+)h)?(?:(\d+)m)?")


def parse_threshold_ms(threshold: str) -> int:
    """Parse "1d2h30m"-style thresholds to milliseconds
    (reference EndpointDependencies.parseThresholdToMilliseconds)."""
    if not threshold:
        return 0
    m = _THRESHOLD_RE.match(threshold)
    if not m:
        return 0
    days = int(m.group(1) or 0)
    hours = int(m.group(2) or 0)
    minutes = int(m.group(3) or 0)
    return (days * 86400 + hours * 3600 + minutes * 60) * 1000


settings = Settings()
