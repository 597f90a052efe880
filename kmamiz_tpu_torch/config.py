"""Global configuration from environment variables.

The part of kmamiz_tpu/config.py (KMamiz src/GlobalSettings.ts:54-89)
that the port's modules read, with the same environment names and
defaults: the application's port, timezone, store URI, schedules and
startup modes, the external Data Processor, the static and wasm paths,
the endpoint-lifetime thresholds of the dependency model, the REST API's
version prefix, and the forecast route's checkpoint directory. The JAX
package's device, ingest-wire and resilience knobs belong to subsystems
not ported yet and join this file with them.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field


def _env_bool(name: str) -> bool:
    return os.environ.get(name) == "true"


@dataclass
class Settings:
    port: str = field(default_factory=lambda: os.environ.get("PORT", "3000"))
    timezone: str = field(default_factory=lambda: os.environ.get("TZ", "Asia/Taipei"))
    api_version: str = field(default_factory=lambda: os.environ.get("API_VERSION", "1"))
    is_running_in_kubernetes: bool = field(
        default_factory=lambda: _env_bool("IS_RUNNING_IN_K8S")
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
    reset_endpoint_dependencies: bool = field(
        default_factory=lambda: _env_bool("RESET_ENDPOINT_DEPENDENCIES")
    )
    read_only_mode: bool = field(default_factory=lambda: _env_bool("READ_ONLY_MODE"))
    enable_testing_endpoints: bool = field(
        default_factory=lambda: _env_bool("ENABLE_TESTING_ENDPOINTS")
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
