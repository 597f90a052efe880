"""Global configuration from environment variables.

The part of kmamiz_tpu/config.py (KMamiz src/GlobalSettings.ts:54-89)
that the port's modules read: the endpoint-lifetime thresholds of the
dependency model, the REST API's version prefix, and the forecast route's
checkpoint directory. The rest of the JAX package's settings belong to
subsystems not ported yet and join this file with them.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field


@dataclass
class Settings:
    inactive_endpoint_threshold: str = field(
        default_factory=lambda: os.environ.get("INACTIVE_ENDPOINT_THRESHOLD", "")
    )
    deprecated_endpoint_threshold: str = field(
        default_factory=lambda: os.environ.get("DEPRECATED_ENDPOINT_THRESHOLD", "")
    )
    api_version: str = field(default_factory=lambda: os.environ.get("API_VERSION", "1"))
    # checkpoint directory of the forecast route (models/checkpoint.py)
    model_dir: str = field(
        default_factory=lambda: os.environ.get("KMAMIZ_MODEL_DIR", "")
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
