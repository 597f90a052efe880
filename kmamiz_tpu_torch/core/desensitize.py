"""Type-preserving JSON de-identification.

Equivalent of the reference's two body-scrubbing implementations:
- the Envoy WASM filter's gjson walk that replaces every JSON value with a
  type-preserving zero value before logging (KMamiz envoy/wasm/main.go:210-240);
- the simulator's sample de-identification
  (KMamiz src/MicroViSim-simulator/classes/SimConfigPreprocessor/
  SimConfigServicesInfoPreprocessor.ts:253-284).

Strings -> "", numbers -> 0, booleans -> false, anything else -> null;
containers keep their shape. (The WASM filter's scrubber, which preserves
booleans/null, lives in kmamiz_tpu_torch.core.envoy_filter.)
"""
from __future__ import annotations

from typing import Any

_TYPE_ZERO = {"string": "", "number": 0, "boolean": False}


def deidentify_sample(value: Any) -> Any:
    """Replace every leaf of a parsed JSON sample with its zero value."""
    if isinstance(value, list):
        return [deidentify_sample(v) for v in value]
    if isinstance(value, dict):
        return {k: deidentify_sample(v) for k, v in value.items()}
    if isinstance(value, bool):  # bool before int: True is an int in Python
        return False
    if isinstance(value, str):
        return ""
    if isinstance(value, (int, float)):
        return 0
    return None


def deidentify_type_definition(value: Any) -> Any:
    """Replace type-name leaves ("string"/"number"/"boolean") of a parsed
    type-definition JSON with zero values; unknown names become null."""
    if isinstance(value, list):
        return [deidentify_type_definition(v) for v in value]
    if isinstance(value, dict):
        return {k: deidentify_type_definition(v) for k, v in value.items()}
    if isinstance(value, str) and value in _TYPE_ZERO:
        return _TYPE_ZERO[value]
    return None
