"""Endpoint body preprocessing for the simulation config.

Equivalent of the body half of the reference's servicesInfo preprocessor
(KMamiz src/MicroViSim-simulator/classes/SimConfigPreprocessor/
SimConfigServicesInfoPreprocessor.ts:49-284): users may provide a request/
response body either as a JSON sample or as a TypeScript-like type
definition (`{ name: string, age: number }`); both are normalized to a
de-identified JSON sample string that the realtime pipeline can infer
schemas from.
"""
from __future__ import annotations

import json
import re
from typing import Tuple

from kmamiz_tpu_torch.core.desensitize import (
    deidentify_sample,
    deidentify_type_definition,
)

_TYPE_DEF_RE = re.compile(r":\s*(string|number|boolean|null|any|\{|\[)", re.I)


def classify_body(body: str) -> str:
    """-> "sample" | "typeDefinition" | "empty" | "unknown"
    (SimConfigServicesInfoPreprocessor.ts:134-151)."""
    if _is_json_sample(body):
        return "sample"
    if _TYPE_DEF_RE.search(body.strip()):
        return "typeDefinition"
    if not body.strip():
        return "empty"
    return "unknown"


def _is_json_sample(body: str) -> bool:
    try:
        parsed = json.loads(body)
    except (json.JSONDecodeError, TypeError):
        return False
    return isinstance(parsed, (dict, list))


def type_definition_to_json(text: str) -> str:
    """Convert a TypeScript-like type definition into a JSON string whose
    leaves are the type names (SimConfigServicesInfoPreprocessor.ts:153-252)."""
    text = re.sub(r"\s+", " ", text).strip()
    if text.startswith("{") and text.endswith("}"):
        return "{" + _parse_properties(text[1:-1].strip()) + "}"
    return text


def _parse_properties(text: str) -> str:
    properties = []
    current = ""
    depth = 0
    for ch in text:
        if ch in "{[":
            depth += 1
        elif ch in "}]":
            depth -= 1
        if ch == "," and depth == 0:
            if current.strip():
                properties.append(_parse_property(current.strip()))
            current = ""
        else:
            current += ch
    if current.strip():
        properties.append(_parse_property(current.strip()))
    return ", ".join(properties)


def _parse_property(text: str) -> str:
    colon = text.find(":")
    if colon == -1:
        return text
    name = text[:colon].strip()
    return f'"{name}": {_parse_type(text[colon + 1:].strip())}'


def _parse_type(type_text: str) -> str:
    array_depth = 0
    base = type_text
    while base.endswith("[]"):
        array_depth += 1
        base = base[:-2]

    if base == "any" and array_depth:
        result = "[]"
        for _ in range(array_depth - 1):
            result = f"[{result}]"
        return result

    if base.startswith("{") and base.endswith("}"):
        result = type_definition_to_json(base)
    elif array_depth:
        result = f'"{base}"'
    else:
        return f'"{type_text}"'
    for _ in range(array_depth):
        result = f"[{result}]"
    return result


def preprocess_json_body(body: str) -> Tuple[bool, str, str]:
    """-> (ok, processed_body_string, warning). Normalizes a user-provided
    JSON body (sample or type definition) to a de-identified sample string
    (SimConfigServicesInfoPreprocessor.ts:91-133)."""
    kind = classify_body(body)
    try:
        if kind == "sample":
            processed = deidentify_sample(json.loads(body))
        elif kind == "typeDefinition":
            processed = deidentify_type_definition(
                json.loads(type_definition_to_json(body))
            )
        elif kind == "empty":
            processed = {}
        else:
            return (
                False,
                "",
                "Unrecognized format. Please provide a valid JSON sample or a "
                "type definition using only primitive types like string, "
                "number, or boolean (e.g., { name: string, age: number }).",
            )
        return True, json.dumps(processed, separators=(",", ":")), ""
    except (json.JSONDecodeError, ValueError) as err:
        return (
            False,
            "",
            "Failed to process input. Make sure it is valid JSON or a type "
            "definition using only primitive types like string, number, or "
            f"boolean (e.g., {{ name: string, age: number }}). err: {err}",
        )


def sample_to_user_defined_type(obj, indent_level: int = 0) -> str:
    """Inverse direction, used when exporting the live system back to a sim
    YAML: JSON sample -> type definition string (SimConfigGenerator.ts:227-264)."""
    if obj == {}:
        return "{}"
    indent = "  " * indent_level
    next_indent = "  " * (indent_level + 1)
    if isinstance(obj, list):
        if obj:
            return f"{sample_to_user_defined_type(obj[0], indent_level)}[]"
        return "any[]"
    if isinstance(obj, dict):  # non-empty: the {} case returned above
        lines = [
            f"{next_indent}{key}: {sample_to_user_defined_type(obj[key], indent_level + 1)}"
            for key in sorted(obj.keys())
        ]
        return "{\n" + ",\n".join(lines) + f"\n{indent}}}"
    if isinstance(obj, bool):
        return "boolean"
    if isinstance(obj, str):
        return "string"
    if isinstance(obj, (int, float)):
        return "number"
    return "null"
