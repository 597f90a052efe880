"""JSON body schema inference and interface-string utilities.

Behavioral parity with the reference's schema tooling:
- ObjectToInterfaceString / json-to-ts emission
  (KMamiz src/utils/Utils.ts:14-75; the Rust twin is
  KMamiz kmamiz_data_processor/src/json_utils.rs:35-108)
- interface field extraction + cosine similarity (Utils.ts:150-177)
- JSON merging with array limit (Utils.ts:279-309)
- OpenAPI type mapping (Utils.ts:207-235)

The emitted "TypeScript interface" strings are a wire format consumed by the
frontend and by the cohesion (SIDC) scorer, so the exact text matters:
sorted keys, shared-subtype dedup, singularized array item names, and
`field?: any;` for nulls all mirror the reference.
"""
from __future__ import annotations

import json
import math
import re
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from kmamiz_tpu_torch import native


def is_primitive(obj: Any) -> bool:
    return not isinstance(obj, (dict, list))


def js_typeof(value: Any) -> str:
    if isinstance(value, bool):
        return "boolean"
    if isinstance(value, (int, float)):
        return "number"
    if isinstance(value, str):
        return "string"
    if value is None:
        return "object"  # JS: typeof null === "object"
    return "object"


def sort_object(obj: Any) -> Any:
    """Recursively sort object keys (reference Utils.sortObject)."""
    if isinstance(obj, list):
        if all(is_primitive(o) for o in obj):
            return obj
        return [sort_object(o) for o in obj if not is_primitive(o)]
    if not isinstance(obj, dict):
        return obj
    out: Dict[str, Any] = {}
    for k in sorted(obj.keys()):
        o = obj[k]
        if isinstance(o, list):
            if o and all(isinstance(i, dict) for i in o):
                o = [sort_object(i) for i in o]
        elif isinstance(o, dict):
            o = sort_object(o)
        out[k] = o
    return out


def _singular(word: str) -> str:
    """Naive singularization matching common json-to-ts outputs."""
    if word.endswith("ies") and len(word) > 3:
        return word[:-3] + "y"
    if word.endswith("ses") and len(word) > 3:
        return word[:-2]
    if word.endswith("s") and not word.endswith("ss") and len(word) > 1:
        return word[:-1]
    return word


def _capitalize(word: str) -> str:
    return word[:1].upper() + word[1:] if word else word


class _InterfaceEmitter:
    """Emits json-to-ts-style interface declarations with subtype dedup."""

    def __init__(self) -> None:
        self._sig_to_name: Dict[Tuple, str] = {}
        self._used_names: Set[str] = set()
        self._out: List[Tuple[str, List[str]]] = []

    def render(self) -> str:
        decls = []
        for name, lines in self._out:
            if lines:
                decls.append(f"interface {name} {{\n" + "\n".join(lines) + "\n}")
            else:
                decls.append(f"interface {name} {{\n}}")
        return "\n".join(decls)

    # -- structural signatures (for shared-subtype dedup) --

    def _merge_fields(
        self, samples: Sequence[dict]
    ) -> List[Tuple[str, List[Any], bool]]:
        keys: List[str] = []
        seen: Set[str] = set()
        for s in samples:
            for k in s.keys():
                if k not in seen:
                    seen.add(k)
                    keys.append(k)
        fields = []
        for k in keys:
            present = [s[k] for s in samples if k in s]
            optional = len(present) < len(samples) or any(v is None for v in present)
            values = [v for v in present if v is not None]
            fields.append((k, values, optional))
        return fields

    def _value_sig(self, values: List[Any]) -> Tuple:
        if not values:
            return ("any",)
        if all(isinstance(v, dict) for v in values):
            return ("obj", self._shape_sig(values))
        if all(isinstance(v, list) for v in values):
            items = [i for v in values for i in v]
            if not items:
                return ("arr", ("any",))
            if all(is_primitive(i) for i in items):
                types = {js_typeof(i) for i in items if i is not None}
                return ("arr", (types.pop(),) if len(types) == 1 else ("any",))
            if all(isinstance(i, dict) for i in items):
                return ("arr", ("obj", self._shape_sig(items)))
            return ("arr", ("any",))
        if all(is_primitive(v) for v in values):
            types = {js_typeof(v) for v in values}
            return (types.pop(),) if len(types) == 1 else ("any",)
        return ("any",)

    def _shape_sig(self, samples: Sequence[dict]) -> Tuple:
        return tuple(
            (k, optional, self._value_sig(values))
            for k, values, optional in self._merge_fields(samples)
        )

    # -- emission --

    def _unique_name(self, hint: str) -> str:
        name = _capitalize(hint) or "Root"
        if name not in self._used_names:
            self._used_names.add(name)
            return name
        i = 2
        while f"{name}{i}" in self._used_names:
            i += 1
        self._used_names.add(f"{name}{i}")
        return f"{name}{i}"

    def process_shape(self, name_hint: str, samples: Sequence[dict]) -> str:
        # a top-level array can mix dicts with nested arrays; only dict
        # samples contribute fields (non-dicts would crash the key walk)
        samples = [s for s in samples if isinstance(s, dict)]
        sig = self._shape_sig(samples)
        existing = self._sig_to_name.get(sig)
        if existing is not None:
            return existing
        name = self._unique_name(name_hint)
        self._sig_to_name[sig] = name
        lines: List[str] = []
        self._out.append((name, lines))
        for key, values, optional in self._merge_fields(samples):
            rendered = self._render_type(key, values)
            q = "?" if optional else ""
            lines.append(f"  {key}{q}: {rendered};")
        return name

    def _render_type(self, key: str, values: List[Any]) -> str:
        if not values:
            return "any"
        if all(isinstance(v, dict) for v in values):
            return self.process_shape(key, values)
        if all(isinstance(v, list) for v in values):
            items = [i for v in values for i in v]
            if not items:
                return "any[]"
            if all(is_primitive(i) for i in items):
                types = {js_typeof(i) for i in items if i is not None}
                return (types.pop() if len(types) == 1 else "any") + "[]"
            if all(isinstance(i, dict) for i in items):
                return self.process_shape(_singular(key), items) + "[]"
            return "any[]"
        if all(is_primitive(v) for v in values):
            types = {js_typeof(v) for v in values}
            return types.pop() if len(types) == 1 else "any"
        return "any"


def json_to_ts(obj: Any, root_name: str = "Root") -> str:
    """Render an object (or list of objects) as interface declarations."""
    emitter = _InterfaceEmitter()
    samples = obj if isinstance(obj, list) else [obj]
    emitter.process_shape(root_name, samples)
    return emitter.render()


def _primitive_interface(obj: Any) -> Optional[str]:
    if not isinstance(obj, list):
        return None
    primitive_types = [js_typeof(o) for o in obj if is_primitive(o)]
    if not primitive_types:
        return None
    uniq = list(dict.fromkeys(primitive_types))
    return "[\n" + ",\n".join(f"  {t}" for t in uniq) + "\n]"


#: object_to_interface_string's answers by (name, repr of the object)
_INTERFACES: Dict[Tuple[str, str], str] = {}
_INTERFACES_MAX = 65_536


def object_to_interface_string(obj: Any, name: str = "Root") -> str:
    """Craft a TypeScript interface string from an object (Utils.ts:14-36).

    Memoized by the object's repr, of which the string is a function for
    the JSON values it is given: the realtime tick renders the same bodies
    for every datatype and combined record it merges."""
    key = (name, repr(obj))
    out = _INTERFACES.get(key)
    if out is None:
        if len(_INTERFACES) >= _INTERFACES_MAX:
            _INTERFACES.clear()
        out = _INTERFACES[key] = _object_to_interface_string(obj, name)
    return out


def _object_to_interface_string(obj: Any, name: str) -> str:
    if is_primitive(obj):
        return js_typeof(obj)
    sorted_obj = sort_object(obj)
    if isinstance(sorted_obj, list):
        array_type = "Array<any>{}"
        appending = ""
        if len(obj) > 0:
            if is_primitive(obj[0]):
                array_type = f"Array<{js_typeof(obj[0])}>{{}}"
            else:
                array_type = "Array<ArrayItem>{}\n"
                appending = json_to_ts(sorted_obj, root_name="ArrayItem")
        return f"interface {name} extends {array_type}{appending}"
    primitive_part = _primitive_interface(obj)
    obj_part = json_to_ts(sorted_obj, root_name=name) if isinstance(sorted_obj, dict) else None
    return (obj_part or "") + (primitive_part or "")


# ---------------------------------------------------------------------------
# interface field extraction + cosine similarity (Utils.ts:150-177)
# ---------------------------------------------------------------------------

_FIELD_LINE_RE = re.compile(r"^[ ]+([^{}\n])*", re.M)
_EXTENDS_RE = re.compile(r"extends (Array<[^>]*>)")


def match_interface_field_and_trim(interface_str: str) -> Set[str]:
    fields = set()
    for m in _FIELD_LINE_RE.finditer(interface_str):
        fields.add(m.group(0).strip())
    for m in _EXTENDS_RE.finditer(interface_str):
        fields.add(m.group(0).strip())
    return fields


def create_standard_vector(base: Sequence[str], vector: Set[str]) -> List[float]:
    v = [1.0 if b in vector else 0.0 for b in base]
    mag = math.sqrt(sum(x * x for x in v))
    return [x / mag if mag else 0.0 for x in v]


def cos_sim(vector_a: Sequence[float], vector_b: Sequence[float]) -> float:
    return sum(a * b for a, b in zip(vector_a, vector_b))


def interface_cosine_similarity(interface_a: str, interface_b: str) -> float:
    set_a = match_interface_field_and_trim(interface_a)
    set_b = match_interface_field_and_trim(interface_b)
    base = sorted(set_a | set_b)
    return cos_sim(
        create_standard_vector(base, set_a), create_standard_vector(base, set_b)
    )


# ---------------------------------------------------------------------------
# JSON merging (Utils.ts:279-309)
# ---------------------------------------------------------------------------


def js_str(value: Any) -> str:
    """JS template-literal coercion: undefined -> 'undefined', booleans to
    lowercase; used where the reference embeds possibly-missing values in
    tab-joined keys."""
    if value is None:
        return "undefined"
    if value is True:
        return "true"
    if value is False:
        return "false"
    return str(value)


def js_truthy(value: Any) -> bool:
    if value is None or value is False:
        return False
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, float)):
        return value != 0 and value == value  # 0 and NaN are falsy
    if isinstance(value, str):
        return value != ""
    return True  # {}, [] are truthy in JS


def merge(a: Any, b: Any) -> Any:
    if isinstance(a, list) and isinstance(b, list):
        return merge_array(a, b)
    if not isinstance(a, list) and not isinstance(b, list):
        return merge_object(a, b)
    return a if js_truthy(a) else b


def _spread(value: Any) -> dict:
    """JS object-spread semantics: dicts spread their entries, ARRAYS
    their index-keyed elements ({...[x]} === {"0": x} — array-bodied
    JSON samples must reach the interface inference),
    strings their indexed characters, everything else (null/number/
    bool) spreads to nothing."""
    if isinstance(value, dict):
        return value
    if isinstance(value, (list, tuple)):
        return {str(i): v for i, v in enumerate(value)}
    if isinstance(value, str):
        return {str(i): c for i, c in enumerate(value)}
    return {}


def merge_object(a: Any, b: Any) -> Any:
    return {**_spread(a), **_spread(b)}


def merge_array(a: List[Any], b: List[Any], limit: int = 10) -> List[Any]:
    return a[:limit] + b[:limit]


_UNPARSED = object()  # JS `undefined` (distinct from parsed JSON null)


def merge_string_body(a: Optional[str], b: Optional[str]) -> Optional[str]:
    if a and b:
        parsed_a = parsed_b = _UNPARSED
        try:
            parsed_a = json.loads(a)
        except (json.JSONDecodeError, TypeError):
            pass
        try:
            parsed_b = json.loads(b)
        except (json.JSONDecodeError, TypeError):
            pass
        a_truthy = parsed_a is not _UNPARSED and js_truthy(parsed_a)
        b_truthy = parsed_b is not _UNPARSED and js_truthy(parsed_b)
        if a_truthy and b_truthy:
            return json_stringify(merge(parsed_a, parsed_b))
        chosen = parsed_a if a_truthy else parsed_b
        if chosen is _UNPARSED:
            return None  # JS: JSON.stringify(undefined) -> undefined
        return json_stringify(chosen)
    return a or b


def json_stringify(obj: Any) -> str:
    """JSON.stringify-compatible serialization (compact separators)."""
    return json.dumps(obj, separators=(",", ":"), ensure_ascii=False)


def fold_string_bodies(bodies: Sequence[Optional[str]]) -> Optional[str]:
    """Left-fold merge_string_body over a group's bodies (the per-group loop
    in RealtimeDataList.toCombinedRealtimeData)."""
    if not bodies:
        return None
    acc = bodies[0]
    for body in bodies[1:]:
        acc = merge_string_body(acc, body)
    return acc


def _parse_and_infer(
    merged: Optional[str],
    content_type: Optional[str],
    precomputed_interface: Optional[str] = None,
) -> Tuple[Optional[Any], Optional[str]]:
    """json.loads the merged body and infer its interface when the content
    type is JSON (one side of parse_request_response_body)."""
    if content_type != "application/json":
        return None, None
    try:
        body = json.loads(merged)
    except (json.JSONDecodeError, TypeError):
        return None, None
    interface = (
        precomputed_interface
        if precomputed_interface is not None
        else object_to_interface_string(body)
    )
    return body, interface


def body_pairs_for_groups(
    row_groups: Sequence[Sequence[dict]],
) -> List[Tuple[List[Optional[str]], Optional[str]]]:
    """Build the (bodies, content_type) pairs merge_and_infer_bodies expects
    from per-(endpoint, status) row groups: two pairs per group, request at
    2*i and response at 2*i+1 (the convention both the realtime combine and
    the DataProcessor assembly rely on)."""
    pairs: List[Tuple[List[Optional[str]], Optional[str]]] = []
    for rows in row_groups:
        pairs.append(
            (
                [r.get("requestBody") for r in rows],
                rows[0].get("requestContentType"),
            )
        )
        pairs.append(
            (
                [r.get("responseBody") for r in rows],
                rows[0].get("responseContentType"),
            )
        )
    return pairs


def merge_and_infer_bodies(
    pairs: Sequence[Tuple[Sequence[Optional[str]], Optional[str]]],
) -> List[Tuple[Optional[Any], Optional[str]]]:
    """Batched body pipeline: for each (bodies, content_type) pair, fold the
    group's raw JSON bodies with merge_string_body and, for JSON content,
    return (parsed_merged_body, interface_string).

    Runs on the native C++ fold (csrc/kmamiz_json.cpp, the twin of
    KMamiz's Rust json_utils.rs) in one call for every pair that holds a
    body. A pair without one folds to None, which parses to (None, None)
    under any content type, so it does not cross to the library: marshalling
    it costs more than the fold (spans without envoy logs carry no bodies).
    The pure-Python fold above runs only where the reference runs it: for a
    group the native side hands back (nesting too deep), for an interface
    it flags as needing Python, and for every pair when the native answer's
    length does not match its input.
    """
    todo = [i for i, (bodies, _ct) in enumerate(pairs) if any(b is not None for b in bodies)]
    results = native.process_body_groups(
        [(pairs[i][0], pairs[i][1] == "application/json") for i in todo]
    )
    if len(results) != len(todo):
        return merge_and_infer_bodies_python(pairs)
    out: List[Tuple[Optional[Any], Optional[str]]] = [(None, None)] * len(pairs)
    for i, res in zip(todo, results):
        bodies, ct = pairs[i]
        if res is None:  # the native side handed this group back
            out[i] = _parse_and_infer(fold_string_bodies(bodies), ct)
            continue
        merged, interface, needs_python = res
        out[i] = _parse_and_infer(merged, ct, None if needs_python else interface)
    return out


def merge_and_infer_bodies_python(
    pairs: Sequence[Tuple[Sequence[Optional[str]], Optional[str]]],
) -> List[Tuple[Optional[Any], Optional[str]]]:
    """merge_and_infer_bodies in pure Python: the plain version the native
    fold is held to (tests, chip_smoke)."""
    return [
        _parse_and_infer(fold_string_bodies(bodies), ct) for bodies, ct in pairs
    ]


# ---------------------------------------------------------------------------
# OpenAPI type mapping (Utils.ts:207-235)
# ---------------------------------------------------------------------------


def map_object_to_openapi_types(o: Any) -> dict:
    if isinstance(o, list):
        item_types = None
        if len(o) > 0:
            if is_primitive(o[0]):
                item_types = {"type": js_typeof(o[0])}
            else:
                combined: Any = {}
                for item in o:
                    combined = merge(combined, item)
                item_types = map_object_to_openapi_types(combined)
        result = {"type": "array", "items": item_types or {"type": "object"}}
        if item_types is None:
            result["example"] = []
        return result
    if not js_truthy(o):
        return {"type": "object", "nullable": True}
    if not isinstance(o, dict):
        return {"type": "object", "properties": {}}
    properties: Dict[str, Any] = {}
    for k, v in o.items():
        if isinstance(v, (dict, list)) or v is None:
            # typeof null === "object": nulls recurse to a nullable object
            properties[k] = map_object_to_openapi_types(v)
        else:
            properties[k] = {"type": js_typeof(v)}
    return {"type": "object", "properties": properties}
