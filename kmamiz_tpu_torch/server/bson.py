"""Minimal BSON codec for the Mongo store backend.

The image ships no pymongo/bson, so the MongoStore
(kmamiz_tpu_torch.server.mongo) carries its own codec for the subset the
framework persists — JSON-shaped documents (dict/list/str/int/float/
bool/None). Decoding additionally understands ObjectId (as the
round-tripping 24-hex str subclass below) and UTC datetime (as epoch
ms) so documents written by other Mongo clients (the reference app
shares the database, KMamiz src/services/MongoOperator.ts:31-93)
read back cleanly AND can be addressed by _id again.

A copy of kmamiz_tpu/server/bson.py, importing the port's modules.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1
_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1


class BsonError(ValueError):
    pass


class Int64(int):
    """Marker forcing int64 encoding (tag 0x12) regardless of magnitude —
    MongoDB requires some fields (getMore cursor ids) to be BSON longs."""


class ObjectId(str):
    """A decoded BSON ObjectId, behaving as its 24-hex string (so JSON
    dumps, dict keys, and string comparisons keep working) while
    re-encoding byte-exactly as tag 0x07. Without the round trip, a
    delete/upsert keyed by an _id the REFERENCE app wrote (Mongoose
    ObjectIds in the shared database) re-encoded as a BSON string and
    never matched: the replace-all sync could not purge those documents
    and stale data was served forever."""

    __slots__ = ()

    def __new__(cls, value: str) -> "ObjectId":
        v = str(value)
        if len(v) != 24:
            raise BsonError(f"ObjectId must be 24 hex chars: {v!r}")
        bytes.fromhex(v)  # validates
        return super().__new__(cls, v)


# -- encoding ---------------------------------------------------------------


def _encode_cstring(s: str) -> bytes:
    raw = s.encode("utf-8")
    if b"\x00" in raw:
        raise BsonError(f"key contains NUL: {s!r}")
    return raw + b"\x00"


def _encode_value(key: str, value: Any, out: bytearray) -> None:
    name = _encode_cstring(key)
    if value is None:
        out += b"\x0a" + name
    elif value is True or value is False:
        out += b"\x08" + name + (b"\x01" if value else b"\x00")
    elif isinstance(value, Int64):
        if not _INT64_MIN <= value <= _INT64_MAX:
            raise BsonError(f"integer out of int64 range: {key}")
        out += b"\x12" + name + struct.pack("<q", value)
    elif isinstance(value, int):  # bool handled above
        if _INT32_MIN <= value <= _INT32_MAX:
            out += b"\x10" + name + struct.pack("<i", value)
        elif _INT64_MIN <= value <= _INT64_MAX:
            out += b"\x12" + name + struct.pack("<q", value)
        else:
            raise BsonError(f"integer out of int64 range: {key}")
    elif isinstance(value, float):
        out += b"\x01" + name + struct.pack("<d", value)
    elif isinstance(value, (bytes, bytearray)):  # binary, generic subtype
        out += (
            b"\x05" + name + struct.pack("<i", len(value)) + b"\x00" + bytes(value)
        )
    elif isinstance(value, ObjectId):  # before str: ObjectId IS a str
        out += b"\x07" + name + bytes.fromhex(value)
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        out += b"\x02" + name + struct.pack("<i", len(raw) + 1) + raw + b"\x00"
    elif isinstance(value, dict):
        out += b"\x03" + name + encode(value)
    elif isinstance(value, (list, tuple)):
        out += b"\x04" + name
        out += encode({str(i): v for i, v in enumerate(value)})
    else:
        raise BsonError(f"unsupported BSON type for {key}: {type(value)}")


def encode(doc: Dict[str, Any]) -> bytes:
    body = bytearray()
    for key, value in doc.items():
        _encode_value(key, value, body)
    return struct.pack("<i", len(body) + 5) + bytes(body) + b"\x00"


# -- decoding ---------------------------------------------------------------


def _decode_cstring(buf: bytes, pos: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("utf-8"), end + 1


def _decode_value(tag: int, buf: bytes, pos: int) -> Tuple[Any, int]:
    if tag == 0x01:  # double
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if tag == 0x02:  # string
        (length,) = struct.unpack_from("<i", buf, pos)
        start = pos + 4
        return buf[start : start + length - 1].decode("utf-8"), start + length
    if tag in (0x03, 0x04):  # document / array
        (length,) = struct.unpack_from("<i", buf, pos)
        sub = decode(buf[pos : pos + length])
        if tag == 0x04:
            return [sub[k] for k in sorted(sub, key=int)], pos + length
        return sub, pos + length
    if tag == 0x05:  # binary: subtype byte + payload
        (length,) = struct.unpack_from("<i", buf, pos)
        start = pos + 5
        return bytes(buf[start : start + length]), start + length
    if tag == 0x07:  # ObjectId -> 24-hex string subclass (re-encodes 0x07)
        return ObjectId(buf[pos : pos + 12].hex()), pos + 12
    if tag == 0x08:
        return buf[pos] != 0, pos + 1
    if tag == 0x09:  # UTC datetime -> epoch ms
        return struct.unpack_from("<q", buf, pos)[0], pos + 8
    if tag == 0x0A:  # null
        return None, pos
    if tag == 0x10:
        return struct.unpack_from("<i", buf, pos)[0], pos + 4
    if tag == 0x11:  # timestamp (internal) -> int
        return struct.unpack_from("<Q", buf, pos)[0], pos + 8
    if tag == 0x12:
        return struct.unpack_from("<q", buf, pos)[0], pos + 8
    raise BsonError(f"unsupported BSON tag 0x{tag:02x}")


def decode(buf: bytes) -> Dict[str, Any]:
    if len(buf) < 5:
        raise BsonError("document too short")
    (length,) = struct.unpack_from("<i", buf, 0)
    if length > len(buf) or buf[length - 1] != 0:
        raise BsonError("malformed document")
    out: Dict[str, Any] = {}
    pos = 4
    while pos < length - 1:
        tag = buf[pos]
        key, pos = _decode_cstring(buf, pos + 1)
        out[key], pos = _decode_value(tag, buf, pos)
    return out


def decode_sequence(buf: bytes) -> List[Dict[str, Any]]:
    """Decode back-to-back documents (OP_MSG kind-1 payloads)."""
    docs = []
    pos = 0
    while pos < len(buf):
        (length,) = struct.unpack_from("<i", buf, pos)
        docs.append(decode(buf[pos : pos + length]))
        pos += length
    return docs
