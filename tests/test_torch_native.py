"""The port's native host library against the JAX package's.

kmamiz_tpu_torch/native builds its own copy of the C++ sources with g++
into kmamiz_tpu_torch/csrc/build/; kmamiz_tpu.native builds the originals
into native/build/. On the same bytes the two must give the same parse
outputs (arrays, shapes, statuses, kept trace ids), the same skip-set and
session behaviour, the same KMZC frames, and the same body fold. A broken
compiler raises; nothing falls back to Python.
"""
from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np
import pytest

from conftest import load_fixture
from kmamiz_tpu import native as ref_native
from kmamiz_tpu.core import schema as ref_schema
from kmamiz_tpu.core import wire as ref_wire
from kmamiz_tpu_torch import native, synth
from kmamiz_tpu_torch.core import schema, wire
from kmamiz_tpu_torch.ops import host_build

REPO = Path(__file__).resolve().parent.parent

PARSE_ARRAYS = (
    "kind",
    "parent_idx",
    "shape_id",
    "status_id",
    "trace_of",
    "latency_ms",
    "timestamp_us",
    "shape_max_ts_ms",
)


def _groups(name):
    if name == "synth":
        return json.loads(synth.make_raw_window(120, 7, n_services=40, urls_per_service=5))
    if name == "legacy_synth":
        return json.loads(synth.make_raw_window(90, 5))
    data = load_fixture(name)
    return data if isinstance(data[0], list) else [data]


WINDOWS = ["pdas_traces", "pdas2_traces", "bookinfo_traces", "synth", "legacy_synth"]


def assert_parses_equal(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    for key in ("n_spans", "shapes", "statuses", "trace_ids"):
        assert got[key] == want[key], key
    for key in PARSE_ARRAYS:
        assert np.array_equal(got[key], want[key]), key


# -- build and isolation -------------------------------------------------------


def test_library_is_the_ports_own_build():
    path = native.library_path().resolve()
    assert path.is_relative_to(REPO / "kmamiz_tpu_torch" / "csrc" / "build")
    assert not path.is_relative_to(REPO / "native")
    assert path == host_build.library_path(native.NAME, native.SOURCES).resolve()
    assert host_build.build_info(path)["march"] in ("native", "generic")
    assert native.available() and native.supports_columnar()


@pytest.mark.parametrize("name", ["kmamiz_json", "kmamiz_spans", "kmamiz_native"])
def test_sources_are_copies_of_the_reference(name):
    """Byte for byte apart from the header line and the reference-tree
    paths in comments, which name the KMamiz project instead."""
    copy = (REPO / "kmamiz_tpu_torch" / "csrc" / f"{name}.cpp").read_text()
    original = (REPO / "native" / f"{name}.cpp").read_text()
    header, body = copy.split("\n", 1)
    assert header.startswith(f"// Copy of native/{name}.cpp")
    assert body == original.replace("(/root/reference/", "(KMamiz ")


def test_a_broken_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="host build of"):
        host_build.build(native.NAME, native.SOURCES, build_dir=tmp_path)
    assert not list(tmp_path.glob("*.so"))


def test_library_key_follows_the_sources(tmp_path):
    src = tmp_path / "a.cpp"
    src.write_text("int f() { return 1; }\n")
    first = host_build.library_path("a", [src], tmp_path)
    assert host_build.library_path("a", [src], tmp_path) == first
    src.write_text("int f() { return 2; }\n")
    assert host_build.library_path("a", [src], tmp_path) != first


# -- the span parse ----------------------------------------------------------------


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("window", WINDOWS)
def test_parse_matches_reference(window, threads):
    raw = json.dumps(_groups(window)).encode()
    got = native.parse_spans(raw, threads=threads)
    assert_parses_equal(got, ref_native.parse_spans(raw, threads=threads))
    assert_parses_equal(got, native.parse_spans(raw, threads=1))
    assert got["timings"]["threads"] >= 1


@pytest.mark.parametrize(
    "raw",
    [b"[[{", b"not json", b'[[{"id": }]]', b"", b"[]", b"[[], []]"],
)
def test_parse_rejects_like_reference(raw):
    assert_parses_equal(native.parse_spans(raw), ref_native.parse_spans(raw))


def test_parse_with_skip_ids_matches_reference():
    groups = _groups("synth")
    raw = json.dumps(groups + groups[:5]).encode()
    skip = [g[0]["traceId"] for g in groups[::3]] + [None]
    blob = bytearray(len(skip).to_bytes(4, "little"))
    for t in skip:
        blob += native.encode_skip_entry(t)
    got = native.parse_spans(raw, skip)
    assert_parses_equal(got, ref_native.parse_spans(raw, skip))
    assert_parses_equal(native.parse_spans(raw, skip_blob=bytes(blob)), got)
    ss = native.SkipSet()
    ss.extend(bytes(blob[4:]))
    assert_parses_equal(native.parse_spans(raw, skipset=ss), got)


@pytest.mark.parametrize("tid", ["t1", "", None, "é-ü", "\ud800x"])
def test_skip_entry_encoding_matches_reference(tid):
    assert native.encode_skip_entry(tid) == ref_native.encode_skip_entry(tid)


def test_skip_set_matches_reference():
    raw = json.dumps(
        [[{"traceId": "tA", "id": "a"}], [{"traceId": "tB", "id": "b"}], [{"id": "c"}]]
    ).encode()
    entries = b"".join(
        native.encode_skip_entry(t) for t in ("tA", None, "tA")
    )
    for mod in (native, ref_native):
        ss = mod.SkipSet()
        assert ss.extend(entries) == 3
        assert len(ss) == 2  # tA + the None sentinel
        assert mod.parse_spans(raw, skipset=ss)["trace_ids"] == ["tB"]
        ss.clear()
        assert len(ss) == 0
        assert mod.parse_spans(raw, skipset=ss)["trace_ids"] == ["tA", "tB", None]
        assert ss.extend(b"\x01\xff\xff\xff\xff") == -1  # truncated
        assert len(ss) == 0


def _session_window(prefix, n=30):
    groups = []
    for t in range(n):
        svc = f"down{t % 7}"
        groups.append(
            [
                {
                    "traceId": f"{prefix}{t}",
                    "id": f"p{t}",
                    "kind": "SERVER",
                    "name": "svc.ns.svc.cluster.local:80/*",
                    "timestamp": 1_700_000_000_000_000 + t,
                    "duration": 1000 + t,
                    "tags": {"http.status_code": "200", "istio.canonical_service": "svc"},
                },
                {
                    "traceId": f"{prefix}{t}",
                    "id": f"c{t}",
                    "parentId": f"p{t}",
                    "kind": "CLIENT",
                    "name": f"{svc}.ns.svc.cluster.local:80/*",
                    "timestamp": 1_700_000_000_000_000 + t * 1000,
                    "duration": 500,
                    "tags": {
                        "http.status_code": "503" if t % 5 == 0 else "200",
                        "http.method": "GET",
                        "istio.canonical_service": svc,
                    },
                },
            ]
        )
    return json.dumps(groups).encode()


def test_session_payloads_match_reference():
    """Delta emission, the unacked re-emit and the acked warm payload,
    step for step against the reference's session."""
    sessions = [native.ParseSession(), ref_native.ParseSession()]
    steps = []
    for mod, sess in zip((native, ref_native), sessions):
        p1 = mod.parse_spans(_session_window("a"), session=sess)
        p2 = mod.parse_spans(_session_window("b"), session=sess)  # not acked
        sess.ack(p2["shapes_total"], p2["statuses_total"])
        p3 = mod.parse_spans(_session_window("c"), session=sess)
        steps.append((p1, p2, p3))
    for got, want in zip(*steps):
        for key in (
            "n_spans", "trace_ids", "new_shapes", "new_statuses", "shape_base",
            "shapes_total", "status_base", "statuses_total",
        ):
            assert got[key] == want[key], key
        for key in PARSE_ARRAYS:
            assert np.array_equal(got[key], want[key]), key
        assert bytes(got["trace_ids_blob"]) == bytes(want["trace_ids_blob"])
    p1, p2, p3 = steps[0]
    assert p1["new_shapes"] and p2["shape_base"] == 0
    assert len(p2["new_shapes"]) == len(p1["new_shapes"])
    assert p3["new_shapes"] == [] and p3["new_statuses"] == []
    assert bytes(p3["trace_ids_blob"]) == b"".join(
        native.encode_skip_entry(t) for t in p3["trace_ids"]
    )


def test_profiling_counters():
    native.prof_reset()
    raw = json.dumps(_groups("synth")).encode()
    native.parse_spans(raw, threads=2)
    got = native.prof_counters()
    assert set(got) == set(ref_native.prof_counters())
    assert got["available"] and got["version"] == 2
    assert got["parses"] == 1 and got["spans"] == 120 * 7
    assert len(got["shards"]) == got["shards_used"]
    native.prof_reset()
    assert native.prof_counters()["parses"] == 0


def test_parse_thread_settings(monkeypatch):
    monkeypatch.setenv("KMAMIZ_PARSE_THREADS", "3")
    assert native.parse_threads() == 3 == native.effective_parse_threads()
    monkeypatch.setenv("KMAMIZ_PARSE_THREADS", "x")
    assert native.parse_threads() == 0
    assert native.effective_parse_threads() == ref_native.effective_parse_threads()


# -- KMZC columnar frames -----------------------------------------------------------


@pytest.mark.parametrize("window", WINDOWS)
def test_columnar_frames_match_reference(window):
    groups = _groups(window)
    frame = wire.encode_groups(groups)
    assert frame == ref_wire.encode_groups(groups)
    assert wire.is_columnar(frame) and not wire.is_columnar(json.dumps(groups).encode())
    assert wire.decode_groups(frame) == ref_wire.decode_groups(frame)
    assert wire.columnar_to_json(frame) == ref_wire.columnar_to_json(frame)
    # the native decoder gives the rows of the frame's JSON transcode
    assert_parses_equal(
        native.parse_spans(frame), native.parse_spans(wire.columnar_to_json(frame))
    )
    assert_parses_equal(native.parse_spans(frame), ref_native.parse_spans(frame))


def test_malformed_frames_reject():
    frame = wire.encode_groups(_groups("pdas_traces"))
    bad = frame[:-3] + bytes([frame[-3] ^ 0xFF]) + frame[-2:]  # CRC breaks
    for raw in (bad, frame[:20], b"KMZC"):
        assert wire.decode_groups(raw) is None
        assert native.parse_spans(raw) is None
        assert ref_native.parse_spans(raw) is None


# -- the body fold -------------------------------------------------------------------


def _body_pairs(seed, n=300):
    from test_processor_equivalence import BODIES

    pool = BODIES + [
        '{"a":[1,2,{"b":null}],"c":{"d":"x","e":[]}}',
        '[{"k":1},{"k":"s","z":[{"q":false}]}]',
        '{"n":1.5e3,"t":true,"u":"\\u00e9"}',
        '{"id":2,"tags":["c"],"extra":{"deep":{"deeper":[1]}}}',
        "[]",
        "{}",
        "null",
        "not json {",
        "[" * 300 + "]" * 300,  # deeper than the native parser takes
        '{"x":' * 200 + "1" + "}" * 200,
        None,
    ]
    rng = random.Random(seed)
    return [
        (
            [rng.choice(pool) for _ in range(rng.randint(1, 6))],
            rng.choice(["application/json", None, "text/plain"]),
        )
        for _ in range(n)
    ]


def _bodiless_pairs():
    """A tick's pairs when its spans carry no bodies, with a few bodies
    and empty groups among them: only pairs holding a body reach the
    library."""
    pairs = [([None] * (1 + k % 4), ["application/json", None][k % 2]) for k in range(200)]
    pairs[7] = (['{"a":1}', None], "application/json")
    pairs[8] = ([], "application/json")
    pairs[9] = ([None, '["x"]'], "text/plain")
    pairs[10] = (["", None], "application/json")
    return pairs


@pytest.mark.parametrize("seed", [5, 6, "bodiless"])
def test_body_fold_matches_python_and_reference(seed):
    pairs = _bodiless_pairs() if seed == "bodiless" else _body_pairs(seed)
    got = schema.merge_and_infer_bodies(pairs)
    assert got == schema.merge_and_infer_bodies_python(pairs)
    assert got == ref_schema.merge_and_infer_bodies(pairs)


def test_body_fold_hands_deep_groups_back():
    deep = "[" * 300 + "]" * 300
    groups = [([deep], True), (['{"a":1}', '{"b":2}'], True), ([None], False)]
    got = native.process_body_groups(groups)
    assert got == ref_native.process_body_groups(groups)
    assert got[0] is None  # the Python fold takes it
    assert got[1][0] is not None and got[1][1] is not None
    assert got[2] == (None, None, False)
