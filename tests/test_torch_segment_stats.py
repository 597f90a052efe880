"""The port's segment-stats reduction against the JAX package's Pallas
kernel (run in interpret mode on the CPU), and the port's window_stats
against the JAX one under both of its segment backends.

Tolerances: counts, 4xx/5xx rows and timestamp maxima are exact; float
sums use rtol/atol 1e-5 because fp32 adds run in another order (the
one-hot matmul vs index_add_); window_stats means and CVs use the
tolerances tests/test_ops_window.py pins between the JAX backends.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmamiz_tpu.ops import window as jax_window
from kmamiz_tpu.ops.pallas_kernels import segment_stats_matmul
from kmamiz_tpu_torch.ops import segment_stats as port_ss
from kmamiz_tpu_torch.ops import window as port_window


def _segment_inputs(m: int, seed: int = 1, n: int = 2000, s: int = 700):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, s + 30, n).astype(np.int32)  # some parked (>= S)
    seg[rng.random(n) < 0.05] = -7  # and some negative
    if m == 5:
        vals = np.stack(
            [
                np.ones(n),
                rng.random(n) < 0.2,
                rng.random(n) < 0.1,
                rng.gamma(2.0, 50.0, n),
                rng.gamma(2.0, 50.0, n) ** 2,
            ]
        ).astype(np.float32)
    else:
        vals = rng.normal(size=(m, n)).astype(np.float32)
    ts = rng.integers(-1000, 1 << 24, n).astype(np.int32)
    return vals, seg, ts, s


@pytest.mark.parametrize("m", [1, 5])
def test_plain_matches_pallas_interpret(m):
    vals, seg, ts, s = _segment_inputs(m)
    want_sums, want_max = segment_stats_matmul(
        jnp.asarray(vals), jnp.asarray(seg), jnp.asarray(ts), s, interpret=True
    )
    sums, ts_max = port_ss.segment_stats(
        torch.from_numpy(vals), torch.from_numpy(seg), torch.from_numpy(ts), s
    )
    want_sums = np.asarray(want_sums)
    assert sums.shape == (m, s) and sums.dtype == torch.float32
    assert ts_max.dtype == torch.int32
    np.testing.assert_array_equal(ts_max.numpy(), np.asarray(want_max))
    exact_rows = 3 if m == 5 else 0  # count, 4xx, 5xx
    np.testing.assert_array_equal(sums.numpy()[:exact_rows], want_sums[:exact_rows])
    np.testing.assert_allclose(sums.numpy(), want_sums, rtol=1e-5, atol=1e-5)


def test_cpu_call_counts_no_launch():
    vals, seg, ts, s = _segment_inputs(5, n=64, s=16)
    before = port_ss.segment_stats.launches
    port_ss.segment_stats(
        torch.from_numpy(vals), torch.from_numpy(seg), torch.from_numpy(ts), s
    )
    assert port_ss.segment_stats.launches == before


@pytest.mark.parametrize(
    "bad",
    [
        dict(values=np.zeros((2, 8), np.float64)),
        dict(seg=np.zeros(8, np.int64)),
        dict(ts=np.zeros(7, np.int32)),
    ],
    ids=["float64-values", "int64-seg", "short-ts"],
)
def test_wrapper_rejects_bad_inputs(bad):
    args = dict(
        values=np.zeros((2, 8), np.float32),
        seg=np.zeros(8, np.int32),
        ts=np.zeros(8, np.int32),
    )
    args.update(bad)
    with pytest.raises((TypeError, ValueError)):
        port_ss.segment_stats(
            *(torch.from_numpy(args[k]) for k in ("values", "seg", "ts")), 4
        )


def _window_inputs(n=3000, ne=130, ns=7, seed=0):
    # the inputs of tests/test_ops_window.py::TestPallasSegmentBackend
    rng = np.random.default_rng(seed)
    return dict(
        endpoint_id=rng.integers(0, ne, n, dtype=np.int32),
        status_id=rng.integers(0, ns, n, dtype=np.int32),
        status_class=rng.choice([2, 4, 5], n).astype(np.int8),
        latency_ms=rng.gamma(2.0, 50.0, n).astype(np.float32),
        timestamp_rel=rng.integers(0, 30_000_000, n, dtype=np.int32),
        valid_server=rng.random(n) < 0.9,
    ), dict(num_endpoints=ne, num_statuses=ns)


@pytest.mark.parametrize("backend", ["pallas_interpret", "xla"])
def test_window_stats_matches_jax(backend):
    arrays, sizes = _window_inputs()
    want = jax_window.window_stats(
        **{k: jnp.asarray(v) for k, v in arrays.items()}, **sizes, backend=backend
    )
    got = port_window.window_stats(
        **{k: torch.from_numpy(v) for k, v in arrays.items()}, **sizes
    )
    for field in ("count", "error_4xx", "error_5xx", "latest_timestamp_rel"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), field
        )
    for field in ("latency_sum", "latency_sq_sum"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(),
            np.asarray(getattr(want, field)),
            rtol=1e-5,
            atol=1e-5,
            err_msg=field,
        )
    np.testing.assert_allclose(
        got.latency_mean.numpy(), np.asarray(want.latency_mean), rtol=1e-5
    )
    np.testing.assert_allclose(
        got.latency_cv.numpy(), np.asarray(want.latency_cv), rtol=1e-4, atol=1e-6
    )


@pytest.mark.parametrize("m", [1, 5])
def test_plain_takes_no_timestamps(m):
    vals, seg, ts, s = _segment_inputs(m, seed=4)
    args = (torch.from_numpy(vals), torch.from_numpy(seg))
    sums, ts_max = port_ss.segment_stats(*args, None, s)
    assert ts_max is None
    with_ts, _ = port_ss.segment_stats(*args, torch.from_numpy(ts), s)
    assert torch.equal(sums, with_ts)


@pytest.mark.parametrize("m", [1, 2, 5, 9])
def test_sums_are_the_m_by_s_view_of_segment_major_storage(m):
    """The kernel wrapper's output layout (allocated here on the CPU, as the
    wrapper allocates it on the card): sums is [m, S] over [S, ld] storage
    (ld = m rounded up to 4 from m = 4 on, 16-byte rows for the vector
    atomic), ts_max follows it in the same buffer, and sums in that layout
    equal the plain version's contiguous ones, and a reference built by
    hand, on integer rows whatever the strides."""
    vals, seg, ts, s = _segment_inputs(m, seed=5)
    vals = np.round(vals * 4)  # integer-valued rows: exact in any order
    ld = port_ss.row_stride(m)
    assert ld == {1: 1, 2: 2, 5: 8, 9: 12}[m]
    buf, sums, ts_max = port_ss._outputs(m, s, True, torch.device("cpu"))
    assert sums.shape == (m, s) and sums.stride() == (1, ld)
    assert sums.storage_offset() == 0 and sums.data_ptr() == buf.data_ptr()
    assert ts_max.shape == (s,) and ts_max.dtype == torch.int32 and ts_max.is_contiguous()
    assert ts_max.data_ptr() == buf.data_ptr() + s * ld * 4  # sums, then ts_max
    bare, bare_sums, none = port_ss._outputs(m, s, False, torch.device("cpu"))
    assert none is None and bare is bare_sums and bare_sums.stride() == (1, ld)
    plain, plain_ts = port_ss.segment_stats(
        torch.from_numpy(vals), torch.from_numpy(seg), torch.from_numpy(ts), s
    )
    sums.copy_(plain)
    ts_max.copy_(plain_ts)
    want = np.zeros((m, s), dtype=np.float32)
    keep = (seg >= 0) & (seg < s)
    for r in range(m):
        np.add.at(want[r], seg[keep], vals[r, keep])
    assert torch.equal(plain, torch.from_numpy(want))
    assert torch.equal(sums, plain)
    assert all(torch.equal(a, b) for a, b in zip(sums.unbind(0), plain.unbind(0)))
    want_ts = np.zeros(s, dtype=np.int32)
    np.maximum.at(want_ts, seg[keep], np.maximum(ts[keep], 0))
    np.testing.assert_array_equal(ts_max.numpy(), want_ts)
