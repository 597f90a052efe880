"""The port on a CUDA card: the hand-written kernels against their plain
PyTorch versions on the same card tensors, a whole tick on the card
against the port's CPU path, the model forwards' kernel launches, and
the graph scorers on the card against the CPU (with no host sync in the
ops, and the store's incremental splice bit-exact), a raw window
ingested on the card against the CPU, and the streaming ingest: a staged
stream on the card against the CPU, the upload pipeline's bound on the
groups in flight, and staging without a synchronising call;
train_on_simulation on the card against the CPU; and a two-worker fleet
on the card (a migration bit-equal to its source, a fold equal to the
CPU's) and a scenario soak on the card, launching no kernel.

These tests need a card and skip inside the test without one. They import
neither jax nor the JAX package, so on a machine with a card and without
JAX they run on their own, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from kmamiz_tpu_torch.graph.store import graph_signature
from kmamiz_tpu_torch.models import graphsage
from kmamiz_tpu_torch.models.stlgt import model as stlgt
from kmamiz_tpu_torch.ops import segment_stats as ss
from kmamiz_tpu_torch.ops import sparse
from kmamiz_tpu_torch.ops import window as window_ops
from kmamiz_tpu_torch.server.processor import DataProcessor

FIXTURES = Path(__file__).resolve().parent / "fixtures"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _window(n, ne, ns, seed):
    rng = np.random.default_rng(seed)
    return dict(
        endpoint_id=rng.integers(0, ne, n, dtype=np.int32),
        status_id=rng.integers(0, ns, n, dtype=np.int32),
        status_class=rng.choice([2, 4, 5], n).astype(np.int8),
        latency_ms=rng.gamma(2.0, 50.0, n).astype(np.float32),
        timestamp_rel=rng.integers(0, 30_000_000, n, dtype=np.int32),
        valid_server=rng.random(n) < 0.9,
    ), dict(num_endpoints=ne, num_statuses=ns)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 1 << 16])
def test_kernel_matches_plain_on_card(card, n):
    arrays, sizes = _window(n, 300, 8, seed=n)
    dev = {k: torch.from_numpy(v).to(card) for k, v in arrays.items()}
    values, seg, ts, num_segments = window_ops.stat_rows(**dev, **sizes)
    seg[: n // 10] = -3  # negative ids are dropped too
    before = ss.segment_stats.launches
    sums, ts_max = ss.segment_stats(values, seg, ts, num_segments)
    torch.cuda.synchronize()
    assert ss.segment_stats.launches == before + 1
    assert sums.stride() == (1, ss.row_stride(sums.shape[0]))  # segment-major
    want_sums, want_max = ss.segment_stats_plain(values, seg, ts, num_segments)
    assert torch.equal(ts_max, want_max)
    assert torch.equal(sums[:3], want_sums[:3])  # count, 4xx, 5xx: exact
    # latency sums: fp32 adds in atomic order, rtol 1e-5
    torch.testing.assert_close(sums, want_sums, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_window_stats_card_matches_cpu(card):
    arrays, sizes = _window(50_000, 2000, 8, seed=3)
    got = window_ops.window_stats(
        **{k: torch.from_numpy(v).to(card) for k, v in arrays.items()}, **sizes
    )
    want = window_ops.window_stats(
        **{k: torch.from_numpy(v) for k, v in arrays.items()}, **sizes
    )
    for name in ("count", "error_4xx", "error_5xx", "latest_timestamp_rel"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    torch.testing.assert_close(got.latency_mean.cpu(), want.latency_mean, rtol=1e-5, atol=0)
    torch.testing.assert_close(got.latency_cv.cpu(), want.latency_cv, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_tick_on_card_matches_cpu(card):
    groups = json.loads((FIXTURES / "bookinfo_traces.json").read_text())
    request = {"uniqueId": "card", "lookBack": 30_000, "time": 0}
    procs = {
        d: DataProcessor(trace_source=lambda lb, t, lim: groups, device=d)
        for d in ("cuda", "cpu")
    }
    before = ss.segment_stats.launches
    got = procs["cuda"].collect(request)
    assert ss.segment_stats.launches == before + 2
    want = procs["cpu"].collect(request)
    assert got["dependencies"] == want["dependencies"]
    assert got["datatype"] == want["datatype"]
    g_idx = {(c["uniqueEndpointName"], c["status"]): c for c in got["combined"]}
    w_idx = {(c["uniqueEndpointName"], c["status"]): c for c in want["combined"]}
    assert set(g_idx) == set(w_idx)
    for key, w in w_idx.items():
        g, w = dict(g_idx[key]), dict(w)
        g_lat, w_lat = g.pop("latency"), w.pop("latency")
        assert g == w, key
        assert math.isclose(g_lat["mean"], w_lat["mean"], rel_tol=1e-5, abs_tol=1e-6)
        assert math.isclose(g_lat["cv"], w_lat["cv"], rel_tol=1e-3, abs_tol=1e-5)
    assert graph_signature(procs["cuda"].graph) == graph_signature(procs["cpu"].graph)


def _edges(n, e, h, seed):
    """Node tables and an edge list with masked-off edges, sentinel padding
    and a few live edges whose ids lie past n (dropped scatters)."""
    rng = np.random.default_rng(seed)
    tables = [torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32)) for _ in range(3)]
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.8
    src[-e // 4 :] = np.iinfo(np.int32).max
    dst[-e // 4 :] = np.iinfo(np.int32).max
    mask[-e // 4 :] = False
    src[:3] = n + 5
    mask[:3] = True
    return tables, [torch.from_numpy(a) for a in (src, dst, mask)]


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("n,e,h", [(1, 1, 1), (300, 5000, 18), (2048, 40_000, 32), (4096, 65_536, 64)])
def test_fused_kernel_matches_plain_on_card(card, gated, n, e, h):
    (v, q, k), (src, dst, mask) = _edges(n, e, h, seed=n + h)
    extra = [t.to(card) for t in (q, k, torch.tensor([0.3]))] if gated else []
    args = [t.to(card) for t in (v, src, dst, mask)] + extra
    before = sparse.fused_sddmm_spmm.launches
    bias, deg, gate = sparse.fused_sddmm_spmm(*args)
    torch.cuda.synchronize()
    assert sparse.fused_sddmm_spmm.launches == before + 1
    want_bias, want_deg, want_gate = sparse.fused_plain(*args)
    # fp32 sums in atomic order against index_add_'s
    torch.testing.assert_close(gate, want_gate, rtol=0, atol=1e-6)
    torch.testing.assert_close(bias, want_bias, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(deg, want_deg, rtol=1e-5, atol=1e-5)
    if not gated:
        assert torch.equal(deg, want_deg)  # sums of 1.0: exact
        # as fused_neighbor_sums calls it: no gate output
        bias2, deg2, none = sparse.fused_sddmm_spmm(*args, want_gate=False)
        assert none is None
        assert torch.equal(deg2, want_deg)
        torch.testing.assert_close(bias2, want_bias, rtol=1e-5, atol=1e-5)
    assert torch.all(gate[~args[3]] == 0)


def _features(n, f, seed):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, f)).astype(np.float32)
    feats[n - n // 8 :] = 0.0  # bucket padding
    return torch.from_numpy(feats)


@pytest.mark.cuda
def test_forwards_launch_the_kernel_and_match_the_cpu(card, monkeypatch):
    """GraphSAGE launches the kernel twice over one edge index, STLGT once
    over one; both match the CPU forward."""
    (_, _, _), (src, dst, mask) = _edges(1024, 8192, 1, seed=7)
    src[:3] = 0  # real snapshots carry no out-of-range ids
    feats = _features(1024, 18, seed=8)
    for model, params_of, launches in (
        (graphsage, lambda d: graphsage.init_params(torch.Generator().manual_seed(1), hidden=64, num_features=18, device=d), 2),
        (stlgt, lambda d: stlgt.init_params(torch.Generator().manual_seed(2), hidden=32, num_features=18, device=d), 1),
    ):
        before = sparse.fused_sddmm_spmm.launches
        builds = sparse.edge_index.builds
        got = model.forward(params_of(card), *(t.to(card) for t in (feats, src, dst, mask)))
        torch.cuda.synchronize()
        assert sparse.fused_sddmm_spmm.launches == before + launches, model.__name__
        assert sparse.edge_index.builds == builds + 1, model.__name__
        want = model.forward(params_of("cpu"), feats, src, dst, mask)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5])
def test_kernel_takes_no_timestamps(card, m):
    arrays, sizes = _window(1 << 16, 300, 8, seed=m)
    dev = {k: torch.from_numpy(v).to(card) for k, v in arrays.items()}
    values, seg, _ts, num_segments = window_ops.stat_rows(**dev, **sizes)
    values = values[:m].contiguous()
    sums, ts_max = ss.segment_stats(values, seg, None, num_segments)
    torch.cuda.synchronize()
    assert ts_max is None
    assert sums.stride() == (1, ss.row_stride(m))
    want, none = ss.segment_stats_plain(values, seg, None, num_segments)
    assert none is None
    assert torch.equal(sums[:3], want[:3])  # count (and 4xx, 5xx): exact
    torch.testing.assert_close(sums, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [False, True])
def test_fused_kernel_is_bit_for_bit_repeatable(card, gated):
    """No atomics: two launches on the same inputs give the same bits,
    with a hub row of ~2,300 entries (many 32-entry batches) included;
    ungated, deg is each row's live incident-edge count."""
    n, e, h = 4096, 65_536, 32 if gated else 64
    (v, q, k), (src, dst, mask) = _edges(n, e, h, seed=21)
    src[100:3000] = 0  # a hub
    extra = [t.to(card) for t in (q, k, torch.tensor([-0.2]))] if gated else []
    args = [t.to(card) for t in (v, src, dst, mask)] + extra
    index = sparse.edge_index(*args[1:4], n)
    first = sparse.fused_sddmm_spmm(*args, index=index)
    second = sparse.fused_sddmm_spmm(*args)  # builds its own index
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    want_bias, want_deg, want_gate = sparse.fused_plain(*args)
    # the hub row sums ~2,300 terms in fp32, in the index's order against
    # index_add_'s: the two differ by up to ~3e-5 there, so 1e-4 (the other
    # rows hold ~20 terms and sit within the 1e-5 of the shape grid above)
    torch.testing.assert_close(first[0], want_bias, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(first[1], want_deg, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(first[0][1:], want_bias[1:], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(first[2], want_gate, rtol=0, atol=1e-6)
    if not gated:
        s, d, live = src.numpy(), dst.numpy(), mask.numpy()
        count = np.zeros(n)
        for ends in (s, d):
            keep = live & (ends >= 0) & (ends < n)
            np.add.at(count, ends[keep], 1)
        assert count[0] > 2000  # the hub: 80% of 2,900 slots are live
        np.testing.assert_array_equal(first[1].cpu().numpy(), count)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 40_000])  # int16 and int32 sort keys
def test_edge_index_on_the_card_matches_the_cpu(card, n):
    """The keys kernel against edge_keys_plain, through the whole index:
    masked slots, sentinel padding, ids past n and negative ids."""
    _tables, (src, dst, mask) = _edges(n, 65_536, 1, seed=17)
    dst[3:6] = -1
    mask[3:6] = True
    got = sparse.edge_index(src.to(card), dst.to(card), mask.to(card), n, for_backward=True)
    torch.cuda.synchronize()
    want = sparse.edge_index(src, dst, mask, n, for_backward=True)
    for part_got, part_want in ((got, want), (got.gather, want.gather)):
        for a, b in zip(part_got[:3], part_want[:3]):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    # the gather part's entry-ordered fields
    for name in ("pos", "split"):
        a, b = getattr(got.gather, name), getattr(want.gather, name)
        assert a.dtype == b.dtype == torch.int32 and torch.equal(a.cpu(), b), name


def _backward_case(card, gated, n, e, h, seed):
    """Leaves on the card (v; q, k, b when gated), the edge list with live
    out-of-range ids, its index with the gather part, and upstream grads."""
    (v, q, k), (src, dst, mask) = _edges(n, e, h, seed=seed)
    dst[3:5] = n  # live edges whose dst lies out of range too
    mask[3:5] = True
    leaves = [t.to(card).requires_grad_() for t in ((v, q, k, torch.tensor([0.2])) if gated else (v,))]
    ids = [t.to(card) for t in (src, dst, mask)]
    index = sparse.edge_index(*ids, n, for_backward=True)
    rng = np.random.default_rng(seed + 1)
    ups = [
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(card)
        for shape in ((n, h), (n,), (e,))
    ]
    return leaves, ids, index, ups


def _kernel_grads(leaves, ids, index, ups, gated, calls=None):
    """The grads through the autograd Function; `calls`, when given, is
    emptied between the forward and the backward."""
    v = leaves[0]
    if gated:
        q, k, b = leaves[1:]
        outs = sparse.fused_gated_bias(q, k, v, b, *ids, index=index)
    else:
        outs = sparse.fused_neighbor_sums(v, *ids, index=index)[:1]
    if calls is not None:
        calls.clear()
    return torch.autograd.grad(outs, leaves, ups if gated else ups[0])


def _count_ctypes_calls(monkeypatch):
    """A list that grows by one at each C call of a kernel library."""
    from kmamiz_tpu_torch.ops import cuda_build

    calls = []
    launch = cuda_build.launch
    monkeypatch.setattr(cuda_build, "launch", lambda *a: calls.append(a[0]) or launch(*a))
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize(
    "n,e,h",
    # H = 5: scalar loads; H = 132: more columns than a warp's lanes hold
    [(1, 1, 1), (300, 5000, 18), (2048, 40_000, 32), (4096, 65_536, 64), (300, 5000, 5), (512, 8192, 132)],
)
def test_backward_kernels_match_plain_on_card(card, gated, n, e, h, monkeypatch):
    """The backward kernels against fused_backward_plain on the same card
    tensors (atol 1e-5 / rtol 1e-4: fp32 sums in the gather index's order
    against index_add_'s), live out-of-range ids and masked edges
    included, two runs the same bits (db included), one C call per
    backward launching the row pass and, gated, the SDDMM once each."""
    leaves, ids, index, ups = _backward_case(card, gated, n, e, h, seed=n + h)
    rows, edges = sparse.fused_sddmm_spmm_grad_rows.launches, sparse.fused_sddmm_spmm_grad_edges.launches
    backwards = sparse.fused_backward.launches
    calls = _count_ctypes_calls(monkeypatch)
    got = _kernel_grads(leaves, ids, index, ups, gated, calls)
    torch.cuda.synchronize()
    assert len(calls) == 1  # the backward's
    assert sparse.fused_backward.launches == backwards + 1
    assert sparse.fused_sddmm_spmm_grad_rows.launches == rows + 1
    assert sparse.fused_sddmm_spmm_grad_edges.launches == edges + int(gated)
    again = _kernel_grads(leaves, ids, index, ups, gated)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    with torch.no_grad():
        plain_in = [t.detach() for t in leaves]
        if gated:
            _, _, gate = sparse.fused_plain(plain_in[0], *ids, *plain_in[1:])
            want = sparse.fused_backward_plain(plain_in[0], *ids, gate, *ups, plain_in[1], plain_in[2])
        else:
            want = sparse.fused_backward_plain(plain_in[0], *ids, ids[2].float(), ups[0])[:1]
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w.reshape(a.shape), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("case", ["hub", "all-masked"])
def test_backward_of_a_hub_and_of_a_masked_list_on_card(card, gated, case):
    """A hub row of more than 4,096 entries (many 32-entry batches in one
    warp), and an edge list with every slot masked (no entry: zero grads,
    db 0), against fused_backward_plain; two runs the same bits. The hub
    row sums ~5,000 fp32 terms in the index's order against index_add_'s,
    so its rows get rtol/atol 1e-4 (as the forward's hub test), the rest
    1e-4 / 1e-5."""
    n, e, h = 4096, 65_536, 32 if gated else 64
    (v, q, k), (src, dst, mask) = _edges(n, e, h, seed=31)
    if case == "hub":
        src[100:6400] = 0
    else:
        mask[:] = False
    leaves = [t.to(card).requires_grad_() for t in ((v, q, k, torch.tensor([-0.3])) if gated else (v,))]
    ids = [t.to(card) for t in (src, dst, mask)]
    index = sparse.edge_index(*ids, n, for_backward=True)
    if case == "hub":
        lengths = index.gather.row_ptr[1:] - index.gather.row_ptr[:-1]
        assert int(lengths[0]) > 4096
    rng = np.random.default_rng(32)
    ups = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(card) for s in ((n, h), (n,), (e,))]
    got = _kernel_grads(leaves, ids, index, ups, gated)
    again = _kernel_grads(leaves, ids, index, ups, gated)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    with torch.no_grad():
        plain_in = [t.detach() for t in leaves]
        if gated:
            _, _, gate = sparse.fused_plain(plain_in[0], *ids, *plain_in[1:])
            want = sparse.fused_backward_plain(plain_in[0], *ids, gate, *ups, plain_in[1], plain_in[2])
        else:
            want = sparse.fused_backward_plain(plain_in[0], *ids, ids[2].float(), ups[0])[:1]
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w.reshape(a.shape), rtol=1e-4, atol=1e-4)
        if a.dim() == 2:
            torch.testing.assert_close(a[1:], w[1:], rtol=1e-4, atol=1e-5)
    if case == "all-masked":
        assert all(not a.any() for a in got)


@pytest.mark.cuda
def test_backward_stages_alone_match_plain_on_card(card):
    """The SDDMM alone (da, and each live entry's (gate, da) in entry
    order) and the row pass alone over its entries, against their plain
    versions on the same card tensors; each one launch."""
    n, e, h = 2048, 40_000, 32
    leaves, ids, index, (d_bias, d_deg, d_gate) = _backward_case(card, True, n, e, h, seed=5)
    v, q, k, b = (t.detach() for t in leaves)
    with torch.no_grad():
        _, _, gate = sparse.fused_sddmm_spmm(v, *ids, q, k, b, index=index)
    args = (v, *ids, gate, d_bias, d_deg, d_gate)
    edges = sparse.fused_sddmm_spmm_grad_edges.launches
    da, gda = sparse.fused_sddmm_spmm_grad_edges(*args, index=index)
    torch.cuda.synchronize()
    assert sparse.fused_sddmm_spmm_grad_edges.launches == edges + 1
    want_da = sparse.grad_edges_plain(*args)
    torch.testing.assert_close(da, want_da, rtol=1e-4, atol=1e-5)
    live = int(index.gather.row_ptr[-1])
    want_gda = sparse.entry_values_plain(index.gather, gate, want_da)
    torch.testing.assert_close(gda[:live], want_gda[:live], rtol=1e-4, atol=1e-5)
    rows = sparse.fused_sddmm_spmm_grad_rows.launches
    got = sparse.fused_sddmm_spmm_grad_rows(n, d_bias, gda, q, k, index=index)
    torch.cuda.synchronize()
    assert sparse.fused_sddmm_spmm_grad_rows.launches == rows + 1
    want = sparse.grad_rows_plain(n, *ids, gate, d_bias, da, q, k)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)
    # the plain version of what the row pass reads, on the card's entries
    for a, w in zip(got, sparse.grad_rows_index_plain(n, index.gather, d_bias, gda, q, k)):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [False, True])
def test_backward_makes_no_host_sync(card, gated):
    """The whole backward, called directly and through autograd, enqueues
    its work without a synchronising call."""
    leaves, ids, index, ups = _backward_case(card, gated, 2048, 40_000, 32, seed=7)
    v = leaves[0].detach()
    if gated:
        q, k, b = (t.detach() for t in leaves[1:])
        with torch.no_grad():
            _, _, gate = sparse.fused_sddmm_spmm(v, *ids, q, k, b, index=index)
        direct = lambda: sparse.fused_backward(v, *ids, gate, *ups, q, k, index)  # noqa: E731
    else:
        direct = lambda: sparse.fused_backward(v, *ids, None, ups[0], index=index)  # noqa: E731
    direct()  # the build and the first load happen outside the check
    outs = (
        sparse.fused_gated_bias(leaves[1], leaves[2], leaves[0], leaves[3], *ids, index=index)
        if gated
        else sparse.fused_neighbor_sums(leaves[0], *ids, index=index)[:1]
    )
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        direct()
        torch.autograd.grad(outs, leaves, ups if gated else ups[:1], retain_graph=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_backward_needs_the_gather_index(card):
    leaves, ids, _index, _ups = _backward_case(card, False, 64, 256, 8, seed=3)
    forward_only = sparse.edge_index(*ids, 64)
    with pytest.raises(ValueError, match="gather"):
        sparse.fused_neighbor_sums(leaves[0], *ids, index=forward_only)
    with torch.no_grad():  # serving needs no gather part
        sparse.fused_neighbor_sums(leaves[0], *ids, index=forward_only)


def _refuse_plain_on_card(monkeypatch):
    """Make every plain version of the fused kernel and its backward raise
    when it is handed a card tensor."""
    for name in ("fused_plain", "fused_backward_plain", "grad_edges_plain", "grad_rows_plain"):
        plain = getattr(sparse, name)

        def guarded(*args, _plain=plain, _name=name, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise AssertionError(f"{_name} ran on card tensors")
            return _plain(*args, **kw)

        monkeypatch.setattr(sparse, name, guarded)


@pytest.mark.cuda
def test_training_grads_reach_the_first_layer_on_card(card, monkeypatch):
    """A GraphSAGE and an STLGT train step on the card: the grads reach
    w_self_1 and w_q through the fused kernels' backward (no plain version
    runs on the card), and match the CPU's within rtol 1e-3 / atol 1e-5."""
    from kmamiz_tpu_torch.models import common

    _refuse_plain_on_card(monkeypatch)

    (_, _, _), (src, dst, mask) = _edges(1024, 8192, 1, seed=9)
    src[:3] = 0
    feats = _features(1024, 18, seed=10)
    rng = np.random.default_rng(11)
    t_lat = torch.from_numpy(rng.normal(size=1024).astype(np.float32))
    t_ano = torch.from_numpy((rng.random(1024) < 0.2).astype(np.float32))
    n_mask = torch.from_numpy(rng.random(1024) < 0.9)
    batch = (feats, src, dst, mask, t_lat, t_ano, n_mask)
    for model, loss_fn, field in (
        (graphsage, common.make_loss_fn(graphsage.forward, 4.0), "w_self_1"),
        (stlgt, stlgt.make_pinball_loss_fn(2.0), "w_q"),
    ):
        grads = {}
        for dev in (card, "cpu"):
            params = model.init_params(torch.Generator().manual_seed(5), hidden=32, num_features=18, device=dev)
            index = sparse.edge_index(*(t.to(dev) for t in (src, dst, mask)), 1024, for_backward=True)
            rows = sparse.fused_sddmm_spmm_grad_rows.launches
            _loss, _aux, g = common.value_and_grad(
                loss_fn, params, *(t.to(dev) for t in batch), index=index if dev == card else None
            )
            if dev == card:
                torch.cuda.synchronize()
                assert sparse.fused_sddmm_spmm_grad_rows.launches > rows, model.__name__
            grads[str(dev)] = g
        card_g, cpu_g = grads[str(card)], grads["cpu"]
        assert float(getattr(card_g, field).abs().sum()) > 0, field
        for name, a, b in zip(card_g._fields, card_g, cpu_g):
            if b is not None:
                torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-5, msg=name)


def _scorer_inputs(seed, n_ep=4096, n_svc=256, cap=1 << 15, n_live=20_000, dist_hi=8):
    """Seeded flat edge columns (SENTINEL past the live rows, a tenth of
    them masked off) and per-endpoint tables for the scorer ops."""
    from kmamiz_tpu_torch.ops.sortutil import SENTINEL

    rng = np.random.default_rng(seed)
    cols = [np.full(cap, SENTINEL, np.int32) for _ in range(3)]
    cols[0][:n_live] = rng.integers(0, n_ep, n_live)
    cols[1][:n_live] = rng.integers(0, n_ep, n_live)
    cols[2][:n_live] = rng.integers(1, dist_hi, n_live)
    mask = (cols[0] != SENTINEL) & (rng.random(cap) < 0.9)
    tables = (
        rng.integers(0, n_svc, n_ep).astype(np.int32),
        rng.integers(0, 512, n_ep).astype(np.int32),
        rng.random(n_ep) < 0.8,
    )
    return [torch.from_numpy(a) for a in (*cols, mask, *tables)]


def _assert_scores_close(card_out, cpu_out):
    """Integer lanes and instability equal; relying_factor, risk and
    norm_risk within rel 1e-5, usage_cohesion within rel 1e-6."""
    rtol = {"relying_factor": 1e-5, "risk": 1e-5, "norm_risk": 1e-5, "usage_cohesion": 1e-6,
            "impact": 1e-5, "probability": 1e-5}
    for name, a, b in zip(cpu_out._fields, card_out, cpu_out):
        a = a.cpu()
        if name in rtol:
            torch.testing.assert_close(a, b, rtol=rtol[name], atol=0, msg=name)
        else:
            assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dist_bits,dist_hi", [(3, 8), (4, 16), (None, 8)])
def test_scorers_on_card_match_cpu(card, dist_bits, dist_hi):
    """Both service-score pipelines, cohesion and risk on card tensors
    against the same ops on the CPU, with no host sync on the card."""
    from kmamiz_tpu_torch.ops import scorers

    cpu_in = _scorer_inputs(21, dist_hi=dist_hi)
    cpu_in.append(torch.rand(256, generator=torch.Generator().manual_seed(3)) * 100)
    card_in = [t.to(card) for t in cpu_in]
    torch.cuda.synchronize()
    outs = {}
    for name, args in (("cpu", cpu_in), ("card", card_in)):
        if name == "card":
            torch.cuda.set_sync_debug_mode("error")
        try:
            s = scorers.service_scores(*args[:7], num_services=256, dist_bits=dist_bits)
            coh = scorers.usage_cohesion(*args[:5], args[6], num_services=256)
            req = args[7]
            risk = scorers.risk_scores(
                s.relying_factor, s.acs, torch.ones_like(req), req, req * 0.01, req * 0.5, coh.total_endpoints > 0
            )
        finally:
            torch.cuda.set_sync_debug_mode(0)
        outs[name] = (s, coh, risk)
    for card_out, cpu_out in zip(outs["card"], outs["cpu"]):
        _assert_scores_close(card_out, cpu_out)
    if dist_bits is not None:
        # the sparse pipeline's relying factor: the same bits on both
        assert torch.equal(outs["card"][0].relying_factor.cpu(), outs["cpu"][0].relying_factor)


def _ring_trace(tid, svc_a, ep_a, svc_b, ep_b):
    def span(sid, svc, ep, parent=None):
        return {
            "traceId": tid,
            "id": sid,
            "parentId": parent,
            "kind": "SERVER",
            "name": f"{svc}.ns.svc.cluster.local:80/*",
            "timestamp": 1_700_000_000_000_000,
            "duration": 1000,
            "tags": {
                "http.method": "GET",
                "http.status_code": "200",
                "http.url": f"http://{svc}.ns.svc.cluster.local/api/{ep}",
                "istio.canonical_revision": "v1",
                "istio.canonical_service": svc,
                "istio.mesh_id": "cluster.local",
                "istio.namespace": "ns",
            },
        }

    return [span(f"{tid}-p", svc_a, ep_a), span(f"{tid}-c", svc_b, ep_b, parent=f"{tid}-p")]


@pytest.mark.cuda
def test_incremental_splice_is_bit_exact_on_card(card):
    """The store on the card: after small merges the cached scores (the
    dirty-service incremental path) equal the uncached full recompute bit
    for bit, and equal the CPU store's."""
    from kmamiz_tpu_torch.core.spans import spans_to_batch
    from kmamiz_tpu_torch.graph.store import EndpointGraph

    base = [_ring_trace(f"i{i}-{j}", f"svc{i}", j, f"svc{(i + 1) % 60}", j) for i in range(60) for j in range(5)]
    windows = [
        [_ring_trace(f"m{k}-{j}", f"svc{3 * k}", j + 4, f"svc{3 * k + 1}", j) for j in range(3)]
        for k in range(4)
    ]
    graphs = {}
    for dev in (card, "cpu"):
        g = EndpointGraph(device=dev)
        g.merge_window(spans_to_batch(base, interner=g.interner))
        g.service_scores()
        for w in windows:
            g.merge_window(spans_to_batch(w, interner=g.interner))
            got, want = g.service_scores(), g.service_scores_uncached()
            for name, a, b in zip(got._fields, got, want):
                assert torch.equal(a, b), name
        assert g.scorer_cache_stats()["incremental"] == len(windows)
        graphs[str(dev)] = g.service_scores()
    for name, a, b in zip(graphs["cpu"]._fields, graphs[str(card)], graphs["cpu"]):
        assert torch.equal(a.cpu(), b), name


@pytest.mark.cuda
def test_raw_window_ingest_on_card_matches_cpu(card):
    """A synth raw window through ingest_raw_window (the native loader,
    then the graph merge) gives the same summary and graph signature on
    the card as on the CPU, and its repeat deduplicates on both."""
    from kmamiz_tpu_torch import synth

    raw = synth.make_raw_window(2_000, 7, n_services=100, urls_per_service=10)
    out = {}
    for dev in (card, "cpu"):
        dp = DataProcessor(trace_source=lambda lb, t, lim: [], device=dev)
        summary = dp.ingest_raw_window(raw)
        again = dp.ingest_raw_window(raw)
        assert again["spans"] == 0 and again["traces"] == 0
        summary.pop("ms")
        out[str(dev)] = (summary, graph_signature(dp.graph))
    assert out[str(card)] == out["cpu"]
    assert out["cpu"][0]["spans"] == 14_000 and out["cpu"][0]["edges"] > 0


def _stream_chunks(n_traces=4_000, n_chunks=4, prefix="s"):
    from kmamiz_tpu_torch import native, synth

    raw = synth.make_raw_window(
        n_traces, 7, trace_prefix=prefix, n_services=100, urls_per_service=10
    )
    return native.split_groups(raw, n_chunks)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
def test_staged_stream_on_card_matches_cpu(card, depth):
    """ingest_raw_stream on the card (pinned uploads on a side stream, the
    staged walks and pre-unions) gives the CPU's summary totals and graph,
    with and without truncated prefixes."""
    from kmamiz_tpu_torch.graph import store

    chunks = _stream_chunks()
    out = {}
    for cap in (store.STAGE_CAP, 64):
        for dev in (card, "cpu"):
            saved, store.STAGE_CAP = store.STAGE_CAP, cap
            try:
                dp = DataProcessor(trace_source=lambda lb, t, lim: [], device=dev)
                summary = dp.ingest_raw_stream(chunks, depth=depth)
            finally:
                store.STAGE_CAP = saved
            totals = {k: summary[k] for k in ("spans", "traces", "chunks", "endpoints", "edges")}
            out[(cap, str(dev))] = (totals, graph_signature(dp.graph))
        assert out[(cap, str(card))] == out[(cap, "cpu")]
    assert out[(64, "cpu")] == out[(store.STAGE_CAP, "cpu")]
    assert out[(64, "cpu")][0]["spans"] == 28_000


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_upload_pipeline_bounds_groups_in_flight(card, depth):
    """At most `depth` upload groups stay in flight (none at depth 0), the
    card tensors hold the host arrays, and a drain retires every group."""
    from kmamiz_tpu_torch.ops.double_buffer import UploadPipeline

    pipe = UploadPipeline(card, depth)
    rng = np.random.default_rng(depth)
    for k in range(6):
        host = (
            rng.integers(0, 1 << 30, 1 << 20, dtype=np.int32),
            rng.random(1 << 16) < 0.5,
        )
        out, waited = pipe.put(host)
        assert waited >= 0.0
        assert pipe.stats()["in_flight"] == min(k + 1, depth)
        # the consumer's stream waits for the copy: no explicit sync here
        for got, want in zip(out, host):
            assert got.device.type == "cuda"
            assert np.array_equal(got.cpu().numpy(), want)
    pipe.drain()
    stats = pipe.stats()
    assert stats["in_flight"] == 0 and stats["uploads"] == 6
    assert stats["peak_in_flight"] == min(depth, 6)


@pytest.mark.cuda
def test_staging_makes_no_host_sync(card):
    """Under torch.cuda.set_sync_debug_mode("error"), staging chunks (the
    pinned upload, the walk, its compaction, the pre-union and the count
    copies) makes no synchronising call; the pipeline's and the counts'
    waits are event waits. The read after it drains to the CPU's graph."""
    from kmamiz_tpu_torch.core.interning import EndpointInterner
    from kmamiz_tpu_torch.core.spans import raw_spans_to_batch
    from kmamiz_tpu_torch.graph.store import EndpointGraph

    chunks = _stream_chunks(n_traces=2_000, n_chunks=3, prefix="q")
    graphs = {}
    for dev in (card, "cpu"):
        interner = EndpointInterner()
        batches = [raw_spans_to_batch(c, interner=interner)[0] for c in chunks]
        g = EndpointGraph(device=dev, interner=interner)
        # the first staging warms the caching allocators and the side stream
        g.merge_window(batches[0], stage=True)
        if dev == card:
            torch.cuda.set_sync_debug_mode("error")
        try:
            for b in batches[1:]:
                g.merge_window(b, stage=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert g._preunion is not None
        graphs[str(dev)] = (g.n_edges, graph_signature(g))
    assert graphs[str(card)] == graphs["cpu"]


@pytest.mark.cuda
def test_gat_forward_and_grads_on_card_match_cpu(card):
    """GAT (PyTorch ops, no hand-written kernel) on the card against its
    CPU run: the forward at rtol 1e-4 / atol 1e-5 and one step's grads at
    rtol 1e-3 / atol 1e-5 (index_add_ of float32 on the card sums in a
    run-dependent order); it launches no port kernel."""
    from kmamiz_tpu_torch.models import common, gat

    rng = np.random.default_rng(5)
    n, e = 2048, 40_000
    feats = rng.normal(size=(n, 18)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.9
    src[-100:] = np.iinfo(np.int32).max  # masked padding, clamped to n-1
    mask[-100:] = False
    t_lat = rng.normal(size=n).astype(np.float32)
    t_ano = (rng.random(n) < 0.25).astype(np.float32)
    n_mask = np.ones(n, dtype=bool)
    batch = (feats, src, dst, mask, t_lat, t_ano, n_mask)
    params = gat.init_params(torch.Generator().manual_seed(3), hidden=64, num_features=18, device="cpu")
    out = {}
    for dev in (card, torch.device("cpu")):
        p = type(params)(*(t.to(dev) for t in params[:-1]), None)
        tensors = [torch.from_numpy(a).to(dev) for a in batch]
        before = (sparse.fused_sddmm_spmm.launches, sparse.fused_backward.launches)
        with torch.no_grad():
            fwd = gat.forward(p, *tensors[:4])
        loss, _aux, grads = common.value_and_grad(gat.loss_fn, p, *tensors)
        if dev == card:
            assert (sparse.fused_sddmm_spmm.launches, sparse.fused_backward.launches) == before
        out[dev.type] = ([t.cpu() for t in fwd], float(loss), [g.cpu() for g in grads if g is not None])
    (c_fwd, c_loss, c_grads), (h_fwd, h_loss, h_grads) = out["cuda"], out["cpu"]
    for a, b in zip(c_fwd, h_fwd):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert math.isclose(c_loss, h_loss, rel_tol=1e-4)
    for a, b in zip(c_grads, h_grads):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)


@pytest.mark.cuda
def test_history_restore_onto_the_card_gives_the_snapshot_back(card):
    """A history snapshot taken by a CPU processor restores into a card
    processor, whose snapshot is the same bytes (the state is host numpy:
    the restore re-interns the names on the card processor's graph)."""
    groups = json.loads((FIXTURES / "bookinfo_traces.json").read_text())
    hour = 3_600_000

    def fresh(prefix):
        out = []
        for g in groups:
            out.append([{**s, "traceId": prefix + s["traceId"], "id": prefix + s["id"],
                         **({"parentId": prefix + s["parentId"]} if s.get("parentId") else {})} for s in g])
        return out

    windows = iter([fresh("a"), fresh("b"), fresh("c")])
    cpu = DataProcessor(trace_source=lambda lb, t, lim: next(windows), device="cpu", now_ms=lambda: 920 * hour)
    for k, h in enumerate((910, 911, 912)):
        cpu.collect({"uniqueId": f"h{k}", "lookBack": 30_000, "time": h * hour})
    docs = cpu.snapshot_history()
    assert docs and docs[0]["forecast"] is not None
    on_card = DataProcessor(trace_source=lambda lb, t, lim: [], device=card, now_ms=lambda: 920 * hour)
    on_card.restore_history(json.loads(json.dumps(docs)))
    assert json.dumps(on_card.snapshot_history(), sort_keys=True) == json.dumps(docs, sort_keys=True)
    assert on_card.graph.device.type == "cuda"


@pytest.mark.cuda
def test_warm_up_leaves_the_processor_as_it_was(card):
    """warm_up runs two scratch ticks on the card (2 segment-stats launches
    each) and leaves the processor's graph, interner, dedup map and
    history as they were."""
    groups = json.loads((FIXTURES / "bookinfo_traces.json").read_text())
    dp = DataProcessor(trace_source=lambda lb, t, lim: groups, device=card, wal=None)
    dp.collect({"uniqueId": "before", "lookBack": 30_000})
    state = (graph_signature(dp.graph), len(dp.graph.interner.endpoints), dict(dp._processed), dp.history)
    before = ss.segment_stats.launches
    dp.warm_up()
    assert ss.segment_stats.launches == before + 4
    assert (graph_signature(dp.graph), len(dp.graph.interner.endpoints), dict(dp._processed), dp.history) == state


# -- multi-tenant serving on the card -------------------------------------------


def _stacks(seed, t=4, cap=512, device="cpu"):
    """Seeded [T, cap] store stacks (a sorted unique prefix per lane, then
    SENTINEL) and SENTINEL-padded windows of uneven lengths."""
    from kmamiz_tpu_torch.ops.sortutil import SENTINEL

    rng = np.random.default_rng(seed)
    a = np.full((3, t, cap), SENTINEL, dtype=np.int32)
    for lane in range(t):
        rows = np.unique(rng.integers(1, 60, size=(300, 3)), axis=0)[: int(rng.integers(0, 250))]
        a[:, lane, : len(rows)] = rows.T
    w = np.full((3, t, 256), SENTINEL, dtype=np.int32)
    for lane in range(t):
        n = int(rng.integers(1, 200))
        w[:, lane, :n] = rng.integers(1, 60, size=(3, n))
    cols = [torch.from_numpy(x).to(device) for x in (a[0], a[1], a[2], a[0] != SENTINEL, w[0], w[1], w[2], w[0] != SENTINEL)]
    return cols


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_stacked_merge_on_card_matches_serial_and_cpu(card, seed):
    from kmamiz_tpu_torch.graph.store import _merge_edges
    from kmamiz_tpu_torch.tenancy import batch

    got = batch.batched_merge_edges(*_stacks(seed, device=card))
    want = batch.batched_merge_edges(*_stacks(seed))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    cols = _stacks(seed, device=card)
    for lane in range(4):
        n = int(cols[7][lane].sum())
        s, d, ds, v = _merge_edges(*(c[lane] for c in cols[:4]), *(c[lane, :n] for c in cols[4:]))
        k = int(v.sum())
        assert k == int(got[4][lane])
        for a, b in zip(got[:3], (s, d, ds)):
            assert torch.equal(a[lane, :k], b[:k])


@pytest.mark.cuda
def test_a_gathered_round_launches_kernel_1_twice_per_tenant(card):
    """Three tenants' ticks in one batch: one stacked merge of 3 lanes,
    2 segment-stats launches each, graphs equal to serial card ticks and
    to the CPU's."""
    from kmamiz_tpu_torch.tenancy import TenantRuntime, TickRouter

    groups = json.loads((FIXTURES / "bookinfo_traces.json").read_text())
    request = {"uniqueId": "round", "lookBack": 30_000, "time": 0}
    names = ("ca", "cb", "cc")

    def runtime(tenant):
        return TenantRuntime(tenant, DataProcessor(trace_source=lambda lb, t, lim: groups, device=card, wal=None, tenant=tenant))

    router = TickRouter(runtime)
    for t in names:
        router.runtime(t)
    before = ss.segment_stats.launches
    out = router.batched_collect([(t, dict(request)) for t in names])
    torch.cuda.synchronize()
    assert ss.segment_stats.launches == before + 2 * len(names)
    assert router.stats()["stackedLanes"] == len(names) and router.stats()["serialMerges"] == 0
    serial = DataProcessor(trace_source=lambda lb, t, lim: groups, device=card, wal=None, tenant="serial")
    cpu = DataProcessor(trace_source=lambda lb, t, lim: groups, device="cpu", wal=None, tenant="cpu")
    want = serial.collect(dict(request))
    cpu.collect(dict(request))
    for t, resp in zip(names, out):
        graph = router.runtime(t).processor.graph
        for g, s, c in zip(graph.edge_arrays(), serial.graph.edge_arrays(), cpu.graph.edge_arrays()):
            assert torch.equal(g, s) and torch.equal(g.cpu(), c)
        assert resp["dependencies"] == want["dependencies"]


@pytest.mark.cuda
def test_a_control_fold_launches_kernel_2_once(card, monkeypatch):
    """With the control plane on and a live STLGT head, a processor's hour
    fold runs the quantile forward: one gated launch of the fused kernel,
    and the controller holds the tenant's verdict."""
    from kmamiz_tpu_torch import control
    from kmamiz_tpu_torch.models import stlgt as stlgt_pkg

    params = stlgt.init_params(torch.Generator().manual_seed(3), hidden=32, num_features=18, device=card)
    monkeypatch.setattr(stlgt_pkg, "serving_params", lambda: {"params": params, "version": 1, "model": stlgt})
    monkeypatch.setenv("KMAMIZ_CONTROL", "1")
    monkeypatch.delenv("KMAMIZ_STLGT", raising=False)
    control.reset_for_tests()
    groups = json.loads((FIXTURES / "bookinfo_traces.json").read_text())
    tick = {"k": 0}

    def source(lb, t, lim):
        tick["k"] += 1
        return [[dict(s, traceId=f"{tick['k']}-{s['traceId']}") for s in g] for g in groups]

    dp = DataProcessor(trace_source=source, device=card, wal=None, tenant="folding")
    dp.collect({"uniqueId": "h0", "lookBack": 30_000, "time": 910 * 3_600_000})
    torch.cuda.synchronize()
    before = sparse.fused_sddmm_spmm.launches
    dp.collect({"uniqueId": "h1", "lookBack": 30_000, "time": 911 * 3_600_000})
    torch.cuda.synchronize()
    assert sparse.fused_sddmm_spmm.launches == before + 1
    assert dp.fold_errors["controlFoldErrors"] == 0
    assert control.snapshot()["tenants"]["folding"]["evaluations"] == 1
    control.reset_for_tests()


# -- telemetry on the card (last: a profiler session slows the process's
# later launches) ------------------------------------------------------------

#: the synchronising calls one warm tick of _telemetry_processor's third
#: window makes on the H100, as the sync guard counts them
#: (analysis/guards.py): its budget. The count moves with timing (two chip
#: runs of one tree counted 8 and 7), so the tick is held to the budget
WARM_TICK_SYNCS = 8


def _telemetry_processor(card):
    """A card processor over three seeded 2,500-trace windows of the
    BASELINE mesh, warmed by the first two ticks; `feed["k"]` picks the
    window."""
    from kmamiz_tpu_torch import synth

    windows = [
        json.loads(
            synth.make_raw_window(2_500, 7, t_start=k * 2_500, trace_prefix=f"g{k}-", n_services=1000, urls_per_service=10)
        )
        for k in range(3)
    ]
    feed = {"k": 0}
    dp = DataProcessor(trace_source=lambda lb, t, lim: windows[feed["k"]], device=card, wal=None)
    for k in (0, 1):
        feed["k"] = k
        dp.collect({"uniqueId": f"warm{k}", "lookBack": 30_000})
    torch.cuda.synchronize()
    feed["k"] = 2
    return dp


@pytest.mark.cuda
def test_a_warm_tick_stays_within_its_pinned_synchronising_calls(card):
    from kmamiz_tpu_torch.analysis import guards

    dp = _telemetry_processor(card)
    with guards.hot_path_guard("disallow", device=dp.device, expected_syncs=WARM_TICK_SYNCS) as report:
        dp.collect({"uniqueId": "guarded", "lookBack": 30_000})
    assert 0 < report.syncs <= WARM_TICK_SYNCS, f"{report.syncs} synchronising calls"
    # at disallow, one call over the design raises
    with pytest.raises(guards.SyncsOverBudget):
        with guards.hot_path_guard("disallow", device=dp.device, expected_syncs=0):
            torch.ones(1, device=card).item()


@pytest.mark.cuda
def test_a_capture_credits_a_ticks_segment_stats_launches(card, tmp_path):
    import threading
    import time

    from kmamiz_tpu_torch.telemetry import device as tel_device
    from kmamiz_tpu_torch.telemetry.profiling import device_attr

    dp = _telemetry_processor(card)
    assert tel_device.capture_profile(50, str(tmp_path / "first"))["ok"]  # the profiler's start-up
    out = {}
    capture = threading.Thread(target=lambda: out.update(tel_device.capture_profile(3_000, str(tmp_path / "tick"))))
    capture.start()
    time.sleep(0.5)
    before = ss.segment_stats.launches
    dp.collect({"uniqueId": "captured", "lookBack": 30_000})
    torch.cuda.synchronize()
    capture.join()
    assert out["ok"] and ss.segment_stats.launches == before + 2
    joined = device_attr.parse_profile_dir(str(tmp_path / "tick"))
    assert joined["programs"].get("segment_stats", 0.0) > 0, joined


#: the JAX package's trainer-test mesh (tests/test_trainer.py's FAULT_YAML,
#: which tests/test_torch_simulator.py holds this copy to): three endpoints
#: in a chain, two simulated days, an error window on the leaf each day
FAULT_YAML = """
servicesInfo:
  - namespace: mesh
    services:
      - serviceName: front
        versions:
          - version: v1
            replica: 2
            endpoints:
              - endpointId: front-get
                endpointInfo: { path: /front, method: get }
      - serviceName: mid
        versions:
          - version: v1
            replica: 1
            endpoints:
              - endpointId: mid-get
                endpointInfo: { path: /mid, method: get }
      - serviceName: back
        versions:
          - version: v1
            replica: 1
            endpoints:
              - endpointId: back-get
                endpointInfo: { path: /back, method: get }
endpointDependencies:
  - endpointId: front-get
    isExternal: true
    dependOn:
      - endpointId: mid-get
  - endpointId: mid-get
    dependOn:
      - endpointId: back-get
loadSimulation:
  config:
    simulationDurationInDays: 2
    overloadErrorRateIncreaseFactor: 3
  serviceMetrics: []
  endpointMetrics:
    - endpointId: front-get
      delay: { latencyMs: 20, jitterMs: 4 }
      errorRatePercent: 1
      expectedExternalDailyRequestCount: 4800
    - endpointId: mid-get
      delay: { latencyMs: 10, jitterMs: 2 }
      errorRatePercent: 1
    - endpointId: back-get
      delay: { latencyMs: 5, jitterMs: 1 }
      errorRatePercent: 1
  faultInjection:
    - type: increase-error-rate
      targets:
        services: []
        endpoints:
          - endpointId: back-get
      timePeriods:
        - startTime: { day: 1, hour: 6 }
          durationHours: 5
          probabilityPercent: 100
        - startTime: { day: 2, hour: 6 }
          durationHours: 5
          probabilityPercent: 100
      increaseErrorRatePercent: 80
"""


@pytest.mark.cuda
def test_train_on_simulation_on_card_launches_kernel_2_and_matches_cpu(card):
    """GraphSAGE through train_on_simulation on a simulated mesh: two
    forward launches a step and a slot of calibration and evaluation, one
    backward call a step, and the losses of the CPU run within rtol 1e-3."""
    from kmamiz_tpu_torch.models import trainer
    from kmamiz_tpu_torch.simulator import Simulator

    result = Simulator().generate_simulation_data(FAULT_YAML, 0.0, rng=np.random.default_rng(7))
    args = (result.endpoint_dependencies, result.realtime_data_per_slot, result.replica_counts)
    train_set, eval_set = trainer.temporal_split(trainer.dataset_from_simulation(*args))
    epochs = 4
    steps = len(train_set.features) * epochs
    for counter in (sparse.fused_sddmm_spmm, sparse.fused_backward):
        counter.launches = 0
    got, got_metrics, _ = trainer.train_on_simulation(*args, epochs=epochs, hidden=8, device=card)
    torch.cuda.synchronize()
    assert sparse.fused_sddmm_spmm.launches == 2 * (steps + len(train_set.features) + len(eval_set.features))
    assert sparse.fused_backward.launches == steps
    want, want_metrics, _ = trainer.train_on_simulation(*args, epochs=epochs, hidden=8, device="cpu")
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-3)
    for a, b in zip(got.params, want.params):
        if b is not None:
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-3, atol=1e-5)


def _fleet_window(tenant, tick):
    import random

    from kmamiz_tpu_torch.scenarios.topology import sample_topology, trace_group

    topo = sample_topology("fanout", random.Random(5), f"cf-{tenant}")
    return json.dumps([trace_group(topo, f"cf-{tenant}", tick, i) for i in range(4)]).encode()


def _launches():
    return (
        ss.segment_stats.launches,
        sparse.fused_sddmm_spmm.launches,
        sparse.fused_sddmm_spmm_grad_edges.launches,
        sparse.fused_sddmm_spmm_grad_rows.launches,
    )


@pytest.mark.cuda
def test_a_card_fleet_migrates_bit_exact_and_folds_as_the_cpu(card, tmp_path):
    from kmamiz_tpu_torch.fleet.coordinator import FleetCoordinator, LocalTransport
    from kmamiz_tpu_torch.fleet.migration import migrate_tenant
    from kmamiz_tpu_torch.fleet.ring import HashRing
    from kmamiz_tpu_torch.fleet.worker import FleetWorker
    from kmamiz_tpu_torch.graph.store import EndpointGraph

    ring = HashRing(["w0", "w1"])
    workers = {w: FleetWorker(w, wal_root=str(tmp_path / "wal"), device=card) for w in ring.workers}
    coord = FleetCoordinator(ring, LocalTransport(workers))
    tenants = ["alpha", "beta", "gamma"]
    for tick in range(3):
        for t in tenants:
            assert coord.route_ingest(t, _fleet_window(t, tick))["spans"] > 0
    source = coord.owner("alpha")
    target = next(w for w in ring.workers if w != source)
    pre = workers[source].signature("alpha")
    out = migrate_tenant(coord, "alpha", target)
    assert out["ok"] and out["signature"] == pre == workers[target].signature("alpha")
    assert workers[target].processor("alpha").graph.device.type == "cuda"
    assert "alpha" not in workers[source].tenants()
    # the fold on the card against a fold of the same exports on the CPU
    exports = [workers[coord.owner(t)].export_edges(t) for t in tenants]
    card_agg = EndpointGraph(device=card, tenant="card-aggregate")
    cpu_agg = EndpointGraph(device="cpu", tenant="cpu-aggregate")
    assert coord.fold(tenants, card_agg) == sum(cpu_agg.fold_named_edges(e) for e in exports)
    assert card_agg.n_edges == cpu_agg.n_edges == sum(len(e["src"]) for e in exports)
    assert graph_signature(card_agg) == graph_signature(cpu_agg)
    assert card_agg.export_named_edges() == cpu_agg.export_named_edges()


@pytest.mark.cuda
def test_a_steady_chain_soak_on_card_launches_no_kernel_and_equals_cpu(card, tmp_path, monkeypatch):
    from kmamiz_tpu_torch.scenarios import build_scenario, run_scenario

    monkeypatch.setenv("KMAMIZ_PROF_FLIGHT_DIR", str(tmp_path / "flight"))
    spec = build_scenario("steady-chain", 0, 0, 4)
    before = _launches()
    on_card = run_scenario(spec, tmpdir=str(tmp_path / "card"), device=card)
    torch.cuda.synchronize()
    assert _launches() == before  # device statistics off: no kernel on this path
    on_cpu = run_scenario(spec, tmpdir=str(tmp_path / "cpu"), device="cpu")
    assert on_card["pass"] and on_cpu["pass"], (on_card["gates"], on_cpu["gates"])
    assert on_card["signatures"] == on_cpu["signatures"] == on_card["ref_signatures"]


@pytest.mark.cuda
def test_collect_scores_on_card_matches_cpu(card):
    """eval_models_large's collect_scores over a seeded 20-service mesh's
    held-out slots: the GraphSAGE forward on the card (two kernel launches
    a slot) against the same params on the CPU."""
    from kmamiz_tpu_torch.models import trainer
    from kmamiz_tpu_torch.tools import eval_models_large as eml

    result = eml.simulate(eml.make_mesh_config(20, 10, 1, np.random.default_rng(3)), 3)
    dataset = trainer.dataset_from_simulation(
        result.endpoint_dependencies, result.realtime_data_per_slot, result.replica_counts
    )
    eval_set = trainer.temporal_split(dataset, eml.TRAIN_FRACTION)[1]
    params = graphsage.init_params(torch.Generator().manual_seed(0), hidden=16, device=card)
    before = sparse.fused_sddmm_spmm.launches
    got = eml.collect_scores(params, eval_set, graphsage)
    torch.cuda.synchronize()
    assert sparse.fused_sddmm_spmm.launches == before + 2 * len(eval_set.features)
    cpu_params = type(params)(*(None if t is None else t.cpu() for t in params))
    want = eml.collect_scores(cpu_params, eval_set, graphsage)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_chaos_probes_degraded_serve_on_card_runs_the_stats_kernel_each_tick(card, tmp_path, monkeypatch):
    """The chaos probe's pillar 3 on the card: a DP server whose processor
    keeps device statistics on serves a tick past its deadline stale and
    recovers; each of its three ticks (the warm one, the straggler once it
    lands, the recovered one) launches the segment-stats kernel twice."""
    from kmamiz_tpu_torch.tools import chaos_probe

    monkeypatch.setenv("KMAMIZ_PROF_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.delenv("KMAMIZ_WAL", raising=False)
    before = ss.segment_stats.launches
    out = chaos_probe.pillar_degraded_serve(card)
    torch.cuda.synchronize()
    assert out["ok"], out
    assert ss.segment_stats.launches == before + 2 * 3


# -- restart warmth: the prebuild, the build cache and the prewarm ---------------

REPO = Path(__file__).resolve().parent.parent

_LOAD_FROM_CACHE = """
import json, sys
import torch
from kmamiz_tpu_torch.core import compile_cache
from kmamiz_tpu_torch.ops import segment_stats as ss, sparse
card = torch.device("cuda")
g = torch.Generator().manual_seed(0)
values = torch.rand(5, 4096, generator=g, dtype=torch.float32)
seg = torch.randint(0, 300, (4096,), generator=g, dtype=torch.int32)
ts = torch.randint(0, 1 << 20, (4096,), generator=g, dtype=torch.int32)
got = ss.segment_stats(values.to(card), seg.to(card), ts.to(card), 300)
want = ss.segment_stats_plain(values, seg, ts, 300)
torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-5)
assert torch.equal(got[1].cpu(), want[1])
n, e = 512, 4096
v = torch.randn(n, 64, generator=g, dtype=torch.float32)
src = torch.randint(0, n, (e,), generator=g, dtype=torch.int32)
dst = torch.randint(0, n, (e,), generator=g, dtype=torch.int32)
mask = torch.rand(e, generator=g) < 0.9
got = sparse.fused_sddmm_spmm(*(t.to(card) for t in (v, src, dst, mask)))
want = sparse.fused_plain(v, src, dst, mask)
for a, b in zip(got, want):
    torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
print(json.dumps(compile_cache.loads()))
"""


@pytest.mark.cuda
def test_the_prebuild_needs_no_card_and_a_process_without_nvcc_loads_from_it(card, tmp_path):
    """An image's build step: the package copied without csrc/build/, the
    prebuild run over the copy with no card visible; then a fresh process
    over the copy, with nvcc and g++ unreachable, loads both kernel
    libraries from the copy's csrc/build/ and launches them, matching the
    plain versions."""
    import os
    import shutil
    import subprocess
    import sys

    image = tmp_path / "app"
    build = REPO / "kmamiz_tpu_torch" / "csrc" / "build"
    shutil.copytree(
        REPO / "kmamiz_tpu_torch",
        image / "kmamiz_tpu_torch",
        ignore=lambda d, names: [n for n in names if n == "__pycache__" or Path(d, n) == build],
    )
    env = dict(os.environ, PYTHONPATH=str(image), CUDA_VISIBLE_DEVICES="")
    env.pop("KMAMIZ_COMPILE_CACHE_DIR", None)
    built = subprocess.run(
        [sys.executable, "-m", "kmamiz_tpu_torch.core.compile_cache", "--prebuild"],
        env=env, cwd=image, capture_output=True, text=True, timeout=900,
    )
    assert built.returncode == 0, built.stderr[-3000:]
    line = json.loads(built.stdout.strip().splitlines()[-1])
    prebuilt = image / "kmamiz_tpu_torch" / "csrc" / "build"
    assert line["dir"] == str(prebuilt)
    assert sorted(lib["library"] for lib in line["libraries"]) == ["fused_sddmm_spmm", "kmamiz_native", "segment_stats"]
    assert all(lib["built"] and Path(lib["path"]).parent == prebuilt for lib in line["libraries"])
    env = dict(
        os.environ,
        PYTHONPATH=str(image),
        CUDA_HOME=str(tmp_path / "no-cuda"),
        CXX=str(tmp_path / "no-cxx"),
        PATH=os.pathsep.join(p for p in os.environ.get("PATH", "").split(os.pathsep) if "cuda" not in p),
    )
    env.pop("CUDA_VISIBLE_DEVICES", None)
    env.pop("KMAMIZ_COMPILE_CACHE_DIR", None)
    run = subprocess.run(
        [sys.executable, "-c", _LOAD_FROM_CACHE], env=env, cwd=image, capture_output=True, text=True, timeout=600
    )
    assert run.returncode == 0, run.stderr[-3000:]
    loads = json.loads(run.stdout.strip().splitlines()[-1])
    assert sorted(entry["library"] for entry in loads) == ["fused_sddmm_spmm", "segment_stats"]
    for entry in loads:
        assert not entry["built"] and Path(entry["path"]).parent == prebuilt, entry


_PREWARMED_FORECAST = """
import json
import torch
from kmamiz_tpu_torch.core import compile_cache, prewarm
from kmamiz_tpu_torch.models import graphsage
from kmamiz_tpu_torch.models.stlgt import model as stlgt
from kmamiz_tpu_torch.ops import sparse
from kmamiz_tpu_torch.server.processor import DataProcessor
card = torch.device("cuda")
dp = DataProcessor(trace_source=lambda lb, t, lim: [], device=card, wal=None)
report = prewarm.run_prewarm(dp)
mark, launches = compile_cache.snapshot(), sparse.fused_sddmm_spmm.launches
g = torch.Generator().manual_seed(0)
n, e = 1024, 8192
feats = torch.randn(n, 18, generator=g, dtype=torch.float32).to(card)
src = torch.randint(0, n, (e,), generator=g, dtype=torch.int32).to(card)
dst = torch.randint(0, n, (e,), generator=g, dtype=torch.int32).to(card)
mask = (torch.rand(e, generator=g) < 0.9).to(card)
with torch.no_grad():
    graphsage.forward(graphsage.init_params(torch.Generator().manual_seed(1), hidden=64, num_features=18, device=card), feats, src, dst, mask)
    stlgt.forward(stlgt.init_params(torch.Generator().manual_seed(2), hidden=32, num_features=18, device=card), feats, src, dst, mask)
torch.cuda.synchronize()
print(json.dumps({"report": report, "after": compile_cache.loads(mark),
                  "launches": sparse.fused_sddmm_spmm.launches - launches}))
"""


@pytest.mark.cuda
def test_a_prewarmed_processors_first_forecast_forward_builds_and_loads_nothing(card):
    """In a fresh process, after the boot prewarm on the card, the
    forecast's forwards (GraphSAGE's two layers, STLGT's gated layer)
    launch kernel 2 with no library built or loaded."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run(
        [sys.executable, "-c", _PREWARMED_FORECAST], env=env, cwd=REPO, capture_output=True, text=True, timeout=900
    )
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert set(out["report"]["libraries"]) == {"kmamiz_native", "segment_stats", "fused_sddmm_spmm"}
    assert out["report"]["kernel2Launches"] == 6
    assert out["after"] == []
    assert out["launches"] == 3
