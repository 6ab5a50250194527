"""The device tier: kernel B3 (``resident_intersect_counts``, plain torch
version on ``device="cpu"``) and ``ResidencyManager`` held against the
reference package on the same seeded numpy inputs, on the scenarios of
``tests/test_device_tier.py``.

The reference runs its Pallas kernel in interpret mode. All results are
integers: counts, stats, slot ids, epochs and the resident rows tensor are
compared bit for bit, dtypes included.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.runtime import ShardedRuntime as RefRuntime
from repro.device import ResidencyManager as RefResidencyManager
from repro.graphs.datasets import powerlaw_graph as ref_powerlaw_graph
from repro.kernels.resident_intersect import (
    resident_intersect_counts as ref_resident_intersect_counts,
)
from repro.streaming import DynamicCSR as RefDynamicCSR
from repro.streaming import EdgeBatch as RefEdgeBatch
from repro.streaming import StreamingLCCEngine as RefEngine
from repro_torch.core.csr import CSRGraph
from repro_torch.core.runtime import ShardedRuntime
from repro_torch.device import ResidencyManager
from repro_torch.kernels import resident_intersect as ri
from repro_torch.kernels.resident_intersect import resident_intersect_counts
from repro_torch.streaming import DynamicCSR, EdgeBatch, StreamingLCCEngine


def random_rows(rng, n_rows, width, id_space):
    out = np.full((n_rows, width), id_space, np.int32)
    for i in range(n_rows):
        k = int(rng.integers(0, width + 1))
        out[i, :k] = np.sort(rng.choice(id_space, size=k, replace=False))
    return out


def same_array(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def same_fields(got, want):
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.keys() == w.keys()
    for k in g:
        assert type(g[k]) is type(w[k]) and g[k] == w[k], (k, g[k], w[k])


# --------------------------------------------------------------------------
# B3 vs the reference kernel (interpret mode)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("e,wb", [(1, 4), (7, 8), (64, 16), (130, 32)])
def test_resident_intersect_counts_match_reference(e, wb):
    rng = np.random.default_rng(e * 31 + wb)
    sent = 500
    res = random_rows(rng, 12, 24, sent)
    res[5] = sent  # an evicted slot: all sentinel, counts 0
    rows = random_rows(rng, e, wb, sent)
    sa = rng.integers(0, 12, e).astype(np.int32)
    sb = rng.integers(0, 12, e).astype(np.int32)
    sa[0] = 5
    ri.reset_launches()
    for res_in in (res, torch.from_numpy(res.copy())):
        got = resident_intersect_counts(res_in, sa, rows, sentinel=sent,
                                        device="cpu")
        want = ref_resident_intersect_counts(res, sa, rows, sentinel=sent,
                                             interpret=True)
        same_array(got, want)
        assert got[0] == 0
        got2 = resident_intersect_counts(res_in, sa, slots_b=sb,
                                         sentinel=sent, device="cpu")
        want2 = ref_resident_intersect_counts(res, sa, slots_b=sb,
                                              sentinel=sent, interpret=True)
        same_array(got2, want2)
        assert got2[0] == 0
    # the plain version ran: no kernel was launched on the CPU
    assert ri.launches() == {"vs_rows": 0, "vs_slots": 0}


def test_resident_intersect_empty_batch_and_evicted_pairs():
    res = np.full((4, 8), 99, np.int32)
    for kw in ({"rows_b": np.zeros((0, 4), np.int32)},
               {"slots_b": np.zeros(0, np.int32)}):
        out = resident_intersect_counts(res, np.zeros(0, np.int32),
                                        sentinel=99, device="cpu", **kw)
        assert out.shape == (0,) and out.dtype == np.int64
    # all-sentinel against all-sentinel: sentinel never matches sentinel
    full = np.full((3, 6), 99, np.int32)
    got = resident_intersect_counts(res, np.array([0, 1, 3]), full,
                                    sentinel=99, device="cpu")
    same_array(got, np.zeros(3, np.int64))
    got = resident_intersect_counts(res, np.array([0, 1]),
                                    slots_b=np.array([1, 1]), sentinel=99,
                                    device="cpu")
    same_array(got, np.zeros(2, np.int64))


def test_resident_intersect_checks_its_inputs():
    res = np.full((4, 8), 99, np.int32)
    rows = np.full((2, 3), 99, np.int32)
    with pytest.raises(ValueError, match="outside"):
        resident_intersect_counts(res, np.array([0, 4]), rows, sentinel=99,
                                  device="cpu")
    with pytest.raises(ValueError, match="outside"):
        resident_intersect_counts(res, np.array([0, 1]),
                                  slots_b=np.array([-1, 0]), sentinel=99,
                                  device="cpu")
    with pytest.raises(ValueError, match="XOR"):
        resident_intersect_counts(res, np.array([0]), sentinel=99,
                                  device="cpu")
    with pytest.raises(ValueError, match="rows_b"):
        resident_intersect_counts(res, np.array([0]), rows, sentinel=99,
                                  device="cpu")
    t = torch.from_numpy(res)
    with pytest.raises(TypeError, match="int32"):
        ri.resident_intersect(t.long(), torch.zeros(1, dtype=torch.int32),
                              torch.from_numpy(rows[:1]), sentinel=99)
    with pytest.raises(ValueError, match="pair counts"):
        ri.resident_intersect(t, torch.zeros(1, dtype=torch.int32),
                              torch.from_numpy(rows), sentinel=99)


# --------------------------------------------------------------------------
# ResidencyManager on the scenarios of tests/test_device_tier.py
# --------------------------------------------------------------------------
def manager_pair(n, avg_deg, seed, **kw):
    g = ref_powerlaw_graph(n, avg_deg, seed=seed)
    ref_store = RefDynamicCSR.from_csr(g)
    port_store = DynamicCSR.from_csr(CSRGraph.from_reference(g))
    return (RefResidencyManager(ref_store, **kw), ref_store,
            ResidencyManager(port_store, device="cpu", **kw), port_store)


def same_manager(got, want):
    same_fields(got.stats, want.stats)
    same_array(got.slot_ids, want.slot_ids)
    same_array(got.slot_epochs, want.slot_epochs)
    same_array(got.widths, want.widths)
    same_array(got.slot_of(np.arange(want.n)), want.slot_of(np.arange(want.n)))
    assert got.rows.dtype == torch.int32 and got.rows.device.type == "cpu"
    same_array(got.rows.numpy(), np.asarray(want.rows))
    assert got.rebuilds == want.rebuilds
    assert got.max_width == want.max_width
    assert got.audit() == want.audit()


def test_manager_selects_the_same_hot_set():
    ref, _, port, _ = manager_pair(120, 6, 4, slots=16)
    same_manager(port, ref)
    assert port.audit() == (16, 0)


def test_manager_excludes_rows_wider_than_the_buffer():
    g = ref_powerlaw_graph(100, 6, seed=9)
    width = int(np.sort(g.degrees)[-3])
    ref, _, port, _ = manager_pair(100, 6, 9, slots=8, max_width=width)
    same_manager(port, ref)


def test_patch_evict_admit_and_epochs_match():
    g = ref_powerlaw_graph(80, 5, seed=1)
    ref, ref_store, port, port_store = manager_pair(
        80, 5, 1, slots=6, max_width=int(g.max_degree) + 8)
    resident = np.flatnonzero(ref.slot_of(np.arange(g.n)) >= 0)
    hub = int(resident[np.argmax(ref_store.degrees[resident])])
    sw, ew = ref.claim(np.array([hub]))
    sg, eg = port.claim(np.array([hub]))
    same_array(sg, sw)
    same_array(eg, ew)
    absent = next(
        v for v in range(g.n)
        if v != hub and not ref_store.has_edge(hub, v)
        and ref.slot_of(np.array([v]))[0] < 0
        and ref_store.degrees[v] + 1 < ref_store.degrees[resident].min()
    )
    edge = np.array([[min(hub, absent), max(hub, absent)]])
    for s in (ref_store, port_store):
        s.insert_edges(edge)
    assert port.notify_batch([hub, absent]) == ref.notify_batch([hub, absent])
    same_manager(port, ref)
    with pytest.raises(AssertionError, match="stale"):
        port.check(sg, eg)
    # drift: raise an outsider's degree above the weakest resident
    resident = np.flatnonzero(ref.slot_of(np.arange(g.n)) >= 0)
    weakest = int(resident[np.argmin(ref_store.degrees[resident])])
    outsider = next(v for v in range(g.n)
                    if ref.slot_of(np.array([v]))[0] < 0
                    and ref_store.degrees[v] > 0)
    target = int(ref_store.degrees[weakest]) + 2
    adds = [v for v in range(g.n)
            if v != outsider and not ref_store.has_edge(outsider, v)
            ][: target - int(ref_store.degrees[outsider])]
    edges = np.array([[min(outsider, v), max(outsider, v)] for v in adds],
                     np.int64)
    for s in (ref_store, port_store):
        s.insert_edges(edges)
    ids = np.unique(edges.ravel()).tolist()
    assert port.notify_batch(ids) == ref.notify_batch(ids)
    same_manager(port, ref)
    assert port.stats.admits >= 1 and port.stats.evicts >= 1
    # the served, padded and mirrored rows agree too
    vs = np.arange(g.n)
    rg, mg = port.padded_rows(vs, int(ref_store.max_degree))
    rw, mw = ref.padded_rows(vs, int(ref_store.max_degree))
    same_array(rg, rw)
    same_array(mg, mw)
    for v in (hub, outsider, 0):
        got, want = port.serve(v), ref.serve(v)
        assert (got is None) == (want is None)
        if want is not None:
            same_array(got, want)
    same_manager(port, ref)


def test_rows_tensor_never_shares_memory_with_the_mirror():
    """The tensor is a copy: writing the mirror behind the manager's back
    leaves ``rows`` alone, and ``audit()`` reports the divergence. If the
    upload aliased the mirror (``torch.from_numpy``), both checks fail."""
    _, _, port, port_store = manager_pair(80, 5, 2, slots=6,
                                          max_width=64)
    assert not np.shares_memory(port.rows.numpy(), port._host)
    s = int(np.flatnonzero(port.slot_ids >= 0)[0])
    before = port.rows[s].clone()
    port._host[s, 0] = port._host[s, 0] + 1  # mirror only, no sync
    assert torch.equal(port.rows[s], before)
    port._host[s, 0] -= 1
    # a patch goes through index_copy_: still a copy afterwards
    v = int(port.slot_ids[s])
    absent = next(x for x in range(port.n)
                  if x != v and not port_store.has_edge(v, x))
    port_store.insert_edges(np.array([[min(v, absent), max(v, absent)]]))
    port.notify_batch([v, absent])
    assert not np.shares_memory(port.rows.numpy(), port._host)
    assert port.audit()[1] == 0
    # a device row that drifts from the mirror is staleness
    port.rows[s, 0] += 1
    assert port.audit()[1] == 1


def test_manager_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    store = DynamicCSR.from_csr(
        CSRGraph.from_reference(ref_powerlaw_graph(30, 3, seed=0)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResidencyManager(store, slots=4)
    rt = ShardedRuntime(store, 2)  # host-only: no tier, no device needed
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt.enable_device_tier(4)


# --------------------------------------------------------------------------
# runtime + streaming consumers of the tier
# --------------------------------------------------------------------------
def test_fetch_rows_consults_device_before_host_cache_match():
    g = ref_powerlaw_graph(80, 6, seed=3)
    ref_store = RefDynamicCSR.from_csr(g)
    port_store = DynamicCSR.from_csr(CSRGraph.from_reference(g))
    ref = RefRuntime(ref_store, 4, device_slots=8)
    port = ShardedRuntime(port_store, 4, device_slots=8, device="cpu")
    resident = np.flatnonzero(ref.device.slot_of(np.arange(g.n)) >= 0)
    v = int(resident[0])
    rank = (int(ref.part.owner(v)) + 1) % 4
    got, want = port.fetch_rows(rank, [v, v]), ref.fetch_rows(rank, [v, v])
    same_array(got[v], want[v])
    same_fields(port.stats[rank], ref.stats[rank])
    assert port.stats[rank].device_hits == 2
    same_manager(port.device, ref.device)


@pytest.mark.parametrize("p", [1, 4])
def test_streaming_oo_resident_route_matches(p):
    g = ref_powerlaw_graph(96, 6, seed=60 + p)
    ref_rt = RefRuntime(None, p, n=g.n, device_slots=16)
    port_rt = ShardedRuntime(None, p, n=g.n, device_slots=16, device="cpu")
    ref = RefEngine(g, use_kernel=True, runtime=ref_rt, interpret=True)
    port = StreamingLCCEngine(CSRGraph.from_reference(g), use_kernel=True,
                              runtime=port_rt, device="cpu")
    rng = np.random.default_rng(61 + p)
    for _ in range(3):
        ins = rng.integers(0, g.n, size=(30, 2))
        src, dst = ref.store.to_csr().edge_list()
        keep = src < dst
        pool = np.stack([src[keep], dst[keep]], 1)
        pick = rng.choice(pool.shape[0], size=8, replace=False)
        u = np.concatenate([ins[:, 0], pool[pick][:, 0]])
        v = np.concatenate([ins[:, 1], pool[pick][:, 1]])
        op = np.concatenate([np.full(30, 1, np.int8), np.full(8, -1, np.int8)])
        rw = ref.apply_batch(RefEdgeBatch(u=u, v=v, op=op))
        rg = port.apply_batch(EdgeBatch(u=u, v=v, op=op))
        assert dataclasses.asdict(rg) == dataclasses.asdict(rw)
        same_array(port.t, ref.t)
        same_array(port.lcc, ref.lcc)
        assert port.oo_resident_pairs == ref.oo_resident_pairs
        assert port.oo_host_bytes == ref.oo_host_bytes
        same_manager(port_rt.device, ref_rt.device)
    port.verify()
    assert port.oo_resident_pairs > 0


def test_residency_tensor_on_another_device_raises():
    """A resident tensor is never copied to the caller's device: the
    wrapper refuses it instead of uploading it again on every call."""
    res = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="lives on"):
        resident_intersect_counts(res, np.array([0]), slots_b=np.array([0]),
                                  sentinel=40, device="meta")
