"""The device tier: kernel B3 (``resident_intersect_counts``, plain torch
version on ``device="cpu"``) and ``ResidencyManager`` held against the
reference package on the same seeded numpy inputs, on the scenarios of
``tests/test_device_tier.py``; B3's slot lengths (``lengths``, the tier's
``lens`` tensor) against the reference fed rows cut to those lengths.

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
from repro_torch.core.csr import CSRGraph, from_edges
from repro_torch.core.runtime import ShardedRuntime
from repro_torch.device import ResidencyManager
from repro_torch.kernels import resident_intersect as ri
from repro_torch.kernels.resident_intersect import resident_intersect_counts
from repro_torch.streaming import DynamicCSR, EdgeBatch, StreamingLCCEngine
from repro_torch.streaming import incremental


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
PAIR_GRID = [(1, 4), (7, 8), (64, 16), (130, 32)]


def held_against_reference(e, wb, lengths):
    """Both variants against the reference, with no slot lengths
    (``"none"``), the tier's true ones (``"true"``), or lengths that cut
    rows short or run past them (``"cut_or_overlong"``): the reference is
    fed the rows cut to the lengths (positions at or past them set to
    sentinel)."""
    rng = np.random.default_rng(e * 31 + wb)
    sent = 500
    res = random_rows(rng, 12, 24, sent)
    res[5] = sent  # an evicted slot: all sentinel, counts 0
    rows = random_rows(rng, e, wb, sent)
    sa = rng.integers(0, 12, e).astype(np.int32)
    sb = rng.integers(0, 12, e).astype(np.int32)
    sa[0] = 5
    lens = (res < sent).sum(1).astype(np.int32)  # the tier's lens
    if lengths == "cut_or_overlong":
        lens = lens + rng.integers(-4, 5, lens.size).astype(np.int32)
    cut = np.where(np.arange(res.shape[1])[None, :] < lens[:, None], res,
                   sent)
    want = ref_resident_intersect_counts(cut, sa, rows, sentinel=sent,
                                         interpret=True)
    want2 = ref_resident_intersect_counts(cut, sa, slots_b=sb, sentinel=sent,
                                          interpret=True)
    ri.reset_launches()
    for res_in, lens_in in ((res, lens),
                            (torch.from_numpy(res.copy()),
                             torch.from_numpy(lens.copy()))):
        kw = {"lengths": None if lengths == "none" else lens_in,
              "sentinel": sent, "device": "cpu"}
        got = resident_intersect_counts(res_in, sa, rows, **kw)
        same_array(got, want)
        assert got[0] == 0
        got2 = resident_intersect_counts(res_in, sa, slots_b=sb, **kw)
        same_array(got2, want2)
        assert got2[0] == 0
    # the plain version ran: no kernel was launched on the CPU
    assert ri.launches() == {"vs_rows": 0, "vs_slots": 0}


@pytest.mark.parametrize("e,wb", PAIR_GRID)
def test_resident_intersect_counts_match_reference(e, wb):
    held_against_reference(e, wb, "none")


@pytest.mark.parametrize("lengths", ["true", "cut_or_overlong"])
@pytest.mark.parametrize("e,wb", PAIR_GRID)
def test_resident_intersect_lengths_match_reference(e, wb, lengths):
    held_against_reference(e, wb, lengths)


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


@pytest.mark.parametrize("bad,err,match", [
    (torch.zeros(4, dtype=torch.int64), TypeError, "int32"),
    (torch.zeros(5, dtype=torch.int32), ValueError, "lengths"),
    (torch.zeros((4, 1), dtype=torch.int32), ValueError, "dims"),
    (torch.zeros(4, dtype=torch.int32, device="meta"), ValueError, "meta"),
    (np.zeros(3, np.int32), ValueError, "lengths"),
])
def test_resident_intersect_refuses_bad_lengths(bad, err, match):
    """Lengths of the wrong dtype, shape or device are refused before any
    launch, by both entry points."""
    res = torch.full((4, 8), 99, dtype=torch.int32)
    rows = np.full((2, 3), 99, np.int32)
    ri.reset_launches()
    with pytest.raises(err, match=match):
        resident_intersect_counts(res, np.array([0, 1]), rows, lengths=bad,
                                  sentinel=99, device="cpu")
    with pytest.raises(err, match=match):
        resident_intersect_counts(res, np.array([0, 1]),
                                  slots_b=np.array([1, 2]), lengths=bad,
                                  sentinel=99, device="cpu")
    if isinstance(bad, torch.Tensor):
        with pytest.raises(err, match=match):
            ri.resident_intersect(res, torch.zeros(2, dtype=torch.int32),
                                  torch.from_numpy(rows), lengths=bad,
                                  sentinel=99)
    assert ri.launches() == {"vs_rows": 0, "vs_slots": 0}


# --------------------------------------------------------------------------
# ResidencyManager on the scenarios of tests/test_device_tier.py
# --------------------------------------------------------------------------
def manager_pair(n, avg_deg, seed, **kw):
    g = ref_powerlaw_graph(n, avg_deg, seed=seed)
    ref_store = RefDynamicCSR.from_csr(g)
    port_store = DynamicCSR.from_csr(CSRGraph.from_reference(g))
    return (RefResidencyManager(ref_store, **kw), ref_store,
            ResidencyManager(port_store, device="cpu", **kw), port_store)


def lens_follow_rows(mgr):
    """The tier's device lengths: int32 ``[slots]`` beside ``rows``, equal
    to each row's valid length and to the host ``widths`` (0 when empty)."""
    assert mgr.lens.dtype == torch.int32 and mgr.lens.shape == (mgr.slots,)
    assert mgr.lens.device == mgr.rows.device
    valid = (mgr.rows < mgr.sentinel).sum(1, dtype=torch.int32)
    same_array(mgr.lens.numpy(), valid.numpy())
    same_array(mgr.lens.numpy(), mgr.widths)
    assert not np.shares_memory(mgr.lens.numpy(), mgr.widths)


def same_manager(got, want):
    same_fields(got.stats, want.stats)
    same_array(got.slot_ids, want.slot_ids)
    same_array(got.slot_epochs, want.slot_epochs)
    same_array(got.widths, want.widths)
    same_array(got.slot_of(np.arange(want.n)), want.slot_of(np.arange(want.n)))
    assert got.rows.dtype == torch.int32 and got.rows.device.type == "cpu"
    same_array(got.rows.numpy(), np.asarray(want.rows))
    lens_follow_rows(got)
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
    port.rows[s, 0] -= 1
    # and so is a device length that drifts from the row's
    assert port.audit()[1] == 0
    port.lens[s] += 1
    assert port.audit()[1] == 1
    port.lens[s] -= 2
    assert port.audit()[1] == 1


@pytest.mark.parametrize("event",
                         ["rebuild", "patch", "evict", "admit", "migrate"])
def test_lens_follow_the_rows(event):
    """``lens`` equals ``(rows < sentinel).sum(1)`` and ``widths`` after each
    way the tier changes; a patch, an eviction and an admission write the
    changed slots in place, and an evicted slot reads 0. Graph: hub 0 on
    1-10, triangle 1-2-3, edge 4-5; six slots hold 0-5."""
    edges = [(0, v) for v in range(1, 11)] + [(1, 2), (1, 3), (2, 3), (4, 5)]
    store = DynamicCSR.from_csr(from_edges(np.array(edges), 12))
    if event == "migrate":
        from repro_torch.core.partition import partition_hub

        rt = ShardedRuntime(store, 2, device="cpu",
                            partition=partition_hub(store.degrees, 2))
        rt.enable_device_tier(3, 16, scope="per_rank")
        assert rt.migrate(np.array([0, 3, 12])) > 0
        for k in range(2):
            lens_follow_rows(rt.device_for(k))
            assert rt.device_for(k).audit()[1] == 0
        return
    mgr = ResidencyManager(store, slots=6, max_width=16, device="cpu")
    lens_follow_rows(mgr)
    assert sorted(mgr.slot_ids.tolist()) == [0, 1, 2, 3, 4, 5]
    before = mgr.lens
    if event == "rebuild":
        store.insert_edges(np.array([[6, 7], [6, 8], [7, 8]]))
        mgr.rebuild()
    elif event == "patch":
        store.insert_edges(np.array([[1, 6]]))
        mgr.notify_batch([1, 6])
        assert mgr.stats.patches == 1 and mgr.stats.admits == 0
    elif event == "evict":
        slot4 = int(mgr.slot_of([4])[0])
        store.delete_edges(np.array([[0, 4], [4, 5]]))
        mgr.notify_batch([0, 4, 5])
        assert mgr.stats.evicts == 1 and mgr.stats.admits == 0
        assert mgr.slot_ids[slot4] == -1 and mgr.lens[slot4] == 0
    else:
        store.insert_edges(np.array([[6, 7], [6, 8]]))
        mgr.notify_batch([6, 7, 8])
        assert mgr.stats.admits == 1 and mgr.stats.evicts == 1
        assert mgr.lens[mgr.slot_of([6])[0]] == 3
    if event != "rebuild":
        assert mgr.lens is before  # index_copy_ of the changed slots
    lens_follow_rows(mgr)
    assert mgr.audit()[1] == 0


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
def test_streaming_oo_resident_route_matches(p, monkeypatch):
    g = ref_powerlaw_graph(96, 6, seed=60 + p)
    ref_rt = RefRuntime(None, p, n=g.n, device_slots=16)
    port_rt = ShardedRuntime(None, p, n=g.n, device_slots=16, device="cpu")
    ref = RefEngine(g, use_kernel=True, runtime=ref_rt, interpret=True)
    port = StreamingLCCEngine(CSRGraph.from_reference(g), use_kernel=True,
                              runtime=port_rt, device="cpu")
    # every B3 call of the engine passes the tier's own lengths tensor
    seen, call = [], incremental.resident_intersect_counts

    def spy(*args, **kw):
        seen.append(kw.get("lengths") is port_rt.device_for(0).lens)
        return call(*args, **kw)

    monkeypatch.setattr(incremental, "resident_intersect_counts", spy)
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
    assert seen and all(seen)


def test_residency_tensor_on_another_device_raises():
    """A resident tensor is never copied to the caller's device: the
    wrapper refuses it instead of uploading it again on every call."""
    res = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="lives on"):
        resident_intersect_counts(res, np.array([0]), slots_b=np.array([0]),
                                  sentinel=40, device="meta")
