"""The SPMD data plane of the port (``distributed/spmd_runtime.py`` and its
device programs B5 ``serve_block`` and B6 ``pair_counts``,
``kernels/spmd_plane.py``) held against the reference on the CPU
(``device="cpu"``: the plain torch versions).

- The executor against the reference's ``SpmdIntersectExecutor`` at p = 1
  in process (JAX sees one device here): counts, dtypes and every ledger
  counter, for the scenarios of ``tests/test_spmd_runtime.py``.
- B5 and B6's plain versions against the reference's compiled
  ``_body_serve`` / ``_body_pairs`` on the same inputs, and B6's kernel
  contract (a count over the two valid prefixes given by ``a_len`` /
  ``b_len``) against the plain version on units of real runs, split hubs
  included.
- Loop vs SPMD at p = 1: the port's ``execution="spmd"`` (pipelined and
  not) against the reference's loop mode and its SPMD mode, field for
  field. p in {4, 8} and the hub partition are in
  ``tests/test_torch_spmd_ranks.py``; the ledgers at p in {4, 8} against
  the reference's SPMD on forced host devices in
  ``tests/test_torch_spmd_ledger.py``.

Every input comes from a seed; integers are compared exactly, dtypes
included.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.partition import partition_1d as ref_partition_1d
from repro.distributed import spmd_runtime as ref_spmd
from repro_torch.core.partition import partition_1d
from repro_torch.distributed import spmd_runtime as spmd
from repro_torch.kernels import spmd_plane

from serving_parity import (
    TickClock,
    engine_view,
    results_view,
    runtime_view,
    same,
)

SENT = 4096


class FakeStore:
    def __init__(self, rows):
        self.rows = rows

    def row(self, v):
        return self.rows[int(v)]


def ledger_dict(led):
    """A ``CollectiveLedger`` as comparable counters — wall-clock fields
    are timing, not semantics."""
    d = led.to_dict()
    d.pop("device_wall_s", None)
    d.pop("overlap_wait_s", None)
    return d


def random_rows(rng, n, lo=0, hi=9):
    return {
        v: np.sort(rng.choice(n, size=int(rng.integers(lo, hi)),
                              replace=False)).astype(np.int32)
        for v in range(n)
    }


def oracle(rows, a, b):
    return np.array([len(np.intersect1d(rows[int(x)], rows[int(y)]))
                     for x, y in zip(a, b)], np.int64)


# --------------------------------------------------------------------------
# the executor against the reference's, p = 1 in process
# --------------------------------------------------------------------------
@pytest.mark.parametrize("use_kernel", [False, True])
def test_executor_matches_oracle_p1(use_kernel):
    rng = np.random.default_rng(3)
    n = 32
    rows = random_rows(rng, n)
    store = FakeStore(rows)
    a = rng.integers(0, n, size=20).astype(np.int64)
    b = rng.integers(0, n, size=20).astype(np.int64)
    held = {int(v): rows[int(v)] for v in np.unique(np.concatenate([a, b]))}
    ex = spmd.SpmdIntersectExecutor(partition_1d(n, 1), n, device="cpu",
                                    use_kernel=use_kernel)
    counts, unit = ex.run([spmd.ShardWork(0, a, b, held)], store)
    ref = ref_spmd.SpmdIntersectExecutor(ref_partition_1d(n, 1), n,
                                         use_kernel=use_kernel)
    want, ref_unit = ref.run([ref_spmd.ShardWork(0, a, b, held)], store)
    assert counts[0].dtype == np.int64 == want[0].dtype
    assert np.array_equal(counts[0], oracle(rows, a, b))
    assert np.array_equal(counts[0], want[0])
    assert unit.rows_shipped.sum() == 0  # p=1: nothing is remote
    assert ledger_dict(unit) == ledger_dict(ref_unit)
    assert ledger_dict(ex.ledger) == ledger_dict(ref.ledger)


def test_executor_empty_unit_is_free():
    ex = spmd.SpmdIntersectExecutor(partition_1d(16, 1), 16, device="cpu")
    z = np.zeros(0, np.int64)
    counts, unit = ex.run([spmd.ShardWork(0, z, z, {})], FakeStore({}))
    assert counts[0].size == 0 and counts[0].dtype == np.int64
    assert unit.n_collectives == 0
    assert ledger_dict(unit) == ledger_dict(spmd.CollectiveLedger.zero(1))
    assert ex._buf.rows is None  # nothing was staged


def test_executor_device_follows_the_caller():
    ex = spmd.SpmdIntersectExecutor(partition_1d(8, 1), 8, device="cpu")
    assert ex.device.type == "cpu" and ex.use_kernel is False
    ex = spmd.SpmdIntersectExecutor(partition_1d(8, 1), 8, device="cpu",
                                    use_kernel=True)
    assert ex.use_kernel is True


def test_resident_buffer_reuse_and_invalidation():
    """A second unit over the same rows reuses the resident buffer, an
    ``invalidate`` forces exactly the mutated row back up — the numbers
    equal the reference's unit by unit."""
    rng = np.random.default_rng(11)
    n = 32
    rows = random_rows(rng, n, lo=1)
    store = FakeStore(rows)
    a = rng.integers(0, n, size=24).astype(np.int64)
    b = rng.integers(0, n, size=24).astype(np.int64)
    held = {int(v): rows[int(v)] for v in np.unique(np.concatenate([a, b]))}
    ex = spmd.SpmdIntersectExecutor(partition_1d(n, 1), n, device="cpu")
    ref = ref_spmd.SpmdIntersectExecutor(ref_partition_1d(n, 1), n)

    def both():
        got, unit = ex.run([spmd.ShardWork(0, a, b, held)], store)
        want, ref_unit = ref.run([ref_spmd.ShardWork(0, a, b, held)], store)
        assert np.array_equal(got[0], oracle(rows, a, b))
        assert np.array_equal(got[0], want[0])
        assert ledger_dict(unit) == ledger_dict(ref_unit)
        return unit

    unit1 = both()
    assert unit1.bytes_uploaded > 0 and unit1.upload_bytes_saved == 0
    unit2 = both()
    assert unit2.bytes_uploaded == 0
    assert unit2.upload_bytes_saved == unit1.bytes_uploaded
    # the device twin equals the authoritative mirror
    assert np.array_equal(ex._buf.rows.numpy(), ex._buf.mirror)
    v = int(a[0])
    old = rows[v]
    new = old
    while np.array_equal(new, old):
        new = np.sort(rng.choice(n, size=old.size,
                                 replace=False)).astype(np.int32)
    rows[v] = new
    held[v] = new
    ex.invalidate([v])
    ref.invalidate([v])
    unit3 = both()
    assert unit3.bytes_uploaded == new.size * 4 and unit3.n_patches == 1
    assert np.array_equal(ex._buf.rows.numpy(), ex._buf.mirror)
    assert ex.audit_resident(store) == 0


def test_pipelined_units_read_the_buffer_they_captured():
    """Two units dispatched before either is waited for: the second one's
    in-place patch and grow do not change what the first one counted."""
    rng = np.random.default_rng(5)
    n = 64
    rows = random_rows(rng, n, lo=1, hi=12)
    store = FakeStore(rows)
    ex = spmd.SpmdIntersectExecutor(partition_1d(n, 1), n, device="cpu")
    units = []
    for k in range(3):
        sl = np.arange(k * 20, k * 20 + 24) % n
        a = sl.astype(np.int64)
        b = rng.integers(0, n, size=a.size).astype(np.int64)
        held = {int(v): rows[int(v)]
                for v in np.unique(np.concatenate([a, b]))}
        units.append((a, b, ex.dispatch([spmd.ShardWork(0, a, b, held)],
                                        store)))
    for a, b, pend in units:
        counts, _ = pend.wait()
        assert np.array_equal(counts[0], oracle(rows, a, b))
        assert pend.keep is None  # released at the barrier


def test_stage_one_upload_keeps_dtypes_and_shapes():
    arrays = [np.arange(6, dtype=np.int32).reshape(2, 3),
              np.array([True, False, True]),
              np.arange(5, dtype=np.int64) * (1 << 40)]
    views, host = spmd._stage(arrays, torch.device("cpu"))
    assert host.dtype == torch.uint8
    for v, a in zip(views, arrays):
        assert v.numpy().dtype == a.dtype and v.shape == a.shape
        assert np.array_equal(v.numpy(), a)


# --------------------------------------------------------------------------
# B5 / B6 against the reference's compiled bodies, p = 1
# --------------------------------------------------------------------------
def padded_rows(rng, m, w, sent, universe=None):
    universe = universe or sent
    out = np.full((m, w), sent, np.int32)
    lens = rng.integers(0, w + 1, size=m)
    for i, ln in enumerate(lens):
        out[i, :ln] = np.sort(rng.choice(universe, size=ln, replace=False))
    return out, lens.astype(np.int32)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_serve_block_matches_reference_body(use_kernel):
    rng = np.random.default_rng(21)
    h, w = 16, 64
    rows, _ = padded_rows(rng, h, w, SENT)
    rows[-1] = SENT  # the pad slot
    # rows shipped at a rung are no wider than it: cut each to its rung
    serve_cfg = [(4, 16), (2, 32), (8, 64)]
    idx = []
    for s_b, w_b in serve_cfg:
        seg = rng.integers(0, h, size=s_b).astype(np.int32)
        seg[-1] = h - 1  # a phantom position
        rows[seg[:-1], w_b:] = SENT
        idx.append(seg)
    serve_idx = np.concatenate(idx)[None, None, :]
    f_pad = 32
    got = spmd_plane.serve_block(torch.from_numpy(rows[None]),
                                 torch.from_numpy(serve_idx), serve_cfg,
                                 f_pad, sentinel=SENT)
    ref = ref_spmd.SpmdIntersectExecutor(ref_partition_1d(SENT, 1), SENT,
                                         use_kernel=use_kernel)
    fn = ref._fn_serve(h, w, tuple(serve_cfg), f_pad)
    want = np.asarray(fn(jnp.asarray(rows[None]), jnp.asarray(serve_idx)))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)
    assert got.shape == (1, f_pad, w)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_pair_counts_matches_reference_body(use_kernel):
    rng = np.random.default_rng(22)
    h, f_pad, w = 24, 16, 64
    rows, rlen = padded_rows(rng, h, w, SENT, universe=256)
    fetched, flen = padded_rows(rng, f_pad, w, SENT, universe=256)
    rows[-1], rlen[-1] = SENT, 0
    lens = np.concatenate([rlen, flen])
    # buckets on the ladder clipped to W: every sub-pair's width at most w_p
    pair_cfg, a_segs, b_segs, m_segs = [], [], [], []
    for e_b, w_p in ((8, 16), (16, 64)):
        ok = np.flatnonzero(lens <= w_p)
        a = rng.choice(ok, size=e_b).astype(np.int32)
        bb = rng.choice(ok, size=e_b).astype(np.int32)
        m = rng.random(e_b) < 0.8
        a[~m] = bb[~m] = h - 1  # phantoms point at the pad slot
        pair_cfg.append((e_b, w_p))
        a_segs.append(a)
        b_segs.append(bb)
        m_segs.append(m)
    a_idx = np.concatenate(a_segs)[None]
    b_idx = np.concatenate(b_segs)[None]
    mask = np.concatenate(m_segs)[None]
    a_len = np.where(mask, lens[a_idx], 0).astype(np.int32)
    b_len = np.where(mask, lens[b_idx], 0).astype(np.int32)
    t = torch.from_numpy
    got = spmd_plane.pair_counts(t(rows[None]), t(fetched[None]), t(a_idx),
                                 t(b_idx), t(a_len), t(b_len), t(mask),
                                 pair_cfg=pair_cfg, sentinel=SENT)
    ref = ref_spmd.SpmdIntersectExecutor(ref_partition_1d(SENT, 1), SENT,
                                         use_kernel=use_kernel)
    fn = ref._fn_pairs(h, f_pad, w,
                       tuple((e, wp, min(128, e)) for e, wp in pair_cfg))
    want = np.asarray(fn(jnp.asarray(rows[None]), jnp.asarray(fetched[None]),
                         jnp.asarray(a_idx), jnp.asarray(b_idx),
                         jnp.asarray(mask)))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)
    assert (got.numpy()[~mask] == 0).all() and got.numpy().sum() > 0
    # the kernel's contract: a count over the two valid prefixes
    assert np.array_equal(got.numpy(), prefix_counts(
        rows[None], fetched[None], a_idx, b_idx, a_len, b_len, mask))


def test_wrappers_refuse_bad_inputs():
    r = torch.zeros((2, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="p, p, S_tot"):
        spmd_plane.serve_block(r, torch.zeros((1, 2, 4), dtype=torch.int32),
                               [(4, 8)], 8, sentinel=9)
    with pytest.raises(ValueError, match="exceed f_pad"):
        spmd_plane.serve_block(r, torch.zeros((2, 2, 4), dtype=torch.int32),
                               [(4, 8)], 4, sentinel=9)
    with pytest.raises(TypeError, match="int32"):
        spmd_plane.serve_block(r.long(), torch.zeros((2, 2, 4)), [(4, 8)],
                               8, sentinel=9)
    z = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="do not sum"):
        spmd_plane.pair_counts(r, r, z, z, z, z, z.bool(),
                               pair_cfg=[(4, 8)], sentinel=9)
    with pytest.raises(TypeError, match="bool"):
        spmd_plane.pair_counts(r, r, z, z, z, z, z, pair_cfg=[(8, 8)],
                               sentinel=9)
    out = spmd_plane.pair_counts(r, r, z, z, z, z, z.bool(),
                                 pair_cfg=[(8, 8)], sentinel=9)
    assert out.dtype == torch.int32 and (out == 0).all()
    assert spmd_plane.launches() == {"serve_block": 0, "pair_counts": 0}


def prefix_counts(rows, fetched, a_idx, b_idx, a_len, b_len, mask):
    """What the B6 kernel computes, in numpy: each side read by index
    (``< H`` the buffer, else the fetched block) over its valid length."""
    h = rows.shape[1]
    out = np.zeros(a_idx.shape, np.int32)

    def side(j, idx, ln):
        src = rows[j, idx] if idx < h else fetched[j, idx - h]
        return src[:ln]

    for j, e in zip(*np.nonzero(mask)):
        out[j, e] = np.intersect1d(side(j, a_idx[j, e], a_len[j, e]),
                                   side(j, b_idx[j, e], b_len[j, e])).size
    return out


class UnitRecorder:
    """Wraps ``spmd_plane.serve_block`` / ``pair_counts`` (``kernel``) or
    their plain versions as the executor calls them: each call's inputs
    and output kept as numpy."""

    def __init__(self, monkeypatch, kernel=True):
        self.serve, self.pairs = [], []
        names = (("serve_block", "pair_counts") if kernel
                 else ("serve_block_ref", "pair_counts_ref"))

        def rec_serve(fn):
            def call(rows, serve_idx, serve_cfg, f_pad, *, sentinel):
                out = fn(rows, serve_idx, serve_cfg, f_pad, sentinel=sentinel)
                self.serve.append((rows.numpy().copy(), serve_idx.numpy(),
                                   list(serve_cfg), f_pad, out.numpy()))
                return out
            return call

        def rec_pairs(fn):
            def call(rows, fetched, *lists, pair_cfg, sentinel):
                out = fn(rows, fetched, *lists, pair_cfg=pair_cfg,
                         sentinel=sentinel)
                self.pairs.append((rows.numpy().copy(),
                                   fetched.numpy().copy(),
                                   [x.numpy().copy() for x in lists],
                                   list(pair_cfg), out.numpy()))
                return out
            return call

        for name, rec in zip(names, (rec_serve, rec_pairs)):
            monkeypatch.setattr(spmd_plane, name,
                                rec(getattr(spmd_plane, name)))

    def check(self, sentinel):
        """Every recorded B6 call equals the kernel's contract (prefix
        counts by index); every B5 call equals an independent numpy
        construction of the block."""
        assert self.pairs
        for rows, fetched, lists, cfg, out in self.pairs:
            assert out.dtype == np.int32
            assert np.array_equal(out, prefix_counts(rows, fetched, *lists))
        for rows, idx, cfg, f_pad, out in self.serve:
            assert np.array_equal(out, numpy_block(rows, idx, cfg, f_pad,
                                                   sentinel))


def numpy_block(rows, serve_idx, serve_cfg, f_pad, sentinel):
    """B5's block, built row by row in numpy."""
    p, _, w = rows.shape
    out = np.full((p, f_pad, w), sentinel, np.int32)
    for j in range(p):
        base = off = 0
        for s_b, w_b in serve_cfg:
            for k in range(p):
                for pos in range(s_b):
                    slot = serve_idx[k, j, off + pos]
                    out[j, base + k * s_b + pos, :w_b] = rows[k, slot, :w_b]
            base += p * s_b
            off += s_b
    return out


# --------------------------------------------------------------------------
# loop vs SPMD: the scenario runners (shared with the p in {4, 8} files)
# --------------------------------------------------------------------------
def packages(pkg):
    if pkg == "ref":
        import repro.core.partition as partition
        import repro.graphs.rmat as rmat
        import repro.serving as serving
        import repro.streaming as streaming

        return rmat, partition, serving, streaming, {}
    import repro_torch.core.partition as partition
    import repro_torch.graphs.rmat as rmat
    import repro_torch.serving as serving
    import repro_torch.streaming as streaming

    return rmat, partition, serving, streaming, {"device": "cpu"}


def run_serving(pkg, execution, p, seed, device_slots=0, pipeline=False,
                device_scope="replicated", hub=False, use_kernel=None):
    """The reference's ``_run_serving`` on either package: R-MAT S7,
    cross-rank, 10 read-write events of Zipf queries, latencies under a
    ``TickClock``. ``hub`` partitions by ``partition_hub`` of the graph's
    degrees."""
    rmat, partition, serving, _, dev = packages(pkg)
    csr = rmat.rmat_graph(7, 8, seed=seed)
    part = partition.partition_hub(csr.degrees, p) if hub else None
    kw = dict(dev)
    if pkg == "port" and use_kernel is not None:
        kw["use_kernel"] = use_kernel
    svc = serving.LiveQueryService(
        csr, p=p, cross_rank=True, execution=execution,
        device_slots=device_slots, device_width=256, pipeline=pipeline,
        device_scope=device_scope, partition=part, clock=TickClock(), **kw)
    results = []
    for ev in serving.read_write_stream(
        lambda: svc.store.degrees, csr.n, n_events=10, write_frac=0.3,
        queries_per_event=24, updates_per_event=24, kind="zipf", seed=seed,
    ):
        if ev.is_update:
            svc.apply_updates(ev.update)
        else:
            results.extend(svc.scheduler.run(ev.queries))
    svc.verify()
    return svc, results


def run_streaming(pkg, execution, p, seed, device_slots=0, pipeline=False,
                  device_scope="replicated", hub=False, use_kernel=True):
    """The reference's ``_run_streaming`` on either package: R-MAT S7,
    batches of 256 with 20% deletes, caches of 32 rows."""
    rmat, partition, _, streaming, dev = packages(pkg)
    n = 1 << 7
    part = None
    if hub:
        part = partition.partition_hub(
            rmat.rmat_graph(7, 8, seed=seed).degrees, p)
    coh = streaming.StreamingCacheCoherence(
        n, np.zeros(n, np.int64), p=p, cache_rows=32, partition=part, **dev)
    eng = streaming.StreamingLCCEngine.empty(
        n, coherence=coh, execution=execution, pipeline=pipeline,
        use_kernel=use_kernel, **dev)
    if device_slots:
        eng.runtime.enable_device_tier(device_slots, 256, scope=device_scope)
    out = [eng.apply_batch(b) for b in rmat.rmat_stream(
        7, 8, batch_size=256, delete_frac=0.2, seed=seed)]
    eng.verify()
    return eng, out


def serving_agrees(got, want, *, latency=True):
    """The port's SPMD service against a reference service (loop or SPMD)
    field for field: answers, per-rank provider stats, serve matrix,
    invalidations, tier stats, pair counters (not the host-packing bytes,
    which SPMD does not pack), stream state; and the port's measured
    traffic equal to its modeled serve matrix."""
    svc, res = got
    ref_svc, ref_res = want
    assert len(res) == len(ref_res) > 0
    same(results_view(res, latency), results_view(ref_res, latency))
    view = runtime_view(svc.runtime)
    ref_view = runtime_view(ref_svc.runtime)
    for k in ("stats", "aggregate", "serve_rows", "invalidations",
              "audit", "device"):
        same(view[k], ref_view[k], k)
    ev, ref_ev = engine_view(svc.engine), engine_view(ref_svc.engine)
    for k in ("n_queries", "n_pairs_total", "n_pairs_raw",
              "n_pairs_resident"):
        assert ev[k] == ref_ev[k], k
    same(svc.stream.t, ref_svc.stream.t)
    same(svc.stream.lcc, ref_svc.stream.lcc)
    led = svc.engine.spmd.ledger
    assert np.array_equal(led.rows_shipped, svc.runtime.serve_rows)
    assert led.bytes_payload == sum(s.bytes_fetched
                                    for s in svc.runtime.stats)
    assert led.n_pairs == svc.engine.n_pairs_total
    return led


def streaming_agrees(got, want):
    """The port's SPMD engine against a reference engine (loop or SPMD):
    every ``BatchResult``, ``t``, ``lcc``, worklist shares, the oo ledgers,
    provider and tier stats; its ledger's pairs equal the delta pairs."""
    eng, br = got
    ref_eng, ref_br = want
    assert len(br) == len(ref_br) > 0
    for x, y in zip(br, ref_br):
        same(x, y)
    same(eng.t, ref_eng.t)
    same(eng.lcc, ref_eng.lcc)
    same(eng.shard_pairs, ref_eng.shard_pairs)
    for k in ("oo_host_rows", "oo_host_bytes", "oo_resident_pairs",
              "delta_pairs_total", "n_updates"):
        assert getattr(eng, k) == getattr(ref_eng, k), k
    view, ref_view = runtime_view(eng.runtime), runtime_view(ref_eng.runtime)
    for k in ("stats", "aggregate", "device", "invalidations"):
        same(view[k], ref_view[k], k)
    assert eng.spmd.ledger.n_pairs == eng.delta_pairs_total
    assert eng.spmd.audit_resident(eng.store) == 0
    return eng.spmd.ledger


# --------------------------------------------------------------------------
# loop vs SPMD at p = 1 (the reference's SPMD runs here too)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serving_loop_vs_spmd_p1(seed):
    want = run_serving("ref", "loop", 1, seed)
    got = run_serving("port", "spmd", 1, seed)
    led = serving_agrees(got, want)
    ref_spmd_run = run_serving("ref", "spmd", 1, seed)
    assert ledger_dict(led) == ledger_dict(ref_spmd_run[0].engine.spmd.ledger)


@pytest.mark.parametrize("seed", [0, 1])
def test_streaming_loop_vs_spmd_p1(seed):
    want = run_streaming("ref", "loop", 1, seed)
    got = run_streaming("port", "spmd", 1, seed)
    led = streaming_agrees(got, want)
    ref_eng, _ = run_streaming("ref", "spmd", 1, seed)
    assert ledger_dict(led) == ledger_dict(ref_eng.spmd.ledger)


def test_streaming_loop_vs_spmd_p1_device_tier():
    streaming_agrees(run_streaming("port", "spmd", 1, 0, device_slots=32),
                     run_streaming("ref", "loop", 1, 0, device_slots=32))


@pytest.mark.parametrize("seed", [0, 1])
def test_serving_pipeline_p1(seed):
    want = run_serving("ref", "loop", 1, seed)
    got = run_serving("port", "spmd", 1, seed, pipeline=True)
    led = serving_agrees(got, want, latency=False)
    unpiped = run_serving("port", "spmd", 1, seed)
    assert ledger_dict(led) == ledger_dict(unpiped[0].engine.spmd.ledger)


@pytest.mark.parametrize("seed", [0, 1])
def test_streaming_pipeline_p1(seed, monkeypatch):
    want = run_streaming("ref", "loop", 1, seed)
    rec = UnitRecorder(monkeypatch)
    got = run_streaming("port", "spmd", 1, seed, pipeline=True)
    led = streaming_agrees(got, want)
    rec.check(got[0].n)
    unpiped, _ = run_streaming("port", "spmd", 1, seed)
    assert ledger_dict(led) == ledger_dict(unpiped.spmd.ledger)


def test_serving_loop_vs_spmd_p1_device_per_rank():
    serving_agrees(
        run_serving("port", "spmd", 1, 0, device_slots=32,
                    device_scope="per_rank"),
        run_serving("ref", "loop", 1, 0, device_slots=32,
                    device_scope="per_rank"))


def test_serving_spmd_through_the_wrappers(monkeypatch):
    """``use_kernel=True`` on the CPU routes the executor through the
    wrappers (their plain versions here): the same answers as the
    reference, and every recorded unit equal to the kernels' contract."""
    rec = UnitRecorder(monkeypatch)
    got = run_serving("port", "spmd", 1, 0, use_kernel=True)
    assert got[0].engine.spmd.use_kernel is True
    serving_agrees(got, run_serving("ref", "loop", 1, 0))
    rec.check(got[0].store.n)


def test_spmd_requires_a_runtime_and_pipeline_requires_spmd():
    from repro_torch.core.csr import CSRGraph
    from repro_torch.streaming import StreamingLCCEngine

    g = CSRGraph(offsets=np.zeros(5, np.int64),
                 adjacencies=np.zeros(0, np.int32), n=4)
    with pytest.raises(AssertionError, match="attach a ShardedRuntime"):
        StreamingLCCEngine(g, execution="spmd", device="cpu")
    with pytest.raises(AssertionError, match="execution='spmd'"):
        StreamingLCCEngine(g, pipeline=True, device="cpu")


def test_collective_ledger_fields_match_reference():
    names = [f.name for f in dataclasses.fields(spmd.CollectiveLedger)]
    assert names == [f.name
                     for f in dataclasses.fields(ref_spmd.CollectiveLedger)]
    names = [f.name for f in dataclasses.fields(spmd.ShardWork)]
    assert names == [f.name for f in dataclasses.fields(ref_spmd.ShardWork)]
    assert spmd._PAIR_WIDTH_LADDER == ref_spmd._PAIR_WIDTH_LADDER
    assert spmd._CAP_WINDOW == ref_spmd._CAP_WINDOW
