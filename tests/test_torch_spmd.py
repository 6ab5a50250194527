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
                                 pair_cfg=pair_cfg, sentinel=SENT,
                                 real=real_of(t(mask)))
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


def landing_of(fetched, lens):
    """The packed landing of the rows ``fetched [p, F, W]`` with valid
    lengths ``lens [p, F]`` and its offsets ``[p, F + 1]``."""
    p, f, _ = fetched.shape
    landing = np.concatenate(
        [fetched[j, i, : lens[j, i]] for j in range(p) for i in range(f)]
        or [np.zeros(0, np.int32)]).astype(np.int32)
    return landing, spmd._exclusive_rows(lens)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_serve_landing_matches_reference_body(use_kernel):
    """B5's landing, unpacked to the block, equals the reference's compiled
    ``_body_serve`` on the same inputs (p = 1: the rank serves itself)."""
    rng = np.random.default_rng(23)
    h, w = 16, 64
    rows, _ = padded_rows(rng, h, w, SENT)
    rows[-1] = SENT  # the pad slot
    serve_cfg = [(4, 16), (2, 32), (8, 64)]
    idx = []
    for s_b, w_b in serve_cfg:
        seg = rng.integers(0, h, size=s_b).astype(np.int32)
        seg[-1] = h - 1  # a phantom position
        rows[seg[:-1], w_b:] = SENT
        idx.append(seg)
    lens = (rows < SENT).sum(1).astype(np.int32)
    serve_idx = np.concatenate(idx)[None, None, :]
    serve_len = lens[serve_idx]
    land_off = spmd._exclusive_rows(serve_len[0])  # p = 1: (j, f) = pos
    n_ids = int(land_off[-1, -1])
    f_pad = 32
    t = torch.from_numpy
    landing = spmd_plane.serve_landing(t(rows[None]), t(serve_idx),
                                       t(serve_len), t(land_off), serve_cfg,
                                       n_ids, items=items_of(land_off))
    ref = ref_spmd.SpmdIntersectExecutor(ref_partition_1d(SENT, 1), SENT,
                                         use_kernel=use_kernel)
    fn = ref._fn_serve(h, w, tuple(serve_cfg), f_pad)
    want = np.asarray(fn(jnp.asarray(rows[None]), jnp.asarray(serve_idx)))
    assert landing.dtype == torch.int32 and want.dtype == np.int32
    assert landing.shape == (n_ids,) and 0 < n_ids < f_pad * w
    got = spmd_plane.unpack_landing(landing, t(land_off), w, SENT, f_pad)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(numpy_unpack(landing.numpy(), land_off, w, SENT),
                          want[:, : land_off.shape[1] - 1])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_pair_counts_landed_matches_reference_body(use_kernel):
    """B6 on a landing equals the reference's compiled ``_body_pairs`` on
    the block the landing unpacks to (f_exact 12 of f_pad 16 rows)."""
    rng = np.random.default_rng(24)
    h, f_exact, f_pad, w = 24, 12, 16, 64
    rows, rlen = padded_rows(rng, h, w, SENT, universe=256)
    fetched, flen = padded_rows(rng, f_exact, w, SENT, universe=256)
    rows[-1], rlen[-1] = SENT, 0
    lens = np.concatenate([rlen, flen])
    pair_cfg, a_segs, b_segs, m_segs = [], [], [], []
    for e_b, w_p in ((8, 16), (16, 64)):
        ok = np.flatnonzero(lens <= w_p)
        a = rng.choice(ok, size=e_b).astype(np.int32)
        bb = rng.choice(ok, size=e_b).astype(np.int32)
        m = rng.random(e_b) < 0.8
        a[~m] = bb[~m] = h - 1
        pair_cfg.append((e_b, w_p))
        a_segs.append(a)
        b_segs.append(bb)
        m_segs.append(m)
    a_idx = np.concatenate(a_segs)[None]
    b_idx = np.concatenate(b_segs)[None]
    mask = np.concatenate(m_segs)[None]
    a_len = np.where(mask, lens[a_idx], 0).astype(np.int32)
    b_len = np.where(mask, lens[b_idx], 0).astype(np.int32)
    landing, land_off = landing_of(fetched[None], flen[None])
    t = torch.from_numpy
    lists = [t(x) for x in (a_idx, b_idx, a_len, b_len, mask)]
    real = t(np.flatnonzero(mask).astype(np.int32))
    got = spmd_plane.pair_counts_landed(t(rows[None]), t(landing),
                                        t(land_off), *lists,
                                        pair_cfg=pair_cfg, sentinel=SENT,
                                        real=real)
    block = np.full((1, f_pad, w), SENT, np.int32)
    block[0, :f_exact] = fetched
    ref = ref_spmd.SpmdIntersectExecutor(ref_partition_1d(SENT, 1), SENT,
                                         use_kernel=use_kernel)
    fn = ref._fn_pairs(h, f_pad, w,
                       tuple((e, wp, min(128, e)) for e, wp in pair_cfg))
    want = np.asarray(fn(jnp.asarray(rows[None]), jnp.asarray(block),
                         jnp.asarray(a_idx), jnp.asarray(b_idx),
                         jnp.asarray(mask)))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)
    assert (want[~mask] == 0).all() and want.sum() > 0
    assert (a_idx[mask] >= h).any() and (b_idx[mask] >= h).any()
    assert np.array_equal(got.numpy(), prefix_counts(
        rows[None], block, a_idx, b_idx, a_len, b_len, mask))


LANDING_CASES = {
    # name: (p, h, w, serve_cfg, f_pad, e_cfg, lens_hi)
    "rows_of_length_0": (4, 8, 64, [(2, 16), (2, 64)], 16,
                         [(8, 16), (8, 64)], 0),
    "rung_at_w": (4, 10, 64, [(3, 16), (2, 64)], 32, [(8, 16), (8, 64)],
                  None),
    "w_no_multiple_of_4": (4, 6, 6, [(3, 6)], 16, [(8, 6)], None),
    "p1": (1, 8, 16, [(2, 16)], 4, [(8, 16)], None),
    "p8": (8, 24, 512, [(4, 16), (2, 64), (2, 256), (1, 512)], 128,
           [(16, 16), (8, 64), (8, 256), (8, 512)], None),
}


@pytest.mark.parametrize("name", list(LANDING_CASES))
def test_landing_edge_cases(name):
    """The landed route through the wrappers (plain versions here) on
    ``tests/test_torch_gpu.py``'s units: the landing unpacked equals the
    block (``serve_block_ref`` and a numpy construction), and the counts on
    it equal ``pair_counts_ref`` on the block and the kernel's contract;
    an all-phantom worklist counts 0."""
    from test_torch_gpu import _spmd_unit

    p, h, w, serve_cfg, f_pad, e_cfg, lens_hi = LANDING_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    rows, serve_idx, lists, (serve_len, land_off) = _spmd_unit(
        rng, p, h, w, serve_cfg, f_pad, e_cfg, SENT, True, lens_hi)
    assert np.array_equal(land_off, spmd._exclusive_rows(
        numpy_unpack_lens(serve_len, serve_cfg)))
    n_ids = int(land_off[-1, -1])
    t = torch.from_numpy
    r, s, lo = t(rows), t(serve_idx), t(land_off)
    landing = spmd_plane.serve_landing(r, s, t(serve_len), lo, serve_cfg,
                                       n_ids, items=items_of(land_off))
    assert landing.dtype == torch.int32 and landing.shape == (n_ids,)
    assert (n_ids == 0) == (lens_hi == 0)
    block = spmd_plane.serve_block_ref(r, s, serve_cfg, f_pad, sentinel=SENT)
    assert torch.equal(spmd_plane.unpack_landing(landing, lo, w, SENT, f_pad),
                       block)
    assert np.array_equal(numpy_unpack(landing.numpy(), land_off, w, SENT),
                          numpy_block(rows, serve_idx, serve_cfg,
                                      land_off.shape[1] - 1, SENT))
    dl = [t(x) for x in lists]
    for mask in (dl[4], torch.zeros_like(dl[4])):  # then all phantom
        got = spmd_plane.pair_counts_landed(r, landing, lo, *dl[:4], mask,
                                            pair_cfg=e_cfg, sentinel=SENT,
                                            real=real_of(mask))
        want = spmd_plane.pair_counts_ref(r, block, *dl[:4], mask,
                                          pair_cfg=e_cfg, sentinel=SENT)
        assert got.dtype == torch.int32 and torch.equal(got, want)
        assert np.array_equal(got.numpy(), prefix_counts(
            rows, block.numpy(), *lists[:4], mask.numpy()))
    assert int(got.abs().sum()) == 0


def test_landing_items_cover_every_landed_id_once():
    """The landing kernel's work list: a ``(row, chunk)`` pair for each
    ``LAND_CHUNK`` ids of each row of nonzero length, rows in landing
    order, none for an empty row."""
    c = spmd_plane.LAND_CHUNK
    lens = np.array([[0, 1, c, 0], [c + 1, 3 * c - 5, 0, 7]], np.int32)
    items = spmd_plane.landing_items(lens)
    assert items.dtype == np.int32 and items.shape == (1 + 1 + 2 + 3 + 1, 2)
    assert items.tolist() == [[1, 0], [2, 0], [4, 0], [4, 1], [5, 0],
                              [5, 1], [5, 2], [7, 0]]
    covered = sum(min(lens.reshape(-1)[r] - k * c, c) for r, k in items)
    assert covered == lens.sum()
    assert spmd_plane.landing_items(np.zeros((3, 0), np.int32)).shape == (0, 2)


def numpy_unpack_lens(serve_len, serve_cfg):
    """The landed lengths ``[p (dst), f_exact]`` in ``(j, f)`` order."""
    p = serve_len.shape[0]
    out, off = [], 0
    for s_b, _ in serve_cfg:
        out.append(serve_len[:, :, off: off + s_b].transpose(1, 0, 2)
                   .reshape(p, p * s_b))
        off += s_b
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_unit_without_serve_traffic(use_kernel, monkeypatch):
    """A unit at p = 2 whose rows are all held where they are read: no B5
    call, B6 on the empty landing (kernel route) or the cached sentinel
    block (plain route), counts equal to the reference's loop."""
    rng = np.random.default_rng(25)
    n = 32
    rows = random_rows(rng, n, lo=1)
    calls = []
    for name in ("serve_landing", "serve_block_ref", "pair_counts_landed",
                 "pair_counts_ref"):
        fn = getattr(spmd_plane, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            calls.append((_name, args[1].shape))
            return _fn(*args, **kw)

        monkeypatch.setattr(spmd_plane, name, spy)
    ex = spmd.SpmdIntersectExecutor(partition_1d(n, 2), n, device="cpu",
                                    use_kernel=use_kernel)
    shards, want = [], []
    for j in range(2):
        a = rng.integers(0, n, size=12).astype(np.int64)
        b = rng.integers(0, n, size=12).astype(np.int64)
        held = {int(v): rows[int(v)]
                for v in np.unique(np.concatenate([a, b]))}
        shards.append(spmd.ShardWork(j, a, b, held))
        want.append(oracle(rows, a, b))
    counts, unit = ex.run(shards, FakeStore(rows))
    assert all(c.dtype == np.int64 and np.array_equal(c, w)
               for c, w in zip(counts, want))
    assert unit.n_collectives == 0 and unit.total_rows == 0
    assert not any(name.startswith("serve") for name, _ in calls)
    if use_kernel:  # the empty landing (its plain version, here, after it)
        assert calls[0] == ("pair_counts_landed", (0,))
    else:
        assert [c[0] for c in calls] == ["pair_counts_ref"]
        assert calls[0][1][0] == 2 and ex._empty_blocks


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
    none = z.new_zeros(0)  # no real position
    with pytest.raises(ValueError, match="do not sum"):
        spmd_plane.pair_counts(r, r, z, z, z, z, z.bool(),
                               pair_cfg=[(4, 8)], sentinel=9, real=none)
    with pytest.raises(TypeError, match="bool"):
        spmd_plane.pair_counts(r, r, z, z, z, z, z, pair_cfg=[(8, 8)],
                               sentinel=9, real=none)
    with pytest.raises(TypeError, match="real"):
        spmd_plane.pair_counts(r, r, z, z, z, z, z.bool(),
                               pair_cfg=[(8, 8)], sentinel=9)
    with pytest.raises(TypeError, match="real: expected int32"):
        spmd_plane.pair_counts(r, r, z, z, z, z, z.bool(),
                               pair_cfg=[(8, 8)], sentinel=9,
                               real=none.long())
    out = spmd_plane.pair_counts(r, r, z, z, z, z, z.bool(),
                                 pair_cfg=[(8, 8)], sentinel=9, real=none)
    assert out.dtype == torch.int32 and (out == 0).all()
    idx = torch.zeros((2, 2, 4), dtype=torch.int32)
    off = torch.zeros((2, 9), dtype=torch.int64)
    items = torch.zeros((0, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="f_exact"):
        spmd_plane.serve_landing(r, idx, idx, off[:, :3], [(4, 8)], 0,
                                 items=items)
    with pytest.raises(TypeError, match="int64"):
        spmd_plane.serve_landing(r, idx, idx, off.int(), [(4, 8)], 0,
                                 items=items)
    with pytest.raises(ValueError, match="S_tot"):
        spmd_plane.serve_landing(r, idx, idx[:, :1], off, [(4, 8)], 0,
                                 items=items)
    with pytest.raises(TypeError, match="items"):
        spmd_plane.serve_landing(r, idx, idx, off, [(4, 8)], 0)
    with pytest.raises(ValueError, match="landing"):
        spmd_plane.pair_counts_landed(r, r, off, z, z, z, z, z.bool(),
                                      pair_cfg=[(8, 8)], sentinel=9,
                                      real=none)
    with pytest.raises(TypeError, match="real"):
        spmd_plane.pair_counts_landed(
            r, torch.zeros(0, dtype=torch.int32), off[:, :1], z, z, z, z,
            z.bool(), pair_cfg=[(8, 8)], sentinel=9)
    out = spmd_plane.pair_counts_landed(
        r, torch.zeros(0, dtype=torch.int32), off[:, :1], z, z, z, z,
        z.bool(), pair_cfg=[(8, 8)], sentinel=9, real=none)
    assert out.dtype == torch.int32 and (out == 0).all()
    assert spmd_plane.launches() == {"serve_landing": 0, "serve_block": 0,
                                     "pair_counts_landed": 0,
                                     "pair_counts": 0}


def real_of(mask):
    """B6's list of real positions: the flat positions of ``mask``."""
    return torch.nonzero(mask.reshape(-1)).reshape(-1).to(torch.int32)


def items_of(land_off):
    """B5's work list from the landing's offsets (``landing_items``)."""
    return torch.from_numpy(spmd_plane.landing_items(
        np.diff(np.asarray(land_off), axis=1)))


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
    """Wraps the executor's B5 and B6 entry points as it calls them — the
    landed route's ``serve_landing`` / ``pair_counts_landed`` (``kernel``)
    or the plain route's ``serve_block_ref`` / ``pair_counts_ref`` — and
    keeps each call's inputs and output as numpy."""

    def __init__(self, monkeypatch, kernel=True):
        self.serve, self.pairs = [], []

        def np_args(args):
            return [a.numpy().copy() if isinstance(a, torch.Tensor) else a
                    for a in args]

        def rec(fn, kind, calls):
            def call(*args, **kw):
                out = fn(*args, **kw)
                calls.append((kind, np_args(args),
                              dict(zip(kw, np_args(kw.values()))),
                              out.numpy().copy()))
                return out
            return call

        if kernel:
            names = (("serve_landing", "landing", self.serve),
                     ("pair_counts_landed", "landing", self.pairs))
        else:
            names = (("serve_block_ref", "block", self.serve),
                     ("pair_counts_ref", "block", self.pairs))
        for name, kind, calls in names:
            monkeypatch.setattr(spmd_plane, name,
                                rec(getattr(spmd_plane, name), kind, calls))

    def check(self, sentinel):
        """Every recorded B6 call equals the kernel's contract (prefix
        counts by index; on the landed route the real positions it
        launches over are the mask's); every B5 call equals an independent
        numpy construction of the block (a landing unpacked to it)."""
        assert self.pairs
        for kind, args, kw, out in self.pairs:
            assert out.dtype == np.int32
            if kind == "landing":
                rows, landing, land_off, *lists = args
                fetched = numpy_unpack(landing, land_off, rows.shape[2],
                                       sentinel)
                assert kw["real"].dtype == np.int32
                assert np.array_equal(kw["real"],
                                      np.flatnonzero(lists[4]))
            else:
                rows, fetched, *lists = args
            assert np.array_equal(out, prefix_counts(rows, fetched, *lists))
        for kind, args, kw, out in self.serve:
            if kind == "landing":
                rows, idx, serve_len, land_off, cfg, n_ids = args
                assert out.dtype == np.int32 and out.size == n_ids
                assert land_off[-1, -1] == n_ids
                assert np.array_equal(kw["items"], spmd_plane.landing_items(
                    np.diff(land_off, axis=1)))
                f_pad = land_off.shape[1] - 1
                out = numpy_unpack(out, land_off, rows.shape[2], sentinel)
            else:
                rows, idx, cfg, f_pad = args
            assert np.array_equal(out, numpy_block(rows, idx, cfg, f_pad,
                                                   sentinel))


def numpy_unpack(landing, land_off, w, sentinel):
    """A landing laid out as the ``[p, f_exact, W]`` block, in numpy."""
    p, f1 = land_off.shape
    out = np.full((p, f1 - 1, w), sentinel, np.int32)
    for j in range(p):
        for f in range(f1 - 1):
            lo, hi = land_off[j, f], land_off[j, f + 1]
            out[j, f, : hi - lo] = landing[lo:hi]
    return out


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
    wrappers of the landed route (their plain versions here): the same
    answers as the reference at p = 1 and 4, and every recorded unit equal
    to the kernels' contract."""
    rec = UnitRecorder(monkeypatch)
    got = run_serving("port", "spmd", 1, 0, use_kernel=True)
    assert got[0].engine.spmd.use_kernel is True
    serving_agrees(got, run_serving("ref", "loop", 1, 0))
    rec.check(got[0].store.n)
    # p = 4: rows ship, so the landed route's B5 runs too
    rec = UnitRecorder(monkeypatch)
    got = run_serving("port", "spmd", 4, 0, use_kernel=True)
    serving_agrees(got, run_serving("ref", "loop", 4, 0))
    rec.check(got[0].store.n)
    assert rec.serve and all(kind == "landing" for kind, *_ in rec.serve)


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
