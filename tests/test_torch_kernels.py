"""The port's ``intersect_count`` and its ragged-pair wrappers held against
the reference package on the same seeded numpy inputs.

On the CPU the port's wrapper takes the kernel's plain torch version; the
reference runs its Pallas kernel in interpret mode and its jnp oracle. All
results are integers: every comparison is bit-for-bit, dtype included. The
bucketing cases of ``test_bucketing.py`` are re-run against the port's copy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import delta_intersect as ref_delta
from repro.kernels import ops as ref_ops
from repro.kernels import point_query as ref_pq
from repro.kernels import ref as ref_ref
from repro_torch.kernels import bucketing, delta_intersect, ops, point_query, ref
from repro_torch.kernels import bitmap_popcount as bm
from repro_torch.kernels import intersect_count as ic

SENT = 4096


def pad_sorted(rng, e, w, sentinel, max_fill=None):
    out = np.full((e, w), sentinel, np.int32)
    for i in range(e):
        k = rng.integers(0, (w if max_fill is None else max_fill) + 1)
        vals = np.unique(rng.integers(0, sentinel, size=k))
        out[i, : len(vals)] = vals
    return out


def port_count(a, b, sentinel=SENT):
    got = ops.intersect_count(
        torch.from_numpy(a), torch.from_numpy(b), sentinel=sentinel
    )
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    return got.numpy()


# --------------------------------------------------------------------------
# intersect_count vs the Pallas kernel (interpret mode) and the jnp oracle
# --------------------------------------------------------------------------
@pytest.mark.parametrize("e,wa,wb,block_e", [
    (128, 16, 32, 64),
    (256, 64, 128, 128),
    (128, 8, 200, 128),  # non-multiple-of-128 width
])
def test_intersect_count_matches_reference(e, wa, wb, block_e):
    rng = np.random.default_rng(0)
    a = pad_sorted(rng, e, wa, SENT)
    b = pad_sorted(rng, e, wb, SENT)
    got = port_count(a, b)
    pallas = ref_ops.intersect_count(
        jnp.asarray(a), jnp.asarray(b), sentinel=SENT, block_e=block_e,
        interpret=True,
    )
    oracle = ref_ref.intersect_count_ref(jnp.asarray(a), jnp.asarray(b),
                                         sentinel=SENT)
    assert np.asarray(pallas).dtype == np.int32
    assert np.array_equal(got, np.asarray(pallas))
    assert np.array_equal(got, np.asarray(oracle))
    # the re-exported plain version is the same function
    assert ref.intersect_count_ref is ic.intersect_count_ref


@pytest.mark.parametrize("e", [1, 3, 37, 1000])
def test_intersect_count_any_pair_count(e):
    # E is a multiple of nothing in particular: no block_e constraint here
    rng = np.random.default_rng(e)
    a = pad_sorted(rng, e, 12, SENT)
    b = pad_sorted(rng, e, 20, SENT)
    want = ref_ref.intersect_count_ref(jnp.asarray(a), jnp.asarray(b),
                                       sentinel=SENT)
    assert np.array_equal(port_count(a, b), np.asarray(want))


def test_intersect_count_zero_pairs_and_zero_width():
    a0 = np.zeros((0, 8), np.int32)
    assert port_count(a0, np.zeros((0, 5), np.int32)).shape == (0,)
    rng = np.random.default_rng(1)
    a = pad_sorted(rng, 6, 8, SENT)
    got = port_count(a, np.zeros((6, 0), np.int32))
    assert np.array_equal(got, np.zeros(6, np.int32))
    got = port_count(np.zeros((6, 0), np.int32), a)
    assert np.array_equal(got, np.zeros(6, np.int32))


def test_intersect_count_sentinels_never_match():
    # all-sentinel rows on either side, and sentinel padding on both sides
    # of a pair: sentinel == sentinel must never count
    full = np.full((4, 8), SENT, np.int32)
    rng = np.random.default_rng(2)
    some = pad_sorted(rng, 4, 8, SENT, max_fill=5)  # >= 3 sentinels per row
    assert (some == SENT).any(axis=1).all()
    for a, b in ((full, full), (full, some), (some, full), (some, some)):
        want = ref_ref.intersect_count_ref(jnp.asarray(a), jnp.asarray(b),
                                           sentinel=SENT)
        assert np.array_equal(port_count(a, b), np.asarray(want))
    assert np.array_equal(port_count(full, full), np.zeros(4, np.int32))
    assert np.array_equal(port_count(some, some), (some < SENT).sum(1))
    # ids above the sentinel are padding too
    hi = some.copy()
    hi[hi == SENT] = SENT + 7
    assert np.array_equal(port_count(hi, hi), (some < SENT).sum(1))


def test_intersect_count_rejects_bad_input():
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.intersect_count(a.long(), a, sentinel=SENT)
    with pytest.raises(ValueError):
        ops.intersect_count(a[0], a[0], sentinel=SENT)
    with pytest.raises(ValueError):
        ops.intersect_count(a, a[:3], sentinel=SENT)
    with pytest.raises(TypeError):
        ops.intersect_count(a.numpy(), a, sentinel=SENT)


def test_cpu_path_launches_no_kernel():
    ic.reset_launches()
    a = torch.zeros((4, 8), dtype=torch.int32)
    ops.intersect_count(a, a, sentinel=SENT)
    assert ic.launches() == 0


@pytest.mark.parametrize("name", ["segment_sum_sorted"])
def test_unported_kernels_raise(name):
    with pytest.raises(NotImplementedError, match=f"not ported yet: {name}"):
        getattr(ops, name)()


# --------------------------------------------------------------------------
# bitmap_intersect_count (B2) vs the Pallas kernel (interpret mode)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("e,w,block_e", [(256, 8, 128), (512, 33, 256)])
def test_bitmap_intersect_count_matches_reference(e, w, block_e):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2**32, size=(e, w), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(e, w), dtype=np.uint32)
    want = ref_ops.bitmap_intersect_count(jnp.asarray(a), jnp.asarray(b),
                                          block_e=block_e, interpret=True)
    assert np.asarray(want).dtype == np.int32
    bm.reset_launches()
    # int32 bit patterns as tensors, uint32 tensors, and numpy words
    for wa, wb in ((torch.from_numpy(a.view(np.int32)),
                    torch.from_numpy(b.view(np.int32))),
                   (torch.from_numpy(a.view(np.int32)).view(torch.uint32),
                    torch.from_numpy(b.view(np.int32)).view(torch.uint32))):
        got = ops.bitmap_intersect_count(wa, wb)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), np.asarray(want))
    got = ops.bitmap_intersect_count(a, b, device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(
        ref.bitmap_intersect_count_ref(torch.from_numpy(a.view(np.int32)),
                                       torch.from_numpy(b.view(np.int32))
                                       ).numpy(),
        np.asarray(want))
    assert bm.launches() == 0  # the CPU path launches no kernel


@pytest.mark.parametrize("e,w", [(1, 1), (3, 3), (257, 5), (1000, 64)])
def test_bitmap_any_e_matches_reference_oracle(e, w):
    """E need not be a multiple of 256 (the Pallas kernel's block): held
    against the reference's jnp oracle."""
    rng = np.random.default_rng(e + w)
    a = rng.integers(0, 2**32, size=(e, w), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(e, w), dtype=np.uint32)
    a[0] = 0xFFFFFFFF
    b[0] = 0xFFFFFFFF  # every bit set: 32 * w
    want = np.asarray(ref_ref.bitmap_intersect_count_ref(jnp.asarray(a),
                                                         jnp.asarray(b)))
    got = ops.bitmap_intersect_count(a, b, device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert int(got[0]) == 32 * w


def test_bitmap_vs_rows_cross_check():
    """B2 == B1 on the same sets, packed with ``rows_to_bitmap_words`` —
    and both equal the reference's Pallas kernels on them."""
    from repro_torch.core.csr import rows_to_bitmap_words

    rng = np.random.default_rng(6)
    e, w, sent = 128, 24, 512
    a = pad_sorted(rng, e, w, sent)
    b = pad_sorted(rng, e, w, sent)
    c1 = port_count(a, b, sentinel=sent)
    wa, wb = rows_to_bitmap_words(a, sent), rows_to_bitmap_words(b, sent)
    c2 = ops.bitmap_intersect_count(wa, wb, device="cpu").numpy()
    assert np.array_equal(c1, c2)
    ref_c2 = ref_ops.bitmap_intersect_count(jnp.asarray(wa), jnp.asarray(wb),
                                            block_e=64, interpret=True)
    assert np.array_equal(c2, np.asarray(ref_c2))


def test_bitmap_checks_its_inputs():
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.bitmap_intersect_count(a.long(), a)
    with pytest.raises(ValueError, match="shapes differ"):
        ops.bitmap_intersect_count(a, a[:3])
    with pytest.raises(ValueError):
        ops.bitmap_intersect_count(a[0], a[0])
    with pytest.raises(TypeError):
        ops.bitmap_intersect_count(np.zeros((2, 2), np.int64),
                                   np.zeros((2, 2), np.int64), device="cpu")
    assert ops.bitmap_intersect_count(a[:0], a[:0]).shape == (0,)


# --------------------------------------------------------------------------
# ragged-pair wrappers: the reference really ends in pl.pallas_call here
# --------------------------------------------------------------------------
def ragged_rows(rng, n_pairs, max_w, sentinel):
    rows = []
    for _ in range(n_pairs):
        k = int(rng.integers(0, max_w + 1))
        rows.append(np.unique(rng.integers(0, sentinel, size=k)).astype(np.int32))
    return rows


@pytest.mark.parametrize("e,wa,wb", [(0, 4, 4), (3, 5, 9), (77, 16, 40),
                                     (130, 8, 0)])
def test_delta_intersect_counts_matches_reference(e, wa, wb):
    rng = np.random.default_rng(10 + e)
    a = pad_sorted(rng, e, wa, SENT)
    b = pad_sorted(rng, e, wb, SENT) if wb else np.zeros((e, 0), np.int32)
    got = delta_intersect.delta_intersect_counts(a, b, sentinel=SENT,
                                                 device="cpu")
    assert got.dtype == np.int64 and got.shape == (e,)
    if wb:  # the Pallas kernel takes no zero-width block
        want = ref_delta.delta_intersect_counts(a, b, sentinel=SENT,
                                                interpret=True)
        assert want.dtype == np.int64
        assert np.array_equal(got, want)
    masks = delta_intersect.delta_intersect_masks(a, b, sentinel=SENT)
    ref_masks = ref_delta.delta_intersect_masks(a, b, sentinel=SENT)
    assert masks.dtype == bool and np.array_equal(masks, ref_masks)
    assert np.array_equal(got, masks.sum(1))


@pytest.mark.parametrize("seed,n_pairs,max_w", [(0, 60, 40), (1, 9, 3),
                                                (2, 200, 90)])
def test_batched_pair_counts_matches_reference(seed, n_pairs, max_w):
    rng = np.random.default_rng(seed)
    ra = ragged_rows(rng, n_pairs, max_w, SENT)
    rb = ragged_rows(rng, n_pairs, max_w, SENT)
    got_k = point_query.batched_pair_counts(ra, rb, sentinel=SENT,
                                            use_kernel=True, device="cpu")
    got_h = point_query.batched_pair_counts(ra, rb, sentinel=SENT)
    want_k = ref_pq.batched_pair_counts(ra, rb, sentinel=SENT,
                                        use_kernel=True, interpret=True)
    want_h = ref_pq.batched_pair_counts(ra, rb, sentinel=SENT)
    for arr in (got_k, got_h, want_k, want_h):
        assert arr.dtype == np.int64 and arr.shape == (n_pairs,)
    assert np.array_equal(got_k, want_k)
    assert np.array_equal(got_h, want_h)
    assert np.array_equal(got_k, got_h)
    brute = [np.intersect1d(x, y).size for x, y in zip(ra, rb)]
    assert np.array_equal(got_k, brute)


def test_batched_pair_counts_empty():
    got = point_query.batched_pair_counts([], [], sentinel=SENT)
    assert got.dtype == np.int64 and got.shape == (0,)


# --------------------------------------------------------------------------
# bucketing: the cases of test_bucketing.py against the port's copy
# --------------------------------------------------------------------------
def test_bucketing_pow2_ceil_zero_and_one():
    assert bucketing.pow2_ceil(0) == 1
    assert bucketing.pow2_ceil(1) == 1


@pytest.mark.parametrize("w", [1, 2, 4, 8, 256, 1 << 20])
def test_bucketing_pow2_ceil_exact_power_is_identity(w):
    assert bucketing.pow2_ceil(w) == w


@pytest.mark.parametrize("w, want", [(3, 4), (5, 8), (9, 16), (1025, 2048)])
def test_bucketing_pow2_ceil_rounds_up(w, want):
    assert bucketing.pow2_ceil(w) == want


def test_bucketing_pow2_ceil_floor():
    assert bucketing.pow2_ceil(3, floor=8) == 8
    assert bucketing.pow2_ceil(9, floor=8) == 16
    assert bucketing.pow2_ceil(0, floor=6) == 8


def test_bucketing_width_classes_matches_scalar():
    ws = [0, 1, 2, 3, 4, 5, 7, 8, 9, 1023, 1024]
    got = bucketing.width_classes(ws)
    want = np.array([bucketing.pow2_ceil(w) for w in ws], np.int64)
    assert np.array_equal(got, want)
    assert bucketing.width_classes([]).size == 0


def test_bucketing_pack_rows():
    assert bucketing.pack_rows([], 4, -1).shape == (0, 4)
    out = bucketing.pack_rows([np.zeros(0, np.int32)] * 3, 4, -1)
    assert out.shape == (3, 4) and (out == -1).all()
    rows = [np.array([5], np.int32), np.array([1, 2, 3], np.int32)]
    out = bucketing.pack_rows(rows, 4, -1)
    assert np.array_equal(out[0], [5, -1, -1, -1])
    assert np.array_equal(out[1], [1, 2, 3, -1])


def _cover(splits, n):
    seen = np.concatenate([idx for idx, _ in splits]) if splits else (
        np.zeros(0, np.int64)
    )
    assert np.array_equal(np.sort(seen), np.arange(n))


def test_bucketing_split_degenerate_cases():
    assert bucketing.split_width_buckets([], 4) == []
    splits = bucketing.split_width_buckets([5, 6, 7, 8], 4)
    assert len(splits) == 1
    idx, w = splits[0]
    assert w == 8 and np.array_equal(idx, np.arange(4))
    ws = [1, 2, 4, 8, 16, 300]
    splits = bucketing.split_width_buckets(ws, 1)
    assert len(splits) == 1 and splits[0][1] == 512
    _cover(splits, len(ws))


@pytest.mark.parametrize("cap", [1, 2, 3, 4])
def test_bucketing_split_respects_budget_and_covers(cap):
    rng = np.random.default_rng(0)
    ws = rng.integers(0, 400, size=200)
    splits = bucketing.split_width_buckets(ws, cap)
    assert 1 <= len(splits) <= cap
    _cover(splits, len(ws))
    widths = [w for _, w in splits]
    assert widths == sorted(widths)
    for idx, w in splits:
        assert (np.maximum(ws[idx], 1) <= w).all()


def test_bucketing_split_merge_rules():
    splits = bucketing.split_width_buckets([2, 2, 2, 3, 8, 7], 2)
    assert [(sorted(i.tolist()), w) for i, w in splits] == [
        ([0, 1, 2], 2),
        ([3, 4, 5], 8),
    ]
    ws = [1, 1, 2, 2, 4]
    splits = bucketing.split_width_buckets(ws, 2)
    assert [w for _, w in splits] == [2, 4]
    _cover(splits, len(ws))


def test_bucketing_matches_reference_on_random_widths():
    from repro.kernels import bucketing as ref_bucketing

    rng = np.random.default_rng(5)
    wa = rng.integers(0, 300, size=150)
    wb = rng.integers(0, 300, size=150)
    got = list(bucketing.iter_width_buckets(wa, wb))
    want = list(ref_bucketing.iter_width_buckets(wa, wb))
    assert len(got) == len(want)
    for (gi, ga, gb), (wi, wa_, wb_) in zip(got, want):
        assert np.array_equal(gi, wi) and (ga, gb) == (wa_, wb_)
    for cap in (1, 3, 6):
        gs = bucketing.split_width_buckets(wa, cap)
        ws_ = ref_bucketing.split_width_buckets(wa, cap)
        assert [(i.tolist(), w) for i, w in gs] == [
            (i.tolist(), w) for i, w in ws_
        ]
