"""Tests of the port that need a CUDA device and ``nvcc``.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports only ``torch``, ``numpy`` and the port, so it runs on a
machine that has the card and no JAX. Each test decides for itself, when it
runs, whether there is a card, and skips with a reason when there is none.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import intersect_count as ic
from repro_torch.kernels import ops

SENT = 4096


def pad_sorted(rng, e, w, sentinel):
    out = np.full((e, w), sentinel, np.int32)
    for i in range(e):
        vals = np.unique(rng.integers(0, sentinel, size=rng.integers(0, w + 1)))
        out[i, : len(vals)] = vals
    return out


@pytest.mark.gpu
def test_intersect_count_kernel_on_card():
    """The CUDA kernel (built with nvcc at first use) against its plain
    version, bit for bit, including ragged pair counts, zero widths and
    all-sentinel rows; a non-contiguous operand raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    rng = np.random.default_rng(3)
    ic.reset_launches()
    cases = [(128, 16, 32), (256, 64, 128), (128, 8, 200), (1, 5, 5),
             (3, 7, 0), (1000, 33, 1), (77, 0, 9), (513, 300, 1000)]
    for e, wa, wb in cases:
        a = torch.from_numpy(pad_sorted(rng, e, wa, SENT)).cuda()
        b = torch.from_numpy(pad_sorted(rng, e, wb, SENT)).cuda()
        got = ops.intersect_count(a, b, sentinel=SENT)
        torch.cuda.synchronize()
        want = ic.intersect_count_ref(a, b, sentinel=SENT)
        assert got.dtype == torch.int32 and got.device == a.device
        assert torch.equal(got, want), (e, wa, wb)
    full = torch.full((40, 64), SENT, dtype=torch.int32, device="cuda")
    assert int(ops.intersect_count(full, full, sentinel=SENT).sum()) == 0
    assert ic.launches() == len(cases) + 1
    wide = torch.from_numpy(pad_sorted(rng, 8, 64, SENT)).cuda()
    with pytest.raises(ValueError, match="contiguous"):
        ops.intersect_count(wide[:, ::2], wide[:, ::2], sentinel=SENT)
    assert ic.launches() == len(cases) + 1  # a refused call launches nothing


@pytest.mark.gpu
def test_resident_intersect_kernel_on_card():
    """B3, both variants, against its plain version bit for bit: ragged E,
    zero-width query rows, evicted (all-sentinel) slots, S = 1; an
    out-of-range slot raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from repro_torch.kernels import resident_intersect as ri

    rng = np.random.default_rng(4)
    ri.reset_launches()
    n = 0
    for s, w in [(64, 48), (1, 16), (300, 200)]:
        res = pad_sorted(rng, s, w, SENT)
        res[rng.integers(0, s)] = SENT  # an evicted slot
        res_t = torch.from_numpy(res).cuda()
        for e, wb in [(1, 4), (7, 0), (130, 32), (1000, 200)]:
            sa = rng.integers(0, s, e)
            sb = rng.integers(0, s, e)
            rows = pad_sorted(rng, e, wb, SENT)
            got = ri.resident_intersect_counts(res_t, sa, rows, sentinel=SENT)
            want = ri.resident_intersect_ref(
                res_t, torch.from_numpy(sa.astype(np.int32)).cuda(),
                torch.from_numpy(rows).cuda(), sentinel=SENT)
            assert got.dtype == np.int64
            assert np.array_equal(got, want.cpu().numpy()), (s, w, e, wb)
            got = ri.resident_intersect_counts(res_t, sa, slots_b=sb,
                                               sentinel=SENT)
            want = ri.resident_intersect_ref(
                res_t, torch.from_numpy(sa.astype(np.int32)).cuda(),
                slots_b=torch.from_numpy(sb.astype(np.int32)).cuda(),
                sentinel=SENT)
            assert np.array_equal(got, want.cpu().numpy()), (s, w, e)
            n += 1
    assert ri.launches() == {"vs_rows": n, "vs_slots": n}
    with pytest.raises(ValueError, match="outside"):
        ri.resident_intersect_counts(res_t, np.array([0, 300]),
                                     slots_b=np.array([0, 0]), sentinel=SENT)
    assert ri.launches() == {"vs_rows": n, "vs_slots": n}


@pytest.mark.gpu
def test_bitmap_popcount_kernel_on_card():
    """B2 against its plain version bit for bit, at any E and W (the
    16-byte path and the scalar path), and against B1 on the same sets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from repro_torch.core.csr import rows_to_bitmap_words
    from repro_torch.kernels import bitmap_popcount as bm

    rng = np.random.default_rng(5)
    bm.reset_launches()
    cases = [(1, 1), (3, 3), (256, 128), (1000, 2048), (77, 6)]
    for e, w in cases:
        a = rng.integers(0, 2**32, size=(e, w), dtype=np.uint32)
        b = rng.integers(0, 2**32, size=(e, w), dtype=np.uint32)
        got = ops.bitmap_intersect_count(a, b)
        torch.cuda.synchronize()
        want = bm.bitmap_intersect_count_ref(
            torch.from_numpy(a.view(np.int32)).cuda(),
            torch.from_numpy(b.view(np.int32)).cuda())
        assert got.dtype == torch.int32 and got.is_cuda
        assert torch.equal(got, want), (e, w)
    assert bm.launches() == len(cases)
    ra = pad_sorted(rng, 300, 40, SENT)
    rb = pad_sorted(rng, 300, 40, SENT)
    c1 = ops.intersect_count(torch.from_numpy(ra).cuda(),
                             torch.from_numpy(rb).cuda(), sentinel=SENT)
    c2 = ops.bitmap_intersect_count(rows_to_bitmap_words(ra, SENT),
                                    rows_to_bitmap_words(rb, SENT))
    assert torch.equal(c1, c2)


def _attention_inputs(rng, b, s, t, kh, g, dh, dtype):
    q = torch.from_numpy(rng.normal(size=(b, s, kh, g, dh)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, t, kh, dh)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, t, kh, dh)).astype(np.float32))
    return (x.to("cuda", dtype) for x in (q, k, v))


@pytest.mark.gpu
def test_flash_attention_kernel_on_card():
    """B8 against its plain version: fp32 at 2e-5 (the reference's kernel
    tolerance; only the summation order differs), bf16/fp16 element by
    element at one ulp of the output dtype (2^-7 / 2^-10 relative: both
    round one fp32 result) plus 1e-4 for the fp32 summation noise near 0;
    causal, windows, softcap, non-causal, G in {1, 2}, dh in {64, 128,
    256}, S that no tile divides, S != T."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import flash_attention_torch

    rng = np.random.default_rng(6)
    fa.reset_launches()
    n = 0
    cases = [  # (b, s, t, kh, g, dh, causal, window, softcap, dtype)
        (2, 200, 200, 2, 2, 64, True, 0, 0.0, torch.float32),
        (1, 300, 300, 2, 2, 128, True, 64, 50.0, torch.float32),
        (1, 129, 129, 3, 1, 128, False, 0, 0.0, torch.float32),
        (2, 96, 160, 2, 2, 64, False, 40, 30.0, torch.float32),
        (1, 65, 65, 2, 2, 256, True, 16, 50.0, torch.float32),
        (1, 1000, 1000, 4, 2, 128, True, 256, 50.0, torch.bfloat16),
        (1, 513, 513, 2, 2, 64, True, 0, 0.0, torch.float16),
    ]
    for b, s, t, kh, g, dh, causal, window, cap, dt in cases:
        q, k, v = _attention_inputs(rng, b, s, t, kh, g, dh, dt)
        kw = dict(scale=dh ** -0.5, causal=causal, window=window, softcap=cap)
        got = ops.flash_attention_gqa(q, k, v, **kw)
        torch.cuda.synchronize()
        want = flash_attention_torch(q, k, v, **kw)
        assert got.dtype == dt and got.shape == q.shape
        if dt == torch.float32:
            rtol, atol = 2e-5, 2e-5
        else:
            rtol, atol = (2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -10), 1e-4
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        n += 1
    assert fa.launches() == n
    q, k, v = _attention_inputs(rng, 1, 64, 64, 2, 2, 48, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention_gqa(q, k, v, scale=1.0)
    assert fa.launches() == n  # a refused call launches nothing


@pytest.mark.gpu
def test_embedding_bag_kernel_on_card():
    """B10 against its plain version at 2e-3 (the reference's bag
    tolerance): fp32/bf16/fp16 tables, D = 18 and odd widths (every load
    width), sum and mean, all-masked bags, B not a multiple of 8, ids out
    of range (NaN, as in the reference's oracle)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from repro_torch.kernels import embedding_bag as eb

    rng = np.random.default_rng(7)
    eb.reset_launches()
    n = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for nrows, d, b, l in [(1000, 18, 13, 100), (64, 16, 16, 4),
                               (300, 7, 5, 33), (50, 130, 9, 3)]:
            table = torch.from_numpy(rng.normal(size=(nrows, d)).astype(
                np.float32)).to("cuda", dtype)
            ids = torch.from_numpy(rng.integers(0, nrows, size=(b, l)).astype(
                np.int32)).cuda()
            mask = torch.from_numpy(rng.random((b, l)) < 0.7).cuda()
            mask[0] = False
            for mode in ("sum", "mean"):
                got = ops.embedding_bag(table, ids, mask, mode=mode)
                torch.cuda.synchronize()
                want = eb.embedding_bag_ref(table, ids, mask, mode=mode)
                assert got.dtype == torch.float32 and got.shape == (b, d)
                torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
                assert not got[0].any()
                n += 1
    ids[1, 0] = nrows + 3
    got = ops.embedding_bag(table, ids, mask)
    assert torch.isnan(got[1]).all() and not torch.isnan(got[2]).any()
    assert eb.launches() == n + 1


@pytest.mark.gpu
def test_segment_sum_sorted_kernel_on_card():
    """B9 against its plain version at 1e-5 (the reference's kernel
    tolerance; fp32 sums whose order the atomics change): every load width
    (D = 1, 3, 64, 100, 128), E in {0, 1, 777}, a padding tail of id N,
    negative and unsorted ids, int64 ids, trailing dims, segments over
    many runs (values on a 2^-10 grid there, so that every order of the
    sum is exact and the plain version's own atomics cannot blur the
    check); float64 values raise before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from repro_torch.kernels import segment_sum_sorted as ss

    rng = np.random.default_rng(8)
    ss.reset_launches()
    n_calls = 0
    for e, d, n, kind in [(512, 16, 64, "sorted"), (1024, 64, 200, "sorted"),
                          (777, 1, 50, "padded"), (777, 3, 50, "negative"),
                          (777, 100, 50, "unsorted"), (1, 128, 4, "sorted"),
                          (0, 64, 10, "sorted"), (100_000, 64, 3, "sorted")]:
        seg = np.sort(rng.integers(0, n, size=e))
        if kind == "padded":
            seg[-e // 4:] = n
        elif kind == "negative":
            seg[: e // 3] = -1
        elif kind == "unsorted":
            seg = rng.permutation(seg)
        vals = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
        if e > 1000:
            vals = torch.round(vals * 1024) / 1024
        for ids in (seg.astype(np.int32), seg.astype(np.int64)):
            v, s = vals.cuda(), torch.from_numpy(ids).cuda()
            got = ops.segment_sum_sorted(v, s, num_segments=n)
            torch.cuda.synchronize()
            want = ss.segment_sum_sorted_ref(v, s, num_segments=n)
            assert got.dtype == torch.float32 and got.shape == (n, d)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            n_calls += e > 0
    v3 = torch.randn(300, 8, 8, device="cuda")
    s3 = torch.sort(torch.randint(0, 20, (300,), device="cuda")).values
    torch.testing.assert_close(
        ops.segment_sum_sorted(v3, s3, num_segments=20),
        ss.segment_sum_sorted_ref(v3, s3, num_segments=20),
        rtol=1e-5, atol=1e-5)
    assert ss.launches() == n_calls + 1
    with pytest.raises(TypeError, match="float32"):
        ops.segment_sum_sorted(v3.double(), s3, num_segments=20)
    assert ss.launches() == n_calls + 1  # a refused call launches nothing
