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
