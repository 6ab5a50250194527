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


def hub_rows(rng, widths, w, sentinel, universe):
    """Sorted rows of the given widths drawn from ``[0, universe)``, padded
    to ``w``: hub rows that share many ids."""
    out = np.full((len(widths), w), sentinel, np.int32)
    for i, k in enumerate(widths):
        out[i, :k] = np.sort(rng.choice(universe, size=int(k), replace=False))
    return out


@pytest.mark.gpu
def test_resident_intersect_kernel_on_card():
    """B3, both variants, with the slot lengths given and
    not given, against its plain version bit for bit: ragged E, zero-width
    query rows, evicted (all-sentinel) slots, S = 1; hub rows (12,000 ids,
    near 9,754, short) in runs of pairs that share slot_a (counted against a
    bitmap of the run's row) and shuffled, with ids below 2^16 and 2^20 (no
    bitmap). Launch counters counted per call; an out-of-range slot raises
    before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from repro_torch.kernels import resident_intersect as ri

    rng = np.random.default_rng(4)
    ri.reset_launches()
    n = {"vs_rows": 0, "vs_slots": 0}

    def t32(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).cuda()

    def held(res_t, sa, rows, sb, sent, orders=(None,)):
        lens_true = (res_t < sent).sum(1, dtype=torch.int32)
        for lens in (None, lens_true):
            want = ri.resident_intersect_ref(
                res_t, t32(sa), None if rows is None else t32(rows),
                slots_b=None if sb is None else t32(sb), lengths=lens,
                sentinel=sent).cpu().numpy()
            for perm in orders:
                idx = slice(None) if perm is None else perm
                got = ri.resident_intersect_counts(
                    res_t, sa[idx], None if rows is None else rows[idx],
                    slots_b=None if sb is None else sb[idx], lengths=lens,
                    sentinel=sent)
                assert got.dtype == np.int64
                assert np.array_equal(got, want[idx]), (
                    res_t.shape, sa.size, perm is None, lens is not None)
                if sa.size:
                    n["vs_rows" if sb is None else "vs_slots"] += 1
                assert ri.launches() == n

    for s, w in [(64, 48), (1, 16), (300, 200)]:
        res = pad_sorted(rng, s, w, SENT)
        res[rng.integers(0, s)] = SENT  # an evicted slot
        res_t = torch.from_numpy(res).cuda()
        for e, wb in [(1, 4), (7, 0), (130, 32), (1000, 200)]:
            sa = rng.integers(0, s, e)
            sb = rng.integers(0, s, e)
            held(res_t, sa, pad_sorted(rng, e, wb, SENT), None, SENT)
            held(res_t, sa, None, sb, SENT)
    # hub rows: 12,000 ids, near 9,754 or short; ids below 2^16 (the kernel
    # counts runs against a bitmap) and below 2^20 (it searches)
    widths = [12_000, 10_240, 10_241] + list(rng.integers(9_000, 9_755, 9))
    widths += list(rng.integers(0, 201, 16)) + [0] * 4
    for sent in (1 << 16, 1 << 20):
        res_t = t32(hub_rows(rng, widths, 12_288, sent, 24_000))
        s = res_t.shape[0]
        sa = np.repeat(rng.integers(0, s, 40), rng.integers(1, 30, 40))[:800]
        sb = rng.integers(0, s, sa.size)
        sb[: sa.size // 2] = rng.integers(0, 12, sa.size // 2)  # hub x hub
        shuffled = rng.permutation(sa.size)
        held(res_t, sa, None, sb, sent, orders=(None, shuffled))
        rows = hub_rows(rng, rng.choice(widths, 256), 12_288, sent, 24_000)
        sa = np.repeat(rng.integers(0, s, 8), 32)
        held(res_t, sa, rows, None, sent, orders=(None, rng.permutation(256)))
    with pytest.raises(ValueError, match="outside"):
        ri.resident_intersect_counts(res_t, np.array([0, s]),
                                     slots_b=np.array([0, 0]), sentinel=sent)
    assert ri.launches() == n


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
    """B8's two kernels against its plain version: fp32 (the FMA kernel) at
    2e-5 (the reference's kernel tolerance; only the summation order
    differs), bf16/fp16 (the wgmma kernel at dh 64 and 128, the FMA kernel
    at dh 256) element by element at one ulp of the output dtype (2^-7 /
    2^-10 relative: both round one fp32 result) plus 1e-4 for the fp32
    summation noise near 0; causal, windows, softcap, non-causal, G in
    {1, 2}, dh in {64, 128, 256}, S that no tile divides, S != T. Each call
    launches the kernel ``variant`` names, and only it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import flash_attention_torch

    rng = np.random.default_rng(6)
    fa.reset_launches()
    n = {"wgmma": 0, "fma": 0}
    cases = [  # (b, s, t, kh, g, dh, causal, window, softcap, dtype)
        (2, 200, 200, 2, 2, 64, True, 0, 0.0, torch.float32),
        (1, 300, 300, 2, 2, 128, True, 64, 50.0, torch.float32),
        (1, 129, 129, 3, 1, 128, False, 0, 0.0, torch.float32),
        (2, 96, 160, 2, 2, 64, False, 40, 30.0, torch.float32),
        (1, 65, 65, 2, 2, 256, True, 16, 50.0, torch.float32),
        (1, 1000, 1000, 4, 2, 128, True, 256, 50.0, torch.bfloat16),
        (1, 513, 513, 2, 2, 64, True, 0, 0.0, torch.float16),
        (1, 65, 65, 2, 2, 256, True, 16, 50.0, torch.bfloat16),
        (2, 96, 160, 2, 2, 64, False, 40, 30.0, torch.bfloat16),
        (1, 200, 350, 2, 1, 128, False, 0, 50.0, torch.float16),
    ]
    cases = [c + (c[5] ** -0.5,) for c in cases]
    # scores of std ~11 against softcap 5: the tanh's ex2 + rcp path
    cases.append((1, 300, 300, 2, 2, 128, True, 64, 5.0, torch.bfloat16, 1.0))
    for causal, window, cap in ((True, 0, 0.0), (True, 0, 50.0),
                                (True, 64, 0.0), (True, 64, 50.0),
                                (False, 0, 0.0)):
        for g in (1, 2):
            for dh in (64, 128):
                cases.append((1, 300, 300, 2, g, dh, causal, window, cap,
                              torch.bfloat16, dh ** -0.5))
    for b, s, t, kh, g, dh, causal, window, cap, dt, scale in cases:
        q, k, v = _attention_inputs(rng, b, s, t, kh, g, dh, dt)
        kw = dict(scale=scale, causal=causal, window=window, softcap=cap)
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
        kind = "wgmma" if dt != torch.float32 and dh in (64, 128) else "fma"
        assert fa.variant(dt, dh) == kind
        n[kind] += 1
        assert fa.launches_by_variant() == n, (b, s, t, dh, dt)
    assert fa.launches() == sum(n.values())
    # rows 136 bytes apart (views of a wider tensor): copied for TMA
    q, k, v = (x[..., :64] for x in _attention_inputs(
        rng, 1, 200, 200, 2, 2, 68, torch.bfloat16))
    kw = dict(scale=0.125, causal=True, window=0, softcap=50.0)
    torch.testing.assert_close(
        ops.flash_attention_gqa(q, k, v, **kw).float(),
        flash_attention_torch(q, k, v, **kw).float(), rtol=2.0 ** -7,
        atol=1e-4)
    n["wgmma"] += 1
    assert fa.launches_by_variant() == n
    q, k, v = _attention_inputs(rng, 1, 64, 64, 2, 2, 48, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention_gqa(q, k, v, scale=1.0)
    assert fa.launches_by_variant() == n  # a refused call launches nothing


@pytest.mark.gpu
def test_embedding_bag_kernel_on_card():
    """B10 against its plain version at 2e-3 (the reference's bag
    tolerance): fp32/bf16/fp16 tables, D = 18 and odd widths (every load
    width, rows wider than a warp, a table at an address only 4-byte
    aligned), sum and mean, int32 and int64 ids, all-masked bags, B not a
    multiple of 8, B = 1 and the served batch's [512, 100] (a bag spread
    over 8 warps), bags longer than one staged tile; ids out of range give
    NaN, masked or not, and so does an Inf row that only masked positions
    touch (as in the reference's oracle). Two calls give the same bits and
    one call is one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from repro_torch.kernels import embedding_bag as eb

    def same(got, want):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        torch.testing.assert_close(torch.nan_to_num(got),
                                   torch.nan_to_num(want), rtol=2e-3,
                                   atol=2e-3)

    rng = np.random.default_rng(7)
    eb.reset_launches()
    n = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for nrows, d, b, l in [(1000, 18, 13, 100), (64, 16, 16, 4),
                               (300, 7, 5, 33), (50, 130, 9, 3),
                               (1000, 18, 512, 100), (1000, 18, 1, 100),
                               (2000, 18, 40, 300), (100, 1, 70, 100)]:
            table = torch.from_numpy(rng.normal(size=(nrows, d)).astype(
                np.float32)).to("cuda", dtype)
            ids = torch.from_numpy(rng.integers(0, nrows, size=(b, l)).astype(
                np.int32)).cuda()
            mask = torch.from_numpy(rng.random((b, l)) < 0.7).cuda()
            mask[0] = False
            for mode in ("sum", "mean"):
                for id_t in (ids, ids.long()):
                    got = ops.embedding_bag(table, id_t, mask, mode=mode)
                    torch.cuda.synchronize()
                    same(got, eb.embedding_bag_ref(table, ids, mask,
                                                   mode=mode))
                    assert not got[0].any()
                    n += 1
    # a table 4-byte aligned only: 4-byte loads of 72-byte rows
    flat = torch.from_numpy(rng.normal(size=1000 * 18 + 1).astype(
        np.float32)).cuda()
    table = flat[1:].view(1000, 18)
    ids = torch.from_numpy(rng.integers(-1000, 1000, size=(37, 100)).astype(
        np.int32)).cuda()
    mask = torch.from_numpy(rng.random((37, 100)) < 0.5).cuda()
    same(ops.embedding_bag(table, ids, mask, mode="mean"),
         eb.embedding_bag_ref(table, ids, mask, mode="mean"))
    n += 1
    # out of range (masked or not) and an Inf row under masked positions
    table = torch.from_numpy(rng.normal(size=(1000, 18)).astype(
        np.float32)).cuda()
    table[5] = float("inf")
    ids = torch.from_numpy(rng.integers(6, 1000, size=(512, 100)).astype(
        np.int32)).cuda()
    mask = torch.from_numpy(rng.random((512, 100)) < 0.5).cuda()
    ids[1, 0], mask[1, 0] = 1000 + 3, True
    ids[2, 7], mask[2, 7] = -1000 - 1, False
    ids[3, 9], mask[3, 9] = 5, False
    for mode in ("sum", "mean"):
        for id_t in (ids, ids.long()):
            got = ops.embedding_bag(table, id_t, mask, mode=mode)
            again = ops.embedding_bag(table, id_t, mask, mode=mode)
            want = eb.embedding_bag_ref(table, ids, mask, mode=mode)
            n += 2
            same(got, want)
            assert torch.isnan(got[1:4]).all()
            assert not torch.isnan(got[4:]).any()
            assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert eb.launches() == n
    ops.embedding_bag(table, ids, mask)
    assert eb.launches() == n + 1


@pytest.mark.gpu
def test_segment_sum_sorted_kernel_on_card():
    """B9 against its plain version at 1e-5 (the reference's kernel
    tolerance; fp32 sums whose order the atomics change): every load width
    (D = 1, 3, 64, 100, 128), E in {0, 1, 777}, a padding tail of id N,
    negative and unsorted ids, int64 ids, trailing dims, segments over
    many runs (values on a 2^-10 grid there, so that every order of the
    sum is exact and the plain version's own atomics cannot blur the
    check); the GNN paths' shapes (MACE's l = 2, 1, 0 paths and readout,
    gat-cora's messages and softmax denominator); the geometry's switches
    just below and above (two lane groups a warp at D = 64, one at 68; one
    row piece at D = 128, two at 132); float64 values raise before any
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from repro_torch.kernels import segment_sum_sorted as ss

    rng = np.random.default_rng(8)
    ss.reset_launches()
    n_calls = 0
    mace = np.sort(np.arange(8_192) // 64 * 30 + rng.integers(0, 30, 8_192))
    for e, d, n, kind in [(512, 16, 64, "sorted"), (1024, 64, 200, "sorted"),
                          (777, 1, 50, "padded"), (777, 3, 50, "negative"),
                          (777, 100, 50, "unsorted"), (1, 128, 4, "sorted"),
                          (0, 64, 10, "sorted"), (100_000, 64, 3, "sorted"),
                          (8_192, 640, 3_840, "mace"),
                          (8_192, 384, 3_840, "mace"),
                          (8_192, 128, 3_840, "mace"),
                          (3_840, 1, 128, "readout"),
                          (10_556, 64, 2_708, "sorted"),
                          (10_556, 8, 2_708, "sorted"),
                          (8_192, 64, 3_840, "sorted"),
                          (8_192, 68, 3_840, "sorted"),
                          (8_192, 128, 3_840, "unsorted"),
                          (8_192, 132, 3_840, "sorted")]:
        seg = np.sort(rng.integers(0, n, size=e))
        if kind == "padded":
            seg[-e // 4:] = n
        elif kind == "negative":
            seg[: e // 3] = -1
        elif kind == "unsorted":
            seg = rng.permutation(seg)
        elif kind == "mace":  # each graph's 64 edges among its 30 nodes
            seg = mace
        elif kind == "readout":  # 30 nodes a graph
            seg = np.arange(e) // 30
        vals = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
        if e > 1000 and n < 100:
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


@pytest.mark.gpu
def test_mace_train_step_on_card():
    """Three launcher steps of MACE's smoke config on the card: the kernel
    route (B9, 23 launches a step: 2 layers x 11 coupling paths + the graph
    readout) against the plain route (B9's plain version) from the same
    parameters, every loss within rel 1e-4 (B9's fp32 summation order
    only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from repro_torch.configs.inputs import make_smoke_batch
    from repro_torch.kernels import segment_sum_sorted as ss
    from repro_torch.launch.train import wire_gnn

    cfg, raw = make_smoke_batch("mace", "gnn_train", np.random.default_rng(0))

    def run():
        params, optim, step, data_fn = wire_gnn("mace", cfg, raw, 0, "cuda")
        state = optim.init(params)
        losses = []
        for s in range(3):
            params, state, m = step(params, state, data_fn(s))
            losses.append(float(m["loss"]))
        return losses

    ss.reset_launches()
    kernel = run()
    assert ss.launches() == 3 * 23
    real = ops.segment_sum_sorted
    ops.segment_sum_sorted = ss.segment_sum_sorted_ref
    try:
        plain = run()
    finally:
        ops.segment_sum_sorted = real
    assert ss.launches() == 3 * 23
    assert all(np.isfinite(kernel))
    np.testing.assert_allclose(kernel, plain, rtol=1e-4, atol=0)


def _card_and_cpu_steps(make_step, params, batches):
    """The same functional train step from the same parameters on the CPU
    and on the card: (CPU losses, card losses, CPU params, card params)."""
    from repro_torch.tree import tree_map

    out = []
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda x: x.to(dev), params)
        step, optim = make_step()
        state = optim.init(p)
        losses = []
        for b in batches:
            p, state, m = step(p, state, {k: torch.as_tensor(v, device=dev)
                                          for k, v in b.items()})
            losses.append(float(m["loss"]))
        out.append((losses, p))
    (l_cpu, p_cpu), (l_card, p_card) = out
    return l_cpu, l_card, p_cpu, p_card


def _assert_leaves_close(p_cpu, p_card, rel):
    from repro_torch.tree import tree_leaves

    for a, b in zip(tree_leaves(p_cpu), tree_leaves(p_card)):
        b = b.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape
        err = float((a - b).norm() / max(float(a.norm()), 1e-30))
        assert err <= rel, err


@pytest.mark.gpu
def test_lm_train_step_on_card_matches_cpu():
    """Three steps of the LM train step (stablelm's smoke config in fp32,
    remat on, 2 microbatches, the launcher's optimizer) on the card and on
    the CPU from the same parameters: losses and parameters to 1e-5
    relative (fp32 GEMMs in another order; TF32 off, asserted)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl

    assert torch.backends.cuda.matmul.allow_tf32 is False
    cfg = dataclasses.replace(get_arch("stablelm-1.6b").smoke_config(),
                              dtype=torch.float32, remat=True)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    stream = TokenStream(cfg.vocab, 4, 64, seed=1)

    def make_step():
        o = opt.adamw(lr=opt.cosine_schedule(3e-4, 2, 3))
        return tl.make_lm_train_step(cfg, o, n_microbatches=2), o

    l_cpu, l_card, p_cpu, p_card = _card_and_cpu_steps(
        make_step, params, [stream.batch_at(i) for i in range(3)])
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-5)
    _assert_leaves_close(p_cpu, p_card, 1e-5)


@pytest.mark.gpu
def test_moe_apply_on_card_matches_cpu():
    """``moe_apply`` at moonshot's smoke sizes (8 experts, top 2, d 64, f
    96) on 256 tokens: in fp32 (TF32 off, asserted) the card's expert ids
    equal the CPU's and its output is within 1e-5 of it (relative L2 and
    element by element against the largest); in bf16 two calls on the card
    give the same bits (the combine adds in slot order, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: no CUDA device found")
    from repro_torch.models import moe
    from repro_torch.tree import tree_map

    assert torch.backends.cuda.matmul.allow_tf32 is False
    e, k, d, f, t = 8, 2, 64, 96, 256
    p = moe.moe_init(torch.Generator().manual_seed(0), d, f, e,
                     torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(t, d)).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        pd = tree_map(lambda v: v.to(dev), p)
        xd = x.to(dev)
        _, ids = moe.moe_route(pd["router"], xd, k)
        out[dev] = (ids.cpu(), moe.moe_apply(pd, xd, n_experts=e,
                                             top_k=k).cpu())
    assert out["cuda"][0].dtype == torch.int32
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    a, b = out["cpu"][1], out["cuda"][1]
    assert float((a - b).norm() / a.norm()) <= 1e-5
    assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
    pb = tree_map(lambda v: v.to("cuda"), p)
    pb = {n: v if n == "router" else v.to(torch.bfloat16)
          for n, v in pb.items()}
    xb = x.to("cuda", torch.bfloat16)
    first = moe.moe_apply(pb, xb, n_experts=e, top_k=k)
    again = moe.moe_apply(pb, xb, n_experts=e, top_k=k)
    assert first.dtype == torch.bfloat16
    assert torch.equal(first.view(torch.int16), again.view(torch.int16))


@pytest.mark.gpu
def test_din_train_step_on_card_matches_cpu():
    """Three steps of the DIN train step (smoke config, the launcher's
    optimizer) on the card and on the CPU from the same parameters:
    losses and parameters to 1e-5 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.recsys import CTRStream
    from repro_torch.models.recsys import din
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl

    assert torch.backends.cuda.matmul.allow_tf32 is False
    cfg = get_arch("din").smoke_config()
    params = din.init_params(cfg, torch.Generator().manual_seed(0))
    stream = CTRStream(cfg.n_items, cfg.n_cats, 128, seq_len=cfg.seq_len,
                       d_profile=cfg.d_profile, seed=2)

    def make_step():
        o = opt.adamw(lr=1e-3, weight_decay=0.0)
        return tl.make_recsys_train_step(din.apply, cfg, o), o

    l_cpu, l_card, p_cpu, p_card = _card_and_cpu_steps(
        make_step, params, [stream.batch_at(i) for i in range(3)])
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-5)
    _assert_leaves_close(p_cpu, p_card, 1e-5)


@pytest.mark.gpu
def test_gat_hub_split_on_card():
    """GAT's smoke batch split into cold and hot streams (6 hub sources)
    on the card: three launcher steps on the kernel route (B9 8 times a
    step: 4 a layer) against the plain route and against the unsplit
    batch, every loss within rel 1e-4 (B9's fp32 summation order only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from hub_split import hub_split_batch
    from repro_torch.configs.inputs import make_smoke_batch
    from repro_torch.kernels import segment_sum_sorted as ss
    from repro_torch.launch.train import wire_gnn

    cfg, raw = make_smoke_batch("gat-cora", "gnn_train",
                                np.random.default_rng(0))
    split = hub_split_batch(raw, 6)

    def run(batch):
        params, optim, step, data_fn = wire_gnn("gat-cora", cfg, batch, 0,
                                                "cuda")
        state = optim.init(params)
        losses = []
        for s in range(3):
            params, state, m = step(params, state, data_fn(s))
            losses.append(float(m["loss"]))
        return losses

    ss.reset_launches()
    kernel = run(split)
    assert ss.launches() == 3 * 8
    unsplit = run(raw)
    assert ss.launches() == 3 * 8 + 3 * 4
    real = ops.segment_sum_sorted
    ops.segment_sum_sorted = ss.segment_sum_sorted_ref
    try:
        plain = run(split)
    finally:
        ops.segment_sum_sorted = real
    assert all(np.isfinite(kernel))
    np.testing.assert_allclose(kernel, plain, rtol=1e-4, atol=0)
    np.testing.assert_allclose(kernel, unsplit, rtol=1e-4, atol=0)


def _hub_problem(p, n_rounds, cache_rows, seed):
    """Five hubs adjacent to every live vertex (hub x hub pairs), random
    edges, 4 isolated vertices; the compiled problem of ``p`` ranks."""
    from repro_torch.core import rma
    from repro_torch.core.cache import build_static_degree_cache
    from repro_torch.core.csr import from_edges

    rng = np.random.default_rng(seed)
    n, live = 600, 596
    edges = [(h, v) for h in (0, 1, 150, 300, 451) for v in range(live)]
    edges += [tuple(e) for e in rng.integers(0, live, size=(3000, 2))]
    g = from_edges(np.array(edges), n, undirected=True)
    cache = (build_static_degree_cache(g.degrees, cache_rows)
             if cache_rows else None)
    return rma.build_sharded_problem(g, p, n_rounds=n_rounds, cache=cache)


@pytest.mark.gpu
def test_epoch_land_and_count_kernels_on_card():
    """B7's two kernels against their plain versions, bit for bit, round by
    round: hub x hub pairs, rows of all three regions, phantom slots that
    point at real rows, n_rounds 1, every method; the phantom row of each
    rank stays 0; one launch of each a round."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from repro_torch.kernels import epoch_count as ec

    ec.reset_launches()
    n_land = n_count = 0
    for p, n_rounds, cache_rows in [(1, 1, 0), (4, 1, 0), (4, 3, 8),
                                    (8, 2, 16)]:
        prob = _hub_problem(p, n_rounds, cache_rows, seed=p)
        phantom = ~prob.edge_mask
        rng = np.random.default_rng(p)
        prob.edge_u[phantom] = rng.integers(0, prob.n_loc, phantom.sum())
        prob.edge_vc[phantom] = rng.integers(0, prob.n_loc, phantom.sum())
        dprob, cprob = prob.to_device("cuda"), prob.to_device("cpu")
        index, cindex = ec.epoch_index(dprob), ec.epoch_index(cprob)
        for r in range(prob.n_rounds):
            land = torch.full((max(1, dprob.land_ids),), -7,
                              dtype=torch.int32, device="cuda")
            ec.epoch_land(dprob, index, r, land)
            n_land += 1
            want_land = ec.epoch_land_ref(cprob, cindex, r, land.cpu().clone())
            assert torch.equal(land.cpu(), want_land), (p, r)
            want = ec.epoch_count_ref(
                cprob, cindex, r, want_land,
                torch.zeros(p * (prob.n_loc + 1), dtype=torch.int32),
                method="bsearch")
            assert int(want.sum()) > 0
            for method in ("bsearch", "pairwise", "hybrid"):
                acc = torch.zeros(p * (prob.n_loc + 1), dtype=torch.int32,
                                  device="cuda")
                ec.epoch_count(dprob, index, r, land, acc, method=method)
                n_count += 1
                torch.cuda.synchronize()
                assert torch.equal(acc.cpu(), want), (p, r, method)
                assert (acc.view(p, -1)[:, prob.n_loc] == 0).all()
    assert ec.launches() == {"epoch_land": n_land, "epoch_count": n_count}


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 4, 8])
def test_epoch_on_card_matches_triangles(p):
    """The engine on the card at R-MAT S10 against ``triangles_per_vertex``
    for every method: one ``epoch_land`` and one ``epoch_count`` a round,
    no B1 launch, and a rounds loop that never synchronises the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from repro_torch.core import async_engine, triangles
    from repro_torch.core.cache import build_static_degree_cache
    from repro_torch.core.partition import partition_1d
    from repro_torch.core.rma import build_sharded_problem
    from repro_torch.graphs.rmat import rmat_graph
    from repro_torch.kernels import epoch_count as ec

    csr = rmat_graph(10, 16, seed=0)
    want = triangles.triangles_per_vertex(csr)
    prob = build_sharded_problem(
        csr, p, n_rounds=6,
        cache=build_static_degree_cache(csr.degrees, 32)).to_device("cuda")
    part = partition_1d(csr.n, p)
    for method in ("bsearch", "pairwise", "hybrid"):
        async_engine._epoch_acc(prob, method)  # build and load first
        torch.cuda.synchronize()
        ec.reset_launches()
        ic.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            acc = async_engine._epoch_acc(prob, method)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert ec.launches() == {"epoch_land": prob.n_rounds,
                                 "epoch_count": prob.n_rounds}
        assert ic.launches() == 0
        t = acc.view(p, -1)[:, : prob.n_loc].cpu().numpy() // 2
        got = np.concatenate([t[k, : part.hi(k) - part.lo(k)]
                              for k in range(p)])
        assert np.array_equal(got, want), method
        t_e, _ = async_engine.lcc_pipelined(prob, "cuda", method=method)
        assert np.array_equal(t_e, t)


@pytest.mark.gpu
@pytest.mark.parametrize("cross_rank", [False, True])
def test_query_service_on_card_matches_plain_route(cross_rank):
    """The query service at R-MAT S10 with the device tier, on the card
    (B1 and B3) against the plain route on the same seed: every answer,
    the stream's state, the provider and residency ledgers and the engine
    counters equal, bit for bit; both B1 and B3 launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from repro_torch.graphs.rmat import rmat_graph
    from repro_torch.kernels import resident_intersect as ri
    from repro_torch.serving import LiveQueryService, read_write_stream

    csr = rmat_graph(10, 16, seed=0)

    def run(use_kernel):
        svc = LiveQueryService(
            csr, p=4, cross_rank=cross_rank, max_batch=64, device_slots=64,
            use_kernel=use_kernel, device="cuda")
        answers = []
        for ev in read_write_stream(lambda: svc.store.degrees, csr.n, 24,
                                    write_frac=0.25, queries_per_event=64,
                                    seed=1):
            if ev.is_update:
                svc.apply_updates(ev.update)
                continue
            for r in svc.scheduler.run(ev.queries):
                ids = None if r.ids is None else r.ids.tolist()
                vals = None if r.values is None else r.values.tolist()
                answers.append((r.query, type(r.value), r.value, ids, vals))
        svc.verify()
        eng = svc.engine
        return {
            "answers": answers, "t": svc.stream.t.tolist(),
            "lcc": svc.stream.lcc.tolist(),
            "stats": [vars(st) for st in svc.runtime.stats],
            "device": vars(svc.runtime.merged_device_stats()),
            "pairs": (eng.n_pairs_raw, eng.n_pairs_total,
                      eng.n_pairs_resident, eng.host_pack_bytes),
        }

    ic.reset_launches()
    ri.reset_launches()
    kernel = run(None)  # the default on a CUDA device: the kernel route
    assert ic.launches() > 0 and ri.launches("vs_rows") > 0
    assert kernel["pairs"][2] > 0
    assert kernel == run(False)


def _spmd_unit(rng, p, h, w, serve_cfg, f_pad, e_cfg, universe=None,
               landed=False, lens_hi=None):
    """A random SPMD unit: the resident buffer ``[p, H, W]`` (pad slot
    last; row lengths up to ``lens_hi``, default W), serve slots ``[p, p,
    S_tot]`` (rows cut to their rung, phantom positions at the pad slot)
    with their valid lengths and the landing's offsets ``[p, f_exact + 1]``
    (the exclusive cumsum of the landed lengths in ``(j, f)`` order), and a
    ``[p, E_tot]`` worklist over ``[rows | fetched]`` whose sub-pairs fit
    their bucket's width, with valid lengths and a mask (phantoms at the
    pad slot, length 0). ``landed``: fetched refs stay below ``f_exact``,
    the rows a landing holds. Returns ``rows, serve_idx, lists, (serve_len,
    land_off)``."""
    universe = universe or SENT
    lens_hi = w if lens_hi is None else lens_hi
    rows = np.full((p, h, w), SENT, np.int32)
    lens = np.zeros((p, h), np.int32)
    for k in range(p):
        for s in range(h - 1):
            n = int(rng.integers(0, lens_hi + 1))
            rows[k, s, :n] = np.sort(rng.choice(universe, n, replace=False))
            lens[k, s] = n
    serve = []
    for s_b, w_b in serve_cfg:
        seg = np.full((p, p, s_b), h - 1, np.int32)
        for k in range(p):
            fits = np.flatnonzero(lens[k, : h - 1] <= w_b)
            for j in range(p):
                m = int(rng.integers(0, s_b + 1))
                if fits.size and m:
                    seg[k, j, :m] = rng.choice(fits, m)
        serve.append(seg)
    serve_idx = np.concatenate(serve, axis=2)
    serve_len = lens[np.arange(p)[:, None, None], serve_idx]
    # the fetched rows' lengths follow the block's layout
    flen = np.zeros((p, f_pad), np.int32)
    for j in range(p):
        base = off = 0
        for s_b, _ in serve_cfg:
            for k in range(p):
                flen[j, base + k * s_b: base + (k + 1) * s_b] = \
                    serve_len[k, j, off: off + s_b]
            base += p * s_b
            off += s_b
    f_exact = p * serve_idx.shape[2]
    ends = np.cumsum(flen[:, :f_exact].reshape(-1)).reshape(p, f_exact)
    land_off = np.zeros((p, f_exact + 1), np.int64)
    land_off[:, 1:] = ends
    if f_exact:
        land_off[1:, 0] = ends[:-1, -1]
    all_len = np.concatenate([lens, flen], axis=1)
    a_idx, b_idx, mask = [], [], []
    for e_b, w_p in e_cfg:
        a = np.full((p, e_b), h - 1, np.int32)
        b = np.full((p, e_b), h - 1, np.int32)
        m = np.zeros((p, e_b), bool)
        for j in range(p):
            ok = np.flatnonzero(all_len[j] <= w_p)
            if landed:
                ok = ok[ok < h + f_exact]
            real = int(rng.integers(0, e_b + 1))
            a[j, :real] = rng.choice(ok, real)
            b[j, :real] = rng.choice(ok, real)
            m[j, :real] = True
        a_idx.append(a)
        b_idx.append(b)
        mask.append(m)
    a_idx, b_idx, mask = (np.concatenate(x, axis=1)
                          for x in (a_idx, b_idx, mask))
    rank = np.arange(p)[:, None]
    a_len = np.where(mask, all_len[rank, a_idx], 0).astype(np.int32)
    b_len = np.where(mask, all_len[rank, b_idx], 0).astype(np.int32)
    return (rows, serve_idx, (a_idx, b_idx, a_len, b_len, mask),
            (serve_len.astype(np.int32), land_off))


@pytest.mark.gpu
def test_spmd_plane_kernels_on_card():
    """B5 (``serve_landing``, ``serve_block``) and B6 (``pair_counts``,
    ``pair_counts_landed``) against their plain versions on the card, bit
    for bit: p 1 and 8, every rung of the ladder, phantom serve and pair
    positions, the widest rung at W, a W that is no multiple of 4 (the
    block kernel's scalar copies), rows of length 0, hub-like rows sharing
    many ids, a unit whose heavy, medium and light classes are all filled,
    an all-phantom worklist; the landing unpacked equals the block, and
    one launch a call (none for a worklist with no real position)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from repro_torch.kernels import spmd_plane as sp

    rng = np.random.default_rng(8)
    cases = [
        (1, 8, 16, [(2, 16)], 4, [(8, 16)], None, None),
        (8, 24, 512, [(4, 16), (2, 64), (2, 256), (1, 512)], 128,
         [(16, 16), (8, 64), (8, 256), (8, 512)], None, None),
        (8, 12, 2048, [(1, 16), (2, 2048)], 32, [(8, 16), (16, 2048)], 3000,
         None),
        (4, 6, 6, [(3, 6)], 16, [(8, 6)], None, None),
        (4, 8, 64, [(2, 16), (2, 64)], 16, [(8, 16), (8, 64)], None, 0),
    ]
    sp.reset_launches()
    expect = dict.fromkeys(sp.launches(), 0)
    for p, h, w, serve_cfg, f_pad, e_cfg, universe, lens_hi in cases:
        for landed in (False, True):
            rows, serve_idx, lists, (serve_len, land_off) = _spmd_unit(
                rng, p, h, w, serve_cfg, f_pad, e_cfg, universe, landed,
                lens_hi)
            # a launch a call; none without a landed id or a real position
            expect["serve_block"] += 1
            expect["pair_counts"] += int(lists[4].any())
            expect["serve_landing"] += landed * int(land_off[-1, -1] > 0)
            expect["pair_counts_landed"] += landed * int(lists[4].any())
            r = torch.from_numpy(rows).cuda()
            s = torch.from_numpy(serve_idx).cuda()
            got = sp.serve_block(r, s, serve_cfg, f_pad, sentinel=SENT)
            torch.cuda.synchronize()
            want = sp.serve_block_ref(r, s, serve_cfg, f_pad, sentinel=SENT)
            assert got.dtype == torch.int32 and torch.equal(got, want), (p, w)
            dl = [torch.from_numpy(x).cuda() for x in lists]
            real = torch.nonzero(dl[4].reshape(-1)).reshape(-1).int()
            want_cnt = sp.pair_counts_ref(r, got, *dl, pair_cfg=e_cfg,
                                          sentinel=SENT)
            assert int(want_cnt[~dl[4]].abs().sum()) == 0
            if not landed:
                cnt = sp.pair_counts(r, got, *dl, pair_cfg=e_cfg,
                                     sentinel=SENT, real=real)
                torch.cuda.synchronize()
                assert cnt.dtype == torch.int32 and torch.equal(cnt, want_cnt)
                continue
            sl = torch.from_numpy(serve_len).cuda()
            lo = torch.from_numpy(land_off).cuda()
            n_ids = int(land_off[-1, -1])
            items = torch.from_numpy(sp.landing_items(
                np.diff(land_off, axis=1))).cuda()
            landing = sp.serve_landing(r, s, sl, lo, serve_cfg, n_ids,
                                       items=items)
            torch.cuda.synchronize()
            assert landing.dtype == torch.int32 and landing.numel() == n_ids
            assert torch.equal(landing, sp.serve_landing_ref(
                r, s, sl, lo, serve_cfg, n_ids))
            assert torch.equal(sp.unpack_landing(landing, lo, w, SENT, f_pad),
                               want)
            cnt = sp.pair_counts_landed(r, landing, lo, *dl, pair_cfg=e_cfg,
                                        sentinel=SENT, real=real)
            blk = sp.pair_counts(r, got, *dl, pair_cfg=e_cfg, sentinel=SENT,
                                 real=real)
            torch.cuda.synchronize()
            assert cnt.dtype == torch.int32 and torch.equal(cnt, want_cnt)
            assert torch.equal(blk, want_cnt)
            assert torch.equal(cnt, sp.pair_counts_landed_ref(
                r, landing, lo, *dl, pair_cfg=e_cfg, sentinel=SENT))
    assert sp.launches() == expect and min(expect.values()) > 0
    # one tile with every class: heavy merges (9,000 ids against 6,000),
    # heavy searches against the same hub row (staged once), medium and
    # light pairs, an empty side and a phantom
    lens = np.array([9000, 6000, 600, 300, 40, 10, 0, 0], np.int32)
    hub = np.sort(rng.choice(1 << 15, 9000, replace=False)).astype(np.int32)
    rows = np.full((1, 8, 9000), 1 << 15, np.int32)
    for s_, n in enumerate(lens):
        rows[0, s_, :n] = np.sort(rng.choice(hub, n, replace=False))
    a = np.array([[0, 0, 3, 2, 4, 4, 5, 1, 6, 7]], np.int32)
    b = np.array([[1, 1, 0, 0, 3, 2, 4, 0, 0, 7]], np.int32)
    m = np.array([[True] * 9 + [False]])
    r = torch.from_numpy(rows).cuda()
    dl = [torch.from_numpy(x).cuda()
          for x in (a, b, np.where(m, lens[a], 0).astype(np.int32),
                    np.where(m, lens[b], 0).astype(np.int32), m)]
    empty = torch.zeros(0, dtype=torch.int32, device="cuda")
    off = torch.zeros((1, 1), dtype=torch.int64, device="cuda")
    cnt = sp.pair_counts_landed(r, empty, off, *dl, pair_cfg=[(10, 9000)],
                                sentinel=1 << 15,
                                real=torch.arange(9, dtype=torch.int32,
                                                  device="cuda"))
    want = np.array([[np.intersect1d(rows[0, x, :lens[x]],
                                     rows[0, y, :lens[y]]).size if mk else 0
                      for x, y, mk in zip(a[0], b[0], m[0])]], np.int32)
    assert cnt.dtype == torch.int32 and np.array_equal(cnt.cpu().numpy(), want)
    assert list(want[0, [0, 2, 3, 7]]) == [6000, 300, 600, 6000]
    # an all-phantom worklist writes zeros and launches nothing
    sp.reset_launches()
    z = torch.zeros((2, 16), dtype=torch.int32, device="cuda")
    r = torch.full((2, 4, 8), SENT, dtype=torch.int32, device="cuda")
    out = sp.pair_counts(r, r, z, z, z, z, z.bool(), pair_cfg=[(16, 8)],
                         sentinel=SENT, real=empty)
    assert torch.equal(out, torch.zeros_like(out))
    out = sp.pair_counts_landed(r, empty, off.expand(2, 1).contiguous(), z,
                                z, z, z, z.bool(), pair_cfg=[(16, 8)],
                                sentinel=SENT, real=empty)
    assert torch.equal(out, torch.zeros_like(out))
    assert sum(sp.launches().values()) == 0
    with pytest.raises(ValueError, match="contiguous"):
        sp.serve_block(r.transpose(1, 2), torch.zeros(
            (2, 2, 2), dtype=torch.int32, device="cuda"), [(2, 4)], 4,
            sentinel=SENT)


def _spmd_service(device, p, hub, pipeline):
    from repro_torch.core.partition import partition_hub
    from repro_torch.graphs.rmat import rmat_graph
    from repro_torch.serving import LiveQueryService, read_write_stream

    csr = rmat_graph(9, 16, seed=0)
    svc = LiveQueryService(
        csr, p=p, cross_rank=True, execution="spmd", pipeline=pipeline,
        partition=partition_hub(csr.degrees, p) if hub else None,
        device_slots=32, device_width=256, device=device)
    answers = []
    for ev in read_write_stream(lambda: svc.store.degrees, csr.n, 16,
                                write_frac=0.25, queries_per_event=48,
                                seed=2):
        if ev.is_update:
            svc.apply_updates(ev.update)
            continue
        for r in svc.scheduler.run(ev.queries):
            ids = None if r.ids is None else r.ids.tolist()
            answers.append((r.query, type(r.value), r.value, ids))
    svc.verify()
    led = svc.engine.spmd.ledger.to_dict()
    for k in ("device_wall_s", "overlap_wait_s"):
        led.pop(k)
    return {"answers": answers, "t": svc.stream.t.tolist(),
            "lcc": svc.stream.lcc.tolist(), "ledger": led,
            "serve_rows": svc.runtime.serve_rows.tolist(),
            "stats": [vars(st) for st in svc.runtime.stats]}


def _spmd_stream(device, p, pipeline):
    from repro_torch.graphs.rmat import rmat_stream
    from repro_torch.streaming import (StreamingCacheCoherence,
                                       StreamingLCCEngine)

    n = 1 << 10
    coh = StreamingCacheCoherence(n, np.zeros(n, np.int64), p=p,
                                  cache_rows=64, device=device)
    eng = StreamingLCCEngine.empty(n, coherence=coh, execution="spmd",
                                   pipeline=pipeline, device=device)
    eng.runtime.enable_device_tier(64, 256)
    out = [vars(eng.apply_batch(b)) for b in rmat_stream(
        10, 16, batch_size=2048, delete_frac=0.2, seed=3)]
    eng.verify()
    led = eng.spmd.ledger.to_dict()
    for k in ("device_wall_s", "overlap_wait_s"):
        led.pop(k)
    return {"batches": out, "t": eng.t.tolist(), "lcc": eng.lcc.tolist(),
            "ledger": led, "shard_pairs": eng.shard_pairs.tolist()}


@pytest.mark.gpu
@pytest.mark.parametrize("hub", [False, True])
def test_spmd_executor_on_card_matches_cpu(hub):
    """The SPMD executor on the card (B5 and B6) against the same run on
    the CPU (their plain versions), p = 8, pipelined: a query service
    (1D and hub partition) and a stream, every answer, the stream state
    and every ledger counter equal; the landed route's kernels launched,
    the block's never."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from repro_torch.kernels import spmd_plane as sp

    sp.reset_launches()
    card = _spmd_service("cuda", 8, hub, True)
    assert sp.launches()["serve_landing"] > 0
    assert sp.launches()["pair_counts_landed"] > 0
    assert sp.launches()["serve_block"] == sp.launches()["pair_counts"] == 0
    assert card == _spmd_service("cpu", 8, hub, True)
    if not hub:
        sp.reset_launches()
        card = _spmd_stream("cuda", 8, True)
        assert sp.launches()["serve_landing"] > 0
        assert sp.launches()["pair_counts_landed"] > 0
        assert card == _spmd_stream("cpu", 8, True)


@pytest.mark.gpu
def test_spmd_dispatch_never_synchronises():
    """``dispatch()`` of real units (a p = 8 stream's) under
    ``torch.cuda.set_sync_debug_mode("error")``: any synchronising call in
    it raises; ``wait()`` then gives the counts the CPU gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    from repro_torch.distributed import spmd_runtime as spmd

    units = []
    real = spmd.SpmdIntersectExecutor.dispatch

    def record(ex, shards, store):
        copies = [spmd.ShardWork(s.rank, s.pair_a.copy(), s.pair_b.copy(),
                                 {v: np.array(r) for v, r in
                                  s.rows_held.items()}, list(s.fetched_ids))
                  for s in shards]
        units.append((copies, {v: np.array(store.row(v))
                               for s in shards for v in s.fetched_ids}))
        return real(ex, shards, store)

    spmd.SpmdIntersectExecutor.dispatch = record
    try:
        _spmd_stream("cpu", 8, False)
    finally:
        spmd.SpmdIntersectExecutor.dispatch = real
    assert len(units) >= 4

    class Rows:
        def __init__(self, rows):
            self.rows = rows

        def row(self, v):
            return self.rows[int(v)]

    from repro_torch.core.partition import partition_1d

    part = partition_1d(1 << 10, 8)
    on_card = spmd.SpmdIntersectExecutor(part, 1 << 10, device="cuda")
    on_cpu = spmd.SpmdIntersectExecutor(part, 1 << 10, device="cpu")
    pending = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for shards, rows in units:
            # the recorded run's coherence fanout is not replayed: drop
            # every mapped row, so each unit patches its rows in place
            on_card.invalidate(None)
            pending.append(on_card.dispatch(shards, Rows(rows)))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for (shards, rows), pend in zip(units, pending):
        got, unit = pend.wait()
        on_cpu.invalidate(None)
        want, ref_unit = on_cpu.run(shards, Rows(rows))
        for g, w in zip(got, want):
            assert g.dtype == np.int64 and np.array_equal(g, w)
        assert unit.to_dict()["bytes_on_wire"] == \
            ref_unit.to_dict()["bytes_on_wire"]
