"""B10 (embedding bag) on the CPU: the plain version against the
reference's Pallas kernel (interpret mode) and its jnp oracle, the launch
geometry the wrapper chooses for the CUDA kernel, and the wrapper on CPU
tensors.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``); what
lays it out (``embedding_bag.geometry``) is Python and is checked here for
every shape class the kernel must take. Tolerance 2e-3: the reference's own
embedding-bag test tolerance (``tests/test_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import ops

BAG_TOL = 2e-3
SMEM_LIMIT = 48 * 1024  # a block's shared memory without the opt-in
N_SM = 132  # an H100 SXM
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def masked_inf_case(seed, n=60, d=18, b=8, l=20):
    """A table whose row 3 is Inf and whose row 4 holds a NaN, each reached
    only from masked positions (bags 2 and 5), and ids in range elsewhere
    that never touch them."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, d)).astype(np.float32)
    table[3] = np.inf
    table[4, 2] = np.nan
    ids = rng.integers(5, n, size=(b, l)).astype(np.int32)
    mask = rng.random((b, l)) < 0.7
    ids[2, 4], mask[2, 4] = 3, False
    ids[5, 0], mask[5, 0] = 4, False
    mask[6] = False  # an all-masked bag
    return table, ids, mask


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_version_matches_reference_under_masked_inf(dtype, mode):
    """A masked position still reads its row, so a masked Inf or NaN row
    gives NaN (0 x Inf) in the reference's Pallas kernel, its oracle and
    the port's plain version alike; every other bag agrees at 2e-3."""
    tt, jt = DTYPES[dtype]
    table, ids, mask = masked_inf_case(11)
    tab_t = torch.from_numpy(table).to(tt)
    tab_j = jnp.asarray(table).astype(jt)
    got = ops.embedding_bag(tab_t, torch.from_numpy(ids),
                            torch.from_numpy(mask), mode=mode).numpy()
    pallas = np.asarray(ref_ops.embedding_bag(
        tab_j, jnp.asarray(ids), jnp.asarray(mask), mode=mode, block_b=4,
        interpret=True))
    oracle = np.asarray(ref_ref.embedding_bag_ref(
        tab_j, jnp.asarray(ids), jnp.asarray(mask), mode=mode))
    nan = np.zeros(got.shape, bool)
    nan[2], nan[5, 2] = True, True  # the Inf row; the NaN element
    for want in (pallas, oracle):
        np.testing.assert_array_equal(np.isnan(want), nan)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_allclose(got[~nan], want[~nan], rtol=BAG_TOL,
                                   atol=BAG_TOL)
    assert not got[6].any()


@pytest.mark.parametrize("b", [1, 13, 512, 262_144])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [1, 7, 16, 18, 130])
def test_geometry_covers_every_chunk_position_and_bag(d, dtype, b):
    """For every bag length and table alignment: each chunk of a
    row is loaded by exactly one lane of each group (over the row's
    pieces), each position of a bag is added by exactly one group, the grid
    covers every bag and no more than one block's worth beyond, and a
    block's shared memory stays under 48 KB (the kernel refuses more)."""
    elem = DTYPES[dtype][0].itemsize
    for l in (0, 1, 100, 300):
        for ptr in (0, elem):
            g = eb.geometry(b, l, d, elem, N_SM, ptr)
            assert (d * elem) % g.vb == 0 and ptr % g.vb == 0
            assert g.ve * elem == g.vb and g.chunks * g.ve == d
            assert 1 <= g.lpr <= 32 and g.lpr * g.gpw <= 32
            assert g.wpb in (1, eb.KWARPS) and g.units * g.wpb == eb.KWARPS
            assert g.tile % 32 == 0 and 32 <= g.tile <= eb.MAX_TILE
            for grp in range(g.gpw):
                seen = [c for piece in range(g.pieces)
                        for lane in range(32)
                        for c in [g.lane(lane, piece)]
                        if c is not None and c[0] == grp]
                assert sorted(c for _, c in seen) == list(range(g.chunks))
            taken = [p for k in range(g.groups) for p in g.positions(k, l)]
            assert sorted(taken) == list(range(l))
            assert g.blocks * g.units >= b > (g.blocks - 1) * g.units
            assert g.smem == g.units * eb.unit_bytes(g.tile, g.groups,
                                                     g.lpr * g.ve)
            assert g.smem % 16 == 0 and g.smem <= SMEM_LIMIT


def test_geometry_of_the_served_and_bulk_batches():
    """D = 18 fp32 (72-byte rows): 8-byte loads, 3 groups of 9 lanes (27 of
    32 lanes load); the served batch (512 bags) spreads each bag over 8
    warps, serve_bulk (262,144) keeps one warp a bag; a lone bag spreads
    too, a short one does not."""
    served = eb.geometry(512, 100, 18, 4, N_SM)
    bulk = eb.geometry(262_144, 100, 18, 4, N_SM)
    for g in (served, bulk):
        assert (g.vb, g.lpr, g.gpw, g.tile) == (8, 9, 3, 128)
        assert g.lpr * g.gpw == 27 and g.unroll == 8
    assert (served.wpb, served.blocks) == (8, 512)
    assert (bulk.wpb, bulk.blocks) == (1, 32_768)
    assert eb.geometry(1, 100, 18, 4, N_SM).wpb == 8
    assert eb.geometry(1, 9, 18, 4, N_SM).wpb == 1


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_wrapper_on_cpu_launches_nothing_and_takes_int64(mode):
    """On CPU tensors the wrapper takes the plain version (no launch), and
    int64 ids give the same bits as int32 ids, with negative and
    out-of-range ids among them."""
    rng = np.random.default_rng(5)
    n, d, b, l = 40, 18, 9, 30
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-n, n, size=(b, l)).astype(np.int32))
    ids[2, 3], ids[4, 0] = n, -n - 1
    mask = torch.from_numpy(rng.random((b, l)) < 0.6)
    eb.reset_launches()
    got32 = ops.embedding_bag(table, ids, mask, mode=mode)
    got64 = ops.embedding_bag(table, ids.long(), mask, mode=mode)
    assert eb.launches() == 0
    assert torch.equal(got32.view(torch.int32), got64.view(torch.int32))
    assert torch.isnan(got32[[2, 4]]).all()
    assert not torch.isnan(got32[[0, 1, 3, 5, 6, 7, 8]]).any()
