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
