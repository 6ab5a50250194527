"""The card's constants for the roofline model and the memory verdicts, the
counterpart of ``repro.launch.mesh``.

The reference's ``HW`` holds one TPU v5e chip of a 256- or 512-chip mesh;
this ``HW`` holds the one NVIDIA H100 that the port runs on. Where a name
of the reference means the same thing here it is kept (``PEAK_FLOPS_BF16``,
``HBM_BW``, ``HBM_BYTES``). Two pieces of the reference have no analogue on
one card and are not ported: ``make_production_mesh`` (a ``(16, 16)`` or
``(2, 16, 16)`` TPU mesh) and ``ICI_BW`` (the bandwidth of a link between
chips): the port carries the rank axis as a leading tensor dimension on one
device, and its all-to-all is a block transpose in HBM.

Rates are NVIDIA's data sheet of the H100 SXM part (dense, no sparsity), at
its 700 W limit; ``HBM_BYTES`` and ``RESERVE_BYTES`` were read on the card
named in ``CARD`` by ``chip_smoke.py``'s phase ``census``, which checks
``HBM_BYTES`` and ``SMS`` against the card on every run and reports the
reserve it finds beside ``RESERVE_BYTES``.
"""
from __future__ import annotations

__all__ = ["HW"]


class HW:
    """One NVIDIA H100 80GB HBM3 (SXM) for the roofline model."""

    # where HBM_BYTES and RESERVE_BYTES were read (nvidia-smi's name and
    # power limit)
    CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
    PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor cores, FLOP/s
    HBM_BW = 3.35e12  # bytes/s
    # the bytes torch.cuda.get_device_properties(0).total_memory reports
    # (the label's "80 GB" less what the card keeps for itself)
    HBM_BYTES = 85_017_493_504
    # bytes of the card outside PyTorch's allocator: the CUDA context,
    # cuBLAS and the kernel libraries' code (total_memory less free memory
    # less memory_reserved), read in chip_smoke.py's phase census, a process
    # that has loaded every kernel library and run the phases before it.
    # cuBLAS's workspace is allocated through the allocator, so it is not
    # in this figure.
    RESERVE_BYTES = 898_433_024
    # fp32 outside the tensor cores, taken as the rate of int32 compares too
    # (an upper bound of it, so a bound from it stays a lower bound)
    INT32_OPS = 67e12
    SMS = 132
    SM_CLOCK_HZ = 1.98e9  # nvidia-smi clocks.max.sm
    # special-function units (exp2, rcp): 16 results a clock per SM
    # (compute capability 9.0's arithmetic throughput table)
    SFU_OPS = 16 * SMS * SM_CLOCK_HZ

    @classmethod
    def usable_bytes(cls) -> int:
        """What PyTorch's allocator of one process can reserve at most."""
        return cls.HBM_BYTES - cls.RESERVE_BYTES
