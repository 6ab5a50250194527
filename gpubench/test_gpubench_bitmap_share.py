"""The reader of the program's count of bitmap-run slots
(``bitmap_slot_share``) on the CPU: it returns the program's own share where
the program has the count and a problem on the device, and nothing where it
does not (as on a program without the count)."""
import types

import pytest

from gpubench import harness
from gpubench.test_gpubench_epoch import small_cell


def reader(name):
    return harness.load_module(harness.HERE / "layer_metrics" / f"{name}.py")


@pytest.mark.parametrize("has_count", [True, False],
                         ids=["program", "no_count"])
@pytest.mark.parametrize("cell_name", ["kron-s18.epoch", "urand-s19.epoch"])
def test_bitmap_slot_share_reads_the_programs_count(monkeypatch, cell_name,
                                                    has_count):
    """``bitmap_slot_share`` reads the program's own count of the slots its
    run table counts by bitmap, and nothing where the program has no such
    count (as on a program before it) or no problem on the device."""
    from repro_torch.kernels import epoch_count

    cell = small_cell(cell_name)
    drv = harness.driver_of(cell.mix)
    state = drv.set_up(cell.config, cell.mix, 2**31 + 13, "cpu",
                       harness.Spans())
    want = epoch_count.count_runs(state.dev_prob).share
    if not has_count:
        monkeypatch.delattr(epoch_count, "bitmap_slot_share")
    got = reader("bitmap_slot_share").read(types.SimpleNamespace(state=state))
    if has_count:
        assert got == want and 0.0 <= got <= 1.0
    else:
        assert got is None
    drv.release(state)
    assert reader("bitmap_slot_share").read(
        types.SimpleNamespace(state=state)) is None
