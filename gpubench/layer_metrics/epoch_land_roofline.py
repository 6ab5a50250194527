"""``epoch_land_roofline``: the least bytes of an epoch's ``epoch_land``
launches (``rooflines/epoch_land.py``) at the card's published memory rate,
over their device time an epoch in the traced window, in percent."""


def read(run):
    return run.kernel_roofline("epoch_land_kernel", "epoch_land")
