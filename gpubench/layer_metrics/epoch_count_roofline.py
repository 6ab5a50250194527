"""``epoch_count_roofline``: the least bytes of an epoch's ``epoch_count``
launches (``rooflines/epoch_count.py``) at the card's published memory rate,
over their device time an epoch in the traced window, in percent."""


def read(run):
    return run.kernel_roofline("epoch_count_kernel", "epoch_count")
