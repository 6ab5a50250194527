"""``epoch_roofline``: the least bytes of one whole epoch
(``rooflines/epoch.py``) at the card's published memory rate, over the
device's busy time an epoch in the traced window (the union of its
activity over the steps completed), in percent. Device time alone: the
profiler's host-side tracing lengthens the traced steps, not the device's
work, and the idle share is ``device_idle_share``'s."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or not run.step_s:
        return None
    nbytes, rate = run.roofline_bytes("epoch"), run.peak("hbm_bytes_per_s")
    if not nbytes or not rate:
        return None
    return 100.0 * nbytes / rate / (t.busy_s / len(run.step_s))
