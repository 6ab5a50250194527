"""``device_idle_share``: 1 - the union of the device's activity over the
traced window (profiler trace)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
