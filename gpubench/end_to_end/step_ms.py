"""``step_ms``: the window's host seconds over the steps completed in it, in
milliseconds (a step: one whole call of the cell's timed entry, its results
on the host)."""


def read(run):
    if not run.step_s:
        return None
    return run.window_s / len(run.step_s) * 1e3
