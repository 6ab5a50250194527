"""``step_p95_ms``: the 95th percentile of the host times of all the window's
steps, in milliseconds (numpy's linear interpolation)."""
import numpy as np


def read(run):
    if not run.step_s:
        return None
    return float(np.percentile(np.asarray(run.step_s), 95)) * 1e3
