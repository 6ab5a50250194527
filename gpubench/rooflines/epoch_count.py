"""Least bytes of an epoch's ``epoch_count`` launches: every valid id of the
rows they intersect read once (the local rows, the cache rows and the
landing, 4 B an id), the real edge slots' u, v and mask (4 + 4 + 1 B a
slot; the schedule's padded slots count nothing) and S written once (4 B a
row of ``[p, n_loc + 1]``)."""
import numpy as np

from gpubench.rooflines.pulled import landed_ids


def least_bytes(state):
    prob = state.host_prob
    local = int(np.asarray(prob.degrees, np.int64).sum())
    cache = int(np.count_nonzero(prob.cache_rows < prob.n))
    real = int(np.count_nonzero(prob.edge_mask))
    return (4.0 * (local + cache + landed_ids(prob)) + 9.0 * real
            + 4.0 * prob.p * (prob.n_loc + 1))
