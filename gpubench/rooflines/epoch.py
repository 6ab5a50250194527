"""Least bytes of one whole LCC epoch, whatever the algorithm: each directed
edge's valid id read once (4 B), the edge list read once (u and v, 4 B each),
and ``t`` and ``lcc`` written once (4 B each a vertex)."""
import numpy as np


def least_bytes(state):
    prob = state.host_prob
    m = int(np.asarray(prob.degrees, np.int64).sum())
    return 12.0 * m + 8.0 * prob.n
