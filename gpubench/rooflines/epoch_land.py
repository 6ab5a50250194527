"""Least bytes of an epoch's ``epoch_land`` launches: every landed id read
once and written once (4 B each way), and for each real serve slot (one
that names a row, ``serve_idx < n_loc``; the schedule pads the lists with
the phantom row ``n_loc``) its row index, landing offset and length read
(4 + 8 + 4 B). Padding is the program's layout and counts nothing."""
import numpy as np

from gpubench.rooflines.pulled import landed_ids


def least_bytes(state):
    prob = state.host_prob
    real = int(np.count_nonzero(prob.serve_idx < prob.n_loc))
    return 8.0 * landed_ids(prob) + 16.0 * real
