"""``cache_hit_share``: of the remote edge slots of the compiled schedule (real
slots whose ``v`` another rank owns), the share served from the replicated
degree cache rather than pulled. Counted from the schedule's combined row
index, so this reader depends on its layout: ``[0, n_loc]`` local,
``[n_loc + 1, n_loc + 1 + C)`` cache, the rest pulled. A program change to
that layout has to bring a reader of its own under a new name."""
import numpy as np


def read(run):
    prob = getattr(run.state, "host_prob", None)
    if prob is None:
        return None
    n_loc, c = prob.n_loc, prob.cache_rows.shape[0]
    vc = prob.edge_vc[prob.edge_mask].astype(np.int64)
    cached = int(np.count_nonzero((vc > n_loc) & (vc < n_loc + 1 + c)))
    remote = int(np.count_nonzero(vc > n_loc))
    return cached / remote if remote else None
