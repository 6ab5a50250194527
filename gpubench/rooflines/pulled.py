"""What the compiled pull schedule lands in an epoch, from its arrays alone
(the yardstick's own count, not the program's index maps)."""
import numpy as np


def landed_ids(prob) -> int:
    """Ids of the valid prefixes of every row that a serve slot pulls, over
    all rounds and ranks (a phantom slot, index ``n_loc``, pulls none)."""
    p, n_loc = prob.p, prob.n_loc
    deg = np.zeros((p, n_loc + 1), np.int64)
    deg[:, :n_loc] = prob.degrees
    return int(deg[np.arange(p)[:, None, None, None], prob.serve_idx].sum())
