"""Reference parameters (numpy trees) as the port's tensors."""
from __future__ import annotations

import numpy as np
import torch

from ...tree import tree_map, tree_paths


def from_reference(tree, template):
    """``tree`` (the reference's parameters, numpy leaves) as CPU tensors
    in the same dict/list layout. ``template`` (the port's own init) names
    the leaves, shapes and dtypes to expect; anything else raises."""
    want = {p: (tuple(x.shape), str(x.dtype))
            for p, x in tree_paths(template)}
    got = tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    have = {p: (tuple(x.shape), str(x.dtype)) for p, x in tree_paths(got)}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))
        raise ValueError(f"parameters differ from the config's layout: "
                         f"{diff[:6]}")
    return got
