"""Least bytes of each kernel or step (``least_bytes(state)``), frozen with the
benchmark: a roofline share is these bytes at the card's published memory
rate over the measured time. Bytes only: the compares a pair needs depend on
the algorithm (merge, search or bitmap), so a compare bound would move with a
change of algorithm and not of speed."""
