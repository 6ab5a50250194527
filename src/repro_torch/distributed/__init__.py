"""Fault tolerance for the port's training loop (the rest of the
reference's ``distributed/`` comes with later slices)."""
