"""Step factories of the port (the serving steps so far)."""
from . import train_loop  # noqa: F401
