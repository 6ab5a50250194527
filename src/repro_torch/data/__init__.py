"""Input streams of the port (host numpy, seeded)."""
from . import tokens, recsys  # noqa: F401
