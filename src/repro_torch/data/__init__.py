"""Input streams of the port (host numpy, seeded)."""
from . import recsys  # noqa: F401
