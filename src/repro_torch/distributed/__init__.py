"""The port's ``distributed/``: fault tolerance for the training loop and the
SPMD data plane (``spmd_runtime``). ``hub_gather`` and ``sharding`` come with
a later slice."""
from . import fault_tolerance, spmd_runtime  # noqa: F401
