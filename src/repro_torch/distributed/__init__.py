"""The port's ``distributed/``: fault tolerance for the training loop, the
hub-replication gather (``hub_gather``) and the SPMD data plane
(``spmd_runtime``). The reference's ``sharding`` (mesh ``PartitionSpec``
rules) has no counterpart on one card."""
from . import hub_gather, fault_tolerance, spmd_runtime  # noqa: F401
