from . import csr, partition, intersect, triangles, cache, rma, lcc  # noqa: F401
