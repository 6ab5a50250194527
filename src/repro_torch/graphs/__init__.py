from . import rmat, datasets, sampler  # noqa: F401
