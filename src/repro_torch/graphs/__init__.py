from . import rmat, datasets  # noqa: F401
