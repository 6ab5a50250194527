from . import embedding, din  # noqa: F401
