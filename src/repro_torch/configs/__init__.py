from .registry import get_arch, ARCHS  # noqa: F401
