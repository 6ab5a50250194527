"""Training and serving steps of the port: step factories, AdamW and
checkpoints."""
from . import train_loop  # noqa: F401
