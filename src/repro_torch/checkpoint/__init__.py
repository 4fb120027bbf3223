"""Training-state checkpoints in the JAX package's on-disk format (``checkpointer.py``)."""

from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
