"""PyTorch/CUDA port of the Beluga KV-cache serving path (twin of ``repro``).

The package mirrors ``repro``'s layout file for file, but imports nothing of
it: it carries its own configs, KV block pool, prefix index, model and
engine. Kernels on the serving path are hand-written CUDA C++ for Hopper
(``kernels/csrc``), compiled with ``nvcc`` at first use; each has a plain
PyTorch version beside it that runs for tensors that lie on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Importing the package does not import torch: a shard service process
(``core/procserver.py``) runs the metadata plane without it.
"""

from __future__ import annotations


def resolve_device(device: str | torch.device | None) -> torch.device:  # noqa: F821
    """``None`` means the card; without one, raise rather than run on the CPU."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
