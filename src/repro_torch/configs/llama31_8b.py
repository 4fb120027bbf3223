"""llama3.1-8b - exact assigned config.

paper's transfer-bench model: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256 [arXiv:2407.21783]

The registry (``repro_torch.configs.registry.LLAMA31_8B``) holds it; this
module exports it as ``CONFIG``, with its reduced smoke config, for the
``--arch llama3.1-8b`` selector (twin of ``repro/configs/llama31_8b.py``).
"""

from repro_torch.configs.registry import LLAMA31_8B as CONFIG  # noqa: F401
from repro_torch.configs.registry import reduced_config

SMOKE_CONFIG = reduced_config("llama3.1-8b")
