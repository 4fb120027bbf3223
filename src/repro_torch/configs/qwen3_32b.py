"""qwen3-32b - exact assigned config.

paper's own eval model: 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936 [arXiv:2505.09388]

The registry (``repro_torch.configs.registry.QWEN3_32B``) holds it; this
module exports it as ``CONFIG``, with its reduced smoke config, for the
``--arch qwen3-32b`` selector (twin of ``repro/configs/qwen3_32b.py``).
"""

from repro_torch.configs.registry import QWEN3_32B as CONFIG  # noqa: F401
from repro_torch.configs.registry import reduced_config

SMOKE_CONFIG = reduced_config("qwen3-32b")
