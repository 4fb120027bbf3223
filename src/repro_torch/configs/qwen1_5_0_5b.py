"""qwen1.5-0.5b - exact assigned config.

[dense] 24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936 - QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]

The registry (``repro_torch.configs.registry.QWEN1_5_0_5B``) holds it; this
module exports it as ``CONFIG``, with its reduced smoke config, for the
``--arch qwen1.5-0.5b`` selector (twin of
``repro/configs/qwen1_5_0_5b.py``).
"""

from repro_torch.configs.registry import QWEN1_5_0_5B as CONFIG  # noqa: F401
from repro_torch.configs.registry import reduced_config

SMOKE_CONFIG = reduced_config("qwen1.5-0.5b")
