"""internlm2-1.8b - exact assigned config.

[dense] 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544 - GQA [arXiv:2403.17297; hf]

The registry (``repro_torch.configs.registry.INTERNLM2_1_8B``) holds it;
this module exports it as ``CONFIG``, with its reduced smoke config, for the
``--arch internlm2-1.8b`` selector (twin of
``repro/configs/internlm2_1_8b.py``).
"""

from repro_torch.configs.registry import INTERNLM2_1_8B as CONFIG  # noqa: F401
from repro_torch.configs.registry import reduced_config

SMOKE_CONFIG = reduced_config("internlm2-1.8b")
