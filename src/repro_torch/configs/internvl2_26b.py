"""internvl2-26b - exact assigned config.

[vlm] 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 - InternViT + InternLM2 [arXiv:2404.16821; hf]

The registry (``repro_torch.configs.registry.INTERNVL2_26B``) holds it; this
module exports it as ``CONFIG``, with its reduced smoke config, for the
``--arch internvl2-26b`` selector (twin of
``repro/configs/internvl2_26b.py``).
"""

from repro_torch.configs.registry import INTERNVL2_26B as CONFIG  # noqa: F401
from repro_torch.configs.registry import reduced_config

SMOKE_CONFIG = reduced_config("internvl2-26b")
