"""arctic-480b - exact assigned config.

[moe] 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2 + dense residual [hf:Snowflake/snowflake-arctic-base; hf]

The registry (``repro_torch.configs.registry.ARCTIC_480B``) holds it; this
module exports it as ``CONFIG``, with its reduced smoke config, for the
``--arch arctic-480b`` selector (twin of ``repro/configs/arctic_480b.py``).
"""

from repro_torch.configs.registry import ARCTIC_480B as CONFIG  # noqa: F401
from repro_torch.configs.registry import reduced_config

SMOKE_CONFIG = reduced_config("arctic-480b")
