"""llama4-maverick-400b-a17b - exact assigned config.

[moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1 - MoE, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

The registry (``repro_torch.configs.registry.LLAMA4_MAVERICK``) holds it;
this module exports it as ``CONFIG``, with its reduced smoke config, for the
``--arch llama4-maverick-400b-a17b`` selector (twin of
``repro/configs/llama4_maverick_400b_a17b.py``).
"""

from repro_torch.configs.registry import LLAMA4_MAVERICK as CONFIG  # noqa: F401
from repro_torch.configs.registry import reduced_config

SMOKE_CONFIG = reduced_config("llama4-maverick-400b-a17b")
