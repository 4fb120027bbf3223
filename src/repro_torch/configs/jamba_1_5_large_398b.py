"""jamba-1.5-large-398b - exact assigned config.

[hybrid] 72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2 - Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887; hf]

The registry (``repro_torch.configs.registry.JAMBA_1_5_LARGE``) holds it;
this module exports it as ``CONFIG``, with its reduced smoke config, for the
``--arch jamba-1.5-large-398b`` selector (twin of
``repro/configs/jamba_1_5_large_398b.py``).
"""

from repro_torch.configs.registry import JAMBA_1_5_LARGE as CONFIG  # noqa: F401
from repro_torch.configs.registry import reduced_config

SMOKE_CONFIG = reduced_config("jamba-1.5-large-398b")
