"""mamba2-2.7b - exact assigned config.

[ssm] 64L d_model=2560 (attn-free) d_ff=0 vocab=50280, ssm_state=128 - SSD (state-space duality) [arXiv:2405.21060; unverified]

The registry (``repro_torch.configs.registry.MAMBA2_2_7B``) holds it; this
module exports it as ``CONFIG``, with its reduced smoke config, for the
``--arch mamba2-2.7b`` selector (twin of ``repro/configs/mamba2_2_7b.py``).
"""

from repro_torch.configs.registry import MAMBA2_2_7B as CONFIG  # noqa: F401
from repro_torch.configs.registry import reduced_config

SMOKE_CONFIG = reduced_config("mamba2-2.7b")
