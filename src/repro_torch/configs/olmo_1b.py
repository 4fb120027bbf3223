"""olmo-1b - exact assigned config.

[dense] 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304 - non-parametric LN [arXiv:2402.00838; hf]

The registry (``repro_torch.configs.registry.OLMO_1B``) holds it; this
module exports it as ``CONFIG``, with its reduced smoke config, for the
``--arch olmo-1b`` selector (twin of ``repro/configs/olmo_1b.py``).
"""

from repro_torch.configs.registry import OLMO_1B as CONFIG  # noqa: F401
from repro_torch.configs.registry import reduced_config

SMOKE_CONFIG = reduced_config("olmo-1b")
