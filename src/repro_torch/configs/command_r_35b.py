"""command-r-35b - exact assigned config.

[dense] 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000 - GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01; unverified]

The registry (``repro_torch.configs.registry.COMMAND_R_35B``) holds it; this
module exports it as ``CONFIG``, with its reduced smoke config, for the
``--arch command-r-35b`` selector (twin of
``repro/configs/command_r_35b.py``).
"""

from repro_torch.configs.registry import COMMAND_R_35B as CONFIG  # noqa: F401
from repro_torch.configs.registry import reduced_config

SMOKE_CONFIG = reduced_config("command-r-35b")
