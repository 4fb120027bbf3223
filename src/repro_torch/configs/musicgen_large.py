"""musicgen-large - exact assigned config.

[audio] 48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048 - decoder-only over EnCodec tokens [arXiv:2306.05284; hf]

The registry (``repro_torch.configs.registry.MUSICGEN_LARGE``) holds it;
this module exports it as ``CONFIG``, with its reduced smoke config, for the
``--arch musicgen-large`` selector (twin of
``repro/configs/musicgen_large.py``).
"""

from repro_torch.configs.registry import MUSICGEN_LARGE as CONFIG  # noqa: F401
from repro_torch.configs.registry import reduced_config

SMOKE_CONFIG = reduced_config("musicgen-large")
