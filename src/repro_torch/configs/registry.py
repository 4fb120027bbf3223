"""Architecture registry: ``--arch <id>`` -> ModelConfig (the port's own copy).

Assigned architectures (10) + the paper's own evaluation model (qwen3-32b).
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

# ---------------------------------------------------------------------------
# Assigned architectures (exact configs from the assignment block).
# ---------------------------------------------------------------------------

JAMBA_1_5_LARGE = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(n_experts=16, top_k=2, layer_period=2),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1),
    attn_period=8,  # 1 attention : 7 mamba per 8-layer period
    source="arXiv:2403.19887; hf",
)

LLAMA4_MAVERICK = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    moe=MoEConfig(n_experts=128, top_k=1, layer_period=1),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)

ARCTIC_480B = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe=MoEConfig(
        n_experts=128,
        top_k=2,
        layer_period=1,
        dense_residual=True,
        dense_residual_ff=4864,
    ),
    source="hf:Snowflake/snowflake-arctic-base; hf",
)

MUSICGEN_LARGE = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio_stub",
    n_frontend_tokens=0,  # EnCodec frame embeddings replace token embeddings
    act="gelu",
    source="arXiv:2306.05284; hf",
)

MAMBA2_2_7B = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    d_head=64,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1),
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)

INTERNLM2_1_8B = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    source="arXiv:2403.17297; hf",
)

OLMO_1B = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    nonparametric_ln=True,
    tie_embeddings=True,
    source="arXiv:2402.00838; hf",
)

QWEN1_5_0_5B = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)

COMMAND_R_35B = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)

INTERNVL2_26B = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    frontend="vision_stub",
    n_frontend_tokens=256,  # precomputed InternViT patch embeddings (stub)
    source="arXiv:2404.16821; hf",
)

# The paper's own evaluation model (Qwen3-32B, GQA: 64L x 2 = 128 fragments
# per KV block — the layout used throughout Beluga's transfer experiments).
QWEN3_32B = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    source="arXiv:2505.09388 (paper's eval model)",
)

# Llama-3.1-8B: used by the paper's transfer benchmarks (64 fragments).
LLAMA31_8B = ModelConfig(
    name="llama3.1-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    source="arXiv:2407.21783 (paper's transfer bench)",
)

ASSIGNED: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        JAMBA_1_5_LARGE,
        LLAMA4_MAVERICK,
        ARCTIC_480B,
        MUSICGEN_LARGE,
        MAMBA2_2_7B,
        INTERNLM2_1_8B,
        OLMO_1B,
        QWEN1_5_0_5B,
        COMMAND_R_35B,
        INTERNVL2_26B,
    ]
}

EXTRA: dict[str, ModelConfig] = {c.name: c for c in [QWEN3_32B, LLAMA31_8B]}

REGISTRY: dict[str, ModelConfig] = {**ASSIGNED, **EXTRA}


def get_config(name: str) -> ModelConfig:
    key = name.strip().lower()
    if key in REGISTRY:
        return REGISTRY[key]
    alt = key.replace("_", "-")
    if alt in REGISTRY:
        return REGISTRY[alt]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests: same family/topology, tiny dims.
# ---------------------------------------------------------------------------


def reduced_config(name: str) -> ModelConfig:
    import dataclasses

    cfg = get_config(name)
    n_layers = {  # keep topology periods intact
        "hybrid": 8,  # one full Jamba period (7 mamba + 1 attn), MoE alt
        "ssm": 4,
    }.get(cfg.family, 4)
    n_heads = 4 if cfg.n_heads else 0
    kv = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0
    moe = cfg.moe
    if moe.enabled:
        moe = dataclasses.replace(moe, n_experts=4, top_k=min(moe.top_k, 2))
    ssm = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk_size=32)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=kv,
        d_head=16 if cfg.n_heads else 16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        moe=moe,
        ssm=ssm,
        n_frontend_tokens=min(cfg.n_frontend_tokens, 8),
    )
