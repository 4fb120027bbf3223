"""Model architecture configs: the port's own copy of ``repro.configs.base``.

``ModelConfig`` (with its MoE and SSM sub-configs, which the registry's
entries fill in) describes an architecture. The port keeps its own copy so
that it imports nothing of ``repro``; it carries the fields of every
registry entry and the methods the port uses, the parameter and cache
byte counts the launch tooling prices cells with among them. ``SHAPES``
are the shape cells (train_4k / prefill_32k / decode_32k / long_500k).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    # 1 = every layer is MoE; 2 = every other layer (alternating), etc.
    layer_period: int = 1
    # Arctic: dense residual MLP in parallel with the expert MLP.
    dense_residual: bool = False
    dense_residual_ff: int = 0
    # Token-dropping capacity factor for the einsum dispatch path.
    capacity_factor: float = 1.25
    # Router softmax over experts; jitter etc. omitted (inference-focused).
    router_dtype: str = "float32"

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) hyperparameters."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # hybrid (Jamba): one attention layer every `attn_period` layers; the rest
    # are Mamba layers. 0 = pure attention stack; n_layers -> pure SSM.
    attn_period: int = 0
    # frontends for audio/vlm: stub providing precomputed embeddings.
    frontend: str = "none"  # none | audio_stub | vision_stub
    n_frontend_tokens: int = 0  # e.g. image patches prepended to the sequence
    qkv_bias: bool = False  # qwen1.5
    attn_out_bias: bool = False
    mlp_bias: bool = False
    nonparametric_ln: bool = False  # olmo
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"  # silu | gelu
    dtype: str = "bfloat16"
    source: str = ""  # where the numbers come from

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_ssm_layers(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def attn_layer_ids(self) -> list[int]:
        """Indices of attention layers in the stack."""
        if self.family == "ssm":
            return []
        if self.attn_period and self.attn_period > 1:
            # Jamba: attention at position (attn_period - 1) of each period.
            return [
                i
                for i in range(self.n_layers)
                if i % self.attn_period == self.attn_period - 1
            ]
        return list(range(self.n_layers))

    def moe_layer_ids(self) -> list[int]:
        if not self.moe.enabled:
            return []
        p = self.moe.layer_period
        return [i for i in range(self.n_layers) if (i % p) == (p - 1)]

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 8, as the JAX tree pads it at tp=1."""
        return self.padded_vocab_tp(1)

    def padded_vocab_tp(self, tp: int) -> int:
        """Vocab rounded up to a multiple of 8 tp (JAX's ``padded_vocab(tp)``):
        the vocab dim is sharded over ``model`` in shards of whole 8s."""
        return _round_up(self.vocab_size, tp * 8)

    def padded_heads(self, tp: int) -> int:
        """Query heads rounded up to a multiple of tp. The padded heads are
        real, randomly drawn heads, as in JAX: a padded model is another
        model."""
        return _round_up(self.n_heads, tp)

    # ---------------- parameter counts (repro/configs/base.py:130-157) ----
    def param_count(self) -> int:
        """True (unpadded) parameter count."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        return _param_count(self, active_only=True)

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KVCache bytes per token across all attention layers."""
        n_attn = len(self.attn_layer_ids())
        return n_attn * 2 * self.n_kv_heads * self.head_dim * dtype_bytes

    def ssm_state_bytes(self, dtype_bytes: int = 4) -> int:
        if not self.has_ssm_layers:
            return 0
        n_ssm = self.n_layers - len(self.attn_layer_ids())
        nh = self.ssm.n_heads(self.d_model)
        conv_dim = self.ssm.d_inner(self.d_model) + 2 * self.ssm.n_groups * self.ssm.d_state
        per_layer = (
            nh * self.ssm.head_dim * self.ssm.d_state  # SSD state
            + conv_dim * (self.ssm.d_conv - 1)  # conv tail
        )
        return n_ssm * per_layer * dtype_bytes


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    """``repro/configs/base.py:160-199``, term for term."""
    d = cfg.d_model
    hd = cfg.head_dim
    attn_ids = set(cfg.attn_layer_ids())
    moe_ids = set(cfg.moe_layer_ids())
    total = cfg.vocab_size * d  # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d  # lm head
    for i in range(cfg.n_layers):
        # mixer
        if i in attn_ids:
            total += d * cfg.n_heads * hd  # q
            total += 2 * d * cfg.n_kv_heads * hd  # k, v
            total += cfg.n_heads * hd * d  # o
        elif cfg.has_ssm_layers:
            ssm = cfg.ssm
            di = ssm.d_inner(d)
            nh = ssm.n_heads(d)
            conv_dim = di + 2 * ssm.n_groups * ssm.d_state
            total += d * (2 * di + 2 * ssm.n_groups * ssm.d_state + nh)  # in_proj
            total += conv_dim * ssm.d_conv  # conv
            total += nh * 2  # A_log, D
            total += di  # dt_bias, counted at d_inner as the reference counts it
            total += di * d  # out_proj
        # mlp
        if i in moe_ids:
            e = cfg.moe.top_k if active_only else cfg.moe.n_experts
            total += e * 3 * d * cfg.d_ff  # gate/up/down per expert
            total += d * cfg.moe.n_experts  # router
            if cfg.moe.dense_residual:
                total += 3 * d * cfg.moe.dense_residual_ff
        else:
            total += 3 * d * cfg.d_ff
        # norms
        if not cfg.nonparametric_ln:
            total += 2 * d
    return total


@dataclass(frozen=True)
class ShapeConfig:
    """A shape cell (``repro/configs/base.py:205-213``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs (ssm/hybrid)
    (``repro/configs/base.py:224-231``)."""
    if shape.name == "long_500k" and model.family not in ("ssm", "hybrid"):
        return False, (
            f"{model.name} is a pure full-attention arch; long_500k requires "
            "sub-quadratic attention (skip recorded in DESIGN.md §5)"
        )
    return True, ""


@dataclass(frozen=True)
class RuntimeConfig:
    """The fields of ``repro.configs.base.RuntimeConfig`` that the port reads
    (``:240-258``): knobs that change execution, not the model's math.
    ``kernel_mode`` takes the port's modes (``kernels/ops.py``: "auto",
    "kernel", "ref") where JAX's are "auto", "pallas" and "jnp"."""

    kernel_mode: str = "auto"
    # checkpoint policy of a training forward, per period of the stack:
    # none | full (recompute everything) | dots (save matmul outputs)
    remat: str = "full"
    # decode KV under a mesh: "pool_interleaved" (the KV sequence spread
    # over `model`, partial attentions merged by log-sum-exp: Beluga O9) or
    # "replicated" (every rank holds the whole sequence); one device ignores it
    decode_kv: str = "pool_interleaved"
    moe_dispatch: str = "einsum"  # einsum | ragged | a2a (ragged on one device)
    # row-parallel products: each rank's partial cast to the activation
    # dtype before the sum over `model` (else the f32 partials are summed)
    rowp_bf16_psum: bool = False
    use_fp8_kv: bool = False  # attention K/V caches in float8_e4m3fn


def describe(cfg: ModelConfig) -> str:
    """One line of a config's shape and parameter counts
    (``repro/configs/base.py:261-274``)."""
    n = cfg.param_count()
    a = cfg.active_param_count()
    parts = [
        f"{cfg.name}: {cfg.family}",
        f"{cfg.n_layers}L d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads}kv",
        f"ff={cfg.d_ff} vocab={cfg.vocab_size}",
        f"params={n/1e9:.1f}B",
    ]
    if cfg.moe.enabled:
        parts.append(
            f"moe={cfg.moe.n_experts}e top{cfg.moe.top_k} active={a/1e9:.1f}B"
        )
    return " ".join(parts)
