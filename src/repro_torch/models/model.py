"""Public model API: parameter init, training loss, prefill, decode, cache
construction.

Twin of ``repro/models/model.py`` on one device: attention with MLPs
(llama, olmo, qwen) or with MoE FFNs (arctic, llama4-maverick), Mamba-2
(ssm), the hybrid period of attention, Mamba-2, MLP and MoE positions
(jamba), and the stub frontends, which take precomputed audio frame
embeddings (musicgen) or vision patch embeddings before the text tokens
(internvl2). With ``RuntimeConfig.use_fp8_kv`` the attention caches hold
K and V in ``float8_e4m3fn``. The parameter tree has the JAX
package's names, shapes, layouts and leaf dtypes (``param_shapes``), so
weights converted from a JAX ``Model.init`` tree are used as they are, and
``init_params`` follows the JAX init rules: normal(0, 1) * 0.02 drawn in
f32 and cast (the MoE router stays f32), norms and ``D`` at ones, biases at
zeros, and the SSM's ``A_log`` and ``dt_bias`` rules.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, RuntimeConfig, ShapeConfig
from repro_torch.models import transformer as stack_lib
from repro_torch.models.attention import FP8_KV
from repro_torch.models.layers import embed_apply, mlp_param_shapes, norm_apply, unembed_apply
from repro_torch.models.mamba import mamba_param_shapes, ssm_dims
from repro_torch.models.moe import DISPATCHES, moe_param_shapes

INIT_SCALE = 0.02
FRONTENDS = ("none", "audio_stub", "vision_stub")


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def param_shapes(cfg: ModelConfig) -> dict:
    """Tree of (shape, init, dtype) leaves, init in {"normal", "ones",
    "zeros", "ssm_a", "ssm_dt"}; dtype the model's, but float32 for the
    SSM's ``A_log``, ``D`` and ``dt_bias`` and the MoE router. The stack has
    one subtree per position of the period, ``pos_<i>``, each leaf with a
    leading n_periods dimension (``repro/models/transformer.py:84-108``)."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv, vocab = cfg.n_heads, cfg.n_kv_heads, cfg.padded_vocab
    dt = torch_dtype(cfg.dtype)
    lead = (stack_lib.n_periods(cfg),)

    def norm(*dims):
        return {} if cfg.nonparametric_ln else {"w": ((*dims, d), "ones", dt)}

    def position(kind) -> dict:
        layer = {"ln1": norm(*lead)}
        if kind.mixer == "ssm":
            layer["ssm"] = mamba_param_shapes(cfg, lead, dt)
        else:
            layer["attn"] = {
                "wq": ((*lead, d, hq, hd), "normal", dt),
                "wk": ((*lead, d, hkv * hd), "normal", dt),
                "wv": ((*lead, d, hkv * hd), "normal", dt),
                "wo": ((*lead, hq, hd, d), "normal", dt),
            }
            if cfg.qkv_bias:
                layer["attn"] |= {
                    "bq": ((*lead, hq, hd), "zeros", dt),
                    "bk": ((*lead, hkv * hd), "zeros", dt),
                    "bv": ((*lead, hkv * hd), "zeros", dt),
                }
            if cfg.attn_out_bias:
                layer["attn"]["bo"] = ((*lead, d), "zeros", dt)
        if kind.ffn != "none":
            layer["ln2"] = norm(*lead)
            if kind.ffn == "moe":
                layer["moe"] = moe_param_shapes(cfg, lead, dt)
            else:
                layer["mlp"] = mlp_param_shapes(cfg, cfg.d_ff, lead, dt)
        return layer

    embed = {"table": ((vocab, d), "normal", dt)}
    if not cfg.tie_embeddings:
        embed["head"] = ((d, vocab), "normal", dt)
    stack = {f"pos_{i}": position(kind) for i, kind in enumerate(stack_lib.layer_kinds(cfg))}
    return {"embed": embed, "stack": stack, "final_ln": norm()}


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random parameters on ``device``; ``generator`` must live there too.

    Stacked leaves are drawn one layer at a time and stacked expert leaves
    one (layer, expert) at a time, so the f32 draw never holds more than one
    layer of one tensor, or one expert of it (all 128 experts of one Arctic
    layer's tensor would be 17.8 GB of f32). ``ssm_a``: log of uniform [1,
    16]; ``ssm_dt``: the inverse softplus of uniform [1e-3, 1e-1]
    (``repro/distributed/sharding.py:215-220``).
    """

    def draw(shape, init: str) -> torch.Tensor:
        if init == "normal":
            return torch.randn(shape, generator=generator, dtype=torch.float32,
                               device=device).mul_(INIT_SCALE)
        u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
        if init == "ssm_a":
            return torch.log(u * 15.0 + 1.0)
        if init == "ssm_dt":
            u = u * (1e-1 - 1e-3) + 1e-3
            return u + torch.log(-torch.expm1(-u))
        raise ValueError(init)

    def make(leaf, split: int) -> torch.Tensor:
        shape, init, dtype = leaf
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in out.view(-1, *shape[split:]).unbind(0):
            part.copy_(draw(part.shape, init))
        return out

    def walk(tree: dict, split: int, path: str) -> dict:
        """``split``: the leading dims drawn one index at a time."""
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, max(split, int(k == "stack")), f"{path}/{k}")
            else:
                expert = path.endswith("/moe") and k != "router"
                out[k] = make(v, split + expert)
        return out

    return walk(param_shapes(cfg), 0, "")


class Model:
    """Prefill / decode over a parameter tree for one config: a period-1
    stack of attention layers (with MLP or MoE FFNs) or of Mamba-2 layers,
    or a hybrid period (Jamba), with token inputs or a stub frontend.

    ``runtime`` is the port's ``RuntimeConfig``: ``kernel_mode`` (the
    dispatcher's mode, ``kernels/ops.py``), ``moe_dispatch`` (``"einsum"``,
    the default, ``"ragged"`` or ``"a2a"``; on one device ``"a2a"`` runs the
    ragged dispatch, as JAX does without a mesh), ``remat`` (``loss_fn``'s
    checkpoint policy) and ``use_fp8_kv``. The
    keywords ``kernel_mode`` and ``moe_dispatch``, where given, replace
    those fields.
    """

    def __init__(self, cfg: ModelConfig, kernel_mode: str | None = None,
                 moe_dispatch: str | None = None, runtime: RuntimeConfig | None = None):
        given = {"kernel_mode": kernel_mode, "moe_dispatch": moe_dispatch}
        runtime = dataclasses.replace(runtime or RuntimeConfig(),
                                      **{k: v for k, v in given.items() if v is not None})
        if cfg.family != "ssm" and cfg.n_heads == 0:
            raise ValueError(f"{cfg.name}: an attention stack without heads")
        if cfg.frontend not in FRONTENDS:
            raise ValueError(f"{cfg.name}: frontend {cfg.frontend!r} not in {FRONTENDS}")
        if runtime.moe_dispatch not in DISPATCHES:
            raise ValueError(f"moe_dispatch {runtime.moe_dispatch!r} not in {DISPATCHES}")
        self.cfg = cfg
        self.runtime = runtime
        self.kernel_mode = runtime.kernel_mode
        self.moe_dispatch = runtime.moe_dispatch
        self.kinds = stack_lib.layer_kinds(cfg)
        # identity block tables of the dense decode caches, built once per
        # (batch, max_len, device) and checked then, never re-checked per
        # step; every attention position of a hybrid shares its table
        self._block_tables: dict[tuple, torch.Tensor] = {}

    def embed(self, params: dict, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(x (b, s, d), positions (b, s)) of a batch (``model.py:64-77``):
        ``frame_embeds`` cast to the model dtype (audio), ``patch_embeds``
        before the text tokens' embeddings (vision), else the tokens'
        embeddings; positions run over the whole sequence."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        if cfg.frontend == "audio_stub":
            x = batch["frame_embeds"].to(dtype)
        elif cfg.frontend == "vision_stub":
            x = torch.cat([batch["patch_embeds"].to(dtype),
                           embed_apply(params["embed"], batch["tokens"])], dim=1)
        else:
            x = embed_apply(params["embed"], batch["tokens"])
        b, s = x.shape[:2]
        return x, torch.arange(s, device=x.device).expand(b, s)

    def loss_fn(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """(mean next-token loss, {"lm_loss", "load_balance_loss"}) of a
        batch (``model.py:82-112``): ``labels`` (b, s) and an optional
        ``loss_mask`` (b, s) beside the inputs ``embed`` reads. Logits in
        f32; the vision stub predicts from the text segment only; the loss
        is ``logsumexp`` minus the target's logit, averaged over the shifted
        positions (or over the mask, its sum floored at 1); MoE adds
        0.01 times the load-balance loss summed over layers. Differentiable:
        ``training.train_loop`` takes its gradient."""
        cfg = self.cfg
        x, positions = self.embed(params, batch)
        aux: list = []
        h = stack_lib.forward_full(params, x, positions, cfg, self.kernel_mode, None,
                                   self.moe_dispatch, aux, remat=self.runtime.remat)
        h = norm_apply(params["final_ln"], h, cfg)
        logits = unembed_apply(params["embed"], h)  # (b, s, V) f32
        if cfg.frontend == "vision_stub":
            logits = logits[:, cfg.n_frontend_tokens:]
        logits = logits[:, :-1]
        targets = batch["labels"][:, 1:].long()
        nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, targets[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = mask[:, 1:].float()
            loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        else:
            loss = nll.mean()
        aux_lb = torch.zeros((), dtype=torch.float32, device=loss.device)
        for stats in aux:
            aux_lb = aux_lb + stats["load_balance_loss"]
        out = {"lm_loss": loss, "load_balance_loss": aux_lb}
        if cfg.moe.enabled:
            loss = loss + 0.01 * aux_lb
        return loss, out

    def prefill_fn(self, params: dict, batch, max_len: int | None = None,
                   aux: list | None = None):
        """batch (JAX's dict: ``tokens``, ``frame_embeds``, ``patch_embeds``;
        a bare (b, s) token tensor is read as ``{"tokens": tokens}``) ->
        (last-position logits (b, 1, V) f32, decode cache): the (k, v) pair
        of an attention stack, the SSM dict of an SSM stack, the
        per-position tree of a hybrid (``init_cache``). ``aux``, if given,
        receives each MoE layer's aux dict (``moe.moe_apply``)."""
        if isinstance(batch, torch.Tensor):
            batch = {"tokens": batch}
        x, positions = self.embed(params, batch)
        b, s = positions.shape
        cache = self.init_cache(b, max_len if max_len is not None else s, x.device)
        h = stack_lib.forward_full(params, x, positions, self.cfg, self.kernel_mode, cache,
                                   self.moe_dispatch, aux)
        h = norm_apply(params["final_ln"], h, self.cfg)
        return unembed_apply(params["embed"], h[:, -1:]), cache

    def decode_fn(self, params: dict, cache, tokens: torch.Tensor, pos: torch.Tensor,
                  aux: list | None = None):
        """tokens, pos (b,) -> logits (b, V) f32; updates ``cache`` in place.
        Both frontends decode from token embeddings (``model.py:147-150``);
        after a vision prefill ``pos`` counts the patches too. ``aux`` as in
        ``prefill_fn``."""
        x = embed_apply(params["embed"], tokens[:, None])
        table = None
        attn = [c for c, kind in zip(stack_lib.position_caches(cache, self.kinds), self.kinds)
                if kind.mixer == "attn"]
        if attn:
            kc = attn[0]["k"]
            key = (kc.shape[1], kc.shape[2], kc.device)
            if key not in self._block_tables:
                self._block_tables[key] = stack_lib.identity_block_table(*key)
            table = self._block_tables[key]
        h = stack_lib.decode_step_stack(params, cache, x, pos, self.cfg,
                                        self.kernel_mode, table, self.moe_dispatch, aux)
        h = norm_apply(params["final_ln"], h, self.cfg)
        return unembed_apply(params["embed"], h)[:, 0]

    def init_cache(self, batch: int, max_len: int, device):
        """Zeros. Per position, {"k", "v"} (n_periods, b, max_len, hkv, hd)
        in the model dtype, or in ``float8_e4m3fn`` with ``use_fp8_kv``, at
        attention, {"state" (n_periods, b, nh, n, hp) f32, "conv"
        (n_periods, b, d_conv - 1, conv_dim) in the model dtype} at SSM
        positions (``repro/models/transformer.py:116-160``,
        ``model.py:164-168``). A period-1 attention stack returns its
        position's (k, v) pair, a period-1 SSM stack its dict; a hybrid the
        tree {"pos_<i>": ...}."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        kv_dtype = FP8_KV if self.runtime.use_fp8_kv else dtype
        n = stack_lib.n_periods(cfg)

        def position(kind) -> dict:
            if kind.mixer == "attn":
                shape = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
                return {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
                        "v": torch.zeros(shape, dtype=kv_dtype, device=device)}
            _, nh, conv_dim = ssm_dims(cfg)
            ssm = cfg.ssm
            return {
                "state": torch.zeros((n, batch, nh, ssm.d_state, ssm.head_dim),
                                     dtype=torch.float32, device=device),
                "conv": torch.zeros((n, batch, ssm.d_conv - 1, conv_dim),
                                    dtype=dtype, device=device),
            }

        if len(self.kinds) > 1:
            return {f"pos_{i}": position(kind) for i, kind in enumerate(self.kinds)}
        only = position(self.kinds[0])
        return (only["k"], only["v"]) if self.kinds[0].mixer == "attn" else only

    def input_specs(self, shape: ShapeConfig) -> dict:
        """The inputs of a shape cell as (shape, dtype) pairs, nothing
        allocated (``model.py:186-219``, which gives ShapeDtypeStructs)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32, bf16 = torch.int32, torch.bfloat16
        if shape.kind not in ("train", "prefill"):  # decode
            return {"tokens": ((b,), i32), "pos": ((b,), i32)}
        if cfg.frontend == "audio_stub":
            batch = {"frame_embeds": ((b, s, cfg.d_model), bf16), "labels": ((b, s), i32)}
        elif cfg.frontend == "vision_stub":
            npatch = cfg.n_frontend_tokens
            batch = {"tokens": ((b, s - npatch), i32),
                     "patch_embeds": ((b, npatch, cfg.d_model), bf16),
                     "labels": ((b, s - npatch), i32)}
        else:
            batch = {"tokens": ((b, s), i32), "labels": ((b, s), i32)}
        if shape.kind == "prefill":
            batch.pop("labels")
        return batch
