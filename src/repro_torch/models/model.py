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
zeros, and the SSM's ``A_log`` and ``dt_bias`` rules. Under a device mesh
(``Model(rules=...)``) the same model runs as one rank on its shards
(``param_specs`` carries each leaf's logical axes; ``Model`` says how).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, RuntimeConfig, ShapeConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (ParamSpec, init_tree,
                                              local_shape, tree_map, tree_specs)
from repro_torch.models import transformer as stack_lib
from repro_torch.models.attention import FP8_KV, attn_param_specs
from repro_torch.models.layers import (embed_apply, embed_param_specs, gather_vocab,
                                       mlp_param_specs, norm_apply, norm_param_specs,
                                       sharded_log_softmax_pick, unembed_apply)
from repro_torch.models.mamba import mamba_param_specs
from repro_torch.models.moe import DISPATCHES, moe_param_specs

FRONTENDS = ("none", "audio_stub", "vision_stub")
DECODE_KV = ("pool_interleaved", "replicated")


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def param_specs(cfg: ModelConfig, tp: int = 1) -> dict:
    """Tree of ``ParamSpec`` leaves: JAX's names, logical axes, shapes
    (query heads and vocab padded for ``tp``: ``attn_params(cfg, tp)``,
    ``embed_params(cfg, tp)``) and leaf dtypes: the model's, but float32 for
    the SSM's ``A_log``, ``D`` and ``dt_bias`` and the MoE router. The stack
    has one subtree per position of the period, ``pos_<i>``, each leaf with
    a leading n_periods dimension on the ``layers`` axis
    (``repro/models/transformer.py:77-113``)."""
    dt = torch_dtype(cfg.dtype)
    n = stack_lib.n_periods(cfg)

    def stacked(tree: dict) -> dict:
        return tree_map(lambda p: ParamSpec((n, *p.shape), p.dtype, ("layers", *p.logical_axes),
                                            init=p.init, scale=p.scale), tree)

    def position(kind) -> dict:
        layer = {"ln1": norm_param_specs(cfg, dt)}
        if kind.mixer == "ssm":
            layer["ssm"] = mamba_param_specs(cfg, dt)
        else:
            layer["attn"] = attn_param_specs(cfg, tp, dt)
        if kind.ffn != "none":
            layer["ln2"] = norm_param_specs(cfg, dt)
            if kind.ffn == "moe":
                layer["moe"] = moe_param_specs(cfg, dt)
            else:
                layer["mlp"] = mlp_param_specs(cfg, cfg.d_ff, dt)
        return stacked(layer)

    stack = {f"pos_{i}": position(kind) for i, kind in enumerate(stack_lib.layer_kinds(cfg))}
    return {"embed": embed_param_specs(cfg, tp, dt), "stack": stack,
            "final_ln": norm_param_specs(cfg, dt)}


def param_shapes(cfg: ModelConfig, tp: int = 1) -> dict:
    """``param_specs`` as (shape, init, dtype) leaves, init in {"normal",
    "ones", "zeros", "ssm_a", "ssm_dt"}."""
    return tree_map(lambda p: (p.shape, p.init, p.dtype), param_specs(cfg, tp))


def init_params(cfg: ModelConfig, generator: torch.Generator, device, tp: int = 1) -> dict:
    """Random parameters on ``device``; ``generator`` must live there too.

    Stacked leaves are drawn one layer at a time and stacked expert leaves
    one (layer, expert) at a time, so the f32 draw never holds more than one
    layer of one tensor, or one expert of it (all 128 experts of one Arctic
    layer's tensor would be 17.8 GB of f32). ``ssm_a``: log of uniform [1,
    16]; ``ssm_dt``: the inverse softplus of uniform [1e-3, 1e-1]
    (``repro/distributed/sharding.py:215-220``). ``tp`` pads the tree for a
    mesh of that TP degree (``param_specs``); a rank's ``Model.init`` keeps
    its shards of the same values.
    """
    return init_tree(param_specs(cfg, tp), generator, device)


class Model:
    """Prefill / decode over a parameter tree for one config: a period-1
    stack of attention layers (with MLP or MoE FFNs) or of Mamba-2 layers,
    or a hybrid period (Jamba), with token inputs or a stub frontend.

    ``runtime`` is the port's ``RuntimeConfig``: ``kernel_mode`` (the
    dispatcher's mode, ``kernels/ops.py``), ``moe_dispatch`` (``"einsum"``,
    the default, ``"ragged"`` or ``"a2a"``; on one device ``"a2a"`` runs the
    ragged dispatch, as JAX does without a mesh), ``remat`` (``loss_fn``'s
    checkpoint policy), ``use_fp8_kv``, and under a mesh ``decode_kv`` and
    ``rowp_bf16_psum``. The keywords ``kernel_mode`` and ``moe_dispatch``,
    where given, replace those fields.

    ``rules`` (``distributed.sharding.AxisRules`` over a ``launch.mesh.Mesh``
    of this process's world) runs the model as one rank of that mesh: its
    parameters and caches are this rank's shards (``init``,
    ``convert.params_from_numpy``, ``init_cache``), the batch is sharded
    over ``data`` where the data axes divide it, and every function takes
    and returns global values: the whole batch's tokens in, the whole
    batch's loss and logits (every vocab entry) out; only the caches stay
    sharded. With ``rules=None`` the model is one device's; ``tp`` then
    picks the tp-padded layout of ``param_specs`` (default 1), so that one
    device can hold the tree a mesh of that TP degree shards.
    """

    def __init__(self, cfg: ModelConfig, kernel_mode: str | None = None,
                 moe_dispatch: str | None = None, runtime: RuntimeConfig | None = None,
                 rules=None, tp: int | None = None):
        given = {"kernel_mode": kernel_mode, "moe_dispatch": moe_dispatch}
        runtime = dataclasses.replace(runtime or RuntimeConfig(),
                                      **{k: v for k, v in given.items() if v is not None})
        if cfg.family != "ssm" and cfg.n_heads == 0:
            raise ValueError(f"{cfg.name}: an attention stack without heads")
        if cfg.frontend not in FRONTENDS:
            raise ValueError(f"{cfg.name}: frontend {cfg.frontend!r} not in {FRONTENDS}")
        if runtime.moe_dispatch not in DISPATCHES:
            raise ValueError(f"moe_dispatch {runtime.moe_dispatch!r} not in {DISPATCHES}")
        if runtime.decode_kv not in DECODE_KV:
            raise ValueError(f"decode_kv {runtime.decode_kv!r} not in {DECODE_KV}")
        if rules is not None and tp not in (None, rules.tp):
            raise ValueError(f"tp {tp} under rules of tp {rules.tp}")
        if rules is not None and runtime.rowp_bf16_psum != rules.rowp_bf16:
            rules = dataclasses.replace(rules, rowp_bf16=runtime.rowp_bf16_psum)
        self.cfg = cfg
        self.runtime = runtime
        self.rules = rules
        self.tp = rules.tp if rules is not None else (tp or 1)
        self.kernel_mode = runtime.kernel_mode
        self.moe_dispatch = runtime.moe_dispatch
        self.kinds = stack_lib.layer_kinds(cfg)
        # identity block tables of the dense decode caches, built once per
        # (batch, max_len, device) and checked then, never re-checked per
        # step; every attention position of a hybrid shares its table
        self._block_tables: dict[tuple, torch.Tensor] = {}
        self._pspecs = tree_specs(self.param_specs(), rules) if rules is not None else None

    @property
    def mesh(self):
        return self.rules.mesh if self.rules is not None else None

    # ------------------------------------------------------------------
    def param_specs(self) -> dict:
        return param_specs(self.cfg, self.tp)

    def partition_specs(self) -> dict:
        """Under ``rules``, the PartitionSpec of every parameter leaf (the
        tree of ``param_specs``); None on one device."""
        return self._pspecs

    def init(self, generator: torch.Generator, device) -> dict:
        """Random parameters (``init_params``'s values); under ``rules``
        this rank's shards of them."""
        return init_tree(self.param_specs(), generator, device, self.rules)

    def cache_specs(self, batch: int, max_len: int, kv_axes=("batch", "kv_seq")) -> dict:
        """The decode cache as ParamSpec leaves per position
        (``repro/models/model.py:164-185``)."""
        dtype = torch_dtype(self.cfg.dtype)
        kv_dtype = FP8_KV if self.runtime.use_fp8_kv else dtype
        return stack_lib.cache_specs(self.cfg, batch, max_len, self.tp, kv_axes, kv_dtype,
                                     dtype)

    def kv_axes(self) -> tuple:
        """The logical (batch, seq) axes of this model's attention caches."""
        return ("batch", "kv_seq" if self.runtime.decode_kv == "pool_interleaved" else None)

    # ------------------------------------------------------------------
    # Under a mesh: the batch rows of this rank and the context of a pass
    # ------------------------------------------------------------------
    def _batch_axes(self, b: int) -> tuple:
        """The mesh axes a global batch of b rows is sharded over: the
        rules' batch axes where they divide b, else none (every rank holds
        the whole batch, as JAX replicates a small decode batch)."""
        axes = self.rules.batch_axes
        return axes if b % self.mesh.axis_size(axes) == 0 else ()

    def local_rows(self, t: torch.Tensor, axes: tuple) -> torch.Tensor:
        """This rank's rows of a global batch tensor."""
        if not axes:
            return t
        n = t.shape[0] // self.mesh.axis_size(axes)
        return t[self.mesh.axis_index(axes) * n:][:n]

    def mesh_context(self, b: int):
        """The ``transformer.MeshContext`` of a pass over a global batch of b
        rows. A batch every rank holds leaves its mesh axes to the cache's
        sequence, as ``init_cache`` lays the cache out."""
        batch_axes = self._batch_axes(b)
        kv_b, kv_s = self.kv_axes()
        kv_seq = self.rules.spec((kv_b if batch_axes else None, kv_s))[1]
        layer_specs = {k: tree_map(lambda sp: sp[1:], v) for k, v in self._pspecs["stack"].items()}
        return stack_lib.MeshContext(self.rules, layer_specs, batch_axes,
                                     self.mesh.axes(kv_seq))

    @property
    def _fsdp(self) -> tuple:
        """The mesh axes the embedding's d_model dim is sharded over."""
        return self.mesh.axes(self._pspecs["embed"]["table"][1])

    def _embed_tokens(self, params: dict, tokens: torch.Tensor, axes: tuple) -> torch.Tensor:
        """The global batch's tokens -> this rank's rows' embeddings. Under
        a mesh the lookup runs on the rank's shard of the table (its vocab
        rows, its FSDP columns), summed over ``model``; the columns are
        then gathered: activations move, never the table."""
        if self.rules is None:
            return embed_apply(params["embed"], tokens)
        rows = embed_apply(params["embed"], tokens, self.rules)
        rows = coll.all_gather(rows, rows.dim() - 1, self.mesh, self._fsdp)
        return self.local_rows(rows, axes)

    def _logits(self, params: dict, h: torch.Tensor, axes: tuple, whole_batch: bool):
        """f32 logits of this rank's rows h; under a mesh vocab-sharded, and
        with ``whole_batch`` every row of the batch. With the head's
        d_model dim sharded (FSDP), every rank multiplies the batch's rows'
        columns it holds by its shard of the head and the partials are
        summed over those axes: activations move, never the head."""
        p = params["embed"]
        if self.rules is None:
            return unembed_apply(p, h)
        if self.mesh.axis_size(self._fsdp) == 1:
            logits = unembed_apply(p, h, self.rules)
            return coll.all_gather(logits, 0, self.mesh, axes) if whole_batch else logits
        head = p["head"] if "head" in p else p["table"].T  # (d / fsdp, V / tp)
        x = coll.all_gather(h, 0, self.mesh, axes)
        lo = self.mesh.axis_index(self._fsdp) * head.shape[0]
        part = x[..., lo:lo + head.shape[0]].float() @ head.float()
        logits = coll.all_reduce(part, self.mesh, self._fsdp).to(h.dtype).float()
        return logits if whole_batch else self.local_rows(logits, axes)

    # ------------------------------------------------------------------
    def embed(self, params: dict, batch: dict, axes: tuple = ()) -> tuple[torch.Tensor,
                                                                             torch.Tensor]:
        """(x (b, s, d), positions (b, s)) of a batch (``model.py:64-77``):
        ``frame_embeds`` cast to the model dtype (audio), ``patch_embeds``
        before the text tokens' embeddings (vision), else the tokens'
        embeddings; positions run over the whole sequence. Under ``rules``
        the batch is the global one and x this rank's rows of it (the
        batch sharded over ``axes``)."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        if cfg.frontend == "audio_stub":
            x = self.local_rows(batch["frame_embeds"], axes).to(dtype)
        elif cfg.frontend == "vision_stub":
            x = torch.cat([self.local_rows(batch["patch_embeds"], axes).to(dtype),
                           self._embed_tokens(params, batch["tokens"], axes)], dim=1)
        else:
            x = self._embed_tokens(params, batch["tokens"], axes)
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
        ``training.train_loop`` takes its gradient. Under ``rules`` the
        logits stay vocab-sharded: the log-softmax takes a max and a sum of
        exponentials over ``model``, and the loss is averaged over the
        global batch (a sum over ``data``); every rank returns the same
        loss. Its gradient is taken through the collectives' backwards
        (``distributed/collectives.py``): seeded with 1 / (world size) on
        every rank, the gradient of each parameter shard comes out as this
        rank's partial, and is whole once summed over the mesh axes its spec
        replicates it along (``training.train_loop.value_and_grad`` does
        both)."""
        cfg = self.cfg
        b = next(iter(batch.values())).shape[0]
        ctx = self.mesh_context(b) if self.rules is not None else None
        axes = ctx.batch_axes if ctx is not None else ()
        x, positions = self.embed(params, batch, axes)
        if ctx is not None:
            batch = {k: self.local_rows(v, axes) for k, v in batch.items()}
        aux: list = []
        h = stack_lib.forward_full(params, x, positions, cfg, self.kernel_mode, None,
                                   self.moe_dispatch, aux, remat=self.runtime.remat,
                                   mesh_ctx=ctx)
        h = norm_apply(params["final_ln"], h, cfg)
        logits = self._logits(params, h, axes, whole_batch=False)  # (b, s, V) f32
        if cfg.frontend == "vision_stub":
            logits = logits[:, cfg.n_frontend_tokens:]
        logits = logits[:, :-1]
        targets = batch["labels"][:, 1:].long()
        if ctx is None:
            nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, targets[..., None])[..., 0]
        else:
            lse, picked = sharded_log_softmax_pick(logits, targets, self.rules)
            nll = lse - picked
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = mask[:, 1:].float()
            num, den = (nll * mask).sum(), mask.sum()
        else:
            num, den = nll.sum(), torch.tensor(float(nll.numel()), device=nll.device)
        if ctx is not None:  # the sums over the global batch
            num = coll.all_reduce(num, self.mesh, axes)
            den = coll.all_reduce(den, self.mesh, axes)
        if mask is not None:
            loss = num / torch.clamp(den, min=1.0)
        else:
            loss = nll.mean() if ctx is None else num / den
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
        receives each MoE layer's aux dict (``moe.moe_apply``). Under
        ``rules`` the cache is this rank's shards (``init_cache``)."""
        if isinstance(batch, torch.Tensor):
            batch = {"tokens": batch}
        b = next(iter(batch.values())).shape[0]
        ctx = self.mesh_context(b) if self.rules is not None else None
        axes = ctx.batch_axes if ctx is not None else ()
        x, positions = self.embed(params, batch, axes)
        s = positions.shape[1]
        cache = self.init_cache(b, max_len if max_len is not None else s, x.device)
        h = stack_lib.forward_full(params, x, positions, self.cfg, self.kernel_mode, cache,
                                   self.moe_dispatch, aux, mesh_ctx=ctx)
        h = norm_apply(params["final_ln"], h, self.cfg)
        logits = self._logits(params, h[:, -1:], axes, whole_batch=True)
        return (gather_vocab(logits, self.rules) if ctx else logits), cache

    def decode_fn(self, params: dict, cache, tokens: torch.Tensor, pos: torch.Tensor,
                  aux: list | None = None, kv_shard_axes: tuple = ("model",),
                  kv_batch_axes: tuple = ("data",)):
        """tokens, pos (b,) -> logits (b, V) f32; updates ``cache`` in place.
        Both frontends decode from token embeddings (``model.py:147-150``);
        after a vision prefill ``pos`` counts the patches too. ``aux`` as in
        ``prefill_fn``. Under ``rules`` the cache is this rank's shards:
        ``kv_shard_axes`` and ``kv_batch_axes`` (JAX's names) must be the
        mesh axes its sequence and batch are sharded over here (the
        pool-interleaved layout's ("model",) and the data axes; for a
        replicated cache or a batch every rank holds, the axes that
        apply)."""
        ctx = None
        if self.rules is not None:
            ctx = self.mesh_context(tokens.shape[0])
            attn = any(kind.mixer == "attn" for kind in self.kinds)
            want = (ctx.kv_seq_axes, ctx.batch_axes)
            got = (self.mesh.axes(kv_shard_axes) if attn and ctx.kv_seq_axes else
                   ctx.kv_seq_axes, self.mesh.axes(kv_batch_axes) if ctx.batch_axes else ())
            if got != want:
                raise ValueError(f"kv_shard_axes {kv_shard_axes}, kv_batch_axes "
                                 f"{kv_batch_axes}: this cache is sharded over {want}")
        axes = ctx.batch_axes if ctx is not None else ()
        x = self._embed_tokens(params, tokens[:, None], axes)
        if ctx is not None:
            pos = self.local_rows(pos, axes)
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
                                        self.kernel_mode, table, self.moe_dispatch, aux,
                                        mesh_ctx=ctx)
        h = norm_apply(params["final_ln"], h, self.cfg)
        logits = self._logits(params, h, axes, whole_batch=True)[:, 0]
        return gather_vocab(logits, self.rules) if ctx else logits

    def init_cache(self, batch: int, max_len: int, device):
        """Zeros. Per position, {"k", "v"} (n_periods, b, max_len, hkv, hd)
        in the model dtype, or in ``float8_e4m3fn`` with ``use_fp8_kv``, at
        attention, {"state" (n_periods, b, nh, n, hp) f32, "conv"
        (n_periods, b, d_conv - 1, conv_dim) in the model dtype} at SSM
        positions (``cache_specs``; ``repro/models/transformer.py:116-160``,
        ``model.py:164-168``). A period-1 attention stack returns its
        position's (k, v) pair, a period-1 SSM stack its dict; a hybrid the
        tree {"pos_<i>": ...}. Under ``rules`` each leaf is this rank's
        shard of the layout ``decode_kv`` picks: the kv sequence over
        ``model`` in whole blocks of 16 (``pool_interleaved``: max_len must
        be a multiple of 16 tp) or whole (``replicated``); the batch over
        ``data`` where that divides it; the SSM state by head."""
        specs = self.cache_specs(batch, max_len, self.kv_axes())

        def leaf(spec: ParamSpec, path: str) -> torch.Tensor:
            shape = spec.shape
            if self.rules is not None:
                axes = list(spec.logical_axes)
                if not self._batch_axes(batch):
                    axes[1] = None  # a batch every rank holds
                shape = local_shape(shape, self.rules.spec(tuple(axes)), self.mesh, path)
            return torch.zeros(shape, dtype=spec.dtype, device=device)

        cache = {j: {k: leaf(v, f"{j}/{k}") for k, v in pos.items()} for j, pos in specs.items()}
        if self.rules is not None and self.runtime.decode_kv == "pool_interleaved":
            for j, kind in enumerate(self.kinds):
                s_loc = cache[f"pos_{j}"]["k"].shape[2] if kind.mixer == "attn" else 16
                if s_loc % stack_lib.DECODE_BLOCK_TOKENS:
                    raise ValueError(f"max_len {max_len} over {self.tp} sequence shards is not "
                                     f"whole blocks of {stack_lib.DECODE_BLOCK_TOKENS}")
        if len(self.kinds) > 1:
            return cache
        only = cache["pos_0"]
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
