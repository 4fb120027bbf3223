"""RealEngine: token generation through the KV block pool, on the card.

Twin of ``repro/serving/real_runner.py``. For each prompt:

  match: the prompt's full blocks are looked up in the prefix index;
  hit  : the hit blocks are scatter-read (``kv_scatter_read`` kernel) from
         the pool straight into a decode cache, prefill is SKIPPED, and only
         the tail tokens are stepped through decode (a fully covered prompt
         re-feeds its last token to get logits);
  miss : prefill (flash-attention kernel), gather-write the per-layer KV
         into pool blocks (``kv_gather_write`` kernel), then bump the
         blocks' epochs and publish them in the index;
  then : greedy decode.

``create`` takes an arch name or a ``ModelConfig``, so the same code runs a
reduced config in the tests and full width on the card. It serves any
period-1 attention stack, MoE FFNs included (arctic, llama4-maverick), as
the JAX engine does; a hybrid or SSM stack is refused. The kernels run for
tensors on the card and their plain versions on the CPU (``kernels/ops.py``
mode "auto"; ``kernel_mode="ref"`` runs the plain versions on the card).
Unlike the JAX
engine, ``max_len`` must be a multiple of the block size, and ``info``
also carries the per-step logits and the final decode cache, which the
parity checks read.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RuntimeConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.index import PrefixIndex
from repro_torch.core.pool import KVBlockLayout, KVBlockPool
from repro_torch.kernels import ops
from repro_torch.models.model import Model, init_params, torch_dtype
from repro_torch.models.transformer import layer_kinds

BLOCK_TOKENS = 16


@dataclass
class RealEngine:
    cfg: ModelConfig
    model: Model
    pool: KVBlockPool
    index: PrefixIndex
    params: dict
    max_len: int
    device: torch.device
    kernel_mode: str = "auto"

    @classmethod
    def create(
        cls,
        arch: str | ModelConfig = "olmo-1b",
        max_len: int = 128,
        pool_blocks: int = 256,
        seed: int = 0,
        device: str | torch.device | None = None,
        params: dict | None = None,
        kernel_mode: str = "auto",
        moe_dispatch: str = "einsum",
        runtime: RuntimeConfig | None = None,
    ) -> "RealEngine":
        """``params`` (e.g. converted from JAX) replaces the seeded init;
        ``moe_dispatch`` is ``RuntimeConfig.moe_dispatch`` (``models/moe.py``).
        ``runtime``, if given, supplies both instead of the keywords.

        Refused, with a ``ValueError`` that names the cause: a stub frontend
        (the engine's prompts are tokens; JAX's engine fails there at its
        first prefill, with a ``KeyError`` for ``frame_embeds`` or
        ``patch_embeds``) and ``use_fp8_kv`` (the JAX engine fixes its
        runtime without it, ``repro/serving/real_runner.py:59-61``; serving
        an fp8 cache through the pool would be a feature JAX lacks). Run
        either through ``models.model.Model``."""
        cfg = get_config(arch) if isinstance(arch, str) else arch
        if runtime is not None:
            kernel_mode, moe_dispatch = runtime.kernel_mode, runtime.moe_dispatch
        if cfg.frontend != "none":
            raise ValueError(f"{cfg.name}: RealEngine serves token prompts; frontend "
                             f"{cfg.frontend!r} runs through models.model.Model")
        if runtime is not None and runtime.use_fp8_kv:
            raise ValueError(f"{cfg.name}: RealEngine serves the model dtype's cache, not "
                             "use_fp8_kv (as the JAX engine); run an fp8 cache through "
                             "models.model.Model")
        kinds = layer_kinds(cfg)
        if len(kinds) != 1 or kinds[0].mixer != "attn":
            # JAX asserts the same (repro/serving/real_runner.py:56): the pool
            # holds per-layer KV blocks, which an SSM layer does not have
            raise ValueError(
                f"{cfg.name}: RealEngine serves period-1 attention stacks only "
                f"(layer kinds {[(k.mixer, k.ffn) for k in kinds]}); run an SSM "
                "or hybrid stack through models.model.Model"
            )
        dev = resolve_device(device)
        if max_len % BLOCK_TOKENS:
            raise ValueError(f"max_len {max_len} is not a multiple of {BLOCK_TOKENS}")
        model = Model(cfg, kernel_mode, moe_dispatch)
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = init_params(cfg, gen, dev)
        pool = KVBlockPool(
            KVBlockLayout.for_model(cfg, BLOCK_TOKENS), pool_blocks, dev
        )
        return cls(
            cfg=cfg, model=model, pool=pool, index=PrefixIndex(pool), params=params,
            max_len=max_len, device=dev, kernel_mode=kernel_mode,
        )

    # ------------------------------------------------------------------
    def generate(self, prompt: list[int], max_new: int = 16,
                 feed: list[int] | None = None) -> tuple[list[int], dict]:
        """-> (tokens, info): info has hit_tokens, ttft_s, total_s, the
        per-step logits (n_out, V) f32 and the final cache ``kv``. With
        ``feed``, decode step i is fed feed[i] in place of the greedy token
        before it, so the logits score that continuation (tokens still holds
        each step's argmax)."""
        if not 0 < len(prompt) <= self.max_len:
            raise ValueError(f"prompt of {len(prompt)} tokens, max_len {self.max_len}")
        t_start = time.perf_counter()
        hits = self.index.match_prefix(prompt)
        n_hit = len(hits) * self.pool.layout.block_tokens
        if n_hit:
            cache = self.fetch([b for _, b, _ in hits])
            # step the tail through decode; a fully covered prompt re-feeds
            # its last token (same KV written again, yields logits)
            for t in range(min(n_hit, len(prompt) - 1), len(prompt)):
                logits = self._decode(cache, prompt[t], t)
        else:
            logits, cache = self.prefill(prompt)
            self.writeback(prompt, cache)
        steps = [logits]
        out = [int(logits.argmax())]
        ttft = time.perf_counter() - t_start
        pos = len(prompt)
        while len(out) < max_new and pos + 1 < self.max_len:
            logits = self._decode(cache, out[-1] if feed is None else feed[len(out) - 1], pos)
            steps.append(logits)
            out.append(int(logits.argmax()))
            pos += 1
        info = {
            "hit_tokens": n_hit,
            "ttft_s": ttft,
            "total_s": time.perf_counter() - t_start,
            "logits": torch.stack(steps),
            "kv": cache,
        }
        return out, info

    # ------------------------------------------------------------------
    def prefill(self, prompt: list[int]):
        """-> (last-position logits (V,), (k, v) caches (L, 1, max_len, hkv, hd))."""
        tokens = torch.tensor([prompt], dtype=torch.long, device=self.device)
        logits, cache = self.model.prefill_fn(self.params, tokens, max_len=self.max_len)
        return logits[0, 0], cache

    def _decode(self, cache, token: int, pos: int) -> torch.Tensor:
        tokens = torch.tensor([token], dtype=torch.long, device=self.device)
        positions = torch.tensor([pos], dtype=torch.long, device=self.device)
        return self.model.decode_fn(self.params, cache, tokens, positions)[0]

    def fetch(self, block_ids: list[int]):
        """Pool blocks -> a fresh decode cache holding them in slots 0..n-1."""
        blocks = self.pool.data[torch.tensor(block_ids, device=self.device)]
        n_slots = self.max_len // self.pool.layout.block_tokens
        k, v = ops.kv_scatter_read(blocks, list(range(len(block_ids))), n_slots,
                                   mode=self.kernel_mode)
        dtype = torch_dtype(self.cfg.dtype)
        return k.to(dtype)[:, None], v.to(dtype)[:, None]

    def writeback(self, prompt: list[int], cache) -> None:
        """Pack the prompt's full blocks into the pool, then publish them."""
        bt = self.pool.layout.block_tokens
        n_blocks = len(prompt) // bt
        if not n_blocks:
            return
        k, v = cache[0][:, 0], cache[1][:, 0]  # (L, max_len, hkv, hd)
        blocks = ops.kv_gather_write(k, v, list(range(n_blocks)), bt, mode=self.kernel_mode)
        block_ids = self.pool.allocate(n_blocks)
        self.pool.data[torch.tensor(block_ids, device=self.device)] = blocks.to(
            self.pool.data.dtype
        )
        keys = self.index.keys_for(prompt)
        # commit AFTER the payload write (§5.1): one epoch bump, one publish
        epochs = self.pool.write_blocks(block_ids)
        self.index.publish_many(list(keys[:n_blocks]), block_ids, epochs, bt)
