"""How far the attention backward moves olmo-1b's training step, measured
against an exact backward.

``chip_smoke.py`` phase 13 (i) holds one AdamW step of full-width olmo-1b
on the kernel path against the same step on the plain path
(``kernel_mode="ref"``). Both paths run a bf16 forward through 16 layers, so
their grad norms differ by bf16 roundings compounded through the stack as
well as by the backward. This probe separates the two. For the weights phase
13 draws and the ``SyntheticLM`` batches it reads (0 .. ``--batches`` - 1),
it prints:

* ``train_bwd_probe.batch<i>.<backward>``: the relative grad-norm gap, kernel
  path against plain path, where the kernel path's attention backward is
  each route of ``flash_attention_bwd`` (``--routes``), the plain f32
  version (``plain_f32``) or the float64 backward rounded to bf16 (``f64``);
  the forward is the kernel in every case; the loss gap and the furthest
  gradient leaf's gap (relative to its largest entry) beside it;
* ``train_bwd_probe.layer<l>.<backward>.<grad>``: at layers 0, 7 and 15, on
  batch 0's captured backward inputs, each route's dq, dk and dv against the
  float64 backward of the same inputs: the RMS relative error and the bias
  <a, w> / <w, w> - 1 (``f64_rounded`` is the float64 result rounded once to
  bf16: the error no bf16 backward can go below); beside them the same for
  the backwards of ``EMULATED`` (``emulated_<name>``): the float64 one with
  P and dS rounded to bf16 as the wgmma route rounds them, one that sums in
  bf16, and two planted faults, which place the routes' readings between a
  rounding and a fault;
* ``train_bwd_probe.f32_weights``: the same one-step gaps with float32
  weights (both paths in float32, the kernels' f32 instantiations), the
  floor that bf16 rounding leaves out;
* with ``--steps n``, ``train_bwd_probe.step.<route>``: the median of n
  timed train steps with that backward route forced, routes in turns.

    python -m repro_torch.experiments.train_bwd_probe [--routes cuda_cores,wgmma] \
        [--batches 8] [--steps 8]

Runs on the card only. The float64 backward takes one batch row at a time
(a row's float64 scores and their products are about 2 GB at 16 heads of
2048 tokens).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import math
import statistics
import time
import types

import torch

from repro_torch.configs.base import RuntimeConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.experiments.common import device_name, emit
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models.model import Model, init_params
from repro_torch.training.optimizer import (OptimizerConfig, global_norm, init_opt_state,
                                            tree_leaves)
from repro_torch.training.train_loop import make_train_step, to_device, value_and_grad

ARCH = "olmo-1b"
SEQ, BATCH = 2048, 4  # chip_smoke.py's TRAIN_SEQ, TRAIN_BATCH
LAYERS = (0, 7, 15)
GRADS = ("dq", "dk", "dv")


# Backwards made from the float64 one with one change each (``emulated``),
# which phase 13's per-layer check should place: the wgmma route's rounding,
# a lower-precision backward, and two planted faults.
EMULATED = {
    "pds_bf16": "P and dS rounded to bf16 before the products that take them, "
                "as the wgmma route feeds them to the tensor cores",
    "acc_bf16": "dQ, dK and dV summed in bf16, rounded after each tile of 64",
    "drop_tile": "the last diagonal tile (64 query rows x 64 keys) of every head left out",
    "mask_shift": "the causal mask one key too wide: row i also takes key i + 1",
}
TILE = 64


def flash_attention_bwd_f64(q, k, v, o, lse, do, causal: bool = True, change: str | None = None):
    """(dq, dk, dv) in float64 from the same inputs as
    ``ref.flash_attention_bwd_ref``: P from q, k and the forward's ``lse``,
    D = rowsum(dO * O), every product in float64; ``change`` names an
    entry of ``EMULATED`` to make instead."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qd, kd, vd = (t.double() for t in (q, k, v))
    qg = qd.reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kd) * scale
    if causal:
        pos_q = torch.arange(sq, device=q.device)
        pos_k = torch.arange(skv, device=q.device)
        width = 1 if change == "mask_shift" else 0
        s = s.masked_fill(~(pos_q[:, None] + width >= pos_k[None, :]), -math.inf)
    p = torch.exp(s - lse.double().reshape(b, hkv, g, sq, 1))
    del s
    if change == "drop_tile":
        p[..., -TILE:, max(0, sq - TILE):sq] = 0
    dog = do.double().reshape(b, sq, hkv, g, d)
    delta = (dog * o.double().reshape(b, sq, hkv, g, d)).sum(-1)  # (b, sq, hkv, g)
    ds = torch.einsum("bqhgd,bkhd->bhgqk", dog, vd)
    ds.sub_(delta.permute(0, 2, 3, 1)[..., None]).mul_(p)
    if change == "pds_bf16":
        p, ds = (t.to(torch.bfloat16).double() for t in (p, ds))
    if change == "acc_bf16":
        return _bf16_sums(p, ds, qg, kd, dog, scale, (b, sq, hq, d))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kd) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    return dq.reshape(b, sq, hq, d), dk, dv


def _bf16_sums(p, ds, qg, kd, dog, scale, q_shape):
    """dq, dk, dv with each running sum rounded to bf16 after every TILE
    rows (dk, dv) or keys (dq) it takes in."""
    def acc(parts):
        total = None
        for part in parts:
            total = part if total is None else total + part
            total = total.to(torch.bfloat16).double()
        return total

    sq, skv = p.shape[-2], p.shape[-1]
    dv = acc(torch.einsum("bhgqk,bqhgd->bkhd", p[..., i:i + TILE, :], dog[:, i:i + TILE])
             for i in range(0, sq, TILE))
    dk = acc(torch.einsum("bhgqk,bqhgd->bkhd", ds[..., i:i + TILE, :], qg[:, i:i + TILE]) * scale
             for i in range(0, sq, TILE))
    dq = acc(torch.einsum("bhgqk,bkhd->bqhgd", ds[..., j:j + TILE], kd[:, j:j + TILE]) * scale
             for j in range(0, skv, TILE))
    return dq.reshape(q_shape), dk, dv


def f64_by_row(q, k, v, o, lse, do, causal: bool = True, change: str | None = None):
    """``flash_attention_bwd_f64`` one batch row at a time, float64."""
    rows = [flash_attention_bwd_f64(*(t[i:i + 1] for t in (q, k, v, o, lse, do)), causal, change)
            for i in range(q.shape[0])]
    return tuple(torch.cat(parts) for parts in zip(*rows))


def f64_rounded(q, k, v, o, lse, do, causal: bool = True):
    """The float64 backward rounded once to the inputs' dtype: a backward
    whose only error is the rounding of its outputs."""
    return tuple(g.to(q.dtype) for g in f64_by_row(q, k, v, o, lse, do, causal))


def emulated(change: str):
    """The backward ``change`` (an ``EMULATED`` name) by batch row, rounded
    to the inputs' dtype, with ``flash_attention_bwd``'s signature."""
    def bwd(q, k, v, o, lse, do, causal=True):
        return tuple(g.to(q.dtype) for g in f64_by_row(q, k, v, o, lse, do, causal, change))
    return bwd


def route_bwd(route: str):
    """``flash_attention_bwd`` with ``route`` forced."""
    return functools.partial(fa.flash_attention_bwd, force_route=route)


@contextlib.contextmanager
def backward_as(bwd):
    """The kernel path's attention backward is ``bwd`` (same signature as
    ``flash_attention_bwd``) inside the block; the forward kernel stays."""
    real = ops._fa
    ops._fa = types.SimpleNamespace(flash_attention=real.flash_attention,
                                    flash_attention_bwd=bwd)
    try:
        yield
    finally:
        ops._fa = real


def capture(model: Model, params: dict, batch: dict, layers=LAYERS) -> dict:
    """{layer: (q, k, v, o, lse, do, causal)}: the inputs of the attention
    backward at ``layers`` in one gradient of ``model.loss_fn`` (the
    backward runs the layers last first)."""
    calls = []

    def keep(q, k, v, o, lse, do, causal=True, **kw):
        calls.append((q, k, v, o, lse, do, causal))
        return fa.flash_attention_bwd(q, k, v, o, lse, do, causal, **kw)

    with backward_as(keep):
        value_and_grad(model, params, batch)
    n = model.cfg.n_layers
    if len(calls) != n:
        raise RuntimeError(f"{len(calls)} attention backward calls for {n} layers")
    return {layer: tuple(t.clone() if isinstance(t, torch.Tensor) else t
                         for t in calls[n - 1 - layer]) for layer in layers}


def layer_stats(captured: dict, backwards: dict) -> dict:
    """{(layer, backward, grad): (rms, bias)} of each named backward against
    the float64 one on each layer's captured inputs; a backward given as
    None is the float64 result rounded once to the inputs' dtype. Sums run
    over the batch rows, one row at a time."""
    out = {}
    for layer, (q, k, v, o, lse, do, causal) in captured.items():
        sums = {}
        for i in range(q.shape[0]):
            row = tuple(t[i:i + 1].contiguous() for t in (q, k, v, o, lse, do))
            want = flash_attention_bwd_f64(*row, causal)
            for name, bwd in backwards.items():
                got = (tuple(w.to(q.dtype) for w in want) if bwd is None
                       else bwd(*row, causal))
                for gname, a, w in zip(GRADS, got, want):
                    s = sums.setdefault((layer, name, gname), [0.0, 0.0, 0.0])
                    a = a.double()
                    s[0] += ((a - w) ** 2).sum().item()
                    s[1] += (w * w).sum().item()
                    s[2] += (a * w).sum().item()
            del want
        for key, (err, ww, aw) in sums.items():
            out[key] = ((err / ww) ** 0.5, aw / ww - 1)
    return out


def norm_gap(model, plain, params, batch, bwd) -> tuple[float, float, float]:
    """(relative grad-norm gap, loss gap, the furthest gradient leaf's gap
    relative to its largest entry), kernel path with backward ``bwd``
    against the plain path."""
    loss_p, _, g_p = value_and_grad(plain, params, batch)
    with backward_as(bwd):
        loss_k, _, g_k = value_and_grad(model, params, batch)
    leaf = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
               for a, b in zip(tree_leaves(g_k), tree_leaves(g_p)))
    gap = float(global_norm(g_k)) / float(global_norm(g_p)) - 1
    return gap, float(loss_k) - float(loss_p), leaf


def setup(dtype: str = "bfloat16"):
    cfg = dataclasses.replace(get_config(ARCH), dtype=dtype)
    dev = torch.device("cuda")
    runtime = RuntimeConfig(remat="full")
    model = Model(cfg, runtime=runtime)
    plain = Model(cfg, kernel_mode="ref", runtime=runtime)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    data = SyntheticLM(DataConfig(seq_len=SEQ, global_batch=BATCH, vocab_size=cfg.vocab_size))
    return model, plain, params, data, dev


def run(routes=("cuda_cores",), batches: int = 8, steps: int = 0) -> list[tuple]:
    model, plain, params, data, dev = setup()
    card = device_name(dev)
    backwards = {r: route_bwd(r) for r in routes}
    backwards["plain_f32"] = ref.flash_attention_bwd_ref
    backwards["f64"] = f64_rounded
    rows = []
    batch0 = None
    for i in range(batches):
        batch = to_device(next(data), dev)
        batch0 = batch if i == 0 else batch0
        for name, bwd in backwards.items():
            gap, loss_gap, leaf = norm_gap(model, plain, params, batch, bwd)
            rows.append((f"train_bwd_probe.batch{i}.{name}", f"{gap:+.4e}",
                         f"grad_norm_gap=relative;loss_gap={loss_gap:+.4e};"
                         f"worst_leaf={leaf:.4g};card={card}"))
            emit(rows[-1:])
    if batch0 is not None:
        captured = capture(model, params, batch0)
        stats = layer_stats(captured, {**{r: route_bwd(r) for r in routes},
                                       **{f"emulated_{c}": emulated(c) for c in EMULATED},
                                       "f64_rounded": None})
        del captured
        for (layer, name, gname), (rms, bias) in stats.items():
            floor = stats[(layer, "f64_rounded", gname)][0]
            rows.append((f"train_bwd_probe.layer{layer}.{name}.{gname}", f"{rms:.5e}",
                         f"rms_rel;ratio_to_f64_rounded={rms / floor:.6f};bias={bias:+.3e}"))
            emit(rows[-1:])
    if steps:
        rows += step_times(model, params, data, dev, routes, steps, card)
    del model, plain, params
    torch.cuda.empty_cache()
    model, plain, params, data, dev = setup("float32")
    ops.reset_launch_counts()
    gap, loss_gap, leaf = norm_gap(model, plain, params, to_device(next(data), dev),
                                   fa.flash_attention_bwd)
    rows.append(("train_bwd_probe.f32_weights", f"{gap:+.4e}",
                 f"grad_norm_gap=relative;loss_gap={loss_gap:+.4e};worst_leaf={leaf:.4g};"
                 f"batch=0;"
                 f"flash_routes={ops.flash_routes()};bwd_routes={ops.bwd_routes()};card={card}"))
    emit(rows[-1:])
    return rows


def step_times(model, params, data, dev, routes, steps: int, card: str) -> list[tuple]:
    """Median wall time of ``steps`` pure train steps per backward route,
    one step of each route in turn."""
    opt = OptimizerConfig()
    step = make_train_step(model, opt)
    state = init_opt_state(opt, params)
    batch = to_device(next(data), dev)
    times = {r: [] for r in routes}
    for _ in range(steps + 1):  # the first round warms up
        for r in routes:
            with backward_as(route_bwd(r)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(params, state, batch)
                torch.cuda.synchronize()
                times[r].append((time.perf_counter() - t0) * 1e3)
            del out
    rows = []
    for r, ts in times.items():
        ms = statistics.median(ts[1:])
        rows.append((f"train_bwd_probe.step.{r}", f"{ms:.1f}",
                     f"ms_median_of={steps};all={'/'.join(f'{t:.1f}' for t in ts[1:])};"
                     f"tokens_per_s={BATCH * SEQ / ms * 1e3:.0f};card={card}"))
        emit(rows[-1:])
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("train_bwd_probe: runs on the card only")
    ap = argparse.ArgumentParser()
    ap.add_argument("--routes", default=",".join(fa.ROUTES))
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--steps", type=int, default=0)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    run(tuple(args.routes.split(",")), args.batches, args.steps)


if __name__ == "__main__":
    main()
