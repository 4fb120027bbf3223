"""The SSD's gradient in the port, against the JAX package's, on the CPU.

The JAX oracle (``repro.kernels.ref.ssd_chunk_ref``, vmapped as
``repro/kernels/ops.py:95`` does, with ``jnp.cumsum(a)`` as a third output)
builds its decay as ``where(causal, exp(seg), 0)``. Above the diagonal
``seg`` is positive and its ``exp`` overflows once it passes about 88, so
the oracle's gradient there is 0 * inf = NaN, though its forward is right.
The port's plain version takes ``exp`` of causal pairs only, as the CUDA
kernels do, and its gradient stays finite: a difference by design
(ROADMAP.md section 3). The tests:

* (a) one chunk of 64 steps at a = -2: JAX's ``jax.grad`` of the oracle is
  NaN in ``d a_log``; the port's autograd of ``ssd_chunk_ref`` is finite and
  equals ``ssd_chunk_bwd_ref`` in float64.
* (b) where JAX's gradient is finite, ``ssd_chunk_bwd_ref`` and autograd of
  the port's ``ssd_chunk_ref`` equal ``jax.vjp`` of the oracle within 1e-5 of
  each gradient's largest entry (float32), for one group, two groups and a
  group per head; chunks of 40, 64 and 100; float32 and bf16 B/C (JAX and
  autograd take the bf16 values in float32); dcum zero and random.
* (c) the reduced mamba2-2.7b and Jamba configs at the published chunk of
  256 over 256 tokens: the port's ``Model.loss_fn`` gradients are finite.
* (d) the repaired plain forward is bit for bit the oracle-shaped one.
* (e) the CUDA backward's plan (``ssd_chunk.bwd_plan``: CTAs per chunk,
  head block and column tile, G per pair kept in the CTA, partials summed
  in a fixed order), emulated in float64 torch tile by tile with every
  scratch slot the kernel does not write filled with NaN, equals
  ``ssd_chunk_bwd_ref`` within 1e-12.
* (f) under autograd the kernel route (``ops.SsdChunk``, its two kernels
  stood in for by their plain versions) launches the forward twice and the
  backward once per layer under remat "full" and "dots", once each under
  "none".
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs.base import RuntimeConfig
from repro_torch.configs.registry import reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk as ssd
from repro_torch.models.model import Model, init_params
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import value_and_grad

torch.set_num_threads(1)

GRAD_TOL = 1e-5  # of each gradient's largest entry, float32 against JAX's float32
PLAN_TOL = 1e-12  # the emulated plan against the float64 formula
T = ssd.TILE


def _inputs(rng, nb, lc, nh, hp, g, n, a_scale, bc_dtype=torch.float32):
    """x, a, B, C (B and C rounded to bc_dtype) and the three cotangents."""
    x = rng.standard_normal((nb, lc, nh, hp)).astype(np.float32)
    a = (-rng.random((nb, lc, nh)) * a_scale).astype(np.float32)
    b = rng.standard_normal((nb, lc, g, n)).astype(np.float32) * 0.5
    c = rng.standard_normal((nb, lc, g, n)).astype(np.float32) * 0.5
    dy = rng.standard_normal((nb, lc, nh, hp)).astype(np.float32)
    dst = rng.standard_normal((nb, nh, n, hp)).astype(np.float32)
    dcum = rng.standard_normal((nb, lc, nh)).astype(np.float32)
    t = [torch.from_numpy(v) for v in (x, a, b, c, dy, dst, dcum)]
    t[2], t[3] = t[2].to(bc_dtype), t[3].to(bc_dtype)
    return t


def _jax_vjp(x, a, b, c, dy, dst, dcum):
    """jax.vjp of the oracle over the chunk tiles, group-shaped B and C
    broadcast to heads inside, cum = jnp.cumsum(a) as the third output."""
    nh, g = x.shape[2], b.shape[2]

    def f(x, a, b, c):
        bh, ch = jnp.repeat(b, nh // g, axis=2), jnp.repeat(c, nh // g, axis=2)
        y, st = jax.vmap(jref.ssd_chunk_ref)(x, a, bh, ch)
        return y, st, jnp.cumsum(a, axis=1)

    args = [jnp.asarray(t.float().numpy()) for t in (x, a, b, c)]
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(v) for v in vjp(tuple(jnp.asarray(t.numpy()) for t in (dy, dst, dcum)))]


def _autograd(x, a, b, c, dy, dst, dcum, dtype=torch.float32):
    """Autograd of the port's plain version, B and C taken in ``dtype``."""
    leaves = [t.to(dtype).clone().requires_grad_(True) for t in (x, a, b, c)]
    y, st, cum = ref.ssd_chunk_ref(*leaves, return_cum=True)
    loss = (y * dy).sum() + (st * dst).sum() + (cum * dcum).sum()
    return torch.autograd.grad(loss, leaves)


def _rel(got, want) -> float:
    got, want = torch.as_tensor(np.asarray(got)).double(), torch.as_tensor(np.asarray(want))
    return float((got - want.double()).abs().max() / want.double().abs().max())


def test_jax_gradient_is_nan_where_the_ports_is_finite():
    """(a) one chunk of 64 steps at a = -2: cum falls to -128, so seg above
    the diagonal reaches +126 and the oracle's exp overflows."""
    rng = np.random.default_rng(0)
    x, _, b, c, dy, dst, dcum = _inputs(rng, 1, 64, 2, 8, 1, 4, 1.0)
    a = torch.full((1, 64, 2), -2.0)
    jgrads = _jax_vjp(x, a, b, c, dy, dst, dcum)
    assert np.isnan(jgrads[1]).any(), "JAX's d a_log holds NaN"
    got = _autograd(x, a, b, c, dy, dst, dcum)
    want = ref.ssd_chunk_bwd_ref(*(t.double() for t in (x, a, b, c, dy, dst, dcum)))
    for name, gv, wv in zip(("dx", "da", "dB", "dC"), got, want):
        assert torch.isfinite(gv).all(), name
        assert _rel(gv, wv) <= GRAD_TOL, (name, _rel(gv, wv))
    # the forward there is finite and the same on both sides
    y, st = jax.vmap(jref.ssd_chunk_ref)(*(jnp.asarray(t.numpy()) for t in (x, a)),
                                         jnp.asarray(b.numpy()), jnp.asarray(c.numpy()))
    yt, stt = ref.ssd_chunk_ref(x, a, b, c)
    assert _rel(yt, y) <= GRAD_TOL and _rel(stt, st) <= GRAD_TOL


@pytest.mark.parametrize("with_dcum", [False, True])
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lc", [40, 64, 100])
@pytest.mark.parametrize("g", [1, 2, 4])  # nh = 4: one group, two, one per head
def test_plain_backward_matches_jax_where_finite(g, lc, bc_dtype, with_dcum):
    """(b) decays of at most 0.1 a step: cum stays above -10 over 100 steps,
    so the oracle's exp above the diagonal stays finite."""
    rng = np.random.default_rng(lc * 10 + g)
    x, a, b, c, dy, dst, dcum = _inputs(rng, 2, lc, 4, 8, g, 16, 0.1, bc_dtype)
    if not with_dcum:
        dcum = torch.zeros_like(dcum)
    want = _jax_vjp(x, a, b, c, dy, dst, dcum)
    assert all(np.isfinite(w).all() for w in want)
    formula = ref.ssd_chunk_bwd_ref(x, a, b, c, dy, dst, dcum if with_dcum else None)
    auto = _autograd(x, a, b, c, dy, dst, dcum)
    for name, f, at, w in zip(("dx", "da", "dB", "dC"), formula, auto, want):
        assert f.dtype == torch.float32 and tuple(f.shape) == w.shape, name
        assert _rel(f, w) <= GRAD_TOL, (name, "formula", _rel(f, w))
        assert _rel(at, w) <= GRAD_TOL, (name, "autograd", _rel(at, w))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_reduced_model_gradients_finite_at_the_published_chunk(arch):
    """(c) chunk 256 over 256 tokens, float32: before the repair 15 of the
    reduced mamba2-2.7b's 16 gradient leaves held NaN."""
    base = reduced_config(arch)
    cfg = dataclasses.replace(base, dtype="float32",
                              ssm=dataclasses.replace(base.ssm, chunk_size=256))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 256)))
    model = Model(cfg, runtime=RuntimeConfig(remat="none"))
    loss, _, grads = value_and_grad(model, params, {"tokens": tokens, "labels": tokens})
    assert math.isfinite(float(loss))
    leaves = tree_leaves(grads)
    bad = [i for i, t in enumerate(leaves) if not torch.isfinite(t).all()]
    assert not bad, f"{len(bad)} of {len(leaves)} gradient leaves hold NaN or inf"


@pytest.mark.parametrize("shape", [(2, 40, 4, 8, 2, 16), (1, 256, 8, 16, 1, 32),
                                   (2, 100, 6, 8, 3, 8)])
def test_repaired_forward_is_bit_for_bit_the_oracle_shaped_one(shape):
    """(d) the causal entries are the same exp, the others an exact 0."""
    nb, lc, nh, hp, g, n = shape
    rng = np.random.default_rng(lc)
    x, a, b, c, *_ = _inputs(rng, nb, lc, nh, hp, g, n, 0.5)
    y, st, cum = ref.ssd_chunk_ref(x, a, b, c, return_cum=True)
    # the pre-repair arithmetic, written out: where(causal, exp(seg), 0)
    rep = nh // g
    bh, ch = b.repeat_interleave(rep, dim=2), c.repeat_interleave(rep, dim=2)
    cum0 = torch.cumsum(a, dim=1)
    seg = cum0[:, :, None, :] - cum0[:, None, :, :]
    li = torch.arange(lc)
    causal = (li[:, None] >= li[None, :])[None, :, :, None]
    decay = torch.where(causal, torch.exp(seg), torch.zeros(()))
    scores = torch.einsum("zlhn,zmhn->zlmh", ch, bh)
    y0 = torch.einsum("zlmh,zmhp->zlhp", scores * decay, x)
    st0 = torch.einsum("zlhn,zlh,zlhp->zhnp", bh, torch.exp(cum0[:, -1:, :] - cum0), x)
    assert torch.equal(y, y0) and torch.equal(st, st0) and torch.equal(cum, cum0)


def test_head_block_and_plan():
    assert [ssd.head_block(nh, g) for nh, g in ((80, 1), (256, 1), (4, 2), (6, 6), (24, 1),
                                                 (48, 2))] == [16, 16, 2, 1, 12, 12]
    plan = ssd.bwd_plan(32, 256, 80, 1)  # mamba2-2.7b's training call
    assert (plan["head_block"], plan["head_blocks"], plan["n_lt"], plan["pairs"]) == (16, 5, 4, 10)
    assert [ssd.pair_index(c, r, 4) for c in range(4) for r in range(c, 4)] == list(range(10))
    assert ssd.bwd_plan(2, 100, 4, 2)["scratch"]["rowpart"] == (2, 2, 128, 4)


def test_rounding_steps_reads_one_rounding_as_at_most_one_step():
    """The measure chip_smoke.py and the gpu tests hold dB and dC to: a
    float32 result rounded once to bf16 reads at most half a step, one
    moved by two steps at its largest entry reads above 1."""
    from repro_torch.experiments.common import rounding_steps

    want = torch.from_numpy(np.random.default_rng(9).standard_normal(4096).astype(np.float32))
    assert rounding_steps(want.to(torch.bfloat16), want) <= 0.5
    assert rounding_steps(want.clone(), want) == 0.0
    i = int(want.abs().argmax())
    bad = want.to(torch.bfloat16)
    bad[i] = bad[i].float() * (1 + 2.0**-6)
    assert rounding_steps(bad, want) > 1.0


def emulated_bwd(x, a, b, c, dy, dst, dcum):
    """The CUDA backward's plan in float64 torch: each CTA (chunk z, head
    block hb, column tile c) writes what the kernel writes, into scratch
    filled with NaN elsewhere; then the two reduction kernels."""
    nb, lc, nh, hp = x.shape
    g, n = b.shape[2], b.shape[3]
    plan = ssd.bwd_plan(nb, lc, nh, g)
    hblk, nhb, n_lt = plan["head_block"], plan["head_blocks"], plan["n_lt"]
    f64 = torch.float64
    sc = {k: torch.full(s, math.nan, dtype=f64) for k, s in plan["scratch"].items()}
    rows = n_lt * T

    def pad(t):  # rows past lc as zeros
        out = torch.zeros((t.shape[0], rows, *t.shape[2:]), dtype=f64)
        out[:, :lc] = t.double()
        return out

    xp, dyp, bp, cp, ap = pad(x), pad(dy), pad(b), pad(c), pad(a)
    cum = torch.cumsum(ap, dim=1)  # rows past lc hold the total
    dx = torch.full(x.shape, math.nan, dtype=f64)
    for z in range(nb):
        for hb in range(nhb):
            grp = hb * hblk // (nh // g)
            for ct in range(n_lt):
                cs = slice(ct * T, ct * T + T)
                bc_ = bp[z, cs, grp]
                pairs = [(rt, ssd.pair_index(ct, rt, n_lt)) for rt in range(ct, n_lt)]
                gts = [cp[z, rt * T:rt * T + T, grp] @ bc_.T for rt, _ in pairs]  # in the CTA
                dgs = torch.zeros((len(pairs), T, T), dtype=f64)
                dbacc = torch.zeros((T, n), dtype=f64)
                for h in range(hb * hblk, hb * hblk + hblk):
                    ch_ = cum[z, :, h]
                    xs = xp[z, cs, h]
                    w = torch.exp(ch_[lc - 1] - ch_[cs])
                    dxa = w[:, None] * (bc_ @ dst[z, h].double())
                    dbacc += w[:, None] * (xs @ dst[z, h].double().T)
                    u = (xs * dxa).sum(1)
                    colacc = torch.zeros(T, dtype=f64)
                    for k, (rt, _) in enumerate(pairs):
                        dys = dyp[z, rt * T:rt * T + T, h]
                        seg = ch_[rt * T:rt * T + T, None] - ch_[None, cs]
                        if k == 0:
                            seg = seg.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(),
                                                  -math.inf)
                        L = torch.exp(seg)
                        dm = dys @ xs.T
                        m_ = gts[k] * L
                        r_ = dm * m_
                        dgs[k] += dm * L
                        colacc += r_.sum(0)
                        if k == 0:
                            rowd = r_.sum(1)
                        else:
                            live = min(T, lc - rt * T)
                            sc["rowpart"][z, ct, rt * T:rt * T + live, h] = r_.sum(1)[:live]
                        dxa += m_.T @ dys
                    live = min(T, lc - ct * T)
                    dx[z, ct * T:ct * T + live, h] = dxa[:live]
                    sc["rowpart"][z, ct, ct * T:ct * T + live, h] = (rowd - colacc - u)[:live]
                    sc["usum"][z, ct, h] = u.sum()
                sc["dbpart"][z, hb, ct, :, :n] = dbacc + sum(
                    dgs[k].T @ cp[z, rt * T:rt * T + T, grp] for k, (rt, _) in enumerate(pairs))
                for k, (rt, pi) in enumerate(pairs):
                    sc["dcpart"][z, hb, pi, :, :n] = dgs[k] @ bc_
    # the reductions: dB / dC per (z, row tile, group), then dcum and da
    rep = nh // g
    db = torch.zeros((nb, rows, g, n), dtype=f64)
    dc = torch.zeros_like(db)
    for z in range(nb):
        for t in range(n_lt):
            for grp in range(g):
                for hb in range(grp * rep // hblk, (grp + 1) * rep // hblk):
                    db[z, t * T:t * T + T, grp] += sc["dbpart"][z, hb, t, :, :n]
                    for ct in range(t + 1):
                        pi = ssd.pair_index(ct, t, n_lt)
                        dc[z, t * T:t * T + T, grp] += sc["dcpart"][z, hb, pi, :, :n]
    d = dcum.double().clone()
    for l in range(lc):
        d[:, l] += sc["rowpart"][:, :l // T + 1, l].sum(1)
    d[:, lc - 1] += sc["usum"].sum(1)
    da = d.flip(1).cumsum(1).flip(1)
    return dx, da, db[:, :lc], dc[:, :lc]


@pytest.mark.parametrize("shape", [
    (2, 100, 4, 8, 2, 16),   # ragged chunk: the last tile is 36 rows, g 2
    (1, 256, 80, 4, 1, 8),   # mamba2-2.7b's heads and chunk: 5 blocks of 16
    (2, 40, 6, 8, 6, 16),    # a group per head: blocks of one
    (1, 200, 32, 8, 2, 128), # n 128: both column halves
    (1, 64, 24, 4, 1, 8),    # blocks of 12
])
def test_emulated_kernel_plan_matches_the_formula(shape):
    """(e) every scratch slot the reductions read was written (NaN
    otherwise), and the sums equal ssd_chunk_bwd_ref in float64."""
    nb, lc, nh, hp, g, n = shape
    rng = np.random.default_rng(nh)
    x, a, b, c, dy, dst, dcum = (t.double() for t in _inputs(rng, nb, lc, nh, hp, g, n, 0.5))
    got = emulated_bwd(x, a, b, c, dy, dst, dcum)
    want = ref.ssd_chunk_bwd_ref(x, a, b, c, dy, dst, dcum)
    for name, gv, wv in zip(("dx", "da", "dB", "dC"), got, want):
        assert torch.isfinite(gv).all(), name
        assert _rel(gv, wv) <= PLAN_TOL, (name, _rel(gv, wv))


@pytest.mark.parametrize("remat, per_layer", [("none", 1), ("full", 2), ("dots", 2)])
def test_kernel_route_launches_per_remat_policy(monkeypatch, remat, per_layer):
    """(f) the kernel route on the CPU, its kernels stood in for by their
    plain versions: forward launches per layer, one backward per layer."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(*args, **kw):
        calls["fwd"] += 1
        return ref.ssd_chunk_ref(*args, **kw)

    def bwd(*args):
        calls["bwd"] += 1
        return ref.ssd_chunk_bwd_ref(*args)

    monkeypatch.setattr(ops, "use_kernel", lambda t, mode: True)
    monkeypatch.setattr(ssd, "ssd_chunk", fwd)
    monkeypatch.setattr(ssd, "ssd_chunk_bwd", bwd)
    cfg = dataclasses.replace(reduced_config("mamba2-2.7b"), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 40)))
    batch = {"tokens": tokens, "labels": tokens}
    loss_k, _, g_k = value_and_grad(Model(cfg, runtime=RuntimeConfig(remat=remat)), params,
                                    batch)
    assert calls == {"fwd": per_layer * cfg.n_layers, "bwd": cfg.n_layers}
    monkeypatch.undo()
    loss_p, _, g_p = value_and_grad(Model(cfg, runtime=RuntimeConfig(remat=remat)), params,
                                    batch)
    assert abs(float(loss_k) - float(loss_p)) <= 1e-6
    for a_, b_ in zip(tree_leaves(g_k), tree_leaves(g_p)):
        assert _rel(a_, b_) <= GRAD_TOL
