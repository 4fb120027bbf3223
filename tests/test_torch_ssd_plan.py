"""The design of the port's ssd_chunk kernel, checked in plain torch on the CPU.

The CUDA kernel (``repro_torch/kernels/csrc/ssd_chunk.cu``) runs only on the
card, so these tests pin what it is built on:

* The split-precision products. A model of the kernel's arithmetic at the
  full Mamba-2 2.7B tile (Lc 256, nh 80, hp 64, n 128, one group; x and a
  drawn as ``chip_smoke.ssd_inputs`` draws them): each float32 operand of a
  tensor-core product is split into big (rounded to TF32: half a TF32 ulp
  added, the low 13 bits of the float32 cleared) and small = v - big, which
  the tensor core reads with its low 13 bits cleared; the product is
  small.big + big.small + big.big with float32 sums. bf16 B and C are exact
  in TF32 and their products exact in float32, so C.B^T is one pass and
  B^T.(w x) two. Against a float64 reference of the same function its
  error stays below SSD_TOL / 5 of the output's scale (SSD_TOL 1e-4, the
  limit chip_smoke.py holds the kernel to), for both B/C dtypes, and at
  least 10x below single-pass TF32's at the same inputs, which misses the
  float32 tolerance.
* The tile schedule (``ssd_chunk.tile_schedule``, the order the kernel
  walks): every causal (row, column) tile pair once, and the diagonal
  steps, where the chunk state is added, every column tile once.
* ``return_cum``: the prefix sums equal jnp.cumsum of the same inputs, the
  other outputs do not change, and ``_ssd_chunked`` (which now takes its
  cum from ssd_chunk) still matches JAX's.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba import _ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_chunk as ssd
from repro_torch.models.mamba import _ssd_chunked

torch.set_num_threads(1)

SSD_TOL = 1e-4  # chip_smoke.py: the kernel against its plain version, of the output's scale
LC, NH, HP, N = 256, 80, 64, 128  # mamba2-2.7b: chunk, heads, head dim, d_state


def _tf32_round(v: torch.Tensor) -> torch.Tensor:
    """The kernel's big part: round to nearest TF32 by adding half a TF32 ulp
    to the float32 bits and clearing the low 13 (ties away from zero)."""
    u = v.numpy().view(np.uint32)
    return torch.from_numpy(((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def _tf32_trunc(v: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 register: the low 13 bits cleared."""
    u = v.numpy().view(np.uint32)
    return torch.from_numpy((u & np.uint32(0xFFFFE000)).view(np.float32))


def _split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = _tf32_round(v)
    return big, _tf32_trunc(v - big)


def _mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the kernel forms it on the tensor cores, sums in float32:
    3 split passes, or 1 pass of operands rounded to TF32."""
    if passes == 1:
        return _tf32_round(a) @ _tf32_round(b)
    ab, as_ = _split(a)
    bb, bs = _split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def _inputs(bc_dtype: torch.dtype, seed: int = 0):
    """One chunk of one Mamba-2 layer as chip_smoke.ssd_inputs draws it:
    x (Lc, nh, hp) f32 * 0.05, a = -dt * A, B and C (Lc, n) one group."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((LC, NH, HP), dtype=np.float32) * 0.05)
    dt = rng.random((LC, NH), dtype=np.float32) * 0.1 + 1e-3
    a = torch.from_numpy(-dt * (rng.random(NH, dtype=np.float32) * 15 + 1))
    bc = torch.from_numpy(rng.standard_normal((LC, 2 * N), dtype=np.float32) * 0.5)
    bc = bc.to(bc_dtype).float()  # bf16 B/C as the model gives them, as exact f32 values
    return x, a, bc[:, :N].contiguous(), bc[:, N:].contiguous()


def _reference(x, a, b, c):
    """The function in float64: y (Lc, nh, hp), st (nh, n, hp)."""
    x, a, b, c = x.double(), a.double(), b.double(), c.double()
    cum = torch.cumsum(a, dim=0)  # (Lc, nh)
    seg = cum[:, None, :] - cum[None, :, :]  # (l, m, nh)
    causal = torch.tril(torch.ones(LC, LC, dtype=torch.bool))[:, :, None]
    decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
    p = (c @ b.T)[:, :, None] * decay  # (l, m, nh)
    y = torch.einsum("lmh,mhp->lhp", p, x)
    w = torch.exp(cum[-1] - cum)  # (Lc, nh)
    st = torch.einsum("ln,lh,lhp->hnp", b, w, x)
    return y, st


def _kernel_model(x, a, b, c, bc_exact: bool, passes: int):
    """The kernel's arithmetic in float32: G = C.B^T (one exact pass for bf16
    B/C, else split), P = G * exp(cum_l - cum_m) on causal pairs, y = P.x and
    st = B^T.(w x) with split products (or single-pass TF32 when passes == 1)."""
    cum = torch.cumsum(a, dim=0)
    g = c @ b.T if bc_exact else _mm(c, b.T.contiguous(), passes)
    causal = torch.tril(torch.ones(LC, LC, dtype=torch.bool))
    y = torch.empty_like(x)
    st = torch.empty((NH, N, HP))
    w = torch.exp(cum[-1] - cum)
    for h in range(NH):
        seg = cum[:, h, None] - cum[None, :, h]
        p = torch.where(causal, g * torch.exp(torch.where(causal, seg, 0.0)), 0.0)
        y[:, h] = _mm(p, x[:, h], passes)
        xw = w[:, h, None] * x[:, h]
        if bc_exact and passes == 3:  # B exact in TF32: big.big + big.small
            xb, xs = _split(xw)
            st[h] = b.T @ xs + b.T @ xb
        else:
            st[h] = _mm(b.T.contiguous(), xw, passes)
    return y, st


def _rel_err(got, want) -> float:
    return max((g.double() - w).abs().max().item() / w.abs().max().item()
               for g, w in zip(got, want))


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
def test_split_products_keep_float32_accuracy_at_the_mamba2_tile(bc_dtype):
    x, a, b, c = _inputs(bc_dtype)
    want = _reference(x, a, b, c)
    exact = bc_dtype == torch.bfloat16
    split_err = _rel_err(_kernel_model(x, a, b, c, exact, passes=3), want)
    single_err = _rel_err(_kernel_model(x, a, b, c, exact, passes=1), want)
    assert split_err < SSD_TOL / 5, split_err
    assert split_err * 10 <= single_err, (split_err, single_err)


def test_tf32_rounding_model():
    v = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 3 * 2.0**-11), 3.0e-3])
    big, small = _split(v)
    assert big.tolist()[:4] == [1.0, 1.0 + 2.0**-10, 1.0, -(1.0 + 2 * 2.0**-10)]
    assert torch.equal(big + (v - big), v)  # the split itself is exact before truncation
    assert ((v - (big + small)).abs() <= v.abs() * 2.0**-21).all()


@pytest.mark.parametrize("lc", [16, 40, 64, 100, 256])
def test_tile_schedule_covers_each_causal_pair_once(lc):
    plan = ssd.tile_schedule(lc)
    n_lt = -(-lc // ssd.TILE)
    assert len(plan) == (n_lt + 1) // 2  # the CTAs of one (chunk, head) cluster
    steps = [st for cta in plan for st in cta]
    assert sorted(steps) == [(r, c) for r in range(n_lt) for c in range(r + 1)]
    diagonals = sorted(c for cta in plan for r, c in cta if r == c)
    assert diagonals == list(range(n_lt))  # the state sees every column tile once
    for cta in plan:  # each row tile runs its columns in order and ends on its diagonal
        rows = [r for r, _ in cta]
        for r in set(rows):
            assert [c for rr, c in cta if rr == r] == list(range(r + 1))
    if n_lt % 2 == 0:  # paired row tiles: every CTA walks the same number of steps
        assert len({len(cta) for cta in plan}) == 1


@pytest.mark.parametrize("g", [1, 2])
def test_return_cum_matches_jnp_cumsum(g):
    nb, lc, nh, hp, n = 3, 40, 4, 8, 16
    rng = np.random.default_rng(17 + g)
    x = rng.standard_normal((nb, lc, nh, hp), dtype=np.float32)
    a = (-np.abs(rng.normal(size=(nb, lc, nh))) * 0.1).astype(np.float32)
    b = rng.standard_normal((nb, lc, g, n), dtype=np.float32)
    c = rng.standard_normal((nb, lc, g, n), dtype=np.float32)
    args = [torch.from_numpy(v) for v in (x, a, b, c)]
    y, st, cum = ops.ssd_chunk(*args, return_cum=True)
    y0, st0 = ops.ssd_chunk(*args)
    want = np.asarray(jnp.cumsum(jnp.asarray(a), axis=1))
    assert cum.shape == (nb, lc, nh) and cum.dtype == torch.float32
    np.testing.assert_allclose(cum.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(y, y0) and torch.equal(st, st0)


@pytest.mark.parametrize("s,chunk,g", [(300, 64, 2), (256, 256, 1)])
def test_ssd_chunked_with_the_kernels_cum_matches_jax(s, chunk, g):
    b, nh, hp, n = 1, 4, 8, 8
    rng = np.random.default_rng(s + chunk + g)
    x = rng.standard_normal((b, s, nh, hp), dtype=np.float32)
    a = (-np.abs(rng.normal(size=(b, s, nh))) * 0.1).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n), dtype=np.float32)
    cm = rng.standard_normal((b, s, g, n), dtype=np.float32)
    yw, sw = jax_ssd_chunked(*(jnp.asarray(v) for v in (x, a, bm, cm)), chunk=chunk)
    y, st = _ssd_chunked(*(torch.from_numpy(v) for v in (x, a, bm, cm)), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sw), atol=1e-4, rtol=1e-4)
