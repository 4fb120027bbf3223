"""The tensor-core design of the port's SSD backward, checked in plain torch on the CPU.

The CUDA kernel (``repro_torch/kernels/csrc/ssd_chunk_bwd.cu``) runs only on
the card, so these tests pin what it is built on:

* The split-precision products. A model of the backward whose every
  product is formed as the kernel forms it, at one chunk of 256 steps and
  one block of 16 heads of one group (n 128, hp 64; x and a drawn as
  ``chip_smoke.ssd_inputs`` draws them, dcum random): G = C.B^T in one exact
  pass for bf16 B/C (three split passes for float32 B/C); every float32 x
  float32 product (dM^T = x.dy^T, M^T.dy, (w x).dst^T) as small.big +
  big.small + big.big over operands split as ``test_torch_ssd_plan.py``
  models the forward's; every product with a bf16 operand (B.dst, dG^T.C,
  dG.B) in two passes, bf16 being exact in TF32; sums in float32. Each
  output (dB and dC as the float32 sums the kernel rounds once to B's
  dtype) stays within 1e-5 of its scale of ``ssd_chunk_bwd_ref`` in
  float64 (chip_smoke.py holds the kernel to SSD_TOL, 1e-4), for both B/C
  dtypes, and at least 10x closer than the same model with single-pass
  TF32 products.
* ``experiments/ssd_bwd_probe.py``'s ablations and timeline apply to the
  current source.
* The fragment permutations and swizzles, mirrored from the source: each
  k permutation and each output-column permutation covers its 64 columns
  once; the warps' tiles cover each output once; each chunk swizzle is a
  permutation of a row's chunks; and the shared-memory accesses of the hot
  loops need one wavefront each (no bank conflict), the u read (once a
  head) at most four.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from tests.test_torch_ssd_plan import _split, _tf32_round

torch.set_num_threads(1)

SPLIT_TOL = 1e-5  # of each output's scale, the model against the float64 formula
LC, HBLK, HP, N = 256, 16, 64, 128  # one chunk tile of mamba2-2.7b, one head block
T = 64  # tile


def _mm(a: torch.Tensor, b: torch.Tensor, passes: int, exact: str = "") -> torch.Tensor:
    """a @ b as the kernel forms it, sums in float32: ``passes`` 3 splits both
    operands (two passes where ``exact`` names an operand that is bf16, exact
    in TF32); ``passes`` 1 reads both rounded to TF32 once."""
    if passes == 1:
        return _tf32_round(a) @ _tf32_round(b)
    if exact == "a":
        bb, bs = _split(b)
        return a @ bs + a @ bb
    if exact == "b":
        ab, as_ = _split(a)
        return as_ @ b + ab @ b
    ab, as_ = _split(a)
    bb, bs = _split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def _inputs(bc_dtype: torch.dtype, seed: int = 0):
    """One chunk and one head block as chip_smoke.ssd_inputs draws a layer's
    (x * 0.05, a = -dt * A, B and C * 0.5 in bc_dtype), and random
    cotangents dy, dst, dcum."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((LC, HBLK, HP), dtype=np.float32) * 0.05)
    dt = rng.random((LC, HBLK), dtype=np.float32) * 0.1 + 1e-3
    a = torch.from_numpy(-dt * (rng.random(HBLK, dtype=np.float32) * 15 + 1))
    bc = torch.from_numpy(rng.standard_normal((LC, 2 * N), dtype=np.float32) * 0.5)
    bc = bc.to(bc_dtype).float()  # bf16 B/C as the model gives them, as exact f32 values
    dy = torch.from_numpy(rng.standard_normal((LC, HBLK, HP), dtype=np.float32))
    dst = torch.from_numpy(rng.standard_normal((HBLK, N, HP), dtype=np.float32))
    dcum = torch.from_numpy(rng.standard_normal((LC, HBLK), dtype=np.float32))
    return x, a, bc[:, :N].contiguous(), bc[:, N:].contiguous(), dy, dst, dcum


def _kernel_model(x, a, b, c, dy, dst, dcum, bc_exact: bool, passes: int):
    """The backward's arithmetic in float32, product by product as the kernel
    forms it (``passes`` 1: every TF32 product in one pass instead)."""
    bx = "a" if bc_exact else ""  # B or C as the A operand
    cx = "b" if bc_exact else ""  # as the B operand
    cum = torch.cumsum(a, dim=0)
    causal = torch.tril(torch.ones(LC, LC, dtype=torch.bool))
    g_ = c @ b.T if bc_exact else _mm(c, b.T.contiguous(), passes)  # one exact bf16 pass
    w = torch.exp(cum[-1] - cum)  # (Lc, nh)
    dx = torch.empty_like(x)
    dg = torch.zeros((LC, LC))
    dbs = torch.zeros((LC, N))
    d = torch.empty((LC, HBLK))
    for h in range(HBLK):
        seg = cum[:, h, None] - cum[None, :, h]
        decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
        dm = _mm(dy[:, h], x[:, h].T.contiguous(), passes)
        m_ = g_ * decay
        dg += dm * decay
        xs = w[:, h, None] * _mm(b, dst[h], passes, bx)
        dx[:, h] = _mm(m_.T.contiguous(), dy[:, h], passes) + xs
        dbs += _mm(w[:, h, None] * x[:, h], dst[h].T.contiguous(), passes)
        u = (x[:, h] * xs).sum(1)
        r = dm * m_
        d[:, h] = r.sum(1) - r.sum(0) - u
        d[-1, h] += u.sum()
    da = (d + dcum).flip(0).cumsum(0).flip(0)
    db = _mm(dg.T.contiguous(), c, passes, cx) + dbs
    dc = _mm(dg, b, passes, cx)
    return dx, da, db, dc


def _rel_errs(got, want) -> dict:
    return {k: ((g.double() - w).abs().max() / w.abs().max()).item()
            for k, g, w in zip(("dx", "da", "dB", "dC"), got, want)}


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
def test_split_products_keep_float32_accuracy_at_the_training_tile(bc_dtype):
    x, a, b, c, dy, dst, dcum = _inputs(bc_dtype)
    want = ref.ssd_chunk_bwd_ref(*(t.double()[None] for t in (x, a)),
                                 b.double()[None, :, None], c.double()[None, :, None],
                                 dy.double()[None], dst.double()[None], dcum.double()[None])
    want = [want[0][0], want[1][0], want[2][0, :, 0], want[3][0, :, 0]]
    exact = bc_dtype == torch.bfloat16
    split = _rel_errs(_kernel_model(x, a, b, c, dy, dst, dcum, exact, passes=3), want)
    single = _rel_errs(_kernel_model(x, a, b, c, dy, dst, dcum, exact, passes=1), want)
    assert max(split.values()) <= SPLIT_TOL, split
    for k in split:
        assert split[k] * 10 <= single[k], (k, split[k], single[k])


# ---------------------------------------------------------------------------
# Mirrors of the source's index maps (ssd_chunk_bwd.cu)
# ---------------------------------------------------------------------------


def swz(kind: str, r: int) -> int:
    """Chunk swizzles of a row of 16 chunks: swz_s (x, dy, dst), swz_d (G^T,
    dG^T, float32 C), swz_c (bf16 C)."""
    if kind == "s":
        return ((r >> 1) & 1) | ((((r >> 2) ^ r) & 1) << 2)
    if kind == "d":
        return (((r >> 1) & 1) << 2) | (((r ^ (r >> 2)) & 1) << 1) | (r & 1)
    return r & 7


def at(kind: str, r: int, k: int) -> int:
    """Float index of (row r, column k) in a 64-float row tile under swz_s / swz_d."""
    return r * T + ((((k >> 2) ^ swz(kind, r)) << 2) | (k & 3))


def _lanes():
    return [(lane >> 2, lane & 3) for lane in range(32)]  # (g, q)


def test_swizzles_permute_each_rows_chunks():
    for kind in "sdc":
        for r in range(T):
            assert sorted(ch ^ swz(kind, r) for ch in range(16)) == list(range(16)), (kind, r)


def test_k_permutations_cover_each_column_once():
    # over p (dM^T, the state's dB term): k-block 2k' + i // 2, slot q + 4 (i % 2)
    # <-> p = 16k' + 4q + i
    seen = {}
    for kp in range(4):
        for q in range(4):
            for i in range(4):
                seen[(2 * kp + i // 2, q + 4 * (i % 2))] = 16 * kp + 4 * q + i
    assert sorted(seen.values()) == list(range(T)) and len(seen) == T
    # over l or m or n in blocks of 8 (M^T.dy, B.dst, dG^T.C, dG.B): slot q <-> 2q,
    # slot q + 4 <-> 2q + 1, which is the accumulator's column order
    block = {q: 2 * q for q in range(4)} | {q + 4: 2 * q + 1 for q in range(4)}
    assert sorted(block.values()) == list(range(8))
    # dx's columns: column j of n-tile u is p 8j + u; a lane's two accumulator
    # columns 2q, 2q + 1 over the 8 n-tiles are p 16q .. 16q + 15
    assert sorted(8 * j + u for j in range(8) for u in range(8)) == list(range(T))
    for q in range(4):
        assert sorted(8 * (2 * q + e) + u for e in range(2) for u in range(8)) == \
            list(range(16 * q, 16 * q + 16))


def test_warp_tiles_cover_each_output_once():
    # pairs (G^T, dG^T, M^T): warp (wm, wl) owns rows 16 wm + g (+ 8), columns
    # 32 wl + 8t + 2q (+ 1)
    cells = [(16 * wm + g + 8 * hi, 32 * wl + 8 * t + 2 * q + e)
             for wm in range(4) for wl in range(2) for g, q in _lanes()
             for hi in range(2) for t in range(4) for e in range(2)]
    assert sorted(cells) == [(m, n) for m in range(T) for n in range(T)]
    # the state's B.dst: warp wl takes n 32 wl .. + 31 of each half's 64 (its k)
    assert sorted(64 * h + 32 * wl + 8 * t + k for h in range(2) for wl in range(2)
                  for t in range(4) for k in range(8)) == list(range(N))
    # dB (state term and end): rows 16 wm + g (+ 8), n 64 h + 32 wl + 8u + 2q (+ 1)
    cells = [(16 * wm + g + 8 * hi, 64 * h + 32 * wl + 8 * u + 2 * q + e)
             for wm in range(4) for wl in range(2) for g, q in _lanes()
             for hi in range(2) for h in range(2) for u in range(4) for e in range(2)]
    assert sorted(cells) == [(m, n) for m in range(T) for n in range(N)]
    # dC: rows l 16 (w & 3) + g (+ 8), n 64 (w >> 2) + 8u + 2q (+ 1)
    cells = [(16 * (w & 3) + g + 8 * hi, 64 * (w >> 2) + 8 * u + 2 * q + e)
             for w in range(8) for g, q in _lanes()
             for hi in range(2) for u in range(8) for e in range(2)]
    assert sorted(cells) == [(m, n) for m in range(T) for n in range(N)]


def _pattern(name: str) -> tuple[list[list[int]], int]:
    """The addresses (in floats) of each warp instruction of one access
    pattern, for every warp and loop index, and the access width in floats."""
    lanes = _lanes()
    out = []
    if name == "p4":  # float4 of x / dy / dst rows base + g, chunk 4k' + q
        for base in range(0, T, 8):
            for kp in range(4):
                out.append([(base + g) * T + (((4 * kp + q) ^ swz("s", base + g)) << 2)
                            for g, q in lanes])
        return out, 4
    if name == "pf":  # float4s of rows 8t + 2q (+ 1), chunks 2g, 2g + 1
        for base in range(0, T, 8):
            for dr in range(2):
                for dc in range(2):
                    out.append([(base + 2 * q + dr) * T
                                + (((2 * g + dc) ^ swz("s", base + 2 * q + dr)) << 2)
                                for g, q in lanes])
        return out, 4
    if name == "pa":  # float2 of G^T / dG^T rows 16 wm + g (+ 8), columns 8t + 2q
        for wm in range(4):
            for hi in range(2):
                for t in range(8):
                    out.append([at("d", 16 * wm + g + 8 * hi, 8 * t + 2 * q) for g, q in lanes])
        return out, 2
    if name == "pt":  # floats of dG^T / f32 C rows 8t + 2q (+ 1), 8 consecutive columns
        for t in range(8):
            for dr in range(2):
                for col0 in range(0, T, 8):
                    out.append([at("d", 8 * t + 2 * q + dr, col0 + g) for g, q in lanes])
        return out, 1
    if name == "c_rows":  # floats of f32 C rows 8t + g, 4 consecutive columns (G^T)
        for t in range(8):
            for k0 in range(0, T, 4):
                out.append([at("d", 8 * t + g, k0 + q) for g, q in lanes])
        return out, 1
    if name == "ldsm_c":  # ldmatrix x4 of bf16 C or B_c: per matrix 8 rows of 16 B at one chunk
        for r0 in range(0, T, 8):
            for ch in range(16):
                out.append([(r0 + i) * 64 + (((ch + j) % 16 ^ swz("c", r0 + i)) << 2)
                            for j in range(4) for i in range(8)])
        return out, 4
    if name == "split":  # a dst or dy tile split once: float4 tid + 256 j
        for j in range(4):
            for w in range(8):
                out.append([4 * (32 * w + lane + 256 * j) for lane in range(32)])
        return out, 4
    if name == "park":  # the dx exchange: float4 (wm 8 + u) 32 + lane
        for wm in range(4):
            for u in range(8):
                out.append([((wm * 8 + u) * 32 + lane) * 4 for lane in range(32)])
        return out, 4
    if name == "u_read":  # x row m0, chunk 4q + k
        for base in range(0, T, 8):
            for k in range(4):
                out.append([(base + g) * T + (((4 * q + k) ^ swz("s", base + g)) << 2)
                            for g, q in lanes])
        return out, 4
    if name.startswith("b32"):  # float32 B_c: rows of 128 floats, chunks under swz_d
        def at_b(r, col):
            return r * 128 + ((((col >> 2) ^ swz("d", r)) << 2) | (col & 3))
        for t in range(8):
            for base in (0, 64):
                if name == "b32_rows":  # G^T: floats of rows g, 4 consecutive columns
                    out.append([at_b(16 * (base // 64) + g, base + 8 * t + q) for g, q in lanes])
                elif name == "b32_pairs":  # the state's B_c.dst: float2 of rows g, columns 8t + 2q
                    out.append([at_b(16 * (base // 64) + g, base + 8 * t + 2 * q)
                                for g, q in lanes])
                else:  # dC: floats of rows 8t + 2q (+ 1), 8 consecutive columns
                    out.append([at_b(8 * t + 2 * q + base // 64, base + g) for g, q in lanes])
        return out, 2 if name == "b32_pairs" else 1
    raise KeyError(name)


def _wavefronts(addrs: list[int], width: int) -> int:
    """Wavefronts of one instruction: 128 bytes a wavefront; lanes of
    ``width`` words each go in phases of 32 / width lanes, and a phase needs
    as many wavefronts as distinct 4-byte words fall into its busiest bank."""
    per = 32 // width
    total = 0
    for p in range(0, 32, per):
        banks: dict[int, set] = {}
        for a in addrs[p:p + per]:
            for w in range(width):
                banks.setdefault((a + w) % 32, set()).add(a + w)
        total += max(len(s) for s in banks.values())
    return total


@pytest.mark.parametrize("name,limit", [
    ("p4", 1), ("pf", 1), ("pa", 1), ("pt", 1), ("c_rows", 1), ("ldsm_c", 1), ("park", 1),
    ("split", 1), ("b32_rows", 1), ("b32_pairs", 1), ("b32_cols", 1), ("u_read", 4),
])
def test_shared_memory_accesses_need_few_wavefronts(name, limit):
    """Per phase (32 / width lanes), one wavefront each where ``limit`` is 1:
    no bank conflict; the u read (once a head) at most four."""
    insts, width = _pattern(name)
    phases = 32 // (32 // width)
    for addrs in insts:
        assert _wavefronts(addrs, width) <= limit * phases, (name, addrs[:8])


def _probe_edits():
    from repro_torch.experiments import ssd_bwd_probe

    return ([(f"ssd_bwd_probe.{k}", v) for k, v in ssd_bwd_probe.VARIANTS.items()]
            + [("ssd_bwd_probe.timeline", ssd_bwd_probe.TIMELINE)])


@pytest.mark.parametrize("name,edits", _probe_edits(), ids=[p[0] for p in _probe_edits()])
def test_probe_edits_apply_to_the_current_source(name, edits):
    """Each ablation and the timeline of ``experiments/ssd_bwd_probe.py``
    finds the text it edits in ``csrc/ssd_chunk_bwd.cu`` as often as it says."""
    from repro_torch.kernels import build

    patched = build.patched_source("ssd_chunk_bwd", edits)
    assert patched != (build.CSRC / "ssd_chunk_bwd.cu").read_text()
    assert all(new in patched for _, new, _ in edits)
