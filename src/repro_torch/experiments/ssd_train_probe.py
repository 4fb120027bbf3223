"""How the SSD backward kernel moves full-width mamba2-2.7b's gradient,
measured against the plain path and a float64 backward.

``chip_smoke.py`` phase 14 (i) holds one gradient of full-width, full-depth
mamba2-2.7b on the kernel path (``ssd_chunk`` and ``ssd_chunk_bwd``) against
the same gradient on the plain path (``kernel_mode="ref"``), float32 weights,
from the same seeded weights and ``SyntheticLM`` batch. This probe prints the
readings its limits are set from. For batches 0 .. ``--batches`` - 1:

* ``ssd_train_probe.batch<i>.<backward>``: the loss gap |kernel - plain| and
  the furthest gradient leaf's gap, relative to the leaf's largest entry,
  where the kernel path's SSD backward is the kernel (``kernel``) or the
  kernel built with a planted fault (``fault_<name>``, ``FAULTS``);
* ``ssd_train_probe.layer<l>.<backward>.<grad>``: at layers ``LAYERS``, on
  batch 0's captured inputs and cotangents of that layer's backward call,
  dx, da, dB and dC of the kernel and of each fault against
  ``ssd_chunk_bwd_ref`` in float64: the largest error relative to the
  largest |entry|.

    python -m repro_torch.experiments.ssd_train_probe [--batches 2]

Runs on the card only (about 40 GB of device memory).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import types

import torch

from repro_torch.configs.base import RuntimeConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.experiments.common import device_name, emit
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import ssd_chunk as ssd
from repro_torch.models.model import Model, init_params
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import to_device, value_and_grad

ARCH = "mamba2-2.7b"
SEQ, BATCH = 2048, 4  # chip_smoke.py phase 14's batches
LAYERS = (0, 31, 63)
GRADS = ("dx", "da", "dB", "dC")
F64_TILES = 8  # chunk tiles per float64 reference call (about 3 GB each)
# wrong backwards the checks must refuse: the kernel with one term cut out
FAULTS = {
    # dcum without -u_j on the tile's own rows (the state's pull on the decay)
    "no_u": (("rowd - colacc - us[tid]", "rowd - colacc", 1),),
    # dB and dC without the first head block's partial (16 of 80 heads)
    "drop_block": (("for (int hb = hb0; hb < hb1; ++hb) {",
                    "for (int hb = hb0 + 1; hb < hb1; ++hb) {", 1),),
}


def setup(dtype: str = "float32"):
    cfg = dataclasses.replace(get_config(ARCH), dtype=dtype)
    dev = torch.device("cuda")
    runtime = RuntimeConfig(remat="full")
    model = Model(cfg, runtime=runtime)
    plain = Model(cfg, kernel_mode="ref", runtime=runtime)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    data = SyntheticLM(DataConfig(seq_len=SEQ, global_batch=BATCH, vocab_size=cfg.vocab_size))
    return model, plain, params, data, dev


def fault_lib(name: str):
    """ssd_chunk_bwd built with the fault ``FAULTS[name]``."""
    return build.load_variant("ssd_chunk_bwd", f"fault_{name}", FAULTS[name],
                              ssd.BWD_SIGNATURES)


@contextlib.contextmanager
def backward_lib(lib):
    """``ssd_chunk_bwd`` launches ``lib`` (a built variant) inside the block."""
    real = build._LIBS.get("ssd_chunk_bwd")
    build._LIBS["ssd_chunk_bwd"] = lib
    try:
        yield
    finally:
        if real is None:
            build._LIBS.pop("ssd_chunk_bwd")
        else:
            build._LIBS["ssd_chunk_bwd"] = real


@contextlib.contextmanager
def backward_as(bwd):
    """The kernel path's SSD backward is ``bwd`` (``ssd_chunk_bwd``'s
    signature) inside the block; the forward kernel stays."""
    real = ops._ssd
    ops._ssd = types.SimpleNamespace(ssd_chunk=real.ssd_chunk, ssd_chunk_bwd=bwd)
    try:
        yield
    finally:
        ops._ssd = real


def gradient(model: Model, params: dict, batch: dict, layers=()) -> tuple:
    """(loss, gradient leaves parked on the host, {layer: (inputs, outputs)}
    of the SSD backward at ``layers``): one gradient of ``model.loss_fn``,
    the backward running the layers last first."""
    n = model.cfg.n_layers
    keep = {n - 1 - layer: layer for layer in layers}
    calls, captured = [0], {}

    def bwd(*args):
        out = ssd.ssd_chunk_bwd(*args)
        if calls[0] in keep:
            captured[keep[calls[0]]] = (
                tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in args),
                tuple(t.clone() for t in out))
        calls[0] += 1
        return out

    with backward_as(bwd):
        loss, _, grads = value_and_grad(model, params, batch)
    if layers and calls[0] != n:
        raise RuntimeError(f"{calls[0]} SSD backward calls for {n} layers")
    host = [t.to("cpu") for t in tree_leaves(grads)]
    return float(loss), host, captured


def leaf_gaps(got: list, want: list, device="cuda") -> list[float]:
    """Each leaf's max |got - want| over its largest |want|; ``got`` and
    ``want`` on any device, compared on ``device`` one leaf at a time."""
    out = []
    for a, w in zip(got, want):
        a, w = a.to(device).float(), w.to(device).float()
        out.append(((a - w).abs().max() / w.abs().max().clamp(min=1e-30)).item())
    return out


def f64_errors(inputs: tuple, got: tuple) -> dict:
    """{grad: max |got - f64| / max |f64|} against ``ssd_chunk_bwd_ref`` in
    float64 on the same inputs, F64_TILES chunk tiles at a time."""
    x, a, b, c, dy, dst, dcum = inputs
    err = dict.fromkeys(GRADS, 0.0)
    top = dict.fromkeys(GRADS, 0.0)
    for z in range(0, x.shape[0], F64_TILES):
        s = slice(z, z + F64_TILES)
        want = ref.ssd_chunk_bwd_ref(x[s].double(), a[s].double(), b[s].double(),
                                     c[s].double(), dy[s].double(), dst[s].double(),
                                     None if dcum is None else dcum[s].double())
        for name, gv, wv in zip(GRADS, got, want):
            err[name] = max(err[name], (gv[s].double() - wv).abs().max().item())
            top[name] = max(top[name], wv.abs().max().item())
        del want
    return {k: err[k] / top[k] for k in GRADS}


def run(batches: int = 2) -> list[tuple]:
    model, plain, params, data, dev = setup()
    card = device_name(dev)
    faults = {name: fault_lib(name) for name in FAULTS}
    rows, captured = [], {}
    libs = {"kernel": None, **{f"fault_{name}": lib for name, lib in faults.items()}}
    for i in range(batches):
        batch = to_device(next(data), dev)
        loss_p, g_p, _ = gradient(plain, params, batch)
        for name, lib in libs.items():
            take = LAYERS if i == 0 and lib is None else ()
            with backward_lib(lib) if lib is not None else contextlib.nullcontext():
                loss, grads, got = gradient(model, params, batch, take)
            captured.update(got)
            gaps = leaf_gaps(grads, g_p)
            worst = max(range(len(gaps)), key=gaps.__getitem__)
            rows.append((f"ssd_train_probe.batch{i}.{name}", "",
                         f"loss_gap={abs(loss - loss_p):.6g};grad_leaf_rel={gaps[worst]:.6g};"
                         f"leaf={worst};loss={loss:.6f};device={card}"))
            del grads
        del g_p
    for layer, (inputs, outputs) in sorted(captured.items()):
        backwards = {"kernel": outputs}
        for name, lib in faults.items():
            with backward_lib(lib):
                backwards[f"fault_{name}"] = ssd.ssd_chunk_bwd(*inputs)
        for name, got in backwards.items():
            for gname, e in f64_errors(inputs, got).items():
                rows.append((f"ssd_train_probe.layer{layer}.{name}.{gname}", "",
                             f"rel={e:.6g};device={card}"))
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_train_probe: runs on the card only")
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=2)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(run(args.batches))


if __name__ == "__main__":
    main()
