"""The port's training path against the JAX package's, on the CPU.

The same weights (a JAX ``Model.init`` tree with seeded norms and biases,
carried across bit for bit by ``params_from_numpy``) and the same
numpy-seeded batches go through both frameworks, float32 reduced configs:

* ``Model.loss_fn`` and every gradient leaf against JAX's
  ``jax.value_and_grad(loss_fn)`` for olmo-1b and qwen1.5-0.5b (qkv bias,
  tied embeddings), llama3.1-8b (GQA), arctic-480b (MoE: the load-balance
  aux loss, summed over layers, enters the loss), internvl2-26b and
  musicgen-large (the stub frontends), mamba2-2.7b and Jamba (on the CPU
  the plain ``ssd_chunk`` trains); and with a ``loss_mask``.
* One ``make_train_step`` for AdamW, Lion and SGD, gradient compression
  none and bf16, ``accum_steps`` 1 and 2, against JAX's step on loss,
  ``grad_norm``, ``lr`` and the updated weights.
* The remat policies none, full and dots give the same gradients, and a
  short ``run_train_loop`` follows JAX's history.
* The launcher's refusal of a ``--mesh`` that is not DxM of positive
  integers (training under a mesh: ``test_torch_train_mesh.py``); its
  checkpoint flags, which are now taken, and the loop's refusal of a
  checkpoint directory with a data iterator that has no state to save.
* ``ssd_chunk``'s kernel route under autograd (``ops.SsdChunk``), its two
  kernels stood in for by their plain versions: one forward and one
  backward launch, gradients equal to plain autograd's, and ``mode="kernel"``
  refused for a tensor on the CPU.

Tolerances: the loss within 1e-5 and each gradient leaf within 1e-4 of its
largest entry (the largest difference seen was 1.1e-5 of it, in Jamba's MoE
and SSM layers); the step's loss, grad norm and lr within 1e-5 relative;
the updated weights within 1e-6, except that AdamW's and Lion's first update
is about lr * sign(g): a near-zero gradient entry whose sign (or zero)
differs between the frameworks moves that weight by up to 2 lr. Those
entries are counted and printed, and must stay under 0.1 % of the weights.
The optimizer's moments within 1e-4 of each leaf's largest entry, or, with
bf16 gradient compression, within one bf16 step of it (2**-8): a gradient
entry that the two frameworks round to neighbouring bf16 values moves its
moment by that much (readings up to 1.6e-3).
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RuntimeConfig as JaxRuntime
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.data import pipeline as jpipe
from repro.models import Model as JaxModel
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.configs.base import RuntimeConfig
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops
from repro_torch.models.model import Model
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

torch.set_num_threads(1)

ARCHS = ["olmo-1b", "qwen1.5-0.5b", "llama3.1-8b", "arctic-480b", "internvl2-26b",
         "musicgen-large", "mamba2-2.7b", "jamba-1.5-large-398b"]
JAX_RT = JaxRuntime(remat="none", attn_chunk_q=16, attn_chunk_kv=16)
B, S = 2, 40
LOSS_TOL, GRAD_TOL, STEP_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-5, 1e-6
BF16_STEP = 2.0**-8
FLIP_SHARE = 1e-3


def _randomize_norms_and_biases(tree, rng, path=""):
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}"
        if isinstance(v, dict):
            out[k] = _randomize_norms_and_biases(v, rng, p)
        elif "ln" in p or k.startswith("b"):
            noise = rng.normal(scale=0.1, size=v.shape).astype(np.float32)
            out[k] = (1.0 if "ln" in p else 0.0) + noise
        else:
            out[k] = v
    return out


def _setup(arch: str, remat: str = "full"):
    jcfg = dataclasses.replace(jax_reduced_config(arch), dtype="float32")
    tcfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    jmodel = JaxModel(jcfg, JAX_RT)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    tree = _randomize_norms_and_biases(tree, np.random.default_rng(1))
    tmodel = Model(tcfg, runtime=RuntimeConfig(remat=remat))
    return jmodel, tree, tmodel, params_from_numpy(tree, tcfg, "cpu")


def _batch(cfg, b: int = B, seed: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    s = S - cfg.n_frontend_tokens if cfg.frontend == "vision_stub" else S
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.frontend == "audio_stub":
        return {"frame_embeds": rng.standard_normal((b, S, cfg.d_model), dtype=np.float32),
                "labels": labels}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": labels}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = rng.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model),
                                                    dtype=np.float32)
    return batch


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaf_gaps(got: dict, want) -> list[float]:
    """Each gradient leaf's max |difference| over its largest |entry|, in
    JAX's leaf order (the port's ``tree_leaves`` order is the same)."""
    out = []
    for a, b in zip(topt.tree_leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b, np.float32)
        out.append(np.abs(a.float().numpy() - b).max() / max(np.abs(b).max(), 1e-30))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    jmodel, tree, tmodel, tparams = _setup(arch)
    batch = _batch(jmodel.cfg)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, tree), _jax(batch))
    tl, taux, tg = tloop.value_and_grad(tmodel, tparams, tloop.to_device(batch, "cpu"))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    for k in ("lm_loss", "load_balance_loss"):
        assert abs(float(taux[k]) - float(jaux[k])) <= LOSS_TOL, k
    if jmodel.cfg.moe.enabled:
        assert float(taux["load_balance_loss"]) > 0
    assert len(topt.tree_leaves(tg)) == len(jax.tree.leaves(jg))
    assert max(_leaf_gaps(tg, jg)) <= GRAD_TOL


def test_loss_mask_matches_jax():
    jmodel, tree, tmodel, tparams = _setup("llama3.1-8b")
    batch = _batch(jmodel.cfg)
    batch["loss_mask"] = (np.random.default_rng(3).random((B, S)) < 0.6).astype(np.float32)
    (jl, _), jg = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, tree), _jax(batch))
    tl, _, tg = tloop.value_and_grad(tmodel, tparams, tloop.to_device(batch, "cpu"))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    assert max(_leaf_gaps(tg, jg)) <= GRAD_TOL


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("compression", ["none", "bf16"])
@pytest.mark.parametrize("name", ["adamw", "lion", "sgd"])
def test_train_step_matches_jax(name, compression, accum):
    jmodel, tree, tmodel, tparams = _setup("olmo-1b")
    kw = dict(name=name, grad_compression=compression, warmup_steps=2, total_steps=50)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    batch = _batch(jmodel.cfg, b=4)
    jparams = jax.tree.map(jnp.asarray, tree)
    jp, jstate, jm = jax.jit(jloop.make_train_step(jmodel, jcfg, accum))(
        jparams, jopt.init_opt_state(jcfg, jparams), _jax(batch))
    tp, tstate, tm = tloop.make_train_step(tmodel, tcfg, accum)(
        tparams, topt.init_opt_state(tcfg, tparams), tloop.to_device(batch, "cpu"))
    assert set(tm) == set(jm)
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= STEP_TOL * max(abs(float(jm[k])), 1.0), k
    assert int(tstate["step"]) == int(jstate["step"]) == 1
    lr = float(jm["lr"])
    flips = total = 0
    for a, b in zip(topt.tree_leaves(tp), jax.tree.leaves(jp)):
        gap = np.abs(a.numpy() - np.asarray(b))
        assert gap.max() <= 2 * lr + PARAM_TOL
        flips += int((gap > PARAM_TOL).sum())
        total += gap.size
    print(f"{name}, compression {compression}, accum {accum}: {flips} of {total} weights "
          f"moved apart by a near-zero gradient of another sign (lr {lr:.3g})")
    assert flips <= FLIP_SHARE * total
    moment_tol = BF16_STEP if compression == "bf16" else GRAD_TOL
    for key in ("m", "v"):
        if key in jstate:
            assert max(_leaf_gaps(tstate[key], jstate[key])) <= moment_tol, key


@pytest.mark.parametrize("arch", ["olmo-1b", "arctic-480b", "jamba-1.5-large-398b"])
def test_remat_policies_give_the_same_gradients(arch):
    jmodel, _, tmodel, tparams = _setup(arch, remat="none")
    batch = tloop.to_device(_batch(jmodel.cfg), "cpu")
    want_l, want_aux, want = tloop.value_and_grad(tmodel, tparams, batch)
    for remat in ("full", "dots"):
        model = Model(tmodel.cfg, runtime=RuntimeConfig(remat=remat))
        loss, aux, got = tloop.value_and_grad(model, tparams, batch)
        assert float(loss) == float(want_l) and float(aux["load_balance_loss"]) == float(
            want_aux["load_balance_loss"]), remat
        for a, b in zip(topt.tree_leaves(got), topt.tree_leaves(want)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_unknown_remat_raises():
    _, _, _, tparams = _setup("olmo-1b")
    model = Model(reduced_config("olmo-1b"), runtime=RuntimeConfig(remat="some"))
    with pytest.raises(ValueError, match="remat"):
        tloop.value_and_grad(model, tparams, tloop.to_device(_batch(model.cfg), "cpu"))


def test_run_train_loop_follows_jax_history():
    jmodel, tree, tmodel, tparams = _setup("olmo-1b")
    kw = dict(warmup_steps=2, total_steps=20)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    data = dict(seq_len=S, global_batch=4, vocab_size=jmodel.cfg.vocab_size, seed=3)
    jdata = iter(jpipe.SyntheticLM(jpipe.DataConfig(**data)))
    tdata = iter(tpipe.SyntheticLM(tpipe.DataConfig(**data)))
    _, _, jhist = jloop.run_train_loop(
        jmodel, jcfg, jloop.TrainLoopConfig(steps=6, log_every=2),
        map(_jax, jdata), params=jax.tree.map(jnp.array, tree))
    _, _, thist = tloop.run_train_loop(
        tmodel, tcfg, tloop.TrainLoopConfig(steps=6, log_every=2), tdata, params=tparams)
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [1, 2, 4, 6]
    for th, jh in zip(thist, jhist):
        assert th.keys() == jh.keys()
        for k in jh:
            assert abs(th[k] - jh[k]) <= 1e-4 * max(abs(jh[k]), 1.0), (th["step"], k)


def test_loop_refuses_a_checkpoint_directory_and_missing_params(tmp_path):
    """A checkpoint directory is refused only with a data iterator that has
    no state to save (the checkpointer itself: tests/test_torch_checkpoint.py)."""
    _, _, tmodel, tparams = _setup("olmo-1b")
    cfg = topt.OptimizerConfig()
    data = iter(tpipe.SyntheticLM(tpipe.DataConfig(seq_len=8, global_batch=2, vocab_size=256)))
    with pytest.raises(TypeError, match="state_dict"):
        tloop.run_train_loop(tmodel, cfg, tloop.TrainLoopConfig(
            steps=1, checkpoint_dir=str(tmp_path)), map(dict, [next(data)]), params=tparams)
    with pytest.raises(ValueError, match="params"):
        tloop.run_train_loop(tmodel, cfg, tloop.TrainLoopConfig(steps=1), data)


@pytest.mark.parametrize("argv,item", [
    (["--mesh", "2x"], "DxM of positive integers"),
])
def test_launcher_refuses_what_is_not_ported(argv, item):
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match=item):
        train.main(["--smoke", "--device", "cpu", *argv])


@pytest.mark.parametrize("flags,said", [
    (["--checkpoint-dir"], ""),
    (["--resume", "--checkpoint-dir"], "nothing to resume"),
])
def test_launcher_takes_the_checkpoint_flags(tmp_path, capsys, flags, said):
    """Once refused naming queue 1 item 4: --checkpoint-dir saves every
    --checkpoint-every steps (keeping 2), --resume over an empty directory
    says so and starts at step 0, as JAX's launcher does."""
    from repro_torch.launch import train

    history = train.main(["--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
                          "--seq-len", "16", "--checkpoint-every", "1", *flags,
                          str(tmp_path)])
    assert [h["step"] for h in history] == [1]
    assert sorted(os.listdir(tmp_path)) == ["step_000000003", "step_000000004"]
    assert said in capsys.readouterr().out


def test_launcher_trains_the_reduced_config_on_the_cpu(tmp_path):
    from repro_torch.launch import train

    hb = tmp_path / "heartbeat"
    history = train.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--steps", "6",
                          "--batch", "2", "--seq-len", "32", "--heartbeat-file", str(hb)])
    assert [h["step"] for h in history] == [1, 5]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in history)
    assert hb.read_text().split()[1] == "5"


def test_ssd_chunk_under_autograd_on_the_card_raises(monkeypatch):
    """The kernel route under autograd (as for a tensor on the card) goes
    through ops.SsdChunk: with the forward and backward kernels stood in for
    by their plain versions it calls each once, and its gradients, B and C
    group-shaped or expanded over the heads with stride 0, equal plain
    autograd's. ``mode="kernel"`` on a CPU tensor still raises: no fallback."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as ssd

    calls = {"fwd": 0, "bwd": 0}

    def fwd(*args, **kw):
        calls["fwd"] += 1
        return ref.ssd_chunk_ref(*args, **kw)

    def bwd(*args):
        calls["bwd"] += 1
        return ref.ssd_chunk_bwd_ref(*args)

    rng = np.random.default_rng(7)
    x0, a0 = rng.standard_normal((2, 32, 4, 8)), -rng.random((2, 32, 4)) * 0.5
    b0, c0 = rng.standard_normal((2, 32, 1, 16)), rng.standard_normal((2, 32, 1, 16))
    dy, dst = rng.standard_normal((2, 32, 4, 8)), rng.standard_normal((2, 4, 16, 8))
    dcum = rng.standard_normal((2, 32, 4))
    t = [torch.tensor(v, dtype=torch.float32) for v in (x0, a0, b0, c0, dy, dst, dcum)]

    def grads(route: bool, expand: bool):
        leaves = [v.clone().requires_grad_(True) for v in t[:4]]
        b, c = leaves[2:]
        if expand:
            b, c = b.expand(-1, -1, 4, -1), c.expand(-1, -1, 4, -1)
        with monkeypatch.context() as m:
            if route:
                m.setattr(ops, "use_kernel", lambda t, mode: True)
                m.setattr(ssd, "ssd_chunk", fwd)
                m.setattr(ssd, "ssd_chunk_bwd", bwd)
            y, st, cum = ops.ssd_chunk(leaves[0], leaves[1], b, c, return_cum=True)
            ((y * t[4]).sum() + (st * t[5]).sum() + (cum * t[6]).sum()).backward()
        return [v.grad for v in leaves]

    for expand in (False, True):
        got, want = grads(True, expand), grads(False, expand)
        for g_, w_ in zip(got, want):
            assert float((g_ - w_).abs().max() / w_.abs().max()) <= GRAD_TOL
    assert calls == {"fwd": 2, "bwd": 2}
    with pytest.raises(ValueError, match="on the card"):
        ops.ssd_chunk(t[0].requires_grad_(True), t[1], t[2], t[3], mode="kernel")


def test_quickstart_trains_a_step_then_decodes_on_the_cpu():
    from repro_torch.examples import quickstart

    out = quickstart.main(["--device", "cpu"])
    assert len(out) == 9
