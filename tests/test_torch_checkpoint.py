"""The port's checkpointer against the JAX package's, on the CPU.

* The port's round trip keeps bf16, float32, a 0-dim int32 and e4m3 leaves
  bit for bit, sync and async, in JAX's layout (manifest names, ``||full``
  members, ``nprocs`` 1); uncommitted steps are ignored, ``keep`` removes
  older steps, a step saved again is overwritten, a missing leaf raises
  ``KeyError``, a shape that differs raises ``ValueError``, a stored dtype
  that differs is cast, and a restore in place equals one into new tensors.
* Across frameworks, bit for bit: the port restores what JAX wrote
  synchronously (one member per shard, ``opt_state/step||`` for a 0-dim
  leaf), asynchronously (``||full``) and sharded over 4 host devices in a
  subprocess (``NamedSharding`` over a 4- and a 2x2-device mesh, a
  replicated leaf); JAX restores what the port wrote.
* An async save copies: tensors changed in place right after ``save``
  returns do not reach the disk; an error in the writing thread is raised
  by ``wait``.
* Resume: reduced qwen1.5-0.5b and mamba2-2.7b, 4 steps with a checkpoint,
  a restore into fresh tensors, 4 more, equal to an unbroken 8 under
  ``torch.equal`` (weights, both moments, ``step``, every metric of steps
  5-8). JAX trains 4 steps and saves, then JAX and the port each resume
  from those files for 4 more, and the same with the roles swapped: the
  two restores equal bit for bit; metrics within 1e-4 relative and the
  weights within 2 lr + 1e-6 (``tests/test_torch_training.py``'s limits
  for one step; the largest gap read was 4.9e-7 at lr 1.65e-4), the moments
  within one bf16 step of each leaf's largest entry (bf16 gradient
  compression; readings up to 1.3e-3).
* The launcher killed after step 6 and resumed to 9 writes the same step-9
  checkpoint as an unbroken run; ``train_tiny --kill-at`` ends where an
  unbroken run does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.configs.base import RuntimeConfig as JaxRuntime
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.data import pipeline as jpipe
from repro.models import Model as JaxModel
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import RuntimeConfig
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.models.model import Model, init_params
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
METRIC_TOL, PARAM_TOL, FLIP_SHARE, BF16_STEP = 1e-4, 1e-6, 1e-3, 2.0**-8


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits as integers (torch.equal has no fp8 kernel)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def _equal(a: dict, b: dict) -> bool:
    la, lb = topt.tree_leaves(a), topt.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _tree(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 8, generator=g).to(torch.bfloat16),
                       "b": torch.randn(8, generator=g),
                       "kv": torch.randn(3, 5, generator=g).to(torch.float8_e4m3fn)},
            "opt_state": {"step": torch.tensor(7 + seed, dtype=torch.int32),
                          "m": {"w": torch.randn(4, 8, generator=g)}}}


def _zeros(tree: dict) -> dict:
    return topt.tree_map(lambda t: torch.zeros(t.shape).to(t.dtype), tree)


@pytest.mark.parametrize("async_save", [False, True])
def test_round_trip_keeps_every_dtype_bit_for_bit(tmp_path, async_save):
    tree = _tree()
    ck = Checkpointer(str(tmp_path), async_save=async_save)
    ck.save(10, tree, extra={"data_state": {"step": 3}})
    ck.wait()
    assert ck.latest_step() == 10
    assert _equal(ck.restore(10, _zeros(tree)), tree)
    assert ck.load_extra(10) == {"data_state": {"step": 3}}
    d = Path(ck.step_dir(10))
    assert d.name == "step_000000010"
    assert sorted(p.name for p in d.iterdir()) == ["_COMMITTED", "extra.json",
                                                   "manifest.json", "proc_0.npz"]
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest == {"nprocs": 1, "leaves": {
        "opt_state/m/w": {"shape": [4, 8], "dtype": "float32"},
        "opt_state/step": {"shape": [], "dtype": "int32"},
        "params/b": {"shape": [8], "dtype": "float32"},
        "params/kv": {"shape": [3, 5], "dtype": "float8_e4m3fn"},
        "params/w": {"shape": [4, 8], "dtype": "bfloat16"}}}
    with np.load(d / "proc_0.npz") as z:
        assert sorted(z.files) == [f"{k}||full" for k in sorted(manifest["leaves"])]
        assert z["params/w||full"].dtype == np.uint16 and z["params/kv||full"].dtype == np.uint8


def test_uncommitted_steps_are_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _tree())
    os.remove(os.path.join(ck.step_dir(5), "_COMMITTED"))  # a crash before the commit
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        ck.restore(5, _zeros(_tree()))
    os.makedirs(ck.step_dir(6) + ".tmp")  # a crash mid-write
    ck.save(4, _tree())
    assert ck.latest_step() == 4


def test_keep_removes_older_steps(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save(s, _tree(s))
    assert ck.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == ["step_000000002", "step_000000003"]
    assert _equal(ck.restore(2, _zeros(_tree())), _tree(2))


def test_saving_a_step_again_overwrites_it(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, _tree(0), extra={"n": 0})
    ck.save(3, _tree(1), extra={"n": 1})
    assert _equal(ck.restore(3, _zeros(_tree())), _tree(1))
    assert ck.load_extra(3) == {"n": 1}
    assert sorted(os.listdir(tmp_path)) == ["step_000000003"]


def test_missing_leaf_raises_key_error(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    target = _zeros(_tree())
    target["params"]["extra_leaf"] = torch.zeros(2)
    with pytest.raises(KeyError, match="params/extra_leaf"):
        ck.restore(1, target)


def test_wrong_shape_raises_value_error(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    target = _zeros(_tree())
    target["params"]["w"] = torch.zeros(8, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"params/w.*\(4, 8\).*\(8, 4\)"):
        ck.restore(1, target)


def test_restore_casts_a_stored_dtype_to_the_target_s(tmp_path):
    tree = _tree()
    Checkpointer(str(tmp_path)).save(1, tree)
    target = topt.tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float64), tree)
    got = Checkpointer(str(tmp_path)).restore(1, target)
    for a, b in zip(topt.tree_leaves(got), topt.tree_leaves(tree)):
        assert a.dtype == torch.float64 and torch.equal(a, b.to(torch.float64))


def test_restore_in_place_equals_a_restore_into_new_tensors(tmp_path):
    tree = _tree()
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)
    new = ck.restore(1, _zeros(tree))
    target = _zeros(tree)
    got = ck.restore(1, target, in_place=True)
    assert _equal(got, new) and _equal(target, tree)
    assert all(a is b for a, b in zip(topt.tree_leaves(got), topt.tree_leaves(target)))


def _jax_tree(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"params": {"w": jnp.asarray(rng.normal(size=(4, 8)), jnp.bfloat16),
                       "b": jnp.asarray(rng.normal(size=(8,)), jnp.float32),
                       "kv": jnp.asarray(rng.normal(size=(3, 5)), jnp.float8_e4m3fn)},
            "opt_state": {"step": jnp.asarray(11, jnp.int32),
                          "m": {"w": jnp.asarray(rng.normal(size=(4, 8)), jnp.float32)}}}


def _to_port(jtree: dict) -> dict:
    return jax.tree.map(lambda x: tensor_from_numpy(np.asarray(x), "cpu"), jtree)


@pytest.mark.parametrize("async_save", [False, True])
def test_port_restores_what_jax_wrote(tmp_path, async_save):
    jtree = _jax_tree()
    jck = JaxCheckpointer(str(tmp_path), async_save=async_save)
    jck.save(4, jtree, extra={"data_state": {"step": 4, "seed": 0}})
    jck.wait()
    with np.load(os.path.join(jck.step_dir(4), "proc_0.npz")) as z:
        members = set(z.files)
    if async_save:
        assert "params/w||full" in members and "opt_state/step||full" in members
    else:
        assert "params/w||0:4,0:8" in members and "opt_state/step||" in members
    want = _to_port(jtree)
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 4
    assert _equal(ck.restore(4, _zeros(want)), want)
    assert ck.load_extra(4) == {"data_state": {"step": 4, "seed": 0}}


def test_jax_restores_what_the_port_wrote(tmp_path):
    jtree = _jax_tree(1)
    Checkpointer(str(tmp_path)).save(6, _to_port(jtree))
    got = JaxCheckpointer(str(tmp_path)).restore(6, jax.tree.map(jnp.zeros_like, jtree))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert jnp.array_equal(a.view(jnp.uint8) if a.dtype.itemsize == 1 else a,
                               b.view(jnp.uint8) if b.dtype.itemsize == 1 else b)


SHARDED_SAVE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.checkpoint.checkpointer import Checkpointer

assert jax.device_count() == 4, jax.devices()
line = Mesh(np.array(jax.devices()), ("x",))
grid = Mesh(np.array(jax.devices()).reshape(2, 2), ("a", "b"))
rng = np.random.default_rng(0)
tree = {
    "params": {
        "rows": jax.device_put(jnp.asarray(rng.normal(size=(8, 6)), jnp.float32),
                               NamedSharding(line, P("x"))),
        "grid": jax.device_put(jnp.asarray(rng.normal(size=(4, 6)), jnp.bfloat16),
                               NamedSharding(grid, P("a", "b"))),
        "rep": jax.device_put(jnp.asarray(rng.normal(size=(5,)), jnp.float32),
                              NamedSharding(line, P())),
    },
    "opt_state": {"step": jnp.asarray(9, jnp.int32)},
}
Checkpointer(sys.argv[1]).save(2, tree)
flat = jax.tree_util.tree_flatten_with_path(tree)[0]
np.savez(sys.argv[2], **{"/".join(p.key for p in path): np.asarray(x).view(np.uint16)
                         if x.dtype == jnp.bfloat16 else np.asarray(x) for path, x in flat})
"""


def test_port_reassembles_a_checkpoint_sharded_over_four_devices(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4", OMP_NUM_THREADS="1")
    ckdir, want_path = tmp_path / "ckpt", tmp_path / "want.npz"
    out = subprocess.run([sys.executable, "-c", SHARDED_SAVE, str(ckdir), str(want_path)],
                         env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    ck = Checkpointer(str(ckdir))
    with np.load(os.path.join(ck.step_dir(2), "proc_0.npz")) as z:
        members = sorted(z.files)
    assert sum(m.startswith("params/rows||") for m in members) == 4
    assert sum(m.startswith("params/grid||") for m in members) == 4
    assert [m for m in members if m.startswith("params/rep||")] == ["params/rep||0:5"]
    assert "opt_state/step||" in members and "params/grid||2:4,3:6" in members
    with np.load(want_path) as w:
        want = {"params": {k: torch.from_numpy(w[f"params/{k}"]) for k in ("rows", "rep")},
                "opt_state": {"step": torch.from_numpy(w["opt_state/step"])}}
        want["params"]["grid"] = torch.from_numpy(w["params/grid"]).view(torch.bfloat16)
    assert _equal(ck.restore(2, _zeros(want)), want)


def test_async_snapshot_is_a_copy(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"params": {f"w{i:02d}": torch.randn(512, 512, generator=g) for i in range(16)},
            "opt_state": {"step": torch.tensor(3, dtype=torch.int32)}}
    before = topt.tree_map(torch.clone, tree)
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(1, tree)
    for t in topt.tree_leaves(tree):  # the next step, in place, while the thread writes
        t.add_(1)
    ck.wait()
    assert _equal(ck.restore(1, _zeros(tree)), before)
    assert not _equal(tree, before)


def test_async_save_error_is_raised_by_wait(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    Path(ck.step_dir(2) + ".tmp").write_text("not a directory")
    ck.save(2, _tree())
    with pytest.raises(NotADirectoryError):
        ck.wait()
    ck.wait()  # raised once
    assert ck.latest_step() is None


def _run(model, opt, params, data, steps, start=0, state=None, ckdir=None):
    loop = tloop.TrainLoopConfig(steps=steps, log_every=1, checkpoint_every=4,
                                 checkpoint_dir=ckdir)
    return tloop.run_train_loop(model, opt, loop, data, params=params, opt_state=state,
                                start_step=start)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-2.7b"])
def test_resume_equals_an_unbroken_run(tmp_path, arch):
    cfg = reduced_config(arch)
    model = Model(cfg, runtime=RuntimeConfig(remat="full"))
    opt = topt.OptimizerConfig(warmup_steps=2, total_steps=8)
    data_cfg = tpipe.DataConfig(seq_len=32, global_batch=2, vocab_size=cfg.vocab_size)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p8, s8, h8 = _run(model, opt, topt.tree_map(torch.clone, params),
                      tpipe.SyntheticLM(data_cfg), 8)
    _, _, h4 = _run(model, opt, params, tpipe.SyntheticLM(data_cfg), 4, ckdir=str(tmp_path))
    del params  # the crash
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 4
    fresh = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    tree = ck.restore(4, {"params": fresh, "opt_state": topt.init_opt_state(opt, fresh)})
    data = tpipe.SyntheticLM(data_cfg)
    data.load_state_dict(ck.load_extra(4)["data_state"])
    assert data.step == 4
    p, s, h = _run(model, opt, tree["params"], data, 8, start=4, state=tree["opt_state"])
    assert _equal(p, p8) and _equal(s, s8) and int(s["step"]) == 8
    assert h4 + h == h8  # every metric of steps 1-8, as floats


def _jax_setup(arch: str):
    jcfg = dataclasses.replace(jax_reduced_config(arch), dtype="float32")
    tcfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    jmodel = JaxModel(jcfg, JaxRuntime(remat="none", attn_chunk_q=16, attn_chunk_kv=16))
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    return jmodel, Model(tcfg, runtime=RuntimeConfig(remat="none")), tree, tcfg


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_framework_resumes_the_other_s_checkpoint(tmp_path, writer):
    jmodel, tmodel, tree, tcfg = _jax_setup("qwen1.5-0.5b")
    kw = dict(warmup_steps=2, total_steps=8)
    jcfg, tcfg_opt = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    data_cfg = dict(seq_len=32, global_batch=2, vocab_size=tcfg.vocab_size, seed=3)
    jstep = jax.jit(jloop.make_train_step(jmodel, jcfg), donate_argnums=(0, 1))
    ckdir = str(tmp_path)
    first = dict(steps=4, log_every=1, checkpoint_every=4, checkpoint_dir=ckdir)
    if writer == "jax":
        jloop.run_train_loop(jmodel, jcfg, jloop.TrainLoopConfig(**first),
                             iter(jpipe.SyntheticLM(jpipe.DataConfig(**data_cfg))),
                             params=jax.tree.map(jnp.array, tree), step_fn=jstep)
    else:
        tloop.run_train_loop(tmodel, tcfg_opt, tloop.TrainLoopConfig(**first),
                             tpipe.SyntheticLM(tpipe.DataConfig(**data_cfg)),
                             params=params_from_numpy(tree, tcfg, "cpu"))
    # both frameworks restore the same files into their own fresh trees
    jp0 = jax.tree.map(jnp.asarray, tree)
    jr = JaxCheckpointer(ckdir).restore(4, {"params": jp0,
                                            "opt_state": jopt.init_opt_state(jcfg, jp0)})
    tp0 = params_from_numpy(tree, tcfg, "cpu")
    ck = Checkpointer(ckdir)
    tr = ck.restore(4, {"params": tp0, "opt_state": topt.init_opt_state(tcfg_opt, tp0)})
    assert int(tr["opt_state"]["step"]) == int(jr["opt_state"]["step"]) == 4
    for a, b in zip(topt.tree_leaves(tr), jax.tree.leaves(jr)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    state = ck.load_extra(4)["data_state"]
    assert state == {"step": 4, "seed": 3}
    jdata, tdata = jpipe.SyntheticLM(jpipe.DataConfig(**data_cfg)), tpipe.SyntheticLM(
        tpipe.DataConfig(**data_cfg))
    jdata.load_state_dict(state)
    tdata.load_state_dict(state)
    jp, js, jh = jloop.run_train_loop(jmodel, jcfg, jloop.TrainLoopConfig(steps=8, log_every=1),
                                      jdata, params=jr["params"], opt_state=jr["opt_state"],
                                      start_step=4, step_fn=jstep)
    tp, ts, th = tloop.run_train_loop(tmodel, tcfg_opt, tloop.TrainLoopConfig(
        steps=8, log_every=1), tdata, params=tr["params"], opt_state=tr["opt_state"],
        start_step=4)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [5, 6, 7, 8]
    for t_, j_ in zip(th, jh):
        assert t_.keys() == j_.keys()
        for k in j_:
            assert abs(t_[k] - j_[k]) <= METRIC_TOL * max(abs(j_[k]), 1.0), (t_["step"], k)
    lr = max(h["lr"] for h in jh)
    flips = total = 0
    for a, b in zip(topt.tree_leaves(tp), jax.tree.leaves(jp)):
        gap = np.abs(a.numpy() - np.asarray(b))
        assert gap.max() <= 2 * lr + PARAM_TOL
        flips += int((gap > PARAM_TOL).sum())
        total += gap.size
    assert flips <= FLIP_SHARE * total
    assert int(ts["step"]) == int(js["step"]) == 8
    for key in ("m", "v"):
        for a, b in zip(topt.tree_leaves(ts[key]), jax.tree.leaves(js[key])):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= BF16_STEP * max(np.abs(b).max(), 1e-30), key


class _Killed(Exception):
    pass


def _step_9(ckdir: Path):
    ck = Checkpointer(str(ckdir))
    assert ck.latest_step() == 9
    with np.load(os.path.join(ck.step_dir(9), "proc_0.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, ck.load_extra(9)


def test_launcher_killed_and_resumed_equals_an_unbroken_run(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import train

    argv = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--steps", "9", "--batch", "2",
            "--seq-len", "32", "--checkpoint-every", "3", "--checkpoint-dir"]
    train.main([*argv, str(tmp_path / "unbroken")])
    real_next = tpipe.SyntheticLM.__next__

    def next_or_crash(self):
        if self.step == 6:  # step 6 is saved; the process dies reading batch 7
            raise _Killed
        return real_next(self)

    with monkeypatch.context() as m:
        m.setattr(tpipe.SyntheticLM, "__next__", next_or_crash)
        with pytest.raises(_Killed):
            train.main([*argv, str(tmp_path / "killed")])
    assert Checkpointer(str(tmp_path / "killed")).latest_step() == 6
    capsys.readouterr()
    history = train.main([*argv, str(tmp_path / "killed"), "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 6 (peak memory" in out
    assert [h["step"] for h in history] == [7]
    want, want_extra = _step_9(tmp_path / "unbroken")
    got, got_extra = _step_9(tmp_path / "killed")
    assert got.keys() == want.keys() and got_extra == want_extra == {
        "data_state": {"step": 9, "seed": 0}}
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_train_tiny_resumes_where_an_unbroken_run_ends(tmp_path, capsys):
    from repro_torch.examples import train_tiny

    argv = ["--device", "cpu", "--steps", "56"]
    p, s, _ = train_tiny.main([*argv, "--ckpt", str(tmp_path / "unbroken")])
    capsys.readouterr()
    p2, s2, hist = train_tiny.main([*argv, "--kill-at", "53", "--ckpt", str(tmp_path / "k")])
    out = capsys.readouterr().out
    assert "simulated crash at step 53" in out and "latest committed checkpoint: step 50" in out
    assert hist[0]["step"] == 51
    assert _equal(p2, p) and _equal(s2, s)
