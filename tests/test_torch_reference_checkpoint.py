"""Resuming in the port from a train state the reference wrote.

The reference trains a reduced model inside the test (``build_train_step``
jitted, one or two steps) and writes ``{"params", "opt"}`` with
``repro.checkpoint.save_checkpoint``, as its trainer does: each per-layer
leaf stacked under one name (``params/layers/<leaf>`` of ``[L, ...]``;
Zamba2's ``blocks`` twice, ``[super-block, layer, ...]``).  The port's
``restore_checkpoint`` reads that layout into its per-layer lists:

  * every restored leaf bit for bit against the reference's state carried
    over with ``params_from_jax`` (float32 and bfloat16 moments; the
    bfloat16 ones as raw bits, which the reference itself cannot restore);
  * one port step from the restored state against the reference's next
    step from its own: the loss to ``rtol=1e-5``, every parameter and
    moment to ``GRAD_TOL`` (``tests/test_torch_train.py``), bfloat16
    moments too;
  * with ``mesh=`` / ``specs=`` on four gloo CPU processes, each rank's
    blocks against the blocks ``steps.local_state`` cuts from a whole
    restore, and ``train.main --mesh`` resuming the reference's directory;
  * a leaf under neither name raises ``KeyError``; ``train.main`` and
    ``serve.main`` with ``--ckpt-dir`` on a directory the reference's
    ``train.main`` wrote.
"""
import dataclasses
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.checkpoint import (restore_checkpoint as jax_restore,
                              save_checkpoint as jax_save)
from repro.configs import get_config as jax_config, reduced as jax_reduced
from repro.launch import steps as jax_steps
from repro.models import get_model as jax_model
import repro_torch.shard as ts
from repro_torch.checkpoint import Checkpointer, restore_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticTokens, shard_batch
from repro_torch.launch import serve, steps, train
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax, reference_name
from repro_torch.optim import AdamWState
from repro_torch.optim.tree import tree_leaves

import lm_dist_ranks as lr

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)
SEQ, BATCH = 20, 2
MOMENTS = {"float32": (torch.float32, jnp.float32),
           "bfloat16": (torch.bfloat16, jnp.bfloat16)}
CASES = [("granite_moe_1b", "float32", 1), ("granite_moe_1b", "bfloat16", 2),
         ("zamba2_12b", "float32", 2), ("zamba2_12b", "bfloat16", 1)]


def _configs(arch, moment):
    tdt, jdt = MOMENTS[moment]
    jcfg = dataclasses.replace(jax_reduced(jax_config(arch)),
                               moment_dtype=jdt)
    cfg = dataclasses.replace(reduced(get_config(arch)), moment_dtype=tdt)
    return jcfg, cfg


def _like(cfg):
    return train._state_like(get_model(cfg), cfg.moment_dtype)


def _ported(tree):
    """A reference tree of numpy-able leaves in the port's layout (CPU)."""
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def _reference_state(arch, moment, n_steps, ckpt_dir):
    """The reference trains ``n_steps`` steps and writes its state at
    ``n_steps``; returns its jitted step, the state and the dataset."""
    jcfg, cfg = _configs(arch, moment)
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jo = jopt.adamw_init(jp, jcfg.moment_dtype)
    jstep = jax.jit(jax_steps.build_train_step(jm, **KW))
    ds = SyntheticTokens(cfg.vocab_size, SEQ, BATCH, seed=1)
    for step in range(n_steps):
        batch = {"tokens": jnp.asarray(ds.batch_at(step)["tokens"])}
        jp, jo, _ = jstep(jp, jo, batch)
    jax_save(ckpt_dir, n_steps, {"params": jp, "opt": jo}, version=1,
             verify=True)
    return jstep, jp, jo, ds


def _flat(tree, path=""):
    """``{path: leaf}`` of a tree of dicts, lists and tensors (the two
    packages order a dict's keys apart)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{path}/{k}"))
    return out


def _pairs(got, exp):
    got, exp = _flat(got), _flat(exp)
    assert got.keys() == exp.keys()
    return [(got[k], exp[k]) for k in sorted(got)]


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("arch,moment,n_steps", CASES)
def test_restore_reference_state_then_step(tmp_path, arch, moment, n_steps):
    d = str(tmp_path / "ckpt")
    jstep, jp, jo, ds = _reference_state(arch, moment, n_steps, d)
    manifest = json.load(open(os.path.join(d, f"step_{n_steps:08d}",
                                           "manifest.json")))
    stacked = [n for n in manifest["leaves"] if n.startswith("params/")
               and n.split("/")[1] in ("layers", "blocks")]
    assert stacked, sorted(manifest["leaves"])[:8]
    _, cfg = _configs(arch, moment)
    state = restore_checkpoint(d, n_steps, _like(cfg), device="cpu",
                               verify=True)
    params, opt = state["params"], state["opt"]
    assert isinstance(opt, AdamWState) and int(opt.step) == n_steps
    for got, exp in ((params, _ported(jp)), (opt.m, _ported(jo.m)),
                     (opt.v, _ported(jo.v))):
        for g, e in _pairs(got, exp):
            assert g.dtype == e.dtype and g.shape == e.shape
            assert torch.equal(_bits(g), _bits(e))
    if moment == "bfloat16":
        assert all(t.dtype == torch.bfloat16 for t in tree_leaves(opt.m))

    batch = ds.batch_at(n_steps)
    jp, jo, jmet = jstep(jp, jo, {"tokens": jnp.asarray(batch["tokens"])})
    tstep = steps.build_train_step(get_model(cfg), **KW)
    params, opt, met = tstep(params, opt, shard_batch(batch, device="cpu"))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    assert int(opt.step) == int(jo.step) == n_steps + 1
    for got, exp in ((params, jp), (opt.m, jo.m), (opt.v, jo.v)):
        for g, e in _pairs(got, _ported(exp)):
            assert g.dtype == e.dtype
            np.testing.assert_allclose(g.float().numpy(), e.float().numpy(),
                                       **GRAD_TOL)


def test_reference_names():
    """The one table ``params_from_jax`` and the restore share."""
    assert reference_name("params/layers/3/attn/wq") == (
        "params/layers/attn/wq", (3,))
    assert reference_name("opt/m/blocks/1/0/mamba/in_proj") == (
        "opt/m/blocks/mamba/in_proj", (1, 0))
    assert reference_name(("opt", "v", "decoder", "2", "cross", "wk")) == (
        "opt/v/decoder/cross/wk", (2,))
    assert reference_name("opt/step") is None
    assert reference_name("params/embed") is None
    assert reference_name("params/shared/attn/wq") is None


def test_missing_leaf_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    _reference_state("granite_moe_1b", "float32", 1, d)
    path = os.path.join(d, "step_00000001", "manifest.json")
    manifest = json.load(open(path))
    name = next(n for n in manifest["leaves"]
                if n.startswith("opt/v/layers/"))
    del manifest["leaves"][name]
    json.dump(manifest, open(path, "w"))
    _, cfg = _configs("granite_moe_1b", "float32")
    port_name = name.replace("opt/v/layers/", "opt/v/layers/0/")
    with pytest.raises(KeyError, match=port_name):
        restore_checkpoint(d, 1, _like(cfg), device="cpu")


def test_restore_on_the_mesh_and_resume_there(tmp_path):
    """Four gloo processes on a (2, 2) mesh: each rank's blocks of a
    restore with ``mesh=`` / ``specs=`` equal the blocks a whole restore
    gives it, for both stacks (granite's layers, zamba2's blocks); and
    ``train.main --mesh`` resumes the reference's directory at its step."""
    dirs = {}
    for arch in ("granite_moe_1b", "zamba2_12b"):
        dirs[arch] = str(tmp_path / arch)
        _reference_state(arch, "float32", 1, dirs[arch])
    resume = str(tmp_path / "resume")
    shutil.copytree(dirs["granite_moe_1b"], resume)
    argv = ["--arch", "granite_moe_1b", "--reduced", "--device", "cpu",
            "--batch", "4", "--seq", "16", "--steps", "2", "--ckpt-dir",
            resume, "--log-every", "100", "--mesh", "single", "--mesh-shape",
            "2x2", "--transport", "gloo"]
    outs = ts.spawn(lr.reference_restore_blocks, 4, device="cpu",
                    transport="gloo", timeout=60.0, join_timeout=300.0,
                    args=(dirs, 1, argv))
    for out in outs:
        for arch, (n, same) in out["blocks"].items():
            assert n > 0 and same == n, (arch, n, same)
        assert out["trainer"]["start"] == 1
        assert len(out["trainer"]["losses"]) == 1
        assert np.isfinite(out["trainer"]["losses"]).all()


def test_train_and_serve_main_from_reference_trainer(tmp_path, capsys,
                                                     monkeypatch):
    """``repro.launch.train`` writes its directory; the port's
    ``serve.main --ckpt-dir`` serves exactly the reference's parameters,
    and ``train.main --ckpt-dir`` resumes at its step."""
    from repro.launch import train as jax_train

    d = str(tmp_path / "ckpt")
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "granite_moe_1b", "--reduced", "--steps", "2",
        "--batch", "2", "--seq", "16", "--ckpt-dir", d, "--log-every", "1"])
    jax_train.main()
    capsys.readouterr()
    jcfg = jax_reduced(jax_config("granite_moe_1b"))
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        {"params": jparams})
    want = _ported(jax_restore(d, 2, like)["params"])

    s = serve.main(["--arch", "granite_moe_1b", "--reduced", "--device",
                    "cpu", "--batch", "2", "--prompt-len", "9", "--gen", "3",
                    "--ckpt-dir", d])
    assert s.ckpt_step == 2
    for g, e in _pairs(s.params, want):
        assert torch.equal(g, e)
    mem = serve.serve(reduced(get_config("granite_moe_1b")), batch=2,
                      prompt_len=9, gen_len=3, device="cpu", params=want)
    assert torch.equal(s.prefill_logits, mem.prefill_logits)

    r = train.main(["--arch", "granite_moe_1b", "--reduced", "--device",
                    "cpu", "--batch", "2", "--seq", "16", "--steps", "3",
                    "--ckpt-dir", d, "--log-every", "1"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert r.start_step == 2 and len(r.losses) == 1
    assert np.isfinite(r.losses).all() and int(r.opt.step) == 3
    step, state = Checkpointer(d).restore_latest(
        train._state_like(get_model(r.cfg), r.cfg.moment_dtype),
        device="cpu")
    assert step == 3    # the port writes its own layout beside it
    for g, e in zip(tree_leaves(state["params"]), tree_leaves(r.params)):
        assert torch.equal(g, e)


def test_chip_smoke_writer_writes_the_reference_layout(tmp_path):
    """``chip_smoke.py``'s own copy of the reference's writer (it imports
    nothing of the reference) writes, from the port's per-layer state,
    the files the reference writes from its stacked state: the same leaf
    names, shapes and dtypes, byte for byte (bfloat16 moments among
    them)."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ref, mine = str(tmp_path / "ref"), str(tmp_path / "mine")
    _reference_state("zamba2_12b", "bfloat16", 1, ref)
    _, cfg = _configs("zamba2_12b", "bfloat16")
    state = restore_checkpoint(ref, 1, _like(cfg), device="cpu")
    cs.save_reference_layout(torch, np, mine, 1, state)
    want = json.load(open(os.path.join(ref, "step_00000001",
                                       "manifest.json")))["leaves"]
    got = json.load(open(os.path.join(mine, "step_00000001",
                                      "manifest.json")))["leaves"]
    assert got.keys() == want.keys()
    for name, entry in want.items():
        e = {k: entry[k] for k in ("file", "shape", "dtype")}
        assert got[name] == e, name
        files = [open(os.path.join(d, "step_00000001", entry["file"]),
                      "rb").read() for d in (ref, mine)]
        assert files[0] == files[1], name
    assert json.load(open(os.path.join(mine, "index.json")))[
        "latest_step"] == 1
