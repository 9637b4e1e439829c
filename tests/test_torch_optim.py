"""The port's optimizer, schedule, gradient compression, data pipeline,
checkpoint leaves and train step against the reference on the CPU.

AdamW against ``repro.optim.adamw_update`` with float32, bfloat16 and
float8_e5m2 moments, clipping active and a stacked leaf: the global norm
sums its leaves in another order, so rtol = atol = 1e-5; the moment casts
themselves are bit-equal on equal float32 inputs.  ``warmup_cosine`` and
``compress_grads`` on the same inputs; ``SyntheticTokens.batch_at`` bit
for bit; bfloat16 / float8 checkpoint leaves written byte for byte as the
reference writes them; one and three ``build_train_step`` steps against
the reference's jitted step.
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config as jax_config, reduced as jax_reduced
from repro.data import SyntheticTokens as JaxTokens
from repro.launch import steps as jax_steps
from repro.models import get_model as jax_model
from repro import optim as jopt
from repro_torch import optim as topt
from repro_torch.checkpoint import (Checkpointer, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticTokens, shard_batch
from repro_torch.launch import steps
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.tree import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-5)
MOMENTS = {"float32": (torch.float32, jnp.float32),
           "bfloat16": (torch.bfloat16, jnp.bfloat16),
           "float8_e5m2": (torch.float8_e5m2, jnp.float8_e5m2)}


def _np(x):
    """A torch or JAX leaf as float32 numpy (bf16 and float8 exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tree(seed, param_dtype):
    """A stacked leaf (ndim 3: updated slice by slice), a matrix, a vector;
    gradients scaled so the global norm is far above the clip norm."""
    rng = np.random.default_rng(seed)
    shapes = {"stack": (4, 8, 6), "w": (6, 5), "b": (7,)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         shapes.items()}
    g = {k: (rng.standard_normal(s) * 3).astype(np.float32) for k, s in
         shapes.items()}
    tp = {k: torch.from_numpy(v).to(param_dtype) for k, v in p.items()}
    jp = {k: jnp.asarray(_np(v)).astype(jnp.bfloat16
                                         if param_dtype == torch.bfloat16
                                         else jnp.float32)
          for k, v in tp.items()}
    return tp, jp, {k: torch.from_numpy(v) for k, v in g.items()}, \
        {k: jnp.asarray(v) for k, v in g.items()}


@pytest.mark.parametrize("moment", list(MOMENTS))
def test_adamw_matches_reference(moment):
    tdt, jdt = MOMENTS[moment]
    param_dtype = torch.float32 if moment == "float32" else torch.bfloat16
    tp, jp, tg, jg = _tree(1, param_dtype)
    ts, js = topt.adamw_init(tp, tdt), jopt.adamw_init(jp, jdt)
    assert float(topt.global_norm(tg)) > 10.0  # clipping is active
    np.testing.assert_allclose(float(topt.global_norm(tg)),
                               float(jopt.adamw.global_norm(jg)), rtol=1e-6)
    for step in range(3):
        lr = 1e-2 * (step + 1)
        tp, ts = topt.adamw_update(tg, ts, tp, lr=lr)
        jp, js = jopt.adamw_update(jg, js, jp, lr=lr)
        assert int(ts.step) == int(js.step) == step + 1
        for k in tp:
            assert tp[k].dtype == param_dtype and ts.m[k].dtype == tdt
            np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **TOL)
            np.testing.assert_allclose(_np(ts.m[k]), _np(js.m[k]), **TOL)
            np.testing.assert_allclose(_np(ts.v[k]), _np(js.v[k]), **TOL)
        tg = {k: v * -0.5 for k, v in tg.items()}
        jg = {k: v * -0.5 for k, v in jg.items()}


@pytest.mark.parametrize("moment", ["bfloat16", "float8_e5m2"])
def test_moment_casts_bit_equal(moment):
    """The cast on store: equal float32 values round to the same bits
    (half to even, subnormals, the largest finite value and past it)."""
    tdt, jdt = MOMENTS[moment]
    rng = np.random.default_rng(4)
    x = np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.integers(-8, 5, 4096),
        [0.0, -0.0, 57344.0, 61440.0, 3.0e38, 1e-7, 2.0 ** -17, 1.5 * 2 ** -16,
         1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8]]).astype(np.float32)
    got = torch.from_numpy(x).to(tdt)
    exp = np.asarray(jnp.asarray(x).astype(jdt))
    int_t = torch.int16 if moment == "bfloat16" else torch.int8
    np.testing.assert_array_equal(got.view(int_t).numpy(),
                                  exp.view(np.int16 if moment == "bfloat16"
                                           else np.int8))


def test_warmup_cosine_matches_reference():
    kw = dict(peak_lr=1e-3, warmup_steps=10, total_steps=100)
    got = topt.warmup_cosine(torch.arange(120), **kw).numpy()
    exp = np.array([float(jopt.warmup_cosine(s, **kw)) for s in range(120)])
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=0)
    assert got[0] == 0.0 and abs(got[10] - 1e-3) < 1e-9
    assert got[99] < got[50] < got[10] and got[119] == got[100]


def test_compress_grads_matches_reference():
    """Error feedback over five steps (the residual carried), the int8 grid
    and range, and no gradient lost: the dequantised sum plus the last
    residual is the true sum."""
    rng = np.random.default_rng(5)
    grads = [{"w": rng.standard_normal((16, 8)).astype(np.float32),
              "b": (rng.standard_normal(8) * 1e-3).astype(np.float32)}
             for _ in range(5)]
    ts = topt.compress_init({k: torch.from_numpy(v)
                             for k, v in grads[0].items()})
    js = jopt.compress_init({k: jnp.asarray(v) for k, v in grads[0].items()})
    total_q = {k: 0.0 for k in grads[0]}
    for g in grads:
        tq, ts = topt.compress_grads(
            {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        jq, js = jopt.compress_grads({k: jnp.asarray(v)
                                      for k, v in g.items()}, js)
        for k in g:
            np.testing.assert_allclose(tq[k].numpy(), np.asarray(jq[k]),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(ts.residual[k].numpy(),
                                       np.asarray(js.residual[k]),
                                       rtol=1e-6, atol=1e-9)
            total_q[k] = total_q[k] + tq[k].numpy()
    for k in grads[0]:  # sum of dq + the last residual = sum of the grads
        np.testing.assert_allclose(total_q[k] + ts.residual[k].numpy(),
                                   sum(g[k] for g in grads), rtol=1e-5,
                                   atol=1e-6)
    dq, err = topt.compress.quant_dequant(torch.tensor([2.0, -1.0, 0.5, 0.0]))
    q = dq / (2.0 / 127.0)
    assert torch.equal(q.round(), torch.tensor([127.0, -64.0, 32.0, 0.0]))
    assert float((dq + err - torch.tensor([2.0, -1.0, 0.5, 0.0])).abs().max()
                 ) < 1e-6


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (3, 12345)])
def test_batch_at_bit_equal(seed, step):
    kw = dict(vocab_size=49408, seq_len=33, global_batch=3, seed=seed)
    got = SyntheticTokens(**kw).batch_at(step)["tokens"]
    exp = JaxTokens(**kw).batch_at(step)["tokens"]
    assert got.dtype == exp.dtype and np.array_equal(got, exp)
    t = shard_batch({"tokens": got}, device="cpu")["tokens"]
    assert t.dtype == torch.int32 and np.array_equal(t.numpy(), got)
    # on a mesh, the rows of this process's block: 3 rows split over a
    # data axis of 3 (model 1), this process at data index 1
    mesh = types.SimpleNamespace(axis_names=("data", "model"), shape=(3, 1),
                                 coords={"data": 1, "model": 0},
                                 device=torch.device("cpu"))
    rows = shard_batch({"tokens": got}, mesh=mesh)
    assert np.array_equal(rows["tokens"].numpy(), got[1:2])
    assert tuple(rows.shardings["tokens"].spec) == (("data", "model"), None)


def test_checkpoint_bf16_and_float8_leaves_as_the_reference(tmp_path):
    """Raw bits under the reference's descr ('<V2' bf16, '<f1' float8) and
    dtype names: the files and manifests of both packages are equal, and
    the port restores its own and the reference's bit for bit."""
    g = torch.Generator().manual_seed(0)
    tree = {"p": torch.randn((3, 4), generator=g).bfloat16(),
            "m": (torch.randn(5, generator=g) * 100).to(torch.float8_e5m2),
            "n": torch.arange(3, dtype=torch.int32),
            "step": torch.zeros((), dtype=torch.int32)}
    jtree = {"p": jnp.asarray(_np(tree["p"])).astype(jnp.bfloat16),
             "m": jnp.asarray(_np(tree["m"])).astype(jnp.float8_e5m2),
             "n": jnp.arange(3, dtype=jnp.int32),
             "step": jnp.zeros((), jnp.int32)}
    mine, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    m = save_checkpoint(mine, 1, tree, version=1, verify=True)
    jm = jax_save(ref, 1, jtree, version=1, verify=True)
    assert m["leaves"] == jm["leaves"]
    assert m["leaves"]["p"]["dtype"] == "bfloat16"
    assert m["leaves"]["m"]["dtype"] == "float8_e5m2"
    for name in tree:
        f = f"step_00000001/{name}.npy"
        with open(os.path.join(mine, f), "rb") as a, \
                open(os.path.join(ref, f), "rb") as b:
            assert a.read() == b.read()
    for d in (mine, ref):
        out = restore_checkpoint(d, 1, tree, device="cpu", verify=True)
        for k, v in tree.items():
            assert out[k].dtype == v.dtype and out[k].shape == v.shape
            assert torch.equal(out[k].float(), v.float())
    ck = Checkpointer(str(tmp_path / "async"))
    ck.save(2, {"params": tree}, blocking=False)
    ck.wait()
    step, out = ck.restore_latest({"params": {"p": tree["p"]}},
                                  device="cpu")
    assert step == 2 and set(out["params"]) == {"p"}
    assert torch.equal(out["params"]["p"].view(torch.int16),
                       tree["p"].view(torch.int16))


@pytest.mark.parametrize("arch", ["granite_moe_1b", "mamba2_780m"])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_matches_reference(arch, n_steps):
    """build_train_step against the reference's jitted step (no warm-up, so
    the first step moves the parameters): losses, step counter, moments
    and the parameters' change from their initial values, each leaf to a
    tolerance scaled by its own largest reference value.  The moments to
    rtol 1e-4 and an atol of 1e-4 of the leaf's largest moment (clipped
    gradients make v about 1e-7, so no fixed atol would see it).  AdamW
    divides each gradient element by its own RMS, so where an element is a
    near-cancelling sum (a few of the 1e5, in expert stacks) f32
    reassociation moves its step by a few percent of lr: every element of
    the change is held to 5% of the leaf's largest change, and all but a
    thousandth of each leaf's elements to rtol 1e-4 and an atol of 1e-3 of
    that largest change, well below the weight-decay term (about 7e-3 of
    it), so a step without weight decay fails."""
    kw = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    jcfg = jax_reduced(jax_config(arch))
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jo = jopt.adamw_init(jp, jcfg.moment_dtype)
    jstep = jax.jit(jax_steps.build_train_step(jm, **kw))
    cfg = reduced(get_config(arch))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    p0 = tree_leaves(tp)
    to = topt.adamw_init(tp, cfg.moment_dtype)
    tstep = steps.build_train_step(get_model(cfg), **kw)
    ds = SyntheticTokens(cfg.vocab_size, 20, 2, seed=1)
    for step in range(n_steps):
        batch = ds.batch_at(step)
        jp, jo, jmet = jstep(jp, jo, {"tokens": jnp.asarray(batch["tokens"])})
        tp, to, tmet = tstep(tp, to, shard_batch(batch, device="cpu"))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                                   rtol=1e-6)
    assert int(to.step) == int(jo.step) == n_steps

    def ref(tree):
        return tree_leaves(params_from_jax(jax.tree.map(np.asarray, tree),
                                           device="cpu"))

    for got, exp in ((tree_leaves(to.m), ref(jo.m)),
                     (tree_leaves(to.v), ref(jo.v))):
        assert len(got) == len(exp)
        for g, e in zip(got, exp):
            e = e.numpy()
            np.testing.assert_allclose(g.numpy(), e, rtol=1e-4,
                                       atol=1e-4 * np.abs(e).max())
    got, exp = tree_leaves(tp), ref(jp)
    assert len(got) == len(exp) == len(p0)
    for g, e, p in zip(got, exp, p0):
        dg, de = (g - p).numpy(), (e - p).numpy()
        top = np.abs(de).max()
        assert top > 0
        np.testing.assert_allclose(dg, de, rtol=0, atol=0.05 * top)
        off = np.abs(dg - de) > 1e-4 * np.abs(de) + 1e-3 * top
        assert off.sum() <= 1e-3 * off.size, (g.shape, int(off.sum()))
