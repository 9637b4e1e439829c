"""LM sharding on a (data, model) mesh of processes (``launch.mesh``,
``models.sharding_ctx``, the expert-parallel MoE, the sharded train step,
``shard_batch(mesh=)``, the checkpoint's mesh paths, ``train --mesh`` and
the dry run) against the reference.

The layouts are checked in this process against the reference's own
functions on stand-in meshes of the production sizes (its
``NamedSharding`` swapped for the bare spec): every arch's parameter,
moment, batch and cache specs on (16, 16), (2, 16, 16) and (2, 2), leaf
for leaf (the reference's stacked axes dropped: the port keeps per-layer
lists), and ``constrain``'s resolved specs.  Everything that runs on a
mesh runs in four gloo processes on the CPU (``shard.spawn``; the rank
bodies are in ``tests/lm_dist_ranks.py``, which imports no JAX) and is
held against the reference's program on four placeholder devices
(``conftest.run_multidevice``, one JAX subprocess writing a pickle):

  * ``moe_shard_map`` at capacity 1.25 (pairs drop) and 8, batch 4 (the
    ``gather_model`` branch) and 2: outputs, load-balance loss and the
    gradients of every input to 1e-5; at capacity 8 the outputs also
    against the dense path to 1e-4;
  * three sharded train steps of reduced granite_moe_1b (capacity 1.25)
    and qwen3_32b at batch 4 and 2 against the reference's jitted step
    under ``sharding_context(full_batch=True)``, to the per-leaf criteria
    of ``test_torch_optim.py::test_train_step_matches_reference``;
  * each process's batch rows and restored checkpoint blocks against the
    reference's addressable shards.

A mesh save is byte-equal to a one-process save, ``train.main --mesh``
resumes a one-process checkpoint and the reverse (qwen3_32b, whose mesh
step is the one-process step), and the dry run's counted bytes match a
count worked out from the layouts.
"""
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.mesh as jmesh
import repro.launch.steps as jsteps
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.configs import shapes_for as jshapes_for
from repro.models import get_model as jax_model
from repro.models import input_specs
from repro.models import moe as JM
from repro.models import sharding_ctx as jctx
from repro.optim import adamw_init as jadamw_init

import repro_torch.shard as ts
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.launch import dryrun, mesh as meshlib, steps, train
from repro_torch.models import get_model, param_shapes
from repro_torch.models import moe as TM
from repro_torch.models import sharding_ctx as tctx
from repro_torch.models.convert import STACKED
from repro_torch.optim.tree import tree_leaves

import lm_dist_ranks as lr
from conftest import run_multidevice

MESHES = [(16, 16), (2, 16, 16), (2, 2)]
TRAIN_CASES = [("granite_moe_1b", None, 4), ("granite_moe_1b", None, 2),
               ("qwen3_32b", None, 4), ("qwen3_32b", None, 2)]
MOE_CASES = [(4, 1.25), (2, 1.25), (4, 8.0), (2, 8.0)]
MOE_CFG = dict(num_experts=4, top_k=2, d_ff=64, d_model=32)
JOIN = 240.0
TIMEOUT = 60.0

REF_SCRIPT = r'''
import dataclasses, os, pickle
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced
from repro.checkpoint import save_checkpoint, restore_checkpoint
from repro.data import SyntheticTokens
from repro.launch import mesh as meshlib, steps as steplib
from repro.models import get_model
from repro.models.moe import _moe_dense, _moe_shard_map, init_moe
from repro.models.sharding_ctx import sharding_context
from repro.optim import adamw_init

OUT, CKPT = %(out)r, %(ckpt)r
TRAIN_CASES, MOE_CASES, MOE_CFG = %(train)r, %(moe)r, %(moe_cfg)r
SEQ, KW = %(seq)r, %(kw)r
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
npt = lambda t: jax.tree.map(np.asarray, t)
coords = {d.id: (i, j) for i, row in enumerate(mesh.devices)
          for j, d in enumerate(row)}
def shards(a):
    return {coords[s.device.id]: np.asarray(s.data)
            for s in a.addressable_shards}
res = {"p0": {}, "train": {}, "moe": {}, "batch": {}}

for arch, cap, b in TRAIN_CASES:
    cfg = reduced(get_config(arch))
    if cap is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cap)
    m = get_model(cfg)
    p = m.init(jax.random.PRNGKey(0))
    o = adamw_init(p, cfg.moment_dtype)
    res["p0"][arch] = npt(p)
    ds = SyntheticTokens(cfg.vocab_size, SEQ, b, seed=1)
    losses = []
    with mesh, sharding_context(mesh, full_batch=True):
        psh, osh = steplib.train_state_shardings(
            m, mesh, jax.eval_shape(lambda: p), jax.eval_shape(lambda: o))
        p, o = jax.device_put(p, psh), jax.device_put(o, osh)
        step = jax.jit(steplib.build_train_step(m, **KW))
        for i in range(3):
            batch = {"tokens": jnp.asarray(ds.batch_at(i)["tokens"])}
            bsh = meshlib.batch_shardings(jax.eval_shape(lambda: batch),
                                          mesh, full_batch=True)
            p, o, met = step(p, o, jax.device_put(batch, bsh))
            losses.append(float(met["loss"]))
    res["train"][(arch, cap, b)] = {"losses": losses, "step": int(o.step),
                                    "params": npt(p), "m": npt(o.m),
                                    "v": npt(o.v)}

for b, cap in MOE_CASES:
    cfg = dataclasses.replace(reduced(get_config("granite_moe_1b")),
                              capacity_factor=cap, **MOE_CFG)
    key = jax.random.PRNGKey(b)
    p = jax.tree.map(lambda x: x.astype(jnp.float32), init_moe(key, cfg))
    x = jax.random.normal(jax.random.fold_in(key, 1), (b, 8, 32))
    w = jax.random.normal(jax.random.fold_in(key, 2), (b, 8, 32))
    def loss(p, x, fn):
        o, a = fn(p, x)
        return jnp.sum(o * w) + a, (o, a)
    sm = lambda p, x: _moe_shard_map(p, x, cfg, mesh)
    dn = lambda p, x: _moe_dense(p, x, cfg)
    with mesh, sharding_context(mesh, full_batch=True):
        (_, (o, a)), (gp, gx) = jax.jit(jax.value_and_grad(
            lambda p, x: loss(p, x, sm), argnums=(0, 1), has_aux=True))(p, x)
    do, da = dn(p, x)
    res["moe"][(b, cap)] = {"p": npt(p), "x": np.asarray(x),
                            "w": np.asarray(w), "out": np.asarray(o),
                            "aux": np.asarray(a), "dx": np.asarray(gx),
                            **{"d" + k: np.asarray(v) for k, v in gp.items()},
                            "dense_out": np.asarray(do)}

rng = np.random.default_rng(3)
batch = {"tokens": rng.integers(1, 100, (4, 9)).astype(np.int32),
         "positions": rng.integers(0, 50, (3, 4, 8)).astype(np.int32)}
res["batch_np"] = batch
bsh = meshlib.batch_shardings(
    jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), batch),
    mesh, full_batch=True)
res["batch"][True] = {k: shards(jax.device_put(v, bsh[k]))
                      for k, v in batch.items()}
res["batch"][(True, "spec")] = {k: tuple(v.spec) for k, v in bsh.items()}

tree = {"w": jnp.arange(64.0).reshape(8, 8),
        "m": jnp.ones((8, 8), jnp.float32)}
save_checkpoint(CKPT, 5, tree, version=1)
sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)
out = restore_checkpoint(CKPT, 5, sds, mesh=mesh,
                         specs={"w": P("data", "model"), "m": P("data", None)})
res["restore"] = {k: shards(v) for k, v in out.items()}
res["restore_np"] = npt(tree)
with open(OUT, "wb") as f:
    pickle.dump(res, f)
print("REF OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_shard_ref")
    out, ckpt = str(d / "ref.pkl"), str(d / "ckpt")
    run_multidevice(REF_SCRIPT % dict(
        out=out, ckpt=ckpt, train=TRAIN_CASES, moe=MOE_CASES,
        moe_cfg=MOE_CFG, seq=lr.SEQ, kw=lr.TRAIN_KW))
    with open(out, "rb") as f:
        res = pickle.load(f)
    res["ckpt_dir"] = ckpt
    return res


def _spawn(fn, *args):
    return ts.spawn(fn, 4, device="cpu", transport="gloo", timeout=TIMEOUT,
                    join_timeout=JOIN, args=args)


# --------------------------------- layouts ---------------------------------

class _FakeMesh:
    """The reference's mesh as its spec functions read it: axis names and
    a device array of the production shape (no devices behind it)."""

    def __init__(self, shape):
        self.axis_names = meshlib.PRODUCTION[len(shape) == 3][1]
        self.devices = np.empty(shape, dtype=object)


@pytest.fixture
def jax_specs(monkeypatch):
    """The reference's sharding builders with ``NamedSharding`` swapped for
    the bare spec, so they run on a stand-in production mesh."""
    bare = lambda mesh, spec: tuple(spec)
    monkeypatch.setattr(jmesh, "NamedSharding", bare)
    monkeypatch.setattr(jsteps, "NamedSharding", bare)
    return jmesh


def _strip(spec, lead):
    spec = tuple(spec)
    assert spec[:lead] == (None,) * lead, spec
    return spec[lead:]


def _match(port, ref, stacked=STACKED, lead=0, key=None):
    """Every leaf of the port's tree ``port`` (Shardings; per-layer lists
    where ``stacked`` names the reference's stacks) equals the reference's
    ``ref`` (specs), the stacks' leading axes dropped."""
    if isinstance(port, list):
        for p in port:
            _match(p, ref, stacked, lead, key)
        return
    if isinstance(ref, dict):
        assert set(port) == set(ref), (set(port), set(ref))
        for k in ref:
            _match(port[k], ref[k], stacked,
                   stacked.get(k, 0) if lead == 0 else lead, k)
        return
    if ref is None:
        assert port is None
        return
    want = _strip(ref, lead)
    got = tuple(port.spec)
    # an axis-free spec of either length replicates alike
    if any(e is not None for e in want + got):
        assert got == want, (key, got, want)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_train_state_and_cache_layouts_match_reference(shape, jax_specs):
    assert ARCHS == JARCHS
    fake = _FakeMesh(shape)
    layout = meshlib.make_production_mesh(multi_pod=len(shape) == 3,
                                          shape=shape)
    assert meshlib.dp_axes(layout) == jmesh.dp_axes(fake)
    for arch in ARCHS:
        jcfg = jax_config(arch)
        jm = jax_model(jcfg)
        psds = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        osds = jax.eval_shape(lambda p: jadamw_init(p, jcfg.moment_dtype),
                              psds)
        jp, jo = jsteps.train_state_shardings(jm, fake, psds, osds)
        model = get_model(get_config(arch))
        like = param_shapes(model)
        tp, to = steps.train_state_shardings(
            model, layout, like, train._state_like(
                model, model.cfg.moment_dtype)["opt"])
        _match(tp, jp)
        _match(to.m, jo.m)
        _match(to.v, jo.v)
        assert tuple(to.step.spec) == jo.step == ()
        for name, (seq, gb, kind) in JSHAPES.items():
            if name not in jshapes_for(jcfg) or kind == "train":
                continue
            csds = jax.eval_shape(lambda: jm.init_cache(gb, seq))
            jc = jsteps.cache_shardings(jm, fake, csds)
            tc_ = steps.cache_shardings(
                model, layout, model.init_cache(gb, seq, device="meta"))
            if isinstance(jc, dict) and "idx" in jc:
                jc, tc_ = dict(jc), dict(tc_)
                del jc["idx"], tc_["idx"]   # an int in the port
            for sub in ("self", "attn"):
                if sub in jc:
                    jc[sub], tc_[sub] = dict(jc[sub]), dict(tc_[sub])
                    del jc[sub]["idx"], tc_[sub]["idx"]
            _match(tc_, jc, stacked={})


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_batch_specs_and_sanitize_match_reference(shape, jax_specs):
    fake = _FakeMesh(shape)
    layout = meshlib.make_production_mesh(multi_pod=len(shape) == 3,
                                          shape=shape)
    for arch in ARCHS:
        jcfg = jax_config(arch)
        for name, (seq, gb, kind) in JSHAPES.items():
            for b in (gb, 1, 2, 6, 64, 512):
                jb = input_specs(jcfg, name, b, min(seq, 64))
                shapes = {k: tuple(v.shape) for k, v in jb.items()}
                for full in (True, False):
                    want = jmesh.batch_shardings(jb, fake, full_batch=full)
                    got = meshlib.batch_shardings(shapes, layout,
                                                  full_batch=full)
                    assert {k: tuple(v.spec) for k, v in got.items()} == \
                        want, (arch, name, b, full)
    from jax.sharding import PartitionSpec as JP
    for spec, dims in [(("data", "model"), (32, 48)),
                       ((("data", "model"), None), (64, 3)),
                       ((("pod", "data", "model"),), (12,)),
                       (("model", "data", None), (5, 16, 7)),
                       ((None, ("model", "pod")), (4, 32)),
                       (("nope",), (8,))]:
        assert tuple(meshlib.sanitize_spec(meshlib.P(*spec), dims,
                                           layout)) == \
            tuple(jmesh.sanitize_spec(JP(*spec), dims, fake))


@pytest.mark.parametrize("full_batch", [True, False])
def test_constrain_resolves_as_the_reference(full_batch, monkeypatch):
    """``resolve`` gives the spec the reference's ``constrain`` hands
    ``with_sharding_constraint``; ``constrain`` is the identity."""
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    cases = [((8, 16, 32), ("dp", None, None)),
             ((8, 16, 256), ("xb", None, "tp")),
             ((2, 16, 256), ("dp", None, "tp")),
             ((512, 4, 64), ("dp", "tp", None)),
             ((6, 5), ("tp", "dp")), ((32, 32), (None, "data"))]
    for shape in MESHES:
        fake = _FakeMesh(shape)
        layout = meshlib.make_production_mesh(multi_pod=len(shape) == 3,
                                              shape=shape)
        for dims, tags in cases:
            seen.clear()
            with jctx.sharding_context(fake, full_batch=full_batch):
                jctx.constrain(jnp.zeros(dims), *tags)
            with tctx.sharding_context(layout, full_batch=full_batch):
                got = tctx.resolve(dims, *tags)
                x = torch.zeros(dims)
                assert tctx.constrain(x, *tags) is x
            assert got == seen[0], (shape, dims, tags)
    assert tctx.resolve((4,), "dp") is None   # outside a context


def test_layout_cell_bytes():
    """Per-rank bytes of the dry run's layouts: each leaf's bytes over the
    product of the axes its spec splits it over, summed."""
    for arch in ARCHS:
        model = get_model(get_config(arch))
        like = param_shapes(model)
        for shape in MESHES:
            rec = dryrun.layout_cell(arch, "train_4k", shape)
            sizes = dict(zip(meshlib.PRODUCTION[len(shape) == 3][1], shape))
            sh = meshlib.sanitize_shardings(model.specs(), like,
                                            dryrun.mesh_layout(shape))
            want = numel = 0
            for t, s in zip(tree_leaves(like), tree_leaves(sh)):
                n = int(np.prod([sizes[a] for a in s.axes], dtype=np.int64))
                want += t.numel() * t.element_size() // n
                numel += t.numel() // n
            assert rec["params_bytes"] == want
            m = torch.empty(0, dtype=model.cfg.moment_dtype).element_size()
            assert rec["moments_bytes"] == 2 * numel * m
            seq, gb, _ = JSHAPES["train_4k"]
            assert rec["batch_spec"]["tokens"][0] is not None
            rows = gb // np.prod([sizes[a] for a in (
                (rec["batch_spec"]["tokens"][0],)
                if isinstance(rec["batch_spec"]["tokens"][0], str)
                else rec["batch_spec"]["tokens"][0])])
            assert rec["batch_local"]["tokens"] == [rows, seq]
            assert rec["argument_bytes"] == (want + rec["moments_bytes"]
                                             + rec["batch_bytes"] + 4)
    rec = dryrun.layout_cell("granite_moe_1b", "decode_32k", (2, 2))
    cfg = get_config("granite_moe_1b")
    kv = cfg.num_layers * 128 * cfg.num_kv_heads * 32768 * cfg.head_dim * 2
    assert rec["cache_bytes"] == 2 * kv // 4
    assert dryrun.layout_cell("qwen3_32b", "long_500k", (2, 2))["skipped"]


# --------------------------------- take_rows --------------------------------

def test_take_rows_values_and_gradients():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    idx = np.array([3, 6, 0, 3, 5, 7, 2, 9], np.int32)
    inv = np.full((6, 3), 8, np.int32)
    for r, i in enumerate(idx):
        if 0 <= i < 6:
            j = int((inv[i] < 8).sum())
            inv[i, j] = r
    g = rng.standard_normal((8, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: JM.take_rows(a, jnp.asarray(idx),
                                               jnp.asarray(inv)),
                        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = TM.take_rows(tx, torch.from_numpy(idx).long(),
                       torch.from_numpy(inv).long())
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (dx,) = torch.autograd.grad(got, tx, torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-6)


# ------------------------------- on the mesh --------------------------------

@pytest.fixture(scope="module")
def moe_runs(ref):
    cases = [(MOE_CFG | {"capacity_factor": c[1]}, ref["moe"][c]["p"],
              ref["moe"][c]["x"], ref["moe"][c]["w"]) for c in MOE_CASES]
    outs = _spawn(lr.moe_cases, cases)
    return {c: [o[i] for o in outs] for i, c in enumerate(MOE_CASES)}


@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: f"b{c[0]}-cf{c[1]}")
def test_moe_shard_map_matches_reference(case, ref, moe_runs):
    """Outputs, the load-balance loss and every gradient of the four
    processes against the reference's shard_map on four devices; batch 4
    runs the ``gather_model`` branch, batch 2 the other."""
    want = ref["moe"][case]
    outs = moe_runs[case]
    for whole, counted, b in outs:
        for k in ("out", "aux", "dx", "drouter", "dwi", "dwg", "dwo"):
            np.testing.assert_allclose(whole[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        assert counted["all-to-all"] > 0
        # the gather_model branch gathers the row over 'model'
        assert ("all-gather" in counted) == (b % 4 == 0)
    if case[1] == 8.0:      # nothing drops: the dense path's output
        np.testing.assert_allclose(outs[0][0]["out"], want["dense_out"],
                                   rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def train_runs(ref):
    return _spawn(lr.train_cases, TRAIN_CASES, ref["p0"])


def _hold_step(got, want):
    """``test_train_step_matches_reference``'s criteria, per leaf."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert got["step"] == want["step"] == 3
    ref_tree = lambda t: tree_leaves(lr.params_from_jax(t, device="cpu"))
    for key in ("m", "v"):
        g, e = tree_leaves(got[key]), ref_tree(want[key])
        assert len(g) == len(e)
        for a, b in zip(g, e):
            b = b.numpy()
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=1e-4 * np.abs(b).max())
    return ref_tree


@pytest.mark.parametrize("i", range(len(TRAIN_CASES)),
                         ids=[f"{a}-b{b}" for a, _, b in TRAIN_CASES])
def test_sharded_train_steps_match_reference(i, ref, train_runs):
    arch, cap, b = TRAIN_CASES[i]
    want = ref["train"][(arch, cap, b)]
    outs = [r[i] for r in train_runs]
    for o in outs[1:]:      # every process holds the same bits
        assert o["losses"] == outs[0]["losses"]
        for a, c in zip(tree_leaves(o["params"]),
                        tree_leaves(outs[0]["params"])):
            np.testing.assert_array_equal(a, c)
    got = outs[0]
    ref_tree = _hold_step(got, want)
    p0 = ref_tree(ref["p0"][arch])
    for g, e, p in zip(tree_leaves(got["params"]), ref_tree(want["params"]),
                       p0):
        dg, de = g - p.numpy(), (e - p).numpy()
        top = np.abs(de).max()
        assert top > 0
        np.testing.assert_allclose(dg, de, rtol=0, atol=0.05 * top)
        off = np.abs(dg - de) > 1e-4 * np.abs(de) + 1e-3 * top
        assert off.sum() <= 1e-3 * off.size, (g.shape, int(off.sum()))


@pytest.fixture(scope="module")
def misc_runs(ref, tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_shard_misc")
    return d, _spawn(lr.misc, ref["batch_np"], ref["ckpt_dir"],
                     ref["restore_np"], ref["p0"]["qwen3_32b"], str(d))


def test_shard_batch_rows_match_reference(ref, misc_runs):
    _, outs = misc_runs
    for r in outs:
        coords = (r["coords"]["data"], r["coords"]["model"])
        for k, v in r["rows"].items():
            np.testing.assert_array_equal(v, ref["batch"][True][k][coords])
        assert {k: tuple(v) for k, v in r["specs"].items()} == \
            ref["batch"][(True, "spec")]


def test_restore_on_mesh_matches_reference(ref, misc_runs):
    _, outs = misc_runs
    for r in outs:
        coords = (r["coords"]["data"], r["coords"]["model"])
        for k, v in r["restored"].items():
            np.testing.assert_array_equal(v, ref["restore"][k][coords])
            assert v.dtype == ref["restore_np"][k].dtype


def test_mesh_save_is_byte_equal_to_one_process_save(misc_runs):
    d, outs = misc_runs
    mesh_dir, one_dir = d / "mesh", d / "one"
    names = sorted(os.listdir(mesh_dir / "step_00000001"))
    assert names == sorted(os.listdir(one_dir / "step_00000001"))
    assert len(names) > 10
    for n in names:
        a = (mesh_dir / "step_00000001" / n).read_bytes()
        b = (one_dir / "step_00000001" / n).read_bytes()
        if n == "manifest.json":
            import json
            ja, jb = json.loads(a), json.loads(b)
            assert ja["leaves"] == jb["leaves"] and ja["step"] == jb["step"]
        else:
            assert a == b, n


def test_restartable_loop_resumes_on_the_mesh(misc_runs):
    """``RestartableLoop(mesh=, specs=)``: blocks saved from the mesh, a
    crash at step 3, a resume from step 2 on the mesh; the final state
    is the uninterrupted run's."""
    _, outs = misc_runs
    w = np.arange(32.0, dtype=np.float32).reshape(4, 8)
    for step in range(5):
        w = w * 2 + step
    for r in outs:
        got, done = r["loop"]
        assert done == 5
        np.testing.assert_array_equal(got, w)


def test_dryrun_counted_bytes_match_layouts(misc_runs):
    """The live cell's per-layer collective bytes (depth 2 less depth 1)
    against a count from the layouts: each gathered leaf's all-gather
    results (twice: remat gathers again in the backward), the backward's
    reduce-scatter results, each replicated leaf's gradient sum, and one
    float per leaf and axis in the clipping norm's sums; depth 3 is the
    extrapolation's."""
    _, outs = misc_runs
    rec = outs[0]["dryrun"]
    cfg = dataclasses.replace(reduced(get_config("qwen3_32b")), remat=True)
    mesh = dryrun.mesh_layout((2, 2))
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    one = dryrun.scale_depth(cfg, 1)
    model = get_model(one)
    sh = meshlib.sanitize_shardings(model.specs(), param_shapes(model), mesh)
    like = param_shapes(model)["layers"][0]
    want = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    for t, s in zip(tree_leaves(like), tree_leaves(sh["layers"][0])):
        local = list(s.local_shape(tuple(t.shape)))
        size = 4
        for n in local:
            size *= n
        for dim, entry in enumerate(s.spec):
            for a in reversed(meshlib._names(entry)):
                want["reduce-scatter"] += size
                size *= sizes[a]
                want["all-gather"] += 2 * size
        for a in mesh.axis_names:
            if a not in s.axes:
                want["all-reduce"] += size      # the gradient's sum
        want["all-reduce"] += 4 * len(s.axes)   # the norm's partial sums
    d1, d2 = (rec[f"depth{d}"]["collectives"] for d in (1, 2))
    got = {k: d2.get(k, 0) - d1.get(k, 0) for k in want}
    assert got == want
    d3 = rec["depth3"]["collectives"]
    for k in d3:
        assert d3[k] == d1[k] + 2 * (d2[k] - d1[k])
    assert rec["reduced"]["batch"] == [256, 4]
    assert rec["full"]["collectives"]["all-gather"] == \
        d1["all-gather"] + 3 * (d2["all-gather"] - d1["all-gather"])


FAMILIES = [("mamba2_780m", 4), ("zamba2_12b", 2)]


@pytest.fixture(scope="module")
def family_runs():
    return _spawn(lr.port_train_cases, FAMILIES)


@pytest.mark.parametrize("i", range(len(FAMILIES)),
                         ids=[a for a, _ in FAMILIES])
def test_ssm_and_hybrid_train_on_the_mesh(i, family_runs):
    """The SSM and hybrid families' layers gathered on the mesh (Zamba2's
    shared block in every super-block, its tail): three sharded steps
    against one process's ``build_train_step`` (no MoE: the same
    function), losses to rtol 1e-5 and first moments to rtol 1e-4 and an
    atol of 1e-4 of each leaf's largest."""
    arch, batch = FAMILIES[i]
    cfg = lr.config(arch)
    model = get_model(cfg)
    p = model.init(torch.Generator().manual_seed(0))
    opt = lr.adamw_init(p, cfg.moment_dtype)
    step = steps.build_train_step(model, **lr.TRAIN_KW)
    ds = lr.SyntheticTokens(cfg.vocab_size, lr.SEQ, batch, seed=1)
    losses = []
    for k in range(3):
        p, opt, met = step(p, opt, lr.shard_batch(ds.batch_at(k),
                                                  device="cpu"))
        losses.append(float(met["loss"]))
    for r in family_runs:
        got = r[i]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for g, e in zip(tree_leaves(got["m"]), tree_leaves(opt.m)):
            e = e.float().numpy()
            np.testing.assert_allclose(g.numpy(), e, rtol=1e-4,
                                       atol=1e-4 * np.abs(e).max())


def test_train_main_resumes_across_the_mesh(tmp_path):
    """A one-process checkpoint resumes on the mesh and a mesh checkpoint
    on one process (qwen3_32b: its mesh step computes the one-process
    step), each continuing the uninterrupted run's losses; and
    ``--compress-grads`` on the mesh gives the one-process losses."""
    base = ["--arch", "qwen3_32b", "--reduced", "--device", "cpu",
            "--batch", "4", "--seq", "16", "--ckpt-every", "2",
            "--log-every", "100"]
    on_mesh = ["--mesh", "single", "--mesh-shape", "2x2", "--transport",
               "gloo"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    whole = train.main(base + ["--steps", "4"])
    first = train.main(base + ["--steps", "2", "--ckpt-dir", a])
    compress = ["--steps", "2", "--compress-grads"]
    outs = _spawn(lr.trainer_runs, [
        base + on_mesh + ["--steps", "4", "--ckpt-dir", a],
        base + on_mesh + ["--steps", "2", "--ckpt-dir", b],
        base + on_mesh + compress])
    resumed_on_mesh, mesh_first, mesh_compressed = outs[0]
    # int8 compression on each leaf's whole scale (a max over its blocks)
    np.testing.assert_allclose(mesh_compressed["losses"],
                               train.main(base + compress).losses, rtol=1e-5)
    assert [o[0]["losses"] for o in outs] == [resumed_on_mesh["losses"]] * 4
    assert resumed_on_mesh["start"] == 2 and mesh_first["start"] == 0
    back = train.main(base + ["--steps", "4", "--ckpt-dir", b])
    assert back.start_step == 2
    np.testing.assert_allclose(first.losses, whole.losses[:2], rtol=1e-6)
    np.testing.assert_allclose(mesh_first["losses"], whole.losses[:2],
                               rtol=1e-5)
    np.testing.assert_allclose(resumed_on_mesh["losses"], whole.losses[2:],
                               rtol=1e-5)
    np.testing.assert_allclose(back.losses, whole.losses[2:], rtol=1e-5)
    assert set(mesh_first["collectives"]) >= {"all-gather", "all-reduce",
                                              "reduce-scatter"}
