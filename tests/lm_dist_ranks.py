"""Rank bodies for ``tests/test_torch_lm_shard.py``.

Each function here runs once in every process of
``repro_torch.shard.spawn`` (four gloo ranks on the CPU, laid out on a
``("data", "model") = (2, 2)`` mesh) as ``fn(mesh, *args)``; spawn pickles
them by name, so they live at module level, in a module that imports
neither JAX nor the reference package.  Inputs are numpy arrays the test
made (the reference's initial parameters among them); each returns plain
values and numpy arrays, compared in the test process.
"""
import dataclasses
import os

import torch

from repro_torch.checkpoint import Checkpointer, restore_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticTokens, shard_batch
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps
from repro_torch.models import get_model
from repro_torch.models import moe as tmoe
from repro_torch.models import sharding_ctx as sc
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw_init
from repro_torch.optim.tree import tree_map

SHAPE = (2, 2)
TRAIN_KW = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)
SEQ = 20


def _mesh(mesh):
    return meshlib.make_production_mesh(mesh, shape=SHAPE)


def config(arch: str, capacity=None):
    """The reduced config, attention through ``sdpa_chunked`` (the
    reference's default; the port's flash kernel has no backward)."""
    cfg = dataclasses.replace(reduced(get_config(arch)), attn_impl="xla")
    if capacity is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity)
    return cfg


def _np(tree):
    return tree_map(lambda t: t.detach().float().numpy(), tree)


# --------------------------------- the MoE ---------------------------------

def moe_case(mesh, cfg_kw, p_np, x_np, w_np):
    """``moe_shard_map`` on this rank's blocks of ``x`` [B, S, d] and of the
    expert stacks: the whole output, aux and the gradients of ``sum(out *
    w) + aux`` gathered back whole."""
    _mesh(mesh)
    cfg = dataclasses.replace(reduced(get_config("granite_moe_1b")),
                              **cfg_kw)
    p = {k: torch.from_numpy(v) for k, v in p_np.items()}
    x = torch.from_numpy(x_np)
    b = x.shape[0]
    p_sh = meshlib.sanitize_shardings(tmoe.moe_specs(cfg), p, mesh)
    rows = meshlib.batch_shardings({"x": x}, mesh, full_batch=True)["x"]
    lp = {k: p_sh[k].local(v).clone().requires_grad_() for k, v in p.items()}
    lx = rows.local(x).clone().requires_grad_()
    lw = rows.local(torch.from_numpy(w_np))
    bytes_before = dict(mesh.group().bytes)
    with sc.sharding_context(mesh, full_batch=True, batch=rows.axes):
        out, aux = tmoe.moe(lp, lx, cfg, path=())
        share = sc.batch_share((out * lw).sum()) + sc.replicated_share(aux)
        grads = torch.autograd.grad(share, [lx] + [lp[k] for k in p])
    counted = {k: v - bytes_before.get(k, 0)
               for k, v in mesh.group().bytes.items()
               if v > bytes_before.get(k, 0)}
    # an input replicated over an axis sums its gradient over it
    gl = [steps._sum_replicas(grads[0], rows)] + [
        steps._sum_replicas(g, p_sh[k]) for g, k in zip(grads[1:], p)]
    whole = {"out": rows.gather(out.detach()), "aux": aux.detach(),
             "dx": rows.gather(gl[0])}
    for g, k in zip(gl[1:], p):
        whole["d" + k] = p_sh[k].gather(g)
    return {k: v.float().numpy() for k, v in whole.items()}, counted, b


def rows_mean_model(model, n_rows):
    """``model`` whose loss is the mean of its loss on ``n_rows`` equal
    splits of the batch: the mesh step's function (its load-balance loss
    is a mean over data rows) where no token is 0."""
    def loss_fn(params, batch):
        parts = [{k: v.chunk(n_rows, dim=1 if k == "positions" else 0)[i]
                  for k, v in batch.items()} for i in range(n_rows)]
        return sum(model.loss_fn(params, b) for b in parts) / n_rows
    return dataclasses.replace(model, loss_fn=loss_fn)


def port_train_case(mesh, arch, batch, n_steps=3):
    """``n_steps`` sharded steps of the reduced ``arch`` (capacity 8) from
    the port's seed-0 parameters on the mesh's device: the losses and the
    whole first moments after the last step, on the host."""
    _mesh(mesh)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config(arch, 8.0 if "granite" in arch else None)
    model = get_model(cfg)
    p0 = tree_map(lambda t: t.to(mesh.device),
                  model.init(torch.Generator().manual_seed(0)))
    o0 = adamw_init(p0, cfg.moment_dtype)
    p_sh, o_sh = steps.train_state_shardings(model, mesh, p0, o0)
    lp, lo = steps.local_state(p0, p_sh), steps.local_state(o0, o_sh)
    step = steps.build_train_step(model, mesh=mesh, **TRAIN_KW)
    ds = SyntheticTokens(cfg.vocab_size, SEQ, batch, seed=1)
    losses = []
    for i in range(n_steps):
        lp, lo, met = step(lp, lo, shard_batch(ds.batch_at(i), mesh=mesh))
        losses.append(float(met["loss"]))
    return {"losses": losses, "m": tree_map(
        lambda t: t.float().cpu(), steps.gather_state(lo.m, p_sh))}


def port_train_cases(mesh, cases):
    """``port_train_case`` for each ``(arch, batch)`` (one spawn)."""
    return [port_train_case(mesh, arch, b) for arch, b in cases]


def moe_cases(mesh, cases):
    """``moe_case`` for each argument tuple of ``cases`` (one spawn)."""
    return [moe_case(mesh, *c) for c in cases]


# ------------------------------ train steps --------------------------------

def train_case(mesh, arch, capacity, batch, p0_np, n_steps=3):
    """``n_steps`` sharded steps from the reference's initial parameters:
    the losses and the whole parameters and moments after them."""
    _mesh(mesh)
    cfg = config(arch, capacity)
    model = get_model(cfg)
    p0 = params_from_jax(p0_np, device="cpu")
    o0 = adamw_init(p0, cfg.moment_dtype)
    p_sh, o_sh = steps.train_state_shardings(model, mesh, p0, o0)
    lp, lo = steps.local_state(p0, p_sh), steps.local_state(o0, o_sh)
    step = steps.build_train_step(model, mesh=mesh, **TRAIN_KW)
    ds = SyntheticTokens(cfg.vocab_size, SEQ, batch, seed=1)
    losses = []
    for i in range(n_steps):
        lp, lo, met = step(lp, lo, shard_batch(ds.batch_at(i), mesh=mesh))
        losses.append(float(met["loss"]))
    return {"losses": losses, "step": int(lo.step),
            "params": _np(steps.gather_state(lp, p_sh)),
            "m": _np(steps.gather_state(lo.m, p_sh)),
            "v": _np(steps.gather_state(lo.v, p_sh))}


def train_cases(mesh, cases, p0s, n_steps=3):
    """Every ``(arch, capacity, batch)`` of ``cases`` (one spawn)."""
    return [train_case(mesh, arch, cap, b, p0s[arch], n_steps)
            for arch, cap, b in cases]


# ------------------------------ batches, files -----------------------------

def misc(mesh, batch_np, ref_ckpt, restore_np, p0_np, outdir):
    """Batch rows, restored blocks, a mesh save beside a one-process save,
    and the dry run's live cell, in one spawn."""
    _mesh(mesh)
    lb = shard_batch(batch_np, mesh=mesh)
    out = {"coords": mesh.coords, "rows": {k: v.numpy()
                                           for k, v in lb.items()},
           "specs": {k: tuple(v.spec) for k, v in lb.shardings.items()}}
    like = {k: torch.from_numpy(v) for k, v in restore_np.items()}
    specs = {"w": meshlib.P("data", "model"), "m": meshlib.P("data", None)}
    got = restore_checkpoint(ref_ckpt, 5, like, device="cpu", mesh=mesh,
                             specs=specs)
    out["restored"] = {k: v.numpy() for k, v in got.items()}

    # one sharded step, then the state saved from the mesh and, gathered,
    # by rank 0 alone
    cfg = config("qwen3_32b")
    model = get_model(cfg)
    p0 = params_from_jax(p0_np, device="cpu")
    o0 = adamw_init(p0, cfg.moment_dtype)
    p_sh, o_sh = steps.train_state_shardings(model, mesh, p0, o0)
    lp, lo = steps.local_state(p0, p_sh), steps.local_state(o0, o_sh)
    step = steps.build_train_step(model, mesh=mesh, **TRAIN_KW)
    ds = SyntheticTokens(cfg.vocab_size, SEQ, 4, seed=1)
    lp, lo, _ = step(lp, lo, shard_batch(ds.batch_at(0), mesh=mesh))
    state, sh = {"params": lp, "opt": lo}, {"params": p_sh, "opt": o_sh}
    Checkpointer(os.path.join(outdir, "mesh")).save(
        1, state, blocking=True, mesh=mesh, shardings=sh)
    whole = steps.gather_state(state, sh)
    if mesh.rank == 0:
        Checkpointer(os.path.join(outdir, "one")).save(1, whole,
                                                       blocking=True)
    mesh.barrier()

    # RestartableLoop on the mesh: crashed at step 3, resumed from 2
    from repro_torch.runtime import RestartableLoop
    whole_w = torch.arange(32.0).reshape(4, 8)
    w_sh = meshlib.sanitize_shardings({"w": meshlib.P("data", "model")},
                                      {"w": whole_w}, mesh)["w"]

    def bump(state, step):
        return {"w": state["w"] * 2 + step}
    loop_dir = os.path.join(outdir, "loop")
    loop = lambda: RestartableLoop(  # noqa: E731
        loop_dir, bump, {"w": whole_w}, ckpt_every=2, mesh=mesh,
        specs={"w": meshlib.P("data", "model")}, device="cpu")
    try:
        loop().run({"w": w_sh.local(whole_w).clone()}, 5, fail_at=3)
    except RuntimeError as e:
        assert "injected failure at step 3" in str(e)
    final, done = loop().run(None, 5)
    out["loop"] = (w_sh.gather(final["w"]).numpy(), done)

    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(config("qwen3_32b"), remat=True)
    out["dryrun"] = dryrun.run_cell("qwen3_32b", "train_4k", mesh, cfg=cfg,
                                    seq=16, out_dir=None, depths=(1, 2, 3))
    return out


def trainer_runs(mesh, runs):
    """``train.main(argv, mesh=mesh)`` for each argv of ``runs``."""
    from repro_torch.launch import train
    out = []
    for argv in runs:
        res = train.main(argv, mesh=mesh)
        out.append({"losses": res.losses, "start": res.start_step,
                    "collectives": res.collectives})
    return out


def reference_restore_blocks(mesh, dirs, step, argv):
    """Each arch's train state, written by the reference at ``step`` into
    ``dirs[arch]``, restored with ``mesh=`` / ``specs=`` against the
    blocks ``steps.local_state`` cuts from a whole restore: (leaves,
    leaves bit-equal) per arch; then ``train.main(argv, mesh=mesh)``."""
    from repro_torch.launch import train
    from repro_torch.optim import AdamWState
    from repro_torch.optim.tree import tree_leaves

    _mesh(mesh)
    out = {"blocks": {}}
    for arch, d in dirs.items():
        cfg = reduced(get_config(arch))
        model = get_model(cfg)
        like = train._state_like(model, cfg.moment_dtype)
        pspecs = model.specs()
        specs = {"params": pspecs, "opt": AdamWState(
            step=meshlib.P(), m=pspecs, v=pspecs)}
        got = restore_checkpoint(d, step, like, device="cpu", mesh=mesh,
                                 specs=specs)
        whole = restore_checkpoint(d, step, like, device="cpu")
        p_sh, o_sh = steps.train_state_shardings(model, mesh, like["params"],
                                                 like["opt"])
        want = {"params": steps.local_state(whole["params"], p_sh),
                "opt": steps.local_state(whole["opt"], o_sh)}
        pairs = list(zip(tree_leaves(got), tree_leaves(want)))
        out["blocks"][arch] = (len(pairs), sum(
            a.shape == b.shape and torch.equal(a, b) for a, b in pairs))
    res = train.main(argv, mesh=mesh)
    out["trainer"] = {"start": res.start_step, "losses": res.losses}
    return out
