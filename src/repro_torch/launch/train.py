"""Trainer CLI: data pipeline + model + AdamW + checkpoint/restart (port of
``repro.launch.train``), on one device or on a mesh of processes.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_moe_1b \
        --steps 12 --batch 8 --seq 4096 --ckpt-dir /tmp/ckpt

``--reduced`` trains a small same-family model (``--device cpu`` runs it
here).  Weights are random, drawn from a ``torch.Generator`` seeded 0 on
the training device; tokens come from ``SyntheticTokens`` (seed 0), a pure
function of the step.  Checkpoints every ``--ckpt-every`` steps (async),
resumes from the latest checkpoint in ``--ckpt-dir`` (the port's own or
one the reference's trainer wrote, its per-layer leaves stacked), flags
straggler steps with the heartbeat monitor.  ``main`` returns a ``TrainResult``.

``--mesh single|multi`` trains on the production mesh of processes,
``("data", "model")`` or ``("pod", "data", "model")``, its sizes from
``--mesh-shape`` (``2x2``; default the reference's 16x16 and 2x16x16),
one process per rank, each holding its blocks of the train state and its
rows of every batch (``launch.steps``).  The processes come from
``torchrun`` (``init_from_env``: ``--transport nccl``, one card per rank,
or ``gloo`` where ranks share a card) or from a ``DistMesh`` handed to
``main(mesh=)`` (``shard.spawn``).  Rank 0 alone prints, writes the
checkpoints and runs the heartbeat; a checkpoint written with or without
a mesh resumes on either (elastic).

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --reduced \
        --device cpu --mesh single --mesh-shape 2x2 --transport gloo
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import PORTED, get_config, reduced as make_reduced
from repro_torch.core.graph_state import resolve_device
from repro_torch.data import SyntheticTokens, shard_batch
from repro_torch.models import ModelConfig, get_model, param_shapes
from repro_torch.optim import AdamWState, adamw_init, compress_init
from repro_torch.optim.tree import tree_leaves, tree_map
from repro_torch.runtime import HeartbeatMonitor
from repro_torch.shard.dist import TRANSPORTS, init_from_env

from . import mesh as meshlib
from . import steps as steplib


@dataclasses.dataclass
class TrainResult:
    cfg: ModelConfig
    params: dict
    opt: object                     # AdamWState
    start_step: int                 # the step training began (or resumed) at
    losses: List[float]             # one per step run
    lrs: List[float]
    step_s: List[float]             # wall of each step run
    tokens_per_s: float
    peak_bytes: Optional[int]       # device memory high-water mark (CUDA)
    stragglers: int
    # On a mesh (params and opt are then this process's blocks): the mesh
    # and the collectives of the steps run (bytes per op as counted, and
    # what the transport moved), summed over the steps.
    mesh: object = None
    collectives: Optional[dict] = None
    moved: Optional[dict] = None


def train_config(arch: str, reduced: bool = False) -> ModelConfig:
    cfg = get_config(arch)
    if reduced:
        cfg = dataclasses.replace(make_reduced(cfg), remat=True)
    # Training runs attention through sdpa_chunked ("xla"), as the reference
    # trains (its default attn_impl): the flash kernel has no backward,
    # neither the port's CUDA one nor the reference's Pallas one.
    return dataclasses.replace(cfg, attn_impl="xla")


def make_train_step(model, total_steps: int, lr: float,
                    compress: bool = False, mesh=None):
    """The trainer's step: warm-up over a tenth of the run (at least 2
    steps), cosine decay to ``total_steps``."""
    return steplib.build_train_step(
        model, peak_lr=lr, warmup_steps=max(2, total_steps // 10),
        total_steps=total_steps, compress=compress, mesh=mesh)


def mesh_shape(text: Optional[str]):
    """``"2x2"`` -> (2, 2); ``None`` -> ``None`` (the production sizes)."""
    return None if text is None else tuple(int(n) for n in text.split("x"))


def _state_like(model, moment_dtype):
    """The whole train state's shapes and dtypes, on ``meta``."""
    p = param_shapes(model)
    z = lambda t: torch.empty(t.shape, dtype=moment_dtype, device="meta")
    return {"params": p, "opt": AdamWState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        m=tree_map(z, p), v=tree_map(z, p))}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, mesh=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_32b", choices=PORTED)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none")
    ap.add_argument("--mesh-shape", default=None,
                    help="the mesh's sizes, e.g. 2x2 (default 16x16, or "
                         "2x16x16 with --mesh multi)")
    ap.add_argument("--transport", choices=TRANSPORTS, default="nccl",
                    help="a torchrun mesh's transport (gloo where ranks "
                         "share a card)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    cfg = train_config(args.arch, args.reduced)
    model = get_model(cfg)
    dm = None
    if args.mesh != "none":
        if mesh is None and "RANK" not in os.environ:
            raise RuntimeError(
                f"--mesh {args.mesh}: the mesh's processes come from "
                "torchrun (RANK, WORLD_SIZE, MASTER_ADDR in the environment)"
                " or from a DistMesh passed to main(mesh=)")
        dm = mesh if mesh is not None else init_from_env(
            transport=args.transport,
            device=None if args.device == "cuda" else args.device)
        meshlib.make_production_mesh(dm, multi_pod=args.mesh == "multi",
                                     shape=mesh_shape(args.mesh_shape))
        dev = dm.device
    else:
        dev = resolve_device(args.device)
    lead = dm is None or dm.rank == 0
    say = print if lead else (lambda *a, **k: None)

    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=0)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(x.numel() for x in tree_leaves(params))
    state_sh = specs = None
    if dm is not None:
        like = _state_like(model, cfg.moment_dtype)
        shardings = steplib.train_state_shardings(model, dm, like["params"],
                                                  like["opt"])
        state_sh = {"params": shardings[0], "opt": shardings[1]}
        params = steplib.local_state(params, shardings[0])
        pspecs = model.specs()
        specs = {"params": pspecs, "opt": AdamWState(
            step=meshlib.P(), m=pspecs, v=pspecs)}
    opt = adamw_init(params, cfg.moment_dtype)
    where = (f"on a {'x'.join(map(str, dm.shape))} mesh of {dm.size} "
             f"processes ({dm.transport}, rank 0 on {dev})"
             if dm is not None else f"on {dev}")
    say(f"[train] {cfg.name}: {n_params:,} params {where}", flush=True)

    train_step = make_train_step(model, args.steps, args.lr,
                                 args.compress_grads, mesh=dm)
    comp = compress_init(params) if args.compress_grads else None

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt:
        # The skeleton goes inline: a name holding it would keep the
        # initial train state alive through the run.
        s, restored = ckpt.restore_latest(
            {"params": params, "opt": opt} if dm is None else like,
            mesh=dm, specs=specs, device=dev)
        if restored is not None:
            params, opt = restored["params"], restored["opt"]
            start = s
            say(f"[train] resumed from step {start}", flush=True)

    mon = HeartbeatMonitor(on_straggler=lambda s, dt, med: print(
        f"[straggler] step {s}: {dt:.3f}s vs median {med:.3f}s"))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tally = dm.group() if dm is not None else None
    before = ({}, {}) if tally is None else (dict(tally.bytes),
                                             dict(tally.moved))
    losses, lrs, walls = [], [], []
    t_start = time.perf_counter()
    for step in range(start, args.steps):
        batch = shard_batch(ds.batch_at(step), mesh=dm, device=dev)
        t0 = time.perf_counter()
        if lead:
            mon.start()
        if args.compress_grads:
            params, opt, comp, metrics = train_step(params, opt, batch, comp)
        else:
            params, opt, metrics = train_step(params, opt, batch)
        _sync(dev)
        walls.append(mon.stop(step) if lead else time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        lrs.append(float(metrics["lr"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {losses[-1]:8.4f} lr {lrs[-1]:.2e} "
                f"{walls[-1] * 1e3:7.1f} ms", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt}, mesh=dm,
                      shardings=state_sh)
    if ckpt:
        final_state_saved = start < args.steps and \
            args.steps % args.ckpt_every == 0
        if final_state_saved:
            ckpt.wait(dm)   # the last step's save is the final one
        else:
            ckpt.save(args.steps, {"params": params, "opt": opt},
                      blocking=True, mesh=dm, shardings=state_sh)
    tok_s = (args.steps - start) * args.batch * args.seq \
        / max(time.perf_counter() - t_start, 1e-9)
    say(f"[train] done: {tok_s:,.0f} tokens/s, "
        f"stragglers={mon.stragglers}", flush=True)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    counted = moved = None
    if tally is not None:
        counted, moved = ({k: v - b.get(k, 0) for k, v in now.items()}
                          for now, b in ((tally.bytes, before[0]),
                                         (tally.moved, before[1])))
    return TrainResult(cfg, params, opt, start, losses, lrs, walls, tok_s,
                       peak, mon.stragglers, dm, counted, moved)


if __name__ == "__main__":
    res = main()
    if res.mesh is not None:    # the torchrun mesh main built
        res.mesh.close()
