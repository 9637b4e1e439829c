"""Trainer CLI: data pipeline + model + AdamW + checkpoint/restart (port of
``repro.launch.train``), on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_moe_1b \\
        --steps 12 --batch 8 --seq 4096 --ckpt-dir /tmp/ckpt

``--reduced`` trains a small same-family model (``--device cpu`` runs it
here).  Weights are random, drawn from a ``torch.Generator`` seeded 0 on
the training device; tokens come from ``SyntheticTokens`` (seed 0), a pure
function of the step.  Checkpoints every ``--ckpt-every`` steps (async),
resumes from the latest checkpoint in ``--ckpt-dir``, flags straggler
steps with the heartbeat monitor.  ``--mesh single|multi`` waits for LM
sharding (ROADMAP.md, queue 1, slice 4).  ``main`` returns a
``TrainResult``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import PORTED, get_config, reduced as make_reduced
from repro_torch.core.graph_state import resolve_device
from repro_torch.data import SyntheticTokens, shard_batch
from repro_torch.models import ModelConfig, get_model
from repro_torch.optim import adamw_init, compress_init
from repro_torch.optim.tree import tree_leaves
from repro_torch.runtime import HeartbeatMonitor

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


def train_config(arch: str, reduced: bool = False) -> ModelConfig:
    cfg = get_config(arch)
    if reduced:
        cfg = dataclasses.replace(make_reduced(cfg), remat=True)
    # Training runs attention through sdpa_chunked ("xla"), as the reference
    # trains (its default attn_impl): the flash kernel has no backward,
    # neither the port's CUDA one nor the reference's Pallas one.
    return dataclasses.replace(cfg, attn_impl="xla")


def make_train_step(model, total_steps: int, lr: float,
                    compress: bool = False):
    """The trainer's step: warm-up over a tenth of the run (at least 2
    steps), cosine decay to ``total_steps``."""
    return steplib.build_train_step(
        model, peak_lr=lr, warmup_steps=max(2, total_steps // 10),
        total_steps=total_steps, compress=compress)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> TrainResult:
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
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: training on a mesh waits for LM sharding "
            f"(ROADMAP.md, queue 1, slice 4)")

    dev = resolve_device(args.device)
    cfg = train_config(args.arch, args.reduced)
    model = get_model(cfg)
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=0)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = adamw_init(params, cfg.moment_dtype)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params:,} params on {dev}", flush=True)

    train_step = make_train_step(model, args.steps, args.lr,
                                 args.compress_grads)
    comp = compress_init(params) if args.compress_grads else None

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt:
        s, restored = ckpt.restore_latest({"params": params, "opt": opt},
                                          device=dev)
        if restored is not None:
            params, opt = restored["params"], restored["opt"]
            start = s
            print(f"[train] resumed from step {start}", flush=True)

    mon = HeartbeatMonitor(on_straggler=lambda s, dt, med: print(
        f"[straggler] step {s}: {dt:.3f}s vs median {med:.3f}s"))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, lrs, walls = [], [], []
    t_start = time.perf_counter()
    for step in range(start, args.steps):
        batch = shard_batch(ds.batch_at(step), device=dev)
        mon.start()
        if args.compress_grads:
            params, opt, comp, metrics = train_step(params, opt, batch, comp)
        else:
            params, opt, metrics = train_step(params, opt, batch)
        _sync(dev)
        walls.append(mon.stop(step))
        losses.append(float(metrics["loss"]))
        lrs.append(float(metrics["lr"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[-1]:8.4f} lr {lrs[-1]:.2e} "
                  f"{walls[-1] * 1e3:7.1f} ms", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt})
    if ckpt:
        final_state_saved = start < args.steps and \
            args.steps % args.ckpt_every == 0
        if final_state_saved:
            ckpt.wait()     # the last step's save is the final one
        else:
            ckpt.save(args.steps, {"params": params, "opt": opt},
                      blocking=True)
    tok_s = (args.steps - start) * args.batch * args.seq \
        / max(time.perf_counter() - t_start, 1e-9)
    print(f"[train] done: {tok_s:,.0f} tokens/s, "
          f"stragglers={mon.stragglers}", flush=True)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    return TrainResult(cfg, params, opt, start, losses, lrs, walls, tok_s,
                       peak, mon.stragglers)


if __name__ == "__main__":
    main()
