#!/usr/bin/env python3
"""How far an LM family served on the (data, model) mesh of processes
drifts from one process over more decode steps than ``chip_smoke.py``
phase 3m takes, in bf16 and in float32, on one NVIDIA GPU.

    python3 tools/mesh_drift.py [--arch zamba2_12b] [--steps 8]
                                [--dtypes bfloat16,float32]
    # a rehearsal on the CPU at the reduced config, a few seconds:
    python3 tools/mesh_drift.py --device cpu --reduced --steps 3

For each dtype, 3m's run of ``--arch`` at full width and depth (seed-0
weights, LM_BATCH prompts from seed 1, Whisper's frames from seed 2) on
3m's (2, 2) mesh of four processes on cuda:0 over gloo, with ``--steps``
greedy decode steps, each data row's rows held against one process on
the card serving the same rows (``chip_smoke.serve_one_process``), TF32
off on both sides.  Prints per step the logits' relative L2 distance (the
larger of the two data rows), and per cache leaf its distance as the
prefill left it and after the decode steps.  Where the mesh differs from
one process only in the order its split-key softmax sums, the float32
distances stay near float32 rounding (~1e-6) while the bf16 ones grow
with the steps; a wrong block or a wrong weight would move both.
Measures and checks nothing else; on ``cuda`` (the default) it exits
nonzero without a card.
"""
import argparse
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def rank(mesh, cfg, max_len, feed):
    """One process: 3m's ``family_serve`` of the run on its blocks."""
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.launch import mesh as meshlib

    meshlib.make_production_mesh(mesh, shape=smoke.LM_MESH)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    run = smoke.family_serve(torch, mesh, cfg, feed, max_len,
                             lambda: kf.LAUNCHES["flash_attention"])
    return {"rank": mesh.rank, "coords": mesh.coords, "runs": [run]}


def main() -> int:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    import chip_smoke as smoke
    from repro_torch.shard import spawn

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2_12b",
                    choices=[a for a, _, _ in smoke.FAMILY_MESH_RUNS])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config, prompt 32 (Whisper's 20)")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("mesh_drift: torch.cuda.is_available() is false")
    smoke.DEV, smoke.SERVE_REDUCED = args.device, args.reduced
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    if args.device == "cuda":
        print("nvidia-smi:", smoke.nvidia_smi(), flush=True)
    prompt, rows3m = next((p, m) for a, p, m in smoke.FAMILY_MESH_RUNS
                          if a == args.arch)
    if args.reduced:
        prompt, rows3m = ((20, 24) if args.arch == "whisper_large_v3"
                          else (32, 32))
    # room for the decode steps, an even count of rows (split in two)
    max_len = max(rows3m, prompt + 2 * args.steps)
    rows = smoke.LM_BATCH // smoke.LM_MESH[0]
    for dtype in args.dtypes.split(","):
        cfg = dataclasses.replace(smoke.serve_config(args.arch),
                                  dtype=getattr(torch, dtype))
        prompts = smoke.serve_prompts(torch, cfg, prompt)
        frames = smoke.family_frames(torch, cfg)
        parts = [smoke.serve_one_process(
            torch, cfg, prompts[r:r + rows], args.steps, max_len,
            frames=None if frames is None else frames[r:r + rows])
            for r in range(0, smoke.LM_BATCH, rows)]
        feed = {"prompts": prompts.cpu().numpy(),
                "frames": None if frames is None else frames.cpu().numpy(),
                "tokens": torch.cat([p["tokens"] for p in parts]).numpy()}
        del frames
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        outs = spawn(rank, 4, device=f"{args.device}:0" if args.device
                     == "cuda" else "cpu", transport="gloo",
                     timeout=smoke.LM_TIMEOUT, join_timeout=3000,
                     args=(cfg, max_len, feed))
        wall = time.perf_counter() - t0
        steps = []
        leaves = {}
        for d, ref in enumerate(parts):
            got = next(o["runs"][0]["logits"] for o in outs
                       if o["coords"] == {"data": d, "model": 0})
            l2 = [smoke.rel_l2(torch, g, w)
                  for g, w in zip(got, ref["logits"])]
            steps = [max(a, b) for a, b in zip(steps, l2)] if steps else l2
            for key in ("prefill_cache", "cache"):
                for path, whole in ref[key].items():
                    mine = smoke.row_whole(torch, outs, "runs", 0, d, path,
                                           key)
                    at = leaves.setdefault(path, {})
                    at[key] = max(at.get(key, 0.0),
                                  smoke.rel_l2(torch, mine, whole))
        print(f"{args.arch} ({cfg.num_layers} layers, d {cfg.d_model}) in "
              f"{dtype}, batch {smoke.LM_BATCH}, prompt {prompt}, "
              f"{args.steps} decode steps, cache {max_len} rows; mesh "
              f"{smoke.LM_MESH} over gloo ({wall:.1f} s, spawn to join) vs "
              f"one process on each data row's {rows} rows", flush=True)
        print("  logits rel L2 by step (prefill first): "
              + ", ".join(f"{x:.3g}" for x in steps), flush=True)
        print("  cache rel L2 after the prefill / after the decode steps: "
              + "; ".join(f"{p} {v['prefill_cache']:.3g} / {v['cache']:.3g}"
                          for p, v in sorted(leaves.items())), flush=True)
        del parts, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
