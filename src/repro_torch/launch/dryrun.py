"""The dry run's counterpart (port of ``repro.launch.dryrun``): what each
rank of a mesh holds and moves, per (arch x shape x mesh) cell.

The reference lowers and compiles every cell against 512 placeholder
devices and reads XLA's memory and cost analyses.  The port has no
compiler to ask, so the cell splits in two:

  * :func:`layout_cell` needs no device: from the parameter, moment,
    batch and cache shapes (``meta`` tensors) and the model's specs on
    the mesh's sizes it gives each rank's local shapes and bytes -- what
    the reference's ``memory_analysis`` argument bytes stand for.
  * :func:`run_cell` runs one step of a cell at depth 1 and 2
    (``scale_depth``, ``unit_count``) on a live mesh of processes -- a
    train step, a prefill of the cell's sequence into an empty cache of
    that length, or one decode step at the cache's last row -- reads the
    collective bytes per op the mesh counted (the reference's
    ``parse_collective_bytes`` keys: result bytes of each op, one rank's)
    and extrapolates them to full depth as the reference does (per-unit
    delta x true depth).  The batch is cut to one sequence per process
    (train) or per data row (prefill, decode: the ``model`` ranks of a
    row serve the same rows, and never more than the cell's batch); the
    cuts are recorded.  Serving runs for every family
    (``steps.build_prefill_step(mesh=)``): an SSM decode cell is one state
    step, Whisper's prefill encodes frames drawn from seed 0 and its
    decode cell serves from the zero cross cache of ``encoder_seq``
    frames, as the reference's ``lower_cell`` lowers them.

The graph engine's cell (the reference's ``run_graph_cell``) splits the
same way: :func:`graph_layout_cell` gives each rank's padded ``vp``,
argument shapes and bytes of the distributed BFS / SSSP / BC / BC-ring
queries on a production mesh (``core.partition.distributed_query_specs``
and the queries' layouts), and :func:`run_graph_cell` runs each kind once
on a live graph mesh and records the collective bytes each counted.

The CLI writes every cell's layout to ``experiments/dryrun_torch/``
(git-ignored), with ``--graph`` the graph engine's too
(``graph_engine.<mesh>.json``); ``run_cell`` and ``run_graph_cell`` are
called on a live mesh (``chip_smoke.py`` phases 3j, 3k, 3l and 3m, the
tests):

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--graph]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, shapes_for
from repro_torch.data import SyntheticTokens, shard_batch
from repro_torch.models import get_model, param_shapes
from repro_torch.optim import adamw_init

from . import mesh as meshlib
from . import steps as steplib

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

MESHES = {"pod16x16": (16, 16), "pod2x16x16": (2, 16, 16),
          "mesh2x2": (2, 2)}


def mesh_layout(shape) -> meshlib.MeshLayout:
    return meshlib.make_production_mesh(multi_pod=len(shape) == 3,
                                        shape=shape)


def scale_depth(cfg, d: int):
    """Same-architecture config with depth = d 'units' (see unit_count)."""
    kw = {}
    if cfg.family == "hybrid":
        kw["num_layers"] = d * cfg.attn_every + cfg.num_layers \
            % cfg.attn_every
    elif cfg.family in ("encdec", "audio"):
        kw["num_layers"] = d
        kw["encoder_layers"] = d
    else:
        kw["num_layers"] = d
    return dataclasses.replace(cfg, **kw)


def unit_count(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


def batch_shapes(cfg, kind: str, batch: int, seq: int) -> dict:
    """The inputs of a cell as ``meta`` tensors (``repro.models.
    input_specs``): modality frontends stubbed, M-RoPE positions, Whisper's
    frames."""
    def t(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")
    s = seq if kind != "decode" else 1
    tokens_s = s
    out = {"tokens": t((batch, tokens_s))}
    if cfg.mrope_sections:
        out["positions"] = t((3, batch, s - 1 if kind == "train" else s))
    if cfg.family in ("encdec", "audio") and kind != "decode":
        out["frames"] = t((batch, cfg.encoder_seq, cfg.d_model),
                          torch.float32)
    return out


def _local(tree, shardings) -> tuple:
    """(bytes one rank holds, its local shape per leaf path)."""
    total, shapes = 0, {}

    def one(path, t, sh):
        nonlocal total
        if isinstance(t, torch.Tensor):
            shape = sh.local_shape(tuple(t.shape))
            total += math.prod(shape) * t.element_size()
            shapes[path] = list(shape)

    def walk(path, t, sh):
        if isinstance(t, dict):
            for k in t:
                walk(f"{path}/{k}" if path else k, t[k], sh[k])
        elif isinstance(t, (list, tuple)):
            for i, (a, b) in enumerate(zip(t, sh)):
                walk(f"{path}/{i}", a, b)
        else:
            one(path, t, sh)
    walk("", tree, shardings)
    return total, shapes


def layout_cell(arch: str, shape_name: str, mesh_shape) -> dict:
    """Each rank's local shapes and bytes of one cell (no device)."""
    mesh = mesh_layout(mesh_shape)
    name = mesh_name(mesh_shape)
    cfg = get_config(arch)
    rec = {"arch": arch, "shape": shape_name, "mesh": name,
           "n_ranks": mesh.size}
    if shape_name not in shapes_for(cfg):
        return {**rec, "skipped": True,
                "reason": "long_500k needs sub-quadratic attention"}
    seq, gbatch, kind = SHAPES[shape_name]
    model = get_model(cfg)
    params = param_shapes(model)
    p_sh = meshlib.sanitize_shardings(model.specs(), params, mesh)
    rec["params_bytes"], rec["params_local"] = _local(params, p_sh)
    full_batch = kind == "train"
    batch = batch_shapes(cfg, kind, gbatch, seq)
    b_sh = meshlib.batch_shardings(batch, mesh, full_batch=full_batch)
    rec["batch_bytes"], rec["batch_local"] = _local(batch, b_sh)
    rec["batch_spec"] = {k: list(v.spec) for k, v in b_sh.items()}
    if kind == "train":
        moments = adamw_init(params, cfg.moment_dtype).m
        rec["moments_bytes"] = 2 * _local(moments, p_sh)[0]
        rec["argument_bytes"] = (rec["params_bytes"] + rec["moments_bytes"]
                                 + rec["batch_bytes"] + 4)   # + step
    else:
        cache = model.init_cache(gbatch, seq, device="meta")
        c_sh = steplib.cache_shardings(model, mesh, cache)
        rec["cache_bytes"], rec["cache_local"] = _local(cache, c_sh)
        rec["argument_bytes"] = (rec["params_bytes"] + rec["cache_bytes"]
                                 + rec["batch_bytes"])
    rec["skipped"] = False
    return rec


def run_cell(arch: str, shape_name: str, mesh, *, cfg=None,
             seq: Optional[int] = None, out_dir: Optional[str] = OUT_DIR,
             depths=(1, 2)) -> dict:
    """One step of the cell at each depth of ``depths`` on the live
    ``mesh`` (every rank calls it; module docstring): the collective
    bytes per op the mesh counted, each rank's, and their extrapolation
    to full depth.
    ``cfg`` replaces the arch's config (a reduced one on the CPU), ``seq``
    the cell's sequence length."""
    cfg = cfg or get_config(arch)
    seq_full, gbatch, kind = SHAPES[shape_name]
    seq = seq or seq_full
    # one sequence per process (train) or per data row (serving), at most
    # the cell's own batch
    batch = min(gbatch, mesh.size if kind == "train" else math.prod(
        mesh.sizes[a] for a in meshlib.dp_axes(mesh)))
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(map(str, mesh.shape)), "n_ranks": mesh.size,
           "transport": mesh.transport, "units": unit_count(cfg),
           "seq": seq, "batch": batch, "reduced": {}}
    if batch != gbatch:
        rec["reduced"]["batch"] = [gbatch, batch]
    if seq != seq_full:
        rec["reduced"]["seq"] = [seq_full, seq]
    tally = mesh.group()
    for d in depths:
        cfg_d = scale_depth(cfg, d)
        if kind == "train":     # the flash kernel has no backward
            cfg_d = dataclasses.replace(cfg_d, attn_impl="xla")
        model = get_model(cfg_d)
        params = model.init(torch.Generator(device=mesh.device)
                            .manual_seed(0))
        if kind == "train":
            p_sh, o_sh = steplib.train_state_shardings(
                model, mesh, params, adamw_init(param_shapes(model),
                                                cfg_d.moment_dtype))
            params = steplib.local_state(params, p_sh)
            state = (params, adamw_init(params, cfg_d.moment_dtype))
            step = steplib.build_train_step(model, mesh=mesh)
            ds = SyntheticTokens(cfg_d.vocab_size, seq, batch, seed=0)
            b = shard_batch(ds.batch_at(0), mesh=mesh)
        else:
            params = steplib.local_state(
                params, steplib.mesh_param_shardings(model, mesh))
            state = (params, steplib.local_cache(model, mesh, batch, seq,
                                                 dtype=cfg_d.dtype))
            step, b = _serving_step(model, mesh, kind, batch, seq, state[1])
        before = dict(tally.bytes)
        step(*state, b)
        rec[f"depth{d}"] = {"collectives": {
            k: v - before.get(k, 0) for k, v in tally.bytes.items()
            if v - before.get(k, 0)}}
        del params, state
    if set(depths) >= {1, 2}:
        c1, c2 = (rec[f"depth{d}"]["collectives"] for d in (1, 2))
        rec["full"] = {"collectives": {
            k: c1.get(k, 0) + (rec["units"] - 1) * (c2.get(k, 0)
                                                     - c1.get(k, 0))
            for k in sorted(set(c1) | set(c2))}}
    if out_dir and mesh.rank == 0:
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.join(out_dir, f"{arch}.{shape_name}.live"
                          f"{rec['mesh']}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _serving_step(model, mesh, kind: str, batch: int, seq: int, cache):
    """A serving cell's step and this process's rows of its batch: a
    prefill of ``seq`` tokens into the empty cache of ``seq`` rows (with
    Whisper's frames), or one decode step at ``idx = seq - 1`` (the
    reference lowers its cells with ``cache_len = seq``; an SSM's state
    has no fill, Whisper's cross cache stays zero)."""
    cfg = model.cfg
    tokens = SyntheticTokens(cfg.vocab_size, seq, batch, seed=0).batch_at(
        0)["tokens"]
    b = {}
    if kind == "prefill":
        step = steplib.build_prefill_step(model, mesh=mesh)
        tokens, start = tokens[:, :seq], 0
        if cfg.encoder_layers:
            b["frames"] = np.random.default_rng(0).standard_normal(
                (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    else:
        step = steplib.build_decode_step(model, mesh=mesh)
        tokens, start = tokens[:, :1], seq - 1
        fill = next((c for c in (cache, *cache.values())
                     if isinstance(c, dict) and "idx" in c), None)
        if fill is not None:
            fill["idx"] = start
    b["tokens"] = tokens
    if cfg.mrope_sections:      # text positions on every M-RoPE section
        pos = np.arange(start, start + tokens.shape[1], dtype=np.int32)
        b["positions"] = np.broadcast_to(pos, (3,) + tokens.shape).copy()
    return step, shard_batch(b, mesh=mesh, full_batch=False)


GRAPH_KINDS = ("bfs", "sssp", "bc", "bc_ring")
GRAPH_VCAP = 131072     # the reference's graph cell: Table 1's scale


def mesh_name(shape) -> str:
    return ("pod" if tuple(shape) in ((16, 16), (2, 16, 16)) else "mesh") \
        + "x".join(map(str, shape))


def graph_layout_cell(mesh_shape, vcap: int = GRAPH_VCAP,
                      bc_vcap: int = 16384, n_sources: int = 512) -> dict:
    """The graph engine's cell without a device (the reference's
    ``run_graph_cell`` on the production mesh, every rank on the flattened
    graph axis): per query kind the vertex capacity (gather-mode BC at
    ``bc_vcap``: it all-gathers the row bands), the padded ``vp``, each
    argument's global shape, layout and the shape a rank holds, and the
    argument bytes a rank holds."""
    from repro_torch.core.partition import distributed_query_specs
    from repro_torch.shard import GraphMesh

    n = math.prod(mesh_shape)
    gmesh = GraphMesh(["meta"] * n)
    rec = {"arch": "graph_engine", "mesh": mesh_name(mesh_shape),
           "vcap": vcap, "bc_vcap": bc_vcap, "n_sources": n_sources,
           "n_ranks": n}
    for kind in GRAPH_KINDS:
        v = bc_vcap if kind == "bc" else vcap
        specs = distributed_query_specs(v, gmesh, n_sources=n_sources,
                                        kind=kind)
        rec[kind] = {
            "vcap": v, "vp": specs[0].shape[0],
            "args": [{"shape": list(a.shape), "layout": a.layout,
                      "rank_shape": list(a.rank_shape),
                      "dtype": str(a.dtype).split(".")[-1]} for a in specs],
            "argument_bytes": sum(
                math.prod(a.rank_shape) * a.dtype.itemsize for a in specs)}
    return rec


def run_graph_cell(mesh, state, *,
                   src_chunk: Optional[int] = None) -> dict:
    """Each query kind of the graph cell once on the live graph ``mesh``
    (every rank calls it on a :class:`~repro_torch.shard.DistMesh`) over
    ``state``, from one source a rank (vertices 0, 1, ...): the collective
    bytes per op each kind counted, this process's rank's.
    ``state.vcap`` stands for the cell's GRAPH_VCAP, recorded as cut in
    ``reduced``; the kernels run on a CUDA state."""
    from repro_torch.core.partition import build_query_inputs
    from repro_torch.core.tiles import TILE
    from repro_torch.shard.queries import counted_query_fn
    from repro_torch.shard.tile_shard import as_graph_mesh

    gmesh = as_graph_mesh(mesh)
    rec = {"arch": "graph_engine", "n_ranks": gmesh.size,
           "vcap": state.vcap, "n_sources": gmesh.size, "reduced": {}}
    if state.vcap != GRAPH_VCAP:
        rec["reduced"]["vcap"] = [GRAPH_VCAP, state.vcap]
    args = build_query_inputs(state, gmesh, list(range(gmesh.size)))
    rec["vp"] = next(b for b in args[0] if b is not None).shape[1]
    for kind in GRAPH_KINDS:
        _, rec[kind] = counted_query_fn(gmesh, kind, TILE, None,
                                        src_chunk)(*args)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--graph", action="store_true",
                    help="also write the graph engine's cells")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    os.makedirs(args.out, exist_ok=True)
    recs = [layout_cell(a, s, m) for m in MESHES.values() for a in archs
            for s in shapes]
    with open(os.path.join(args.out, "layouts.json"), "w") as f:
        json.dump(recs, f, indent=1)
    if args.graph:
        for shape in ((16, 16), (2, 16, 16)):
            rec = graph_layout_cell(shape)
            with open(os.path.join(args.out, f"graph_engine."
                                   f"{rec['mesh']}.json"), "w") as f:
                json.dump(rec, f, indent=1)
            print(f"[graph_engine {rec['mesh']}] " + ", ".join(
                f"{k} vp {rec[k]['vp']} {rec[k]['argument_bytes'] / 2**30:.3f}"
                " GiB a rank" for k in GRAPH_KINDS), flush=True)
    for r in recs:
        if not r["skipped"]:
            print(f"[{r['arch']} {r['shape']} {r['mesh']}] "
                  f"{r['argument_bytes'] / 2**30:.2f} GiB a rank",
                  flush=True)


if __name__ == "__main__":
    main()
