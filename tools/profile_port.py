#!/usr/bin/env python3
"""Where the port's main path spends its time on one NVIDIA GPU.

    python3 tools/profile_port.py

Replays ``chip_smoke.py``'s traffic with that script's own constants and
helpers: the same R-MAT GraphService, a cold all-vertex ``bc_scores``,
then the first ``RING_DEPTH`` batches of its commit stream, each followed
by its BFS/SSSP/BC queries.  Then it profiles, with ``torch.profiler``
(CPU + CUDA activities):

  * ``bc_scores delta`` -- the delta ``bc_scores`` call the smoke makes
    after those commits;
  * ``ladder round``   -- the stream's next batch and its nine queries;
  * ``ladder round, every option`` -- the same round through a second
    service with every option of ``chip_smoke.py``'s phase 3e (telemetry
    with a JSONL trace, adaptive thresholds, the resilience policy, the
    breaker, a journal, a heartbeat monitor, compaction every
    ``COMPACT_EVERY`` commits; no faults), after the same batches: what
    the instruments add to a round;
  * ``sssp_batched_dense masked`` -- one batched SSSP at the batched
    phase's shape (``SRC_CHUNK`` sources of the initial R-MAT state, the
    tile view's occupancy as the mask);
  * ``full rung, lane-batched`` / ``full rung, sequential`` -- phase 3f's
    lane work (``chip_smoke.serve_lane_inputs``: the stream's last state,
    ``SERVE_BATCH`` sources): one 32-lane ``bfs_lanes``, ``sssp_lanes``
    and ``bc_dependencies_lanes`` call, against the same 96 queries as
    single-source calls; ``delta rung, ...`` the same for the delta lane
    forms on priors ``RING_DEPTH`` versions older; each with its host reads
    and its launches, host reads and device time per query;
  * ``static bfs query`` -- one BFS query of the Section 5 workload's
    static mode as ``run_mix`` runs it (``chip_smoke.py`` 3c's graph and
    the first query source of its BFS op stream): ``dense_views`` of the
    snapshot, then ``bfs_batched_dense`` from one source, which pads it to
    one row block (M = 128) and packs the adjacency once;
  * ``static sssp query`` -- the same for SSSP: ``dense_views``, then
    ``sssp_batched_dense`` from that source, one ``minplus_mm`` of its
    distance row (padded to the row granule) per relax pass;
  * ``sharded ladder round (<bc_mode>)`` / ``sharded bc_scores
    (<bc_mode>)`` -- ``chip_smoke.py`` 3g's service
    (``ShardedGraphService`` on ``SHARDS`` ranks of the card) after the same
    cold ``bc_scores`` and ``RING_DEPTH`` batches: one ladder round, and the
    ``bc_scores`` after it (its rung in the printed tallies), per
    ``bc_mode``.  The ranks' streams
    overlap on the card, so the summed device time can exceed the wall;
  * ``<arch> prefill`` / ``<arch> decode x N`` -- for each model of
    ``chip_smoke.LM_ARCHS``, ``chip_smoke.FAMILY_ARCHS`` and gemma3_27b (the
    first of ``chip_smoke.LM2_ARCHS``) at its serving shape (``LM_BATCH`` prompts of ``LM_PROMPT`` tokens, Whisper's of
    ``WHISPER_PROMPT`` over its 1500 frames, seed 0 weights): one prefill
    after an unprofiled warm-up prefill, then ``DECODE_STEPS`` greedy
    decode steps after as many unprofiled warm-up steps;
  * ``<mamba2> ssd_chunked, one layer`` -- one Mamba2 layer's SSD at the
    serving shape (the chunk loop's launches and busy share);
  * ``<granite> train step`` -- one step of ``chip_smoke.py`` 3i's trainer
    (``chip_smoke.TRAIN_ARCH`` at ``TRAIN_SEQ``, the first batch of
    ``TRAIN_BATCHES``: forward, backward, AdamW) after an unprofiled
    warm-up step, and the same step's unprofiled wall.

For each window it prints the host wall time, the summed device time of
every kernel, the device busy share (device time / wall; the profiler's
own host overhead lengthens the wall), the number of kernel launches and
the kernels that take the most device time, then one JSON line with the
same numbers.  For the SSSP call, the lane windows and the decode steps it
also counts the host's reads of device values (per relax pass, per query,
per step), in a second, unprofiled run under
``torch.cuda.set_sync_debug_mode("warn")`` (``chip_smoke.host_reads``: each
synchronising read warns once), and for the decode steps their unprofiled
wall time.
It needs CUDA and exits nonzero without it.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODE_STEPS = 4


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_window(torch, name, fn, top=8):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Only device-side kernel events: a CPU op (aten::*) also carries the
    # device time of the kernels it launched, and a record_function range
    # (a span's, such as "collect") spans them on the device
    # timeline; either would count them twice.
    rows = [(evt.key, evt.count, _device_us(evt))
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)]
    rows = [r for r in rows if r[2] > 0]
    rows.sort(key=lambda r: -r[2])
    device_us = sum(r[2] for r in rows)
    launches = sum(r[1] for r in rows)
    print(f"== {name}: wall {wall_us / 1e3:.1f} ms, device {device_us / 1e3:.1f}"
          f" ms, busy {device_us / wall_us:.3f}, {launches} kernel launches",
          flush=True)
    for key, count, us in rows[:top]:
        print(f"  {us / 1e3:10.2f} ms  {us / device_us:6.3f}  x{count:<6d} "
              f"{key[:90]}", flush=True)
    return {"window": name, "wall_ms": wall_us / 1e3,
            "device_ms": device_us / 1e3, "busy": device_us / wall_us,
            "launches": launches,
            "top": [{"kernel": k[:120], "count": c, "ms": us / 1e3}
                    for k, c, us in rows[:top]]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_port: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    import chip_smoke as smoke
    from repro_torch.core import queries
    from repro_torch.core.tiles import build_tile_view, dense_views_from_tiles
    from repro_torch.data import load_rmat_graph
    from repro_torch.engine import GraphService
    from repro_torch.kernels import minplus_mm as kmp

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    state = load_rmat_graph(smoke.N_VERTICES, smoke.N_EDGES, seed=smoke.SEED,
                            device="cuda")
    svc = GraphService(state, ring_depth=smoke.RING_DEPTH,
                       batch_size=smoke.BATCH_SIZE)
    rng = np.random.default_rng(smoke.SEED)
    stream, hot_base = smoke.commit_stream(np, rng, smoke.N_VERTICES)
    sources = smoke.query_sources(torch, state, hot_base)

    svc.bc_scores(src_chunk=smoke.SRC_CHUNK)
    for i in range(smoke.RING_DEPTH):
        smoke.ladder_round(svc, stream[i], sources, i)
    nxt = smoke.RING_DEPTH
    out = [profile_window(torch, "bc_scores delta",
                          lambda: svc.bc_scores(src_chunk=smoke.SRC_CHUNK)),
           profile_window(torch, "ladder round",
                          lambda: smoke.ladder_round(svc, stream[nxt],
                                                     sources, nxt))]
    print(f"  bc_scores modes {svc.bc_scores_stats}; ladder {svc.stats.as_dict()}")
    out.append(options_window(torch, smoke, state, stream, sources))

    view = build_tile_view(state)
    _, w, alive = dense_views_from_tiles(state, view)
    srcs, _ = smoke.batch_sources(torch, np, state)

    def sssp():
        return queries.sssp_batched_dense(w, srcs, alive, amask=view.occ,
                                          tile=view.tile)

    sssp()  # warm: the kernel's first launch loads its module
    out.append(profile_window(torch, "sssp_batched_dense masked", sssp))
    before = kmp.LAUNCHES["minplus_mm_masked"]
    reads = smoke.host_reads(torch, sssp)
    passes = kmp.LAUNCHES["minplus_mm_masked"] - before
    out[-1].update(passes=passes, host_reads=reads,
                   host_reads_per_pass=reads / max(passes, 1))
    print(f"  {passes} relax passes, {reads} synchronising host reads "
          f"({reads / max(passes, 1):.2f} per pass)", flush=True)
    del state, svc, view, w, alive, srcs
    torch.cuda.empty_cache()
    out += serve_windows(torch, np, smoke)
    torch.cuda.empty_cache()
    for query in ("bfs", "sssp"):
        out.append(static_window(torch, np, smoke, query))
        torch.cuda.empty_cache()
    out += sharded_windows(torch, np, smoke)
    torch.cuda.empty_cache()
    out += lm_windows(torch, smoke)
    out.append(train_window(torch, smoke))
    print(json.dumps({"device": smi, "n": smoke.N_VERTICES, "windows": out}),
          flush=True)
    return 0


def options_window(torch, smoke, state, stream, sources):
    import tempfile

    from repro_torch.engine import GraphService
    from repro_torch.obs import Telemetry
    from repro_torch.resil import OpJournal, ResiliencePolicy, journal_meta
    from repro_torch.runtime import HeartbeatMonitor

    with tempfile.TemporaryDirectory() as tmp:
        tel = Telemetry.make(trace_path=os.path.join(tmp, "trace.jsonl"))
        journal = OpJournal(os.path.join(tmp, "wal.jsonl"),
                            meta=journal_meta(
                                state, {"batch_size": smoke.BATCH_SIZE}))
        svc = GraphService(
            state, ring_depth=smoke.RING_DEPTH, batch_size=smoke.BATCH_SIZE,
            telemetry=tel, adaptive=True,
            policy=ResiliencePolicy(max_retries=1), breaker=True,
            journal=journal, monitor=HeartbeatMonitor(),
            compact_every=smoke.COMPACT_EVERY)
        for i in range(smoke.RING_DEPTH):
            smoke.ladder_round(svc, stream[i], sources, i)
        nxt = smoke.RING_DEPTH
        row = profile_window(torch, "ladder round, every option",
                             lambda: smoke.ladder_round(svc, stream[nxt],
                                                        sources, nxt))
        journal.close()
        tel.close()
    return row


def serve_windows(torch, np, smoke):
    """Phase 3f's lane work: its R-MAT state after the commit stream, its
    sources padded to ``SERVE_BATCH`` (``chip_smoke.serve_lane_inputs``),
    and per rung one lane-batched call of each kind against the same
    lanes as single-source calls (``chip_smoke.lane_calls``): launches,
    host reads, device time and busy share, per query beside the window's
    totals."""
    from repro_torch.data import load_rmat_graph

    state = load_rmat_graph(smoke.N_VERTICES, smoke.N_EDGES, seed=smoke.SEED,
                            device="cuda")
    stream, hot_base = smoke.commit_stream(
        np, np.random.default_rng(smoke.SEED), smoke.N_VERTICES)
    sources = smoke.serve_sources(torch, state, hot_base)
    state, srcs, delta = smoke.serve_lane_inputs(
        torch, smoke.stream_states(state, stream), sources)
    calls = smoke.lane_calls(torch, state, srcs, delta)
    out = []
    for rung in ("full", "delta"):
        n = sum(len(delta[k]) if rung == "delta" else len(srcs)
                for k in smoke.KINDS)
        for label, pick in (("lane-batched", 0), ("sequential", 1)):
            fns = [calls[kind, rung][pick] for kind in smoke.KINDS]

            def run(fns=fns):
                for fn in fns:
                    fn()

            run()  # warm-up
            row = profile_window(torch, f"{rung} rung, {label}, bfs+sssp+bc,"
                                 f" {n} queries", run)
            reads = smoke.host_reads(torch, run)
            row.update(queries=n, host_reads=reads,
                       launches_per_query=row["launches"] / n,
                       host_reads_per_query=reads / n,
                       device_ms_per_query=row["device_ms"] / n)
            print(f"  per query: {row['launches_per_query']:.1f} launches, "
                  f"{reads / n:.2f} host reads, "
                  f"{row['device_ms_per_query']:.3f} ms device, "
                  f"{row['wall_ms'] / n:.3f} ms wall", flush=True)
            out.append(row)
    return out


def sharded_windows(torch, np, smoke):
    """Phase 3g's sharded service, per ``bc_mode``: one ladder round and
    one ``bc_scores`` after the smoke's first ``RING_DEPTH`` batches."""
    from repro_torch.data import load_rmat_graph
    from repro_torch.shard import GraphMesh, ShardedGraphService

    state = load_rmat_graph(smoke.N_VERTICES, smoke.N_EDGES, seed=smoke.SEED,
                            device="cuda")
    rng = np.random.default_rng(smoke.SEED)
    stream, hot_base = smoke.commit_stream(np, rng, smoke.N_VERTICES)
    sources = smoke.query_sources(torch, state, hot_base)
    mesh = GraphMesh(["cuda:0"] * smoke.SHARDS)
    out = []
    for bc_mode in ("gather", "ring"):
        svc = ShardedGraphService(state, mesh, use_kernel=True,
                                  src_chunk=smoke.SRC_CHUNK, bc_mode=bc_mode,
                                  ring_depth=smoke.RING_DEPTH,
                                  batch_size=smoke.BATCH_SIZE)
        svc.bc_scores()
        for i in range(smoke.RING_DEPTH):
            smoke.ladder_round(svc, stream[i], sources, i)
        nxt = smoke.RING_DEPTH
        out.append(profile_window(
            torch, f"sharded ladder round ({bc_mode})",
            lambda: smoke.ladder_round(svc, stream[nxt], sources, nxt)))
        out.append(profile_window(torch, f"sharded bc_scores ({bc_mode})",
                                  svc.bc_scores))
        print(f"  ladder {svc.stats.as_dict()}", flush=True)
        del svc
        torch.cuda.empty_cache()
    return out


def static_window(torch, np, smoke, query_name):
    """One static-mode BFS or SSSP query, after an unprofiled warm-up query
    from the same source; ``levels`` counts its dense product's launches
    (BFS levels, SSSP relax passes)."""
    from repro_torch.bench import workload as wl
    from repro_torch.core import (bfs_batched_dense, dense_views,
                                  sssp_batched_dense)
    from repro_torch.kernels import bool_mm as kb
    from repro_torch.kernels import minplus_mm as kmp

    graph = wl.load_graph(smoke.N_VERTICES, device="cuda")
    ops = wl.make_ops(np.random.default_rng(smoke.SEED), smoke.WORKLOAD_OPS,
                      smoke.N_VERTICES, smoke.WORKLOAD_MIX)
    src = next(op[1] for op in ops if op[0] == "QUERY")
    srcs = torch.tensor([src], dtype=torch.int32, device="cuda")
    mod, kernel = (kb, "bool_mm") if query_name == "bfs" else (kmp,
                                                               "minplus_mm")

    def query():
        am, wd, alive = dense_views(graph)
        if query_name == "bfs":
            return bfs_batched_dense(am, srcs, alive)
        return sssp_batched_dense(wd, srcs, alive)

    query()
    before = mod.LAUNCHES[kernel]
    row = profile_window(torch, f"static {query_name} query", query)
    levels = mod.LAUNCHES[kernel] - before
    row.update(source=src, levels=levels)
    print(f"  source {src}: {levels} {kernel} launches", flush=True)
    return row


def ssd_window(torch, smoke, cfg):
    """One Mamba2 layer's ``ssd_chunked`` at the serving shape: the chunk
    loop's launches and busy share (random inputs of the layer's shapes and
    dtypes: dt in [0.3, 1.3], as softplus of the init's projections)."""
    from repro_torch.models import ssm

    g = torch.Generator(device="cuda").manual_seed(4)
    b, s, h = smoke.LM_BATCH, smoke.LM_PROMPT, cfg.ssm_heads

    def draw(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(cfg.dtype)

    x = draw(b, s, h, cfg.ssm_headdim)
    dt = torch.rand((b, s, h), generator=g, device="cuda") + 0.3
    a = -torch.ones(h, device="cuda")
    bm, cm = draw(b, s, cfg.ssm_state), draw(b, s, cfg.ssm_state)
    state = torch.zeros((b, h, cfg.ssm_headdim, cfg.ssm_state),
                        dtype=cfg.dtype, device="cuda")

    def run():
        ssm.ssd_chunked(x, dt, a, bm, cm, cfg.ssm_chunk, state)

    run()
    return profile_window(torch, f"{cfg.name} ssd_chunked, one layer", run)


def lm_windows(torch, smoke):
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    out = []
    for arch in smoke.LM_ARCHS + smoke.FAMILY_ARCHS + smoke.LM2_ARCHS[:1]:
        cfg = get_config(arch)
        model = get_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        draw = torch.Generator(device="cuda").manual_seed(1)
        prompt = (smoke.WHISPER_PROMPT if cfg.family == "audio"
                  else smoke.LM_PROMPT)
        prompts = torch.randint(1, cfg.vocab_size, (smoke.LM_BATCH, prompt),
                                generator=draw, device="cuda")
        extra = {}
        if cfg.family == "audio":  # as launch/serve.py draws them
            extra["frames"] = torch.randn(
                (smoke.LM_BATCH, cfg.encoder_seq, cfg.d_model),
                generator=torch.Generator(device="cuda").manual_seed(2),
                device="cuda")
        # Room for four runs of decode(): warm-up, profiled, timed and the
        # host-read count.
        cache = model.init_cache(smoke.LM_BATCH, prompt + 4 * DECODE_STEPS,
                                 dtype=cfg.dtype)
        state = {}

        def prefill():
            state["logits"], state["cache"] = model.prefill(params, prompts,
                                                            cache, **extra)

        def decode():
            for _ in range(DECODE_STEPS):
                tok = state["logits"][:, -1].argmax(dim=-1)[:, None]
                state["logits"], state["cache"] = model.decode_step(
                    params, tok, state["cache"])

        prefill()  # warm-up: the kernel's first launch loads its module
        out.append(profile_window(torch, f"{arch} prefill", prefill))
        decode()  # warm-up
        out.append(profile_window(torch, f"{arch} decode x {DECODE_STEPS}",
                                  decode))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
        reads = smoke.host_reads(torch, decode)
        out[-1].update(unprofiled_ms_per_step=step_ms,
                       host_reads_per_step=reads / DECODE_STEPS)
        print(f"  unprofiled decode {step_ms:.2f} ms/step, "
              f"{reads / DECODE_STEPS:.2f} synchronising host reads per step",
              flush=True)
        del params, cache, state, extra
        torch.cuda.empty_cache()
        if cfg.family == "ssm":
            out.append(ssd_window(torch, smoke, cfg))
    return out


def train_window(torch, smoke):
    """One step of 3i's trainer at its shape, profiled after a warm-up
    step, and one more unprofiled."""
    from repro_torch.data import SyntheticTokens, shard_batch
    from repro_torch.launch import train
    from repro_torch.models import get_model
    from repro_torch.optim import adamw_init

    cfg = train.train_config(smoke.TRAIN_ARCH)
    model = get_model(cfg)
    batch = smoke.TRAIN_BATCHES[0]
    ds = SyntheticTokens(cfg.vocab_size, smoke.TRAIN_SEQ, batch, seed=0)
    step_fn = train.make_train_step(model, smoke.TRAIN_STEPS, smoke.TRAIN_LR)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    state = {"params": params, "opt": adamw_init(params, cfg.moment_dtype)}
    del params

    def step(i):
        p, o, _ = step_fn(state["params"], state["opt"],
                          shard_batch(ds.batch_at(i), device="cuda"))
        state.update(params=p, opt=o)

    step(0)  # warm-up
    row = profile_window(torch, f"{smoke.TRAIN_ARCH} train step "
                         f"({batch} x {smoke.TRAIN_SEQ})", lambda: step(1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(2)
    torch.cuda.synchronize()
    row["unprofiled_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"  unprofiled step {row['unprofiled_ms']:.1f} ms", flush=True)
    del state
    torch.cuda.empty_cache()
    return row


if __name__ == "__main__":
    sys.exit(main())
