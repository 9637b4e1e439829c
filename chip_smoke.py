#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a traceback and a nonzero
exit code:

  0. device   -- require CUDA, turn TF32 off, print the card's name and
                 power limit (nvidia-smi);
  1. build    -- compile the CUDA source under src/repro_torch/kernels/csrc
                 with nvcc;
  2. kernels  -- each kernel's wrapper on the card against its plain PyTorch
                 version on the same inputs: the shape and mask-density sweeps
                 of tests/test_kernels.py, the single-tile mask, and the main
                 path's own product (2048 sources x the R-MAT adjacency,
                 integer-valued counts).  Integer inputs must match bit for
                 bit, float inputs to rtol = atol = 1e-5.  Each kernel is
                 timed (CUDA events, median of 5) beside its plain version,
                 torch.matmul at the same shape, and its bound (the masked
                 product's work counted at the fixed WORK_* granularity);
  3. main     -- the port's GraphService on R-MAT(16384, 163840, seed 0):
                 a cold all-vertex bc_scores, 16 commits of 24 hot-set ops
                 each answered by BFS/SSSP/BC queries (one source in "cn"
                 mode) that must equal a fresh recompute bit for bit, a delta
                 bc_scores every 8 commits (the ring depth), and a dense-path
                 bc().  The kernel launch counts of this phase must be > 0.
                 Then the delta trees must equal a cold sweep bit for bit, the
                 scores must match the plain path (use_kernel=False) to 1e-5,
                 and a small graph must match a pure-Python Brandes oracle;
  4. report   -- one JSON line of kernels, the nvidia-smi line, and as the
                 last line {"ok": true, "device": {...}}.

It imports nothing of JAX or of the reference package ``repro``.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import deque

ROOT = os.path.dirname(os.path.abspath(__file__))
N_VERTICES, N_EDGES, SEED = 16384, 163840, 0
SRC_CHUNK = 2048
COMMITS, OPS_PER_COMMIT, HOT_FRAC = 16, 24, 0.05
RING_DEPTH, BATCH_SIZE = 8, 32
DEV = "cuda"
FP32_PEAK = 67e12       # H100 SXM FP32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12      # H100 SXM device memory, bytes/s
TOL = dict(rtol=1e-5, atol=1e-5)
# Granularity (rows x cols x k) at which the bound counts the masked
# product's work: the operands' own nonzero blocks at this fixed size, not
# the kernel's block shape, so the bound does not move when the kernel's
# blocks do.
WORK_BM, WORK_BN, WORK_BK = 64, 64, 32


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(torch, fn, reps=5) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


# --------------------------------- phase 2 ---------------------------------

SHAPES = [(128, 128, 128), (70, 200, 130), (1, 512, 64), (256, 64, 256)]
MASKED = [(64, 256, 192, 64, 0.3), (70, 200, 130, 64, 0.25),
          (33, 513, 129, 128, 0.2), (16, 96, 96, 16, 0.0),
          (16, 96, 96, 16, 1.0)]


def sparse_tiled(np, rng, k, n, tile, density):
    """{0,1} matrix whose ones live in a random subset of tiles."""
    mat = np.zeros((k, n), np.float32)
    for i in range(-(-k // tile)):
        for j in range(-(-n // tile)):
            if rng.random() < density:
                r0, c0 = i * tile, j * tile
                blk = rng.random((min(tile, k - r0), min(tile, n - c0)))
                mat[r0:r0 + blk.shape[0], c0:c0 + blk.shape[1]] = blk < 0.3
    return mat


def tile_occ(np, mat, tile):
    k, n = mat.shape
    nr, nc = -(-k // tile), -(-n // tile)
    pad = np.zeros((nr * tile, nc * tile), np.float32)
    pad[:k, :n] = mat
    return (pad.reshape(nr, tile, nc, tile) != 0).any(axis=(1, 3)).astype(
        np.int32)


class ErrLog:
    """Largest |kernel - plain| seen per kernel over every comparison."""

    def __init__(self):
        self.max = {"count_mm": 0.0, "count_mm_masked": 0.0}

    def check(self, torch, name, got, exp, exact, what):
        torch.cuda.synchronize()
        err = float((got - exp).abs().max()) if got.numel() else 0.0
        self.max[name] = max(self.max[name], err)
        ok = torch.equal(got, exp) if exact else torch.allclose(got, exp,
                                                                **TOL)
        log(f"  {name:16s} {what:40s} max_abs_err={err:.3g} "
            f"{'bit-exact' if exact else 'allclose 1e-5'}: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {what}")


def sweep_kernels(torch, np, errs):
    from repro_torch.core import semiring
    from repro_torch.kernels import ops as kops

    dev = DEV
    rng = np.random.default_rng(0)
    for s, k, n in SHAPES:
        f = (rng.random((s, k)) * 4).astype(np.int32).astype(np.float32)
        a = (rng.random((k, n)) < 0.1).astype(np.float32)
        ft, at = torch.tensor(f, device=dev), torch.tensor(a, device=dev)
        errs.check(torch, "count_mm", kops.count_mm(ft, at),
                   semiring.count_mm(ft, at, use_kernel=False), True,
                   f"int {s}x{k}x{n}")
        fr = torch.tensor(rng.standard_normal((s, k)).astype(np.float32),
                          device=dev)
        ar = torch.tensor(rng.standard_normal((k, n)).astype(np.float32),
                          device=dev)
        errs.check(torch, "count_mm", kops.count_mm(fr, ar),
                   semiring.count_mm(fr, ar, use_kernel=False), False,
                   f"float {s}x{k}x{n}")
    for s, k, n, tile, density in MASKED:
        a = sparse_tiled(np, rng, k, n, tile, density)
        f = (rng.random((s, k)) < 0.15).astype(np.float32)
        ft, at = torch.tensor(f, device=dev), torch.tensor(a, device=dev)
        am = torch.tensor(tile_occ(np, a, tile), device=dev)
        errs.check(torch, "count_mm_masked",
                   kops.count_mm(ft, at, amask=am, tile=tile),
                   semiring.count_mm(ft, at, use_kernel=False, amask=am,
                                     tile=tile), True,
                   f"masked {s}x{k}x{n} tile {tile} density {density}")
    # one live tile in the far corner: everything else is skipped
    tile, k, n, s = 32, 160, 160, 48
    a = np.zeros((k, n), np.float32)
    a[128:160, 128:160] = 1.0
    f = np.zeros((s, k), np.float32)
    f[:, 130] = 2.0
    ft, at = torch.tensor(f, device=dev), torch.tensor(a, device=dev)
    am = torch.tensor(tile_occ(np, a, tile), device=dev)
    got = kops.count_mm(ft, at, amask=am, tile=tile)
    errs.check(torch, "count_mm_masked", got,
               semiring.count_mm(ft, at, use_kernel=False, amask=am,
                                 tile=tile), True, "single live tile")
    if not bool((got[:, 128:160] == 2.0).all()):
        raise AssertionError("single-tile contribution lost")


def work_masks(x, a):
    """Which (WORK_BM x WORK_BK) slabs of ``x`` and (WORK_BK x WORK_BN)
    blocks of ``a`` hold a nonzero entry."""
    from repro_torch.kernels import ops as kops

    return (kops._slab_mask(x, WORK_BM, WORK_BK).bool(),
            kops._slab_mask(a, WORK_BK, WORK_BN).bool())


def capture_main_products(torch, state, view):
    """The inputs the main path hands the kernels: chunk 0 of the all-source
    sweep (``bc_batched_dense``'s adjacency, occupancy and per-level
    products), run with the plain product.  Returns the adjacency, its
    occupancy and the forward input with the most nonzero block pairs."""
    from repro_torch.core import queries
    from repro_torch.core.tiles import dense_views_from_tiles
    from repro_torch.kernels import ops as kops

    adj_mask, _, alive = dense_views_from_tiles(state, view)
    a = (adj_mask & alive[:, None] & alive[None, :]).float()
    V = a.shape[0]
    am_rows = kops._slab_mask(a, WORK_BK, WORK_BN).sum(dim=1).double()
    best = {"pairs": -1, "x": None}

    def fwd(x):
        sm = kops._slab_mask(x, WORK_BM, WORK_BK)
        pairs = float(sm.sum(dim=0).double() @ am_rows)
        if pairs > best["pairs"]:
            best.update(pairs=pairs, x=x.clone())
        return x @ a

    srcs = torch.arange(SRC_CHUNK, dtype=torch.int32, device=a.device)
    queries.bc_sweep_ops(fwd, lambda g: g @ a.t(), srcs, alive, V)
    return a, view.occ, best["x"]


def product_work(x, a):
    """(FLOPs, bytes) the masked product needs on these inputs, counted at
    the fixed WORK_* granularity: only the (slab, block) pairs where both
    operands hold a nonzero, each needed input block read once, the whole
    output and one int32 occupancy flag per block written/read once."""
    sm, am = work_masks(x, a)
    pairs = float(sm.sum(dim=0).double() @ am.sum(dim=1).double())
    s_blocks = float((sm & am.any(dim=1)[None, :]).sum())
    a_blocks = float((am & sm.any(dim=0)[:, None]).sum())
    S, N = x.shape[0], a.shape[1]
    flops = 2.0 * WORK_BM * WORK_BN * WORK_BK * pairs
    nbytes = 4.0 * (s_blocks * WORK_BM * WORK_BK + a_blocks * WORK_BK
                    * WORK_BN + S * N) + 4.0 * (sm.numel() + am.numel())
    return flops, nbytes


def main_shape_kernels(torch, state, view, errs):
    from repro_torch.kernels import count_mm as kc
    from repro_torch.kernels import ops as kops

    a, occ, x = capture_main_products(torch, state, view)
    S, V = x.shape
    log(f"  main-path product: s {S}x{V} (max count {float(x.max()):.0f}, "
        f"{float((x != 0).float().mean()):.4f} nonzero) x adjacency "
        f"{V}x{V} ({float(occ.gt(0).float().mean()):.4f} of 128-tiles live)")
    sm = kops._slab_mask(x, kc.BM, kc.BK)
    am = kops._coarsen_mask(occ, view.tile, kc.BK, V // kc.BK, kc.BN,
                            V // kc.BN)
    dense_k = kc.count_mm(x, a)
    dense_p = kc.count_mm_ref(x, a)
    if float(dense_p.abs().max()) >= 2**24:
        raise AssertionError("main-path counts reach 2^24: not exact in f32")
    errs.check(torch, "count_mm", dense_k, dense_p, True,
               f"main path {S}x{V}x{V}")
    masked_k = kc.count_mm_masked(x, a, sm, am)
    masked_p = kc.count_mm_masked_plain(x, a, sm, am)
    errs.check(torch, "count_mm_masked", masked_k, masked_p, True,
               f"main path {S}x{V}x{V}")
    errs.check(torch, "count_mm_masked", masked_k, dense_p, True,
               "main path, masked == dense")
    del dense_k, dense_p, masked_k, masked_p

    rows = []
    dense_flops = 2.0 * S * V * V
    dense_bytes = 4.0 * (S * V + V * V + S * V)
    mflops, mbytes = product_work(x, a)
    for name, kern, plain, flops, nbytes in (
            ("count_mm", lambda: kc.count_mm(x, a),
             lambda: kc.count_mm_ref(x, a), dense_flops, dense_bytes),
            ("count_mm_masked", lambda: kc.count_mm_masked(x, a, sm, am),
             lambda: kc.count_mm_masked_plain(x, a, sm, am), mflops,
             mbytes)):
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain, reps=3)
        library_ms = time_ms(torch, lambda: torch.matmul(x, a))
        t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
        bound = max(t_ops, t_bytes)
        log(f"  {name:16s} {S}x{V}x{V}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, torch.matmul {library_ms:.3f} ms, bound "
            f"{bound:.3f} ms ({flops:.4g} FLOP, {nbytes:.4g} B)")
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound,
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes"))
    return rows


# --------------------------------- phase 3 ---------------------------------

def commit_stream(np, rng, n):
    """Edge churn confined to a contiguous hot set of HOT_FRAC * n sources
    (the draw of benchmarks/bench_engine.py:make_commit_stream)."""
    from repro_torch.core import PUTE, REME

    size = max(2, int(n * HOT_FRAC))
    base = int(rng.integers(0, max(1, n - size)))
    hot = np.arange(base, base + size)
    stream = []
    for _ in range(COMMITS):
        ops = []
        for _ in range(OPS_PER_COMMIT):
            u = int(rng.choice(hot))
            v = int(rng.integers(0, n))
            if rng.random() < 0.6:
                ops.append((PUTE, u, v, float(rng.integers(1, 9))))
            else:
                ops.append((REME, u, v))
        stream.append(ops)
    return stream, base


def query_sources(torch, state, hot_base):
    """A hub, a vertex of the hot set, and the highest-id vertex with
    edges."""
    deg = torch.bincount(state.esrc[state.esrc < N_VERTICES].long(),
                         minlength=N_VERTICES)
    return [0, hot_base + 1, int(deg.nonzero().max())]


def ladder_round(svc, ops, sources, i):
    """Commit ``ops`` (the ``i``-th batch of the stream), then BFS/SSSP/BC
    from every source, source ``i % len(sources)`` in "cn" mode.  Returns
    ``[(kind, src, mode, reply)]``."""
    svc.submit_many(ops)
    svc.flush()
    out = []
    for j, src in enumerate(sources):
        for kind in ("bfs", "sssp", "bc"):
            mode = "cn" if j == i % len(sources) else "icn"
            out.append((kind, src, mode, svc.query(kind, src, mode=mode)))
    return out


def brandes_oracle(n, edges, alive):
    """Pure-Python all-source Brandes over live (u, v) edges."""
    adj = {u: [] for u in range(n)}
    for u, v in edges:
        adj[u].append(v)
    scores = [0.0] * n
    for s in range(n):
        if not alive[s]:
            continue
        dist, sigma, order = {s: 0}, {s: 1.0}, []
        q = deque([s])
        while q:
            u = q.popleft()
            order.append(u)
            for v in adj[u]:
                if v not in dist:
                    dist[v], sigma[v] = dist[u] + 1, 0.0
                    q.append(v)
                if dist[v] == dist[u] + 1:
                    sigma[v] += sigma[u]
        delta = {v: 0.0 for v in dist}
        for u in reversed(order):
            for v in adj[u]:
                if dist.get(v) == dist[u] + 1:
                    delta[u] += sigma[u] / sigma[v] * (1 + delta[v])
        for v, d in delta.items():
            if v != s:
                scores[v] += d
    return [sc if alive[v] else math.nan for v, sc in enumerate(scores)]


def small_oracle_check(torch, np):
    from repro_torch.core import PUTE, REMV, state_to_numpy
    from repro_torch.core.graph_state import INF, NOKEY
    from repro_torch.data import load_rmat_graph
    from repro_torch.engine import GraphService

    svc = GraphService(load_rmat_graph(64, 400, seed=3, weighted=False,
                                       device=DEV), batch_size=8)
    svc.submit_many([(REMV, 9), (PUTE, 60, 2, 1.0)])
    svc.flush()
    scores, _ = svc.bc_scores()
    st = state_to_numpy(svc.ring.latest.state)
    live = ((st.esrc != NOKEY) & (st.ew < INF)
            & st.alive[np.clip(st.esrc, 0, 63)]
            & st.alive[np.clip(st.edst, 0, 63)])
    exp = brandes_oracle(64, list(zip(st.esrc[live].tolist(),
                                      st.edst[live].tolist())),
                         st.alive.tolist())
    got = scores.cpu().numpy().astype(np.float64)
    if not np.allclose(got, exp, rtol=1e-4, atol=1e-4, equal_nan=True):
        raise AssertionError("bc_scores disagrees with the Brandes oracle")
    log(f"  small graph (64 vertices): bc_scores == pure-Python Brandes "
        f"(max |diff| {np.nanmax(np.abs(got - np.asarray(exp))):.3g})")


def main_path(torch, np, state, timings):
    from repro_torch.core import queries
    from repro_torch.core.tiles import dense_views_from_tiles
    from repro_torch.engine import GraphService, validate_incremental
    from repro_torch.kernels import count_mm as kc

    svc = GraphService(state, ring_depth=RING_DEPTH, batch_size=BATCH_SIZE)
    rng = np.random.default_rng(SEED)
    stream, hot_base = commit_stream(np, rng, N_VERTICES)
    sources = query_sources(torch, state, hot_base)
    log(f"  query sources {sources} (hot set starts at {hot_base})")
    torch.cuda.reset_peak_memory_stats()

    kc.reset_launches()
    t0 = time.perf_counter()
    scores, version = svc.bc_scores(src_chunk=SRC_CHUNK)
    torch.cuda.synchronize()
    timings["bc_scores cold"] = time.perf_counter() - t0
    log(f"  cold bc_scores at version {version}: "
        f"{timings['bc_scores cold']:.2f} s")
    checked, t_loop = 0, 0.0
    for i, ops in enumerate(stream):
        t0 = time.perf_counter()
        for kind, src, mode, reply in ladder_round(svc, ops, sources, i):
            snap = svc.ring.get(reply.version)
            if not validate_incremental(snap, src, reply.result, kind):
                raise AssertionError(
                    f"{kind}({src}) at version {reply.version} "
                    f"({reply.mode}, {mode}) != fresh recompute")
            checked += 1
        t_loop += time.perf_counter() - t0
        if (i + 1) % RING_DEPTH == 0:
            t0 = time.perf_counter()
            scores, version = svc.bc_scores(src_chunk=SRC_CHUNK)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            timings[f"bc_scores after commit {i + 1}"] = dt
            log(f"  bc_scores at version {version}: {dt:.2f} s "
                f"({svc.bc_scores_stats})")
    timings["16 commits + validated queries"] = t_loop
    state = svc.ring.latest.state
    t0 = time.perf_counter()
    v_probe = int(svc.ring.latest.state.alive.nonzero()[0])
    bc_dense = queries.bc(state, v_probe,
                          sources=torch.arange(SRC_CHUNK, device=DEV))
    torch.cuda.synchronize()
    timings[f"bc dense ({SRC_CHUNK} sources)"] = time.perf_counter() - t0
    launches = dict(kc.LAUNCHES)
    log(f"  {checked} ladder answers bit-identical to a fresh recompute")
    log(f"  ladder tallies {vars(svc.stats)}; bc_scores "
        f"{svc.bc_scores_stats}")
    log(f"  main-path kernel launches {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the main path never launched {name}")
    if svc.bc_scores_stats["delta"] < 1:
        raise AssertionError("no bc_scores call took the delta rung")

    # -- held against a cold sweep and the plain path (launches not counted)
    alive = state.alive
    if scores.shape != (N_VERTICES,) or not bool(
            torch.isfinite(scores[alive]).all()) or not bool(
            scores[~alive].isnan().all()):
        raise AssertionError("bc_scores: wrong shape or non-finite values")
    slot = svc._bc_scores
    view = svc.tile_view()
    adj_mask, _, alive_v = dense_views_from_tiles(state, view)
    t0 = time.perf_counter()
    _, sigma, level, ok = queries.bc_batched_dense(
        adj_mask, torch.arange(N_VERTICES, dtype=torch.int32, device=DEV),
        alive_v, amask=view.occ, src_chunk=SRC_CHUNK)
    torch.cuda.synchronize()
    timings["cold bc_batched_dense (comparison)"] = time.perf_counter() - t0
    for name, got, exp in (("level", slot["level"], level),
                           ("sigma", slot["sigma"], sigma),
                           ("ok", slot["ok"], ok)):
        if not torch.equal(got, exp):
            raise AssertionError(f"delta bc_scores {name} != cold sweep")
    log(f"  delta bc_scores level/sigma/ok bit-identical to a cold sweep "
        f"(max sigma {float(sigma.max()):.0f})")
    del sigma, level, ok
    t0 = time.perf_counter()
    plain, _ = svc.bc_scores(use_kernel=False, src_chunk=SRC_CHUNK)
    torch.cuda.synchronize()
    timings["plain bc_scores (comparison)"] = time.perf_counter() - t0
    err = float((plain - scores)[alive].abs().max())
    if not torch.allclose(scores, plain, equal_nan=True, **TOL):
        raise AssertionError(f"bc_scores kernel vs plain path: {err}")
    log(f"  bc_scores (kernels) == plain path to 1e-5 (max |diff| {err:.3g})")
    bc_plain = queries.bc(state, v_probe, use_kernel=False,
                          sources=torch.arange(SRC_CHUNK, device=DEV))
    if not torch.allclose(bc_dense, bc_plain, **TOL):
        raise AssertionError(f"bc({v_probe}) dense kernel {float(bc_dense)} "
                             f"!= plain {float(bc_plain)}")
    log(f"  bc({v_probe}) over {SRC_CHUNK} sources, dense kernel "
        f"{float(bc_dense):.6g} == plain {float(bc_plain):.6g}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs only on an NVIDIA GPU")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from repro_torch.core.tiles import build_tile_view
    from repro_torch.data import load_rmat_graph
    from repro_torch.kernels import build

    timings = {}
    log("== phase 0: device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    log(f"  torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    smi = nvidia_smi()
    log(f"  nvidia-smi: {smi}")

    log("== phase 1: build")
    t0 = time.perf_counter()
    build.load("count_mm")
    timings["build"] = time.perf_counter() - t0
    text = build.build_logs.get("count_mm", "")
    regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
    log(f"  count_mm: {regs or 'cached'}")
    log(f"  build {timings['build']:.2f} s")

    log("== phase 2: kernels against their plain versions")
    errs = ErrLog()
    t0 = time.perf_counter()
    sweep_kernels(torch, np, errs)
    state = load_rmat_graph(N_VERTICES, N_EDGES, seed=SEED, device=DEV)
    rows = main_shape_kernels(torch, state, build_tile_view(state), errs)
    torch.cuda.empty_cache()
    timings["kernels"] = time.perf_counter() - t0

    log("== phase 3: main path")
    t0 = time.perf_counter()
    launches = main_path(torch, np, state, timings)
    small_oracle_check(torch, np)
    timings["main path total"] = time.perf_counter() - t0
    for k, v in timings.items():
        log(f"  wall {k}: {v:.2f} s")

    log("== phase 4: report")
    sources = {"count_mm": "src/repro/kernels/count_mm.py:57",
               "count_mm_masked": "src/repro/kernels/count_mm.py:80"}
    kernels = []
    for row in rows:
        name = row["name"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/count_mm.cu",
            "replaces": sources[name], "launches": launches[name],
            "max_abs_err": errs.max[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
