#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a traceback and a nonzero
exit code:

  0. device   -- require CUDA, turn TF32 off, print the card's name and
                 power limit (nvidia-smi);
  1. build    -- compile the four CUDA sources under
                 src/repro_torch/kernels/csrc with nvcc, all at once, and
                 print each kernel's registers and spills (-Xptxas -v);
  2. kernels  -- each kernel's wrapper on the card against its plain PyTorch
                 version on the same inputs: the shape and mask-density sweeps
                 of tests/test_kernels.py, the single-tile mask, and the main
                 paths' own products (2048 sources x the R-MAT adjacency:
                 Brandes counts; the first and the widest BFS frontier and
                 SSSP distance matrix of the batched queries), and
                 flash_attention over the attention sweeps of
                 tests/test_kernels.py plus head_dim 64 and 128, in f32 and
                 bf16, plus count products whose sums reach 2^24 - 1, a
                 masked one on a float right operand (three bf16 planes),
                 a three-plane one on a 2^-9 grid (every f32 summation
                 order sums it alike), and a reading of the kernel and the
                 plain version against the exact product on normals.
                 count_mm on float inputs matches to rtol = atol = 1e-5,
                 flash_attention as FLASH_TOL states; everything else bit
                 for bit.  Each product is timed (CUDA events, median of 5)
                 beside its plain version (min-plus on a row subset: its
                 plain version cannot hold the full width), one library call
                 at the same shape where one computes the same function
                 (torch.matmul; for the boolean products torch._int_mm on
                 the int8-packed operands, the FP32 torch.matmul beside it),
                 and its bound (the masked products' work counted at the
                 fixed WORK_* granularity; the count products at their
                 tensor-core form, one bf16 product per nonzero piece of the
                 left operand's split, with all COUNT_TERMS products and the
                 FP32 bound beside it; the boolean products on the packed
                 int8 adjacency they read).  bool_mm is also held and timed
                 at the static mode's shape (STATIC_ROWS rows), and its two
                 packs are timed on their own; minplus_mm at the static
                 mode's call, one row of the widest SSSP pass through
                 ops.minplus_mm_against, bounded on that one row.  The
                 three masked kernels are also held and timed at phase
                 3g's band shapes (band_shape_kernels: rank 0's band of
                 4096 rows; BFS and SSSP 1 x 4096 x 16384, the ring's
                 counting products 2048 x 4096 x 16384 and, on the
                 transposed band, 2048 x 16384 x 4096), through the raw
                 entry points and through the ops path 3g runs;
  3a. main    -- the port's GraphService on R-MAT(16384, 163840, seed 0):
                 a cold all-vertex bc_scores, 16 commits of 24 hot-set ops
                 each answered by BFS/SSSP/BC queries (one source in "cn"
                 mode) that must equal a fresh recompute bit for bit, a delta
                 bc_scores every 8 commits (the ring depth), and a dense-path
                 bc().  The count_mm launch counts of this phase must be > 0.
                 Then the delta trees must equal a cold sweep bit for bit, the
                 scores must match the plain path (use_kernel=False) to 1e-5,
                 and a small graph must match a pure-Python Brandes oracle;
  3b. batched -- bfs_batched_dense and sssp_batched_dense from 2048 sources
                 on the same R-MAT state and tile view, dense and masked: the
                 two must be equal, equal the COO bfs/sssp on 8 sampled
                 sources, and find no negative cycle; all four bool/min-plus
                 kernels must launch;
  3c. workload -- the paper's Section 5 mix (repro_torch.bench.workload,
                 40/10/50 update/search/query, 45 ops) for BFS, SSSP and BC in
                 the PG-Cn, PG-Icn and static modes on R-MAT(16384): every
                 PG-Cn scan must end validated and static mode must launch the
                 dense kernels;
  3d. LM serving -- the port's serve entry point (repro_torch.launch.serve)
                 on mistral_nemo_12b (40 layers, d 5120, bf16, 12.2 B
                 parameters) and granite_moe_1b (24 layers, 32 experts top-8)
                 at full width and depth, random weights from seed 0: batch
                 4, prompt 2048, 32 generated tokens.  Each prefill must
                 launch flash_attention once per layer.  Then, per model:
                 the kernel against its plain version on layer 0's own
                 q/k/v (and timed there beside SDPA); the prefill's logits
                 against the port's "xla" attention path on the same
                 weights; the last decode step's logits against a fresh
                 "xla" prefill of prompt + generated tokens (LM_REL_TOL;
                 for the MoE model one decode step at a capacity that
                 drops nothing, since the served decode's capacity of 1
                 drops pairs a prefill keeps);
  3e. options -- GraphService with every option of the reference on
                 (Telemetry with a JSONL trace, device timer and cost
                 accounting; adaptive thresholds; ResiliencePolicy
                 (max_retries=1, allow_stale); the circuit breaker; an
                 OpJournal with segments; a HeartbeatMonitor; compaction
                 every 4 commits) over 3a's state (reloaded) and stream,
                 bc_scores cold and every 4 commits, with faults fired at the
                 collect points by a seeded FaultPlan.  Every reply must equal
                 the bare 3a service's at its version (BC delta and the scores
                 to 1e-5); stats.errors must equal the faults fired, with at
                 least one retry and one degraded reply, each after a fault of
                 its own query and naming a version still in the ring;
                 bc_scores must launch count_mm_masked and trace tile_refresh;
                 the exposition must validate and a GET /metrics on 127.0.0.1
                 return its families; obs.report must have a row per kind and
                 rung that ran; every finished query and collect span must
                 carry 0 < device_us <= its wall (CUDA events, stream time
                 host gaps included), and in a round run under
                 torch.profiler each collect's device_us must cover the
                 kernels launched inside it.  Then the service is
                 dropped and recover() rebuilds it from the compaction snapshot
                 and the journal tail: state, ledger and thresholds equal the
                 live ones and verify_service finds nothing; a second stream
                 crashes on a torn barrier and recovers to the last whole one
                 with the torn batch pending.  Prints p50/p99 per kind and
                 rung, both streams' walls, the snapshot's bytes and time, the
                 recovery times, the thresholds and each query's cost dict;
  3f. serving -- the async front end (repro_torch.serve.AsyncGraphService,
                 max_batch 32) over a GraphService(ring_depth=8,
                 batch_size=32, telemetry) on 3a's graph (reloaded) and
                 stream: 4 client threads of 48 query_async calls each
                 (BFS/SSSP/BC cycling over 16 sources, 3a's three and the
                 hot set's highest-degree vertices, in waves of 8) and an
                 updater committing the stream's 16 batches, batch i once
                 i/16 of the replies are in.  Every reply must be
                 torch.equal, field by field, BC delta included, to the
                 sequential query on the state at the version it names;
                 both rungs must have batched dispatches (>= 2 lanes); no
                 fallback, no error, no pin left.  Before that, the lane
                 forms (core.queries.*_lanes, engine.incremental.delta_*_lanes)
                 must equal sequential calls bit for bit at 32 lanes on the
                 stream's last state (delta priors 8 versions older) and
                 through a 17-lane dispatch padded to 32.  Then the same
                 schedule on one thread through svc.query, for queries/s;
                 a chaos run under serve.dispatch faults that must fall
                 back and stay exact; and, per kind and rung, one 32-lane
                 call against 32 sequential calls: wall, host reads and
                 (one torch.profiler session) kernel launches per query.
                 Prints replies and rung tallies, dispatches and the lane
                 histogram, serve_request_us p50/p99 per kind, commits
                 that overlapped a dispatch and peak memory;
  3g. sharded -- the sharded tile-grid engine (repro_torch.shard) on SHARDS
                 ranks of the one card (GraphMesh(["cuda:0"] * 4), band
                 4096): 3a's state and stream through the local
                 GraphService first (with telemetry whose accountant
                 measures nothing), then through ShardedGraphService(
                 use_kernel=True, src_chunk=SRC_CHUNK) once per bc_mode
                 (gather, ring): a cold bc_scores, per commit BFS/SSSP/BC
                 from 3a's sources (ladder_round), bc_scores every
                 RING_DEPTH commits.  Every reply must equal the local
                 service's at the same version bit for bit (BC delta and
                 bc_scores to 1e-5) with the cross-rank agreement set; the
                 delta and the full rung must run; bool_mm_masked,
                 minplus_mm_masked and count_mm_masked must launch in the
                 sharded runs; AsyncGraphService over the sharded service
                 (three clients, two commits landing) must answer every
                 request as the single-source query at its version.
                 Prints per kind and rung walls against the local
                 service's, bc_scores walls, collective bytes per query
                 and the peak memory of each mode;
  4. report   -- one JSON line of kernels, the nvidia-smi line, and as the
                 last line {"ok": true, "device": {...}}.  count_mm_masked's
                 launches are those of 3a, 3e and 3g; bool_mm_masked's and
                 minplus_mm_masked's those of 3b, 3c and 3g.  The masked
                 rows carry their band-shape timings under "band" (and
                 count_mm_masked's backward under "band_t").

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
SHARDS = 4              # ranks of 3g's mesh, all on the one card
DEV = "cuda"
FP32_PEAK = 67e12       # H100 SXM FP32 outside the tensor cores, FLOP/s
FP32_NONFMA = 33.5e12   # the same, one non-FMA FP32 instruction per op, op/s
INT8_PEAK = 1979e12     # H100 SXM int8 tensor cores (dense), op/s
BF16_PEAK = 989e12      # H100 SXM bf16 tensor cores (dense), FLOP/s
HBM_RATE = 3.35e12      # H100 SXM device memory, bytes/s
# bf16 products per k-step of the count kernel's exact split against the
# main path's {0,1} adjacency at most (csrc/count_mm.cu): hi, mid and lo
# of s; it skips a piece's products where the piece is zero
COUNT_TERMS = 3
TOL = dict(rtol=1e-5, atol=1e-5)
# Granularity (rows x cols x k) at which the bound counts the masked
# product's work: the operands' own nonzero blocks at this fixed size, not
# the kernel's block shape, so the bound does not move when the kernel's
# blocks do.
WORK_BM, WORK_BN, WORK_BK = 64, 64, 32
PLAIN_ROWS = 256        # rows of the min-plus products its plain version runs
STATIC_ROWS = 128       # the static mode's boolean product: one row block
N_SAMPLES = 8           # sources of the batched queries held against COO
WORKLOAD_OPS, WORKLOAD_MIX, UPDATE_BATCH = 45, (0.4, 0.1, 0.5), 8
KERNELS = {  # name: (CUDA source, the TPU kernel it replaces)
    "count_mm": ("count_mm", "src/repro/kernels/count_mm.py:57"),
    "count_mm_masked": ("count_mm", "src/repro/kernels/count_mm.py:80"),
    "bool_mm": ("bool_mm", "src/repro/kernels/bool_mm.py:67"),
    "bool_mm_masked": ("bool_mm", "src/repro/kernels/bool_mm.py:93"),
    "minplus_mm": ("minplus_mm", "src/repro/kernels/minplus_mm.py:65"),
    "minplus_mm_masked": ("minplus_mm",
                          "src/repro/kernels/minplus_mm.py:88"),
    "flash_attention": ("flash_attention",
                        "src/repro/kernels/flash_attention.py:88"),
}
# flash_attention against its plain version: f32 to 3e-5 (summation order);
# bf16 to one bf16 rounding step (both compute in f32 and round the output
# once, so they differ only where the f32 values straddle a rounding
# boundary).
FLASH_TOL = {"float32": dict(rtol=0.0, atol=3e-5),
             "bfloat16": dict(rtol=2**-7, atol=1e-5)}
# (b, hq, hkv, sq, skv, d, causal, window): tests/test_kernels.py's sweeps
# and the window / non-causal / ragged corners, at head_dims 16 to 128.
FLASH_SWEEP = [(1, 4, 4, 32, 32, 16, True, None),
               (2, 4, 2, 37, 53, 16, True, None),
               (1, 8, 1, 16, 64, 32, True, None),
               (2, 2, 2, 1, 40, 16, True, None),
               (1, 2, 2, 24, 40, 16, False, None),
               (1, 2, 2, 48, 48, 16, True, 8),
               (1, 4, 2, 100, 100, 32, False, 20),
               (2, 16, 8, 300, 300, 64, True, None),
               (1, 32, 8, 257, 513, 128, True, None),
               (2, 8, 2, 130, 70, 64, True, 40)]
# Keys a kernel row may carry beyond the required ones: the boolean rows'
# FP32 yardstick, the static mode's shape and the packs' own times.
EXTRA_KEYS = ("matmul_fp32_ms", "static", "pack_right_ms", "pack_left_ms",
              "pack_left_static_ms", "band", "band_t")
LM_ARCHS = ("mistral_nemo_12b", "granite_moe_1b")
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32
# Two bf16 forward passes that differ only in where they round (the flash
# kernel keeps the probabilities in f32, the "xla" path rounds them to
# bf16; a decode step and a prefill sum their products in other orders)
# agree on the logits to a relative L2 error of about sqrt(layers x
# roundings per layer) x 2^-9; the bound allows 5e-2 (logits of two
# different prompts differ by about 1.4).
LM_REL_TOL = 5e-2


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


def sparse_tiled(np, rng, k, n, tile, density, identity=0.0):
    """Matrix whose non-identity entries live in a random subset of tiles:
    {0,1} for identity 0, values in [0, 0.3) among +inf for identity +inf."""
    mat = np.full((k, n), identity, np.float32)
    for i in range(-(-k // tile)):
        for j in range(-(-n // tile)):
            if rng.random() < density:
                r0, c0 = i * tile, j * tile
                blk = rng.random((min(tile, k - r0), min(tile, n - c0)))
                live = blk < 0.3
                vals = blk.astype(np.float32) if identity else 1.0
                mat[r0:r0 + blk.shape[0], c0:c0 + blk.shape[1]] = np.where(
                    live, vals, identity)
    return mat


def tile_occ(np, mat, tile, identity=0.0):
    k, n = mat.shape
    nr, nc = -(-k // tile), -(-n // tile)
    pad = np.full((nr * tile, nc * tile), identity, np.float32)
    pad[:k, :n] = mat
    blocks = pad.reshape(nr, tile, nc, tile)
    live = np.isfinite(blocks) if identity else blocks != 0
    return live.any(axis=(1, 3)).astype(np.int32)


class ErrLog:
    """Largest |kernel - plain| seen per kernel over every comparison (0
    where both are the same infinity)."""

    def __init__(self):
        self.max = {name: 0.0 for name in KERNELS}

    def check(self, torch, name, got, exp, exact, what, tol=TOL):
        torch.cuda.synchronize()
        if got.dtype != exp.dtype or got.shape != exp.shape:
            raise AssertionError(f"{name} on {what}: {got.dtype} "
                                 f"{tuple(got.shape)} != plain {exp.dtype} "
                                 f"{tuple(exp.shape)}")
        got, exp = got.float(), exp.float()
        diff = torch.where(got == exp, 0.0, (got - exp).abs())
        err = float(diff.max()) if got.numel() else 0.0
        self.max[name] = max(self.max[name], err)
        ok = torch.equal(got, exp) if exact else torch.allclose(got, exp,
                                                                **tol)
        how = "bit-exact" if exact else (
            f"allclose rtol={tol['rtol']:.3g} atol={tol['atol']:.3g}")
        log(f"  {name:17s} {what:44s} max_abs_err={err:.3g} {how}: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {what}")


def sweep_kernels(torch, np, errs):
    from repro_torch.core import semiring
    from repro_torch.kernels import count_mm as kc
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
    # the 2^24 - 1 boundary: counts whose sums reach 2^24 - 1 (one entry of
    # 2^24 - 1, whose three bf16 pieces are all nonzero, and a row of
    # counts below 2^14 with the same sum) against a {0,1} adjacency
    s, k, n, tile = 256, 1024, 256, 64
    f = (rng.random((s, k)) * 40).astype(np.int32).astype(np.float64)
    f[0] = 0.0
    f[0, 3] = 2**24 - 1
    f[1] = (rng.random(k) * 2**14).astype(np.int32)
    f[1, -1] = 0.0
    f[1, -1] = 2**24 - 1 - f[1].sum()
    a = (rng.random((k, n)) < 0.05).astype(np.float32)
    a[:, 0] = 1.0
    a[:, n // 2:] = 0.0
    exact = f @ a.astype(np.float64)
    if exact.max() != 2**24 - 1:
        raise AssertionError("boundary case does not reach 2^24 - 1")
    ft = torch.tensor(f.astype(np.float32), device=dev)
    at = torch.tensor(a, device=dev)
    am = torch.tensor(tile_occ(np, a, tile), device=dev)
    exp = torch.tensor(exact.astype(np.float32), device=dev)
    errs.check(torch, "count_mm", kops.count_mm(ft, at), exp, True,
               f"int {s}x{k}x{n}, sums to 2^24 - 1")
    errs.check(torch, "count_mm_masked",
               kops.count_mm(ft, at, amask=am, tile=tile), exp, True,
               f"masked {s}x{k}x{n}, sums to 2^24 - 1")
    # the three-plane path (a not exact in bf16), masked
    fr = torch.tensor(rng.standard_normal((64, 256)).astype(np.float32),
                      device=dev)
    ar_np = sparse_tiled(np, rng, 256, 192, 64, 0.5) * rng.standard_normal(
        (256, 192)).astype(np.float32)
    ar = torch.tensor(ar_np, device=dev)
    if kc.right_planes(ar).shape[0] != 3:
        raise AssertionError("a float right operand took one plane")
    am = torch.tensor(tile_occ(np, ar_np, 64), device=dev)
    errs.check(torch, "count_mm_masked",
               kops.count_mm(fr, ar, amask=am, tile=64),
               semiring.count_mm(fr, ar, use_kernel=False, amask=am,
                                 tile=64), False,
               "masked float 64x256x192, three planes")
    # three planes on floats that every f32 summation order sums alike
    # (multiples of 2^-9 in [-1, 1]): the kernel against its plain version
    fg = (rng.integers(-512, 513, (200, 512)) / 512).astype(np.float32)
    ag = (rng.integers(-512, 513, (512, 300)) / 512).astype(np.float32)
    fg_t, ag_t = torch.tensor(fg, device=dev), torch.tensor(ag, device=dev)
    errs.check(torch, "count_mm", kops.count_mm(fg_t, ag_t),
               semiring.count_mm(fg_t, ag_t, use_kernel=False), False,
               "float 200x512x300 on a 2^-9 grid, three planes")
    # standard normals at the same shape: two f32 orders differ there, so
    # this is a reading of each against the exact product, not a check
    fn_np = rng.standard_normal((200, 512)).astype(np.float32)
    an_np = rng.standard_normal((512, 300)).astype(np.float32)
    fn_t, an_t = torch.tensor(fn_np, device=dev), torch.tensor(an_np,
                                                               device=dev)
    got = kops.count_mm(fn_t, an_t).cpu().numpy()
    plain = semiring.count_mm(fn_t, an_t, use_kernel=False).cpu().numpy()
    exact = fn_np.astype(np.float64) @ an_np.astype(np.float64)
    log(f"  count_mm          normal 200x512x300, three planes: max |plain "
        f"- exact| {np.abs(plain - exact).max():.3g}, max |kernel - exact| "
        f"{np.abs(got - exact).max():.3g}, max |kernel - plain| "
        f"{np.abs(got - plain).max():.3g}")
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


def sweep_traversal_kernels(torch, np, errs):
    """The sweeps of tests/test_kernels.py for the boolean and min-plus
    products, dense and masked, against their plain versions."""
    from repro_torch.core import semiring
    from repro_torch.kernels import ops as kops

    dev, inf = DEV, float("inf")
    rng = np.random.default_rng(1)

    def dist(s, k, inf_frac):
        d = rng.random((s, k)).astype(np.float32) * 9 - 1
        d[rng.random((s, k)) < inf_frac] = inf
        return torch.tensor(d, device=dev)

    for s, k, n in SHAPES:
        f = torch.tensor((rng.random((s, k)) < 0.15).astype(np.float32),
                         device=dev)
        a = torch.tensor((rng.random((k, n)) < 0.08).astype(np.float32),
                         device=dev)
        errs.check(torch, "bool_mm", kops.bool_mm(f, a),
                   semiring.bool_mm(f, a, use_kernel=False), True,
                   f"{s}x{k}x{n}")
        d, w = dist(s, k, 0.3), dist(k, n, 0.5)
        errs.check(torch, "minplus_mm", kops.minplus_mm(d, w),
                   semiring.minplus_mm(d, w, use_kernel=False), True,
                   f"{s}x{k}x{n}, negative weights")
    for s, k, n, tile, density in MASKED:
        what = f"masked {s}x{k}x{n} tile {tile} density {density}"
        a_np = sparse_tiled(np, rng, k, n, tile, density)
        a = torch.tensor(a_np, device=dev)
        f = torch.tensor((rng.random((s, k)) < 0.15).astype(np.float32),
                         device=dev)
        am = torch.tensor(tile_occ(np, a_np, tile), device=dev)
        errs.check(torch, "bool_mm_masked",
                   kops.bool_mm(f, a, amask=am, tile=tile),
                   semiring.bool_mm(f, a, use_kernel=False, amask=am,
                                    tile=tile), True, what)
        w_np = sparse_tiled(np, rng, k, n, tile, density, identity=inf)
        w = torch.tensor(w_np, device=dev)
        d = dist(s, k, 0.5)
        wm = torch.tensor(tile_occ(np, w_np, tile, identity=inf), device=dev)
        errs.check(torch, "minplus_mm_masked",
                   kops.minplus_mm(d, w, amask=wm, tile=tile),
                   semiring.minplus_mm(d, w, use_kernel=False, amask=wm,
                                       tile=tile), True, what)
    # one live tile in the far corner: everything else is skipped
    tile, k, n, s = 32, 160, 160, 48
    w_np = np.full((k, n), inf, np.float32)
    w_np[128:160, 128:160] = 1.0
    d = torch.full((s, k), inf, device=dev)
    d[:, 130] = 2.0
    w = torch.tensor(w_np, device=dev)
    wm = torch.tensor(tile_occ(np, w_np, tile, identity=inf), device=dev)
    got = kops.minplus_mm(d, w, amask=wm, tile=tile)
    errs.check(torch, "minplus_mm_masked", got,
               semiring.minplus_mm(d, w, use_kernel=False, amask=wm,
                                   tile=tile), True, "single live tile")
    f, a = torch.isfinite(d).float(), torch.isfinite(w).float()
    got_b = kops.bool_mm(f, a, amask=wm, tile=tile)
    errs.check(torch, "bool_mm_masked", got_b,
               semiring.bool_mm(f, a, use_kernel=False, amask=wm, tile=tile),
               True, "single live tile")
    if not (bool((got[:, 128:160] == 3.0).all())
            and bool(torch.isinf(got[:, :128]).all())
            and bool((got_b[:, 128:160] == 1.0).all())):
        raise AssertionError("single-tile contribution lost")
    # a slab of nothing but 0.0 distances (SSSP sources) is live for min-plus
    d = torch.full((128, 64), inf, device=dev)
    d[:, :16] = 0.0
    w = dist(64, 64, 0.5)
    wm = torch.ones((4, 4), dtype=torch.int32, device=dev)
    errs.check(torch, "minplus_mm_masked", kops.minplus_mm(d, w, amask=wm,
                                                           tile=16),
               semiring.minplus_mm(d, w, use_kernel=False), True,
               "slab of 0.0 distances only")


def _nonzero(x):
    return x != 0


def work_masks(x, a, nonidentity=_nonzero):
    """Which (WORK_BM x WORK_BK) slabs of ``x`` (all its rows when it has
    fewer than WORK_BM) and (WORK_BK x WORK_BN) blocks of ``a`` hold a
    non-identity entry."""
    from repro_torch.kernels import ops as kops

    bm = min(WORK_BM, x.shape[0])
    return (kops._slab_mask(x, bm, WORK_BK, nonidentity).bool(),
            kops._slab_mask(a, WORK_BK, WORK_BN, nonidentity).bool())


class Capture:
    """Wraps a product: records the first input and the one whose
    (slab, block) pairs with the right operand are the most, counted at the
    WORK_* granularity under the semiring's ``nonidentity``."""

    def __init__(self, product, right, nonidentity):
        from repro_torch.kernels import ops as kops

        self.product, self.nonidentity = product, nonidentity
        self.right_rows = kops._slab_mask(right, WORK_BK, WORK_BN,
                                          nonidentity).sum(dim=1).double()
        self.first = self.wide = None
        self.wide_level, self.best, self.calls = -1, -1.0, 0

    def __call__(self, x):
        from repro_torch.kernels import ops as kops

        sm = kops._slab_mask(x, WORK_BM, WORK_BK, self.nonidentity)
        pairs = float(sm.sum(dim=0).double() @ self.right_rows)
        if self.first is None:
            self.first = x.clone()
        if pairs > self.best:
            self.best, self.wide, self.wide_level = pairs, x.clone(), \
                self.calls
        self.calls += 1
        return self.product(x)


def capture_main_products(torch, state, view):
    """The inputs the main path hands the kernels: chunk 0 of the all-source
    sweep (``bc_batched_dense``'s adjacency, occupancy and per-level
    products), run with the plain product.  Returns the adjacency, its
    occupancy, and the forward and the backward input with the most
    nonzero block pairs."""
    from repro_torch.core import queries
    from repro_torch.core.tiles import dense_views_from_tiles

    adj_mask, _, alive = dense_views_from_tiles(state, view)
    a = (adj_mask & alive[:, None] & alive[None, :]).float()
    fwd = Capture(lambda x: x @ a, a, _nonzero)
    bwd = Capture(lambda g: g @ a.t(), a.t(), _nonzero)
    srcs = torch.arange(SRC_CHUNK, dtype=torch.int32, device=a.device)
    queries.bc_sweep_ops(fwd, bwd, srcs, alive, a.shape[0])
    return a, view.occ, fwd.wide, bwd.wide


def product_work(x, a, nonidentity=_nonzero, a_bytes=4):
    """(operations, bytes) the masked product needs on these inputs,
    counted at the fixed WORK_* granularity: only the (slab, block) pairs
    where both operands hold a non-identity entry (two operations per
    term: a multiply and an add, or an add and a min), each needed input
    block read once (f32, the right operand at ``a_bytes`` per entry as the
    kernel reads it), the whole f32 output and one int32 occupancy flag per
    block written/read once."""
    sm, am = work_masks(x, a, nonidentity)
    pairs = float(sm.sum(dim=0).double() @ am.sum(dim=1).double())
    s_blocks = float((sm & am.any(dim=1)[None, :]).sum())
    a_blocks = float((am & sm.any(dim=0)[:, None]).sum())
    S, N = x.shape[0], a.shape[1]
    bm = min(WORK_BM, S)
    flops = 2.0 * bm * WORK_BN * WORK_BK * pairs
    nbytes = (4.0 * (s_blocks * bm * WORK_BK + S * N)
              + a_bytes * a_blocks * WORK_BK * WORK_BN
              + 4.0 * (sm.numel() + am.numel()))
    return flops, nbytes


def dense_work(S, K, N, a_bytes=4):
    """(operations, bytes) of a dense S x K x N semiring product: f32 left
    operand and output, the right operand at ``a_bytes`` per entry."""
    return 2.0 * S * K * N, 4.0 * (S * K + S * N) + a_bytes * K * N


def kernel_row(torch, name, kern, plain, work, peak, library=None,
               plain_rows=None, fp32_ops=None, all_terms_ops=None,
               matmul_fp32=None):
    """Time ``kern`` (and ``plain``, ``library``) and bound it by
    ``work`` = (operations, bytes) at ``peak`` op/s and HBM_RATE.  For the
    count products ``fp32_ops`` are the same function's operations on the
    CUDA cores: their bound at FP32_PEAK (the old SIMT design's ceiling) is
    printed beside the tensor-core one, and so is the bound of
    ``all_terms_ops``, those of all COUNT_TERMS products at ``peak`` (what
    the split costs where no piece is zero).  Neither goes into the kernels
    line: it carries only this run's times and the one bound.  For the
    boolean products, whose library call is the int8 ``torch._int_mm``,
    ``matmul_fp32`` is the FP32 ``torch.matmul`` kept beside it for
    continuity with the earlier rows (as ``matmul_fp32_ms``)."""
    ops, nbytes = work
    ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain, reps=3)
    library_ms = None if library is None else time_ms(torch, library)
    fp32_ms = None if matmul_fp32 is None else time_ms(torch, matmul_fp32)
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_RATE * 1e3
    bound = max(t_ops, t_bytes)
    fp32 = None if fp32_ops is None else max(fp32_ops / FP32_PEAK * 1e3,
                                             t_bytes)
    terms = None if all_terms_ops is None else max(
        all_terms_ops / peak * 1e3, t_bytes)
    lib = "-" if library_ms is None else f"{library_ms:.3f} ms"
    if fp32_ms is not None:
        lib += f" (FP32 torch.matmul {fp32_ms:.3f} ms)"
    rows = "" if plain_rows is None else f" on its first {plain_rows} rows"
    alt = "" if fp32 is None else (
        f"; all {COUNT_TERMS} terms {terms:.3f} ms; FP32 bound {fp32:.3f} ms"
        f" ({fp32_ops:.4g} op at {FP32_PEAK:.4g})")
    log(f"  {name:17s} kernel {ms:.3f} ms, plain{rows} {plain_ms:.3f} ms, "
        f"library {lib}, bound {bound:.3f} ms ({ops:.4g} op at "
        f"{peak:.4g} op/s, {nbytes:.4g} B){alt}")
    row = dict(name=name, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound, plain_rows=plain_rows,
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    if fp32_ms is not None:
        row["matmul_fp32_ms"] = fp32_ms
    return row


def main_shape_kernels(torch, view, a, occ, x, errs):
    from repro_torch.kernels import count_mm as kc
    from repro_torch.kernels import ops as kops

    S, V = x.shape
    log(f"  main-path product: s {S}x{V} (max count {float(x.max()):.0f}, "
        f"{float((x != 0).float().mean()):.4f} nonzero) x adjacency "
        f"{V}x{V} ({float(occ.gt(0).float().mean()):.4f} of 128-tiles live)")
    sm = kops._slab_mask(x, kc.BM, kc.BK, _nonzero)
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
    live = float(sm.float().sum(dim=0) @ am.float().sum(dim=1)) / (
        sm.shape[0] * sm.shape[1] * am.shape[1])
    sm0 = kops._slab_mask(x, 64, 32, _nonzero)
    am0 = kops._coarsen_mask(occ, view.tile, 32, V // 32, 64, V // 64)
    live0 = float(sm0.float().sum(dim=0) @ am0.float().sum(dim=1)) / (
        sm0.shape[0] * sm0.shape[1] * am0.shape[1])
    log(f"  masked: {live:.4f} of the (slab, block) pairs live at the "
        f"kernel's {kc.BM}x{kc.BN}x{kc.BK} blocks, {live0:.4f} at 64x64x32")
    errs.check(torch, "count_mm_masked", masked_k, masked_p, True,
               f"main path {S}x{V}x{V}")
    errs.check(torch, "count_mm_masked", masked_k, dense_p, True,
               "main path, masked == dense")
    del dense_k, dense_p, masked_k, masked_p

    # The kernel's own form of the same exact function: one bf16 product on
    # the tensor cores for each piece of s's split (kc.split3) where the
    # piece is nonzero, counted at the WORK_* granularity (the right
    # operand, {0,1}, is one plane, split once as ops.count_mm_against
    # does; its planes are not timed).
    library = lambda: torch.matmul(x, a)  # noqa: E731
    planes = kc.right_planes(a)
    dense, masked = dense_work(S, V, V), product_work(x, a)
    pieces = [p.float() for p in kc.split3(x)]
    dense_ops = sum(2.0 * WORK_BM * WORK_BK * V * float(
        kops._slab_mask(p, WORK_BM, WORK_BK, _nonzero).sum())
        for p in pieces)
    masked_ops = sum(product_work(p, a)[0] for p in pieces)
    share = [round(float((p != 0).float().mean()), 4) for p in pieces]
    log(f"  s = hi + mid + lo, nonzero in {share} of the entries")
    del pieces
    return [
        kernel_row(torch, "count_mm", lambda: kc.count_mm(x, a, planes),
                   lambda: kc.count_mm_ref(x, a), (dense_ops, dense[1]),
                   BF16_PEAK, library, fp32_ops=dense[0],
                   all_terms_ops=COUNT_TERMS * dense[0]),
        kernel_row(torch, "count_mm_masked",
                   lambda: kc.count_mm_masked(x, a, sm, am, planes),
                   lambda: kc.count_mm_masked_plain(x, a, sm, am),
                   (masked_ops, masked[1]), BF16_PEAK, library,
                   fp32_ops=masked[0], all_terms_ops=COUNT_TERMS * masked[0])]


def main_shape_traversal(torch, state, view, errs):
    """The batched BFS/SSSP's own products: run both queries once from
    SRC_CHUNK sources with the dense kernels, capture the first and the
    widest frontier / distance matrix, and hold the four kernels against
    their plain versions on them (min-plus's plain versions on the first
    PLAIN_ROWS rows).  Then time each at the widest input."""
    from repro_torch.core import queries
    from repro_torch.core.tiles import dense_views_from_tiles
    from repro_torch.kernels import bool_mm as kb
    from repro_torch.kernels import minplus_mm as kmp
    from repro_torch.kernels import ops as kops

    inf = float("inf")
    adj, w, alive = dense_views_from_tiles(state, view)
    V = adj.shape[0]
    live2 = alive[:, None] & alive[None, :]
    a = (adj & live2).float()
    big = torch.where(live2, w, inf)
    del adj, live2
    srcs = torch.arange(SRC_CHUNK, dtype=torch.int32, device=DEV)
    bfs_cap = Capture(kops.bool_mm_against(a), a, _nonzero)
    queries.bfs_batched_ops(bfs_cap, srcs, alive, V)
    sssp_cap = Capture(kops.minplus_mm_against(big), big, torch.isfinite)
    queries.sssp_batched_ops(sssp_cap, srcs, alive, V)
    S, R = SRC_CHUNK, PLAIN_ROWS
    log(f"  captured: BFS {bfs_cap.calls} levels (widest frontier at level "
        f"{bfs_cap.wide_level}, {float((bfs_cap.wide != 0).float().mean()):.4f}"
        f" nonzero), SSSP {sssp_cap.calls} passes (widest at pass "
        f"{sssp_cap.wide_level}, "
        f"{float(torch.isfinite(sssp_cap.wide).float().mean()):.4f} finite)")

    am_b = kops._coarsen_mask(view.occ, view.tile, kb.BK, V // kb.BK, kb.BN,
                              V // kb.BN)
    # the min-plus mask as ops.minplus_mm_against narrows it, once
    am_m = kops._coarsen_mask(view.occ, view.tile, kmp.BK, V // kmp.BK,
                              kmp.BN, V // kmp.BN) & kops.minplus_live_blocks(
                                  big)
    # the adjacency packed once, as ops.bool_mm_against does
    apk = kb.pack_right(a)
    if not torch.equal(apk, kb.pack_right_plain(a)):
        raise AssertionError("pack_right disagrees with its plain version")
    # (label, frontier): the first and the widest level, and the static
    # mode's shape (one row block of the widest frontier)
    for label, f in (("first level", bfs_cap.first),
                     (f"level {bfs_cap.wide_level}", bfs_cap.wide),
                     (f"level {bfs_cap.wide_level} rows :{STATIC_ROWS}",
                      bfs_cap.wide[:STATIC_ROWS])):
        fm = kops._slab_mask(f, kb.BM, kb.BK, _nonzero)
        if not torch.equal(kb.pack_left(f), kb.pack_left_plain(f)):
            raise AssertionError(f"pack_left disagrees on {label}")
        what = f"main path {f.shape[0]}x{V}x{V}, {label}"
        dense_k = kb.bool_mm(f, a, apk)
        errs.check(torch, "bool_mm", dense_k, kb.bool_mm_ref(f, a), True,
                   what)
        masked_k = kb.bool_mm_masked(f, a, fm, am_b, apk)
        errs.check(torch, "bool_mm_masked", masked_k,
                   kb.bool_mm_masked_plain(f, a, fm, am_b), True, what)
        errs.check(torch, "bool_mm_masked", masked_k, dense_k, True,
                   f"main path, {label}, masked == dense")
    for label, d in (("first pass", sssp_cap.first),
                     (f"pass {sssp_cap.wide_level}", sssp_cap.wide)):
        dm = kops._slab_mask(d, kmp.BM, kmp.BK, torch.isfinite)
        dense_k = kmp.minplus_mm(d, big)
        errs.check(torch, "minplus_mm", dense_k[:R],
                   kmp.minplus_mm_plain(d[:R], big), True,
                   f"main path {S}x{V}x{V}, {label}, rows :{R}")
        masked_k = kmp.minplus_mm_masked(d, big, dm, am_m)
        errs.check(torch, "minplus_mm_masked", masked_k[:R],
                   kmp.minplus_mm_masked_plain(d[:R], big,
                                               dm[:R // kmp.BM], am_m),
                   True, f"main path {S}x{V}x{V}, {label}, rows :{R}")
        errs.check(torch, "minplus_mm_masked", masked_k, dense_k, True,
                   f"main path, {label}, masked == dense")
    del dense_k, masked_k
    # the static mode's call: one source's row, padded to the row granule
    d1 = sssp_cap.wide[:1].contiguous()
    static_mm = kops.minplus_mm_against(big)
    errs.check(torch, "minplus_mm", static_mm(d1),
               kmp.minplus_mm_plain(d1, big), True,
               f"static call 1x{V}x{V} through ops, pass "
               f"{sssp_cap.wide_level} row 0")

    f, d = bfs_cap.wide, sssp_cap.wide
    fm = kops._slab_mask(f, kb.BM, kb.BK, _nonzero)
    dm = kops._slab_mask(d, kmp.BM, kmp.BK, torch.isfinite)
    dr, dmr = d[:R].contiguous(), dm[:R // kmp.BM]
    bool_rows = bool_kernel_rows(torch, f, a, apk, fm, am_b)
    del apk
    dense = kernel_row(torch, "minplus_mm", lambda: kmp.minplus_mm(d, big),
                       lambda: kmp.minplus_mm_plain(dr, big),
                       dense_work(S, V, V), FP32_NONFMA, plain_rows=R)
    log("  static call, one row through ops.minplus_mm_against:")
    static = kernel_row(torch, "minplus_mm", lambda: static_mm(d1),
                        lambda: kmp.minplus_mm_plain(d1, big),
                        dense_work(1, V, V), FP32_NONFMA)
    dense["static"] = {key: static[key] for key in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    dense["static"]["m"] = 1
    return bool_rows + [
        dense,
        kernel_row(torch, "minplus_mm_masked",
                   lambda: kmp.minplus_mm_masked(d, big, dm, am_m),
                   lambda: kmp.minplus_mm_masked_plain(dr, big, dmr, am_m),
                   product_work(d, big, torch.isfinite), FP32_NONFMA,
                   plain_rows=R)]


def band_row(row, extra) -> dict:
    """The keys of a band-shape timing kept in a kernel row."""
    out = {key: row[key] for key in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")}
    out.update(extra)
    return out


def band_shape_kernels(torch, state, view, x, g, rows, errs):
    """The three masked kernels at 3g's band shapes: rank 0's band of the
    SHARDS-way grid (rows :V/SHARDS of the live adjacency and weights, its
    occupancy rows), held against their plain versions through the raw
    entry points and through the ``ops`` path 3g runs, then timed with
    their bound.  BFS and SSSP at 3g's query shape (one source, 3a's hub:
    its widest BFS level and its distances, on the band's columns), the
    ring's counting products at a bc_scores chunk (``x``/``g``: the widest
    forward and backward inputs of the all-source sweep's first chunk),
    forward ``[chunk, band] x [band, V]`` and backward ``[chunk, V] x [V,
    band]`` on the transposed band.  Adds ``band`` (and ``band_t``) to the
    rows of ``rows``."""
    from repro_torch.core import queries
    from repro_torch.core.tiles import dense_views_from_tiles
    from repro_torch.kernels import bool_mm as kb
    from repro_torch.kernels import count_mm as kc
    from repro_torch.kernels import minplus_mm as kmp
    from repro_torch.kernels import ops as kops

    inf = float("inf")
    V, tile = N_VERTICES, view.tile
    B = V // SHARDS
    adj, w, alive = dense_views_from_tiles(state, view)
    live2 = alive[:B, None] & alive[None, :]
    a = (adj[:B] & live2).float()                      # [B, V]
    big = torch.where(live2, w[:B], inf).contiguous()  # [B, V]
    occ = view.occ[:B // tile].contiguous()            # [nt/n, nt]
    del adj, w, live2
    dist = queries.bfs(state, 0).dist
    widest = int(torch.bincount(dist[dist > 0]).argmax())
    f1 = (dist[:B] == widest).float()[None]            # [1, B]
    d1 = queries.sssp(state, 0).dist[:B][None].contiguous()
    xb = x[:, :B].contiguous()                         # [chunk, B]
    at = a.t()                                         # [V, B], a view
    occ_t = occ.t()
    log(f"  band {B} of {V} (rank 0 of {SHARDS}): {float((a != 0).sum()):.0f}"
        f" live edges, {float((occ > 0).float().mean()):.4f} of its "
        f"128-tiles live; BFS level {widest} ({int(f1.sum())} of the band's "
        f"vertices), SSSP row {int(torch.isfinite(d1).sum())} finite")
    by_name = {row["name"]: row for row in rows}

    # bool_mm_masked: [1 -> BM, B] x [B, V], mask [nt/n, nt]
    fp = torch.zeros((kb.BM, B), device=a.device)
    fp[:1] = f1
    fm = kops._slab_mask(fp, kb.BM, kb.BK, _nonzero)
    am_b = kops._coarsen_mask(occ, tile, kb.BK, B // kb.BK, kb.BN,
                              V // kb.BN)
    apk = kb.pack_right(a)
    what = f"band 1x{B}x{V}"
    k = kb.bool_mm_masked(fp, a, fm, am_b, apk)
    errs.check(torch, "bool_mm_masked", k,
               kb.bool_mm_masked_plain(fp, a, fm, am_b), True, what)
    errs.check(torch, "bool_mm_masked", kops.bool_mm_against(
        a, amask=occ, tile=tile)(f1), kb.bool_mm_ref(f1, a), True,
        f"{what} through ops")
    row = kernel_row(torch, "bool_mm_masked",
                     lambda: kb.bool_mm_masked(fp, a, fm, am_b, apk),
                     lambda: kb.bool_mm_masked_plain(fp, a, fm, am_b),
                     product_work(f1, a, a_bytes=1), INT8_PEAK,
                     lambda: torch.matmul(f1, a))
    by_name["bool_mm_masked"]["band"] = band_row(
        row, {"shape": [1, B, V], "library": "torch.matmul (FP32 counts)"})

    # minplus_mm_masked: [1 -> BM, B] x [B, V], mask [nt/n, nt] narrowed
    dp = torch.full((kmp.BM, B), inf, device=a.device)
    dp[:1] = d1
    dm = kops._slab_mask(dp, kmp.BM, kmp.BK, torch.isfinite)
    am_m = kops._coarsen_mask(occ, tile, kmp.BK, B // kmp.BK, kmp.BN,
                              V // kmp.BN) & kops.minplus_live_blocks(big)
    k = kmp.minplus_mm_masked(dp, big, dm, am_m)
    errs.check(torch, "minplus_mm_masked", k,
               kmp.minplus_mm_masked_plain(dp, big, dm, am_m), True, what)
    errs.check(torch, "minplus_mm_masked", kops.minplus_mm_against(
        big, amask=occ, tile=tile)(d1), kmp.minplus_mm_plain(dp, big)[:1],
        True, f"{what} through ops")
    row = kernel_row(torch, "minplus_mm_masked",
                     lambda: kmp.minplus_mm_masked(dp, big, dm, am_m),
                     lambda: kmp.minplus_mm_masked_plain(dp, big, dm, am_m),
                     product_work(d1, big, torch.isfinite), FP32_NONFMA)
    by_name["minplus_mm_masked"]["band"] = band_row(row,
                                                    {"shape": [1, B, V]})

    # count_mm_masked, the ring's forward [chunk, B] x [B, V] and backward
    # [chunk, V] x [V, B] products on a bc_scores chunk
    for key, s_in, right, mask in (("band", xb, a, occ),
                                   ("band_t", g, at, occ_t)):
        m, kd = s_in.shape
        n = right.shape[1]
        sm = kops._slab_mask(s_in, kc.BM, kc.BK, _nonzero)
        am = kops._coarsen_mask(mask, tile, kc.BK, kd // kc.BK, kc.BN,
                                n // kc.BN)
        planes = kc.right_planes(right)
        exact = key == "band"  # integer counts; the backward flow is float
        what = f"{key} {m}x{kd}x{n}"
        k = kc.count_mm_masked(s_in, right, sm, am, planes)
        errs.check(torch, "count_mm_masked", k,
                   kc.count_mm_masked_plain(s_in, right, sm, am), exact,
                   what)
        errs.check(torch, "count_mm_masked", kops.count_mm_against(
            right, amask=mask, tile=tile)(s_in), k, True,
            f"{what} through ops")
        pieces = [p.float() for p in kc.split3(s_in)]
        ops_count = sum(product_work(p, right)[0] for p in pieces)
        del pieces
        row = kernel_row(
            torch, "count_mm_masked",
            lambda: kc.count_mm_masked(s_in, right, sm, am, planes),
            lambda: kc.count_mm_masked_plain(s_in, right, sm, am),
            (ops_count, product_work(s_in, right)[1]), BF16_PEAK,
            lambda: torch.matmul(s_in, right))
        by_name["count_mm_masked"][key] = band_row(row,
                                                   {"shape": [m, kd, n]})


def bool_kernel_rows(torch, f, a, apk, fm, am_b):
    """The boolean rows, timed at the widest frontier (S = SRC_CHUNK) with
    the adjacency packed once (``apk``), bounded on the operands as the
    kernel reads them (f32 f and output, int8 packed a) at the int8 rate.
    The library call is ``torch._int_mm`` on the packed operands (the same
    exact counts on the int8 tensor cores; its threshold is not timed),
    the FP32 ``torch.matmul`` beside it.  The dense row also carries the
    static mode's shape (M = STATIC_ROWS rows) under ``static`` and the
    two packs timed on their own."""
    from repro_torch.kernels import bool_mm as kb

    S, V = f.shape
    fpk = kb.pack_left(f)
    counts = torch._int_mm(fpk, apk.t())
    if not torch.equal((counts > 0).float(), kb.bool_mm(f, a, apk)):
        raise AssertionError("torch._int_mm > 0 disagrees with bool_mm")
    del counts
    dense = kernel_row(torch, "bool_mm", lambda: kb.bool_mm(f, a, apk),
                       lambda: kb.bool_mm_ref(f, a),
                       dense_work(S, V, V, a_bytes=1), INT8_PEAK,
                       lambda: torch._int_mm(fpk, apk.t()),
                       matmul_fp32=lambda: torch.matmul(f, a))
    fs = f[:STATIC_ROWS].contiguous()
    fspk = kb.pack_left(fs)
    log(f"  static shape, M = {STATIC_ROWS}:")
    static = kernel_row(torch, "bool_mm", lambda: kb.bool_mm(fs, a, apk),
                        lambda: kb.bool_mm_ref(fs, a),
                        dense_work(STATIC_ROWS, V, V, a_bytes=1), INT8_PEAK,
                        lambda: torch._int_mm(fspk, apk.t()),
                        matmul_fp32=lambda: torch.matmul(fs, a))
    dense["static"] = {key: static[key] for key in (
        "ms", "plain_ms", "library_ms", "matmul_fp32_ms", "bound_ms",
        "bound_by")}
    dense["static"]["m"] = STATIC_ROWS
    packs = {"pack_right_ms": time_ms(torch, lambda: kb.pack_right(a)),
             "pack_left_ms": time_ms(torch, lambda: kb.pack_left(f)),
             "pack_left_static_ms": time_ms(torch, lambda: kb.pack_left(fs))}
    log(f"  packs on their own: a {V}x{V} -> int8 transposed "
        f"{packs['pack_right_ms']:.3f} ms; f {S}x{V} "
        f"{packs['pack_left_ms']:.3f} ms; f {STATIC_ROWS}x{V} "
        f"{packs['pack_left_static_ms']:.4f} ms")
    dense.update(packs)
    masked = kernel_row(torch, "bool_mm_masked",
                        lambda: kb.bool_mm_masked(f, a, fm, am_b, apk),
                        lambda: kb.bool_mm_masked_plain(f, a, fm, am_b),
                        product_work(f, a, a_bytes=1), INT8_PEAK,
                        lambda: torch._int_mm(fpk, apk.t()),
                        matmul_fp32=lambda: torch.matmul(f, a))
    return [dense, masked]


def sweep_flash(torch, errs):
    """flash_attention on the card against its plain version over
    FLASH_SWEEP, in f32 and bf16, plus a prefix of a longer cache read
    through its strides."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels.ref import flash_attention_ref

    g = torch.Generator(device=DEV).manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        tol = FLASH_TOL[str(dtype).split(".")[-1]]
        for b, hq, hkv, sq, skv, d, causal, window in FLASH_SWEEP:
            q = torch.randn((b, hq, sq, d), generator=g, device=DEV).to(dtype)
            k = torch.randn((b, hkv, skv, d), generator=g,
                            device=DEV).to(dtype)
            v = torch.randn((b, hkv, skv, d), generator=g,
                            device=DEV).to(dtype)
            kw = dict(causal=causal, window=window)
            errs.check(torch, "flash_attention",
                       kf.flash_attention(q, k, v, **kw),
                       flash_attention_ref(q, k, v, **kw), False,
                       f"{str(dtype)[6:]} {b}x{hq}/{hkv}x{sq}x{skv}x{d} "
                       f"{'causal' if causal else 'full'} w={window}", tol)
        cache = torch.randn((2, 8, 700, 128), generator=g,
                            device=DEV).to(dtype)
        q = torch.randn((2, 500, 32, 128), generator=g,
                        device=DEV).to(dtype).transpose(1, 2)
        k, v = cache[:, :, :600], cache.flip(2)[:, :, :600]
        errs.check(torch, "flash_attention", kf.flash_attention(q, k, v),
                   flash_attention_ref(q, k, v), False,
                   f"{str(dtype)[6:]} strided q, cache prefix 600 of 700",
                   tol)


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
    log(f"  ladder tallies {svc.stats.as_dict()}; bc_scores "
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


# --------------------------------- phase 3b --------------------------------

def batch_sources(torch, np, state):
    """SRC_CHUNK sources whose first N_SAMPLES rows are the sampled ones:
    the highest-degree vertex, vertex 0, a vertex of the hot set, the
    highest-id vertex with edges, the last vertex, then random vertices."""
    _, hot_base = commit_stream(np, np.random.default_rng(SEED), N_VERTICES)
    deg = torch.bincount(state.esrc[state.esrc < N_VERTICES].long(),
                         minlength=N_VERTICES)
    picks = [int(deg.argmax())] + query_sources(torch, state, hot_base) + [
        N_VERTICES - 1]
    rng = np.random.default_rng(SEED + 1)
    while len(set(picks)) < N_SAMPLES:
        picks.append(int(rng.integers(0, N_VERTICES)))
    samples = list(dict.fromkeys(picks))[:N_SAMPLES]
    rest = np.setdiff1d(np.arange(N_VERTICES), samples)[:SRC_CHUNK - N_SAMPLES]
    srcs = torch.tensor(np.concatenate([samples, rest]), dtype=torch.int32,
                        device=DEV)
    return srcs, samples


def batched_phase(torch, np, state, view, timings):
    from repro_torch.core import queries
    from repro_torch.core.tiles import dense_views_from_tiles
    from repro_torch.kernels import bool_mm as kb
    from repro_torch.kernels import minplus_mm as kmp

    adj, w, alive = dense_views_from_tiles(state, view)
    srcs, samples = batch_sources(torch, np, state)
    log(f"  {SRC_CHUNK} sources; sampled {samples}")
    kb.reset_launches()
    kmp.reset_launches()
    out = {}
    for label, kw in (("dense", {}),
                      ("masked", dict(amask=view.occ, tile=view.tile))):
        for query, fn, arg, mod in (
                ("bfs", queries.bfs_batched_dense, adj, kb),
                ("sssp", queries.sssp_batched_dense, w, kmp)):
            before = sum(mod.LAUNCHES.values())
            t0 = time.perf_counter()
            out[query, label] = fn(arg, srcs, alive, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            steps = sum(mod.LAUNCHES.values()) - before
            timings[f"{query}_batched_dense {label}"] = dt
            log(f"  {query}_batched_dense {label:6s}: {dt:.3f} s, "
                f"{steps} {'levels' if query == 'bfs' else 'relax passes'}")
    launches = {**kb.LAUNCHES, **kmp.LAUNCHES}
    log(f"  batched-phase kernel launches {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the batched queries never launched {name}")

    bfs_d, bfs_m = out["bfs", "dense"], out["bfs", "masked"]
    (sd_d, neg_d), (sd_m, neg_m) = out["sssp", "dense"], out["sssp", "masked"]
    if bfs_d.shape != (SRC_CHUNK, N_VERTICES) or bfs_d.dtype != torch.int32:
        raise AssertionError("bfs_batched_dense: wrong shape or type")
    if sd_d.shape != (SRC_CHUNK, N_VERTICES) or neg_d.shape != (SRC_CHUNK,):
        raise AssertionError("sssp_batched_dense: wrong shape")
    for what, got, exp in (("bfs dist", bfs_m, bfs_d),
                           ("sssp dist", sd_m, sd_d),
                           ("sssp negcycle", neg_m, neg_d)):
        if not torch.equal(got, exp):
            raise AssertionError(f"masked {what} != dense {what}")
    if bool(neg_d.any()):
        raise AssertionError("a negative cycle found with positive weights")
    log(f"  masked == dense bit for bit (bfs, sssp, negcycle); no negative "
        f"cycle; {int((bfs_d >= 0).sum())} reached (source, vertex) pairs, "
        f"max level {int(bfs_d.max())}, max distance "
        f"{float(sd_d[torch.isfinite(sd_d)].max()):.0f}")
    t0 = time.perf_counter()
    for row, src in enumerate(samples):
        if not torch.equal(bfs_d[row], queries.bfs(state, src).dist):
            raise AssertionError(f"batched BFS from {src} != COO bfs")
        if not torch.equal(sd_d[row], queries.sssp(state, src).dist):
            raise AssertionError(f"batched SSSP from {src} != COO sssp")
    torch.cuda.synchronize()
    timings["COO bfs+sssp on the samples (comparison)"] = \
        time.perf_counter() - t0
    log(f"  {len(samples)} sampled sources equal the COO bfs/sssp bit for "
        f"bit")
    return launches


# --------------------------------- phase 3c --------------------------------

def workload_phase(torch, np, timings):
    from repro_torch.bench import workload as wl
    from repro_torch.kernels import bool_mm as kb
    from repro_torch.kernels import minplus_mm as kmp

    graph = wl.load_graph(N_VERTICES, device=DEV)
    rng = np.random.default_rng(SEED)
    kb.reset_launches()
    kmp.reset_launches()
    for query in ("bfs", "sssp", "bc"):
        ops = wl.make_ops(rng, WORKLOAD_OPS, N_VERTICES, WORKLOAD_MIX)
        for mode in ("pgcn", "pgicn", "static"):
            before = {**kb.LAUNCHES, **kmp.LAUNCHES}
            r = wl.run_mix(graph, ops, query, mode,
                           update_batch=UPDATE_BATCH)
            used = {k: v - before[k]
                    for k, v in {**kb.LAUNCHES, **kmp.LAUNCHES}.items()}
            q = max(r.queries, 1)
            timings[f"workload {query} {mode}"] = r.seconds
            log(f"  {query:4s} {mode:6s} {r.queries} queries: "
                f"{r.seconds / q * 1e3:9.2f} ms/query, collects/scan "
                f"{r.collects / q:.2f}, interrupts/query {r.interrupts / q:.2f}"
                f", kernel launches {used}")
            if r.queries <= 0:
                raise AssertionError(f"workload {query}/{mode} ran no query")
            if mode == "pgcn" and r.unvalidated:
                raise AssertionError(f"{r.unvalidated} PG-Cn {query} scans "
                                     f"ended unvalidated")
            dense = {"bfs": "bool_mm", "sssp": "minplus_mm"}.get(query)
            if mode == "static" and dense and used[dense] <= 0:
                raise AssertionError(f"static {query} never launched {dense}")
    launches = {**kb.LAUNCHES, **kmp.LAUNCHES}
    log(f"  workload-phase kernel launches {launches}")
    return launches


# --------------------------------- phase 3d --------------------------------

class FlashCapture:
    """Within ``with``: records clones of the inputs of the first
    ``ops.flash_attention`` call (a prefill's layer 0) and passes every
    call on unchanged."""

    def __init__(self):
        from repro_torch.kernels import ops as kops

        self.kops, self.first = kops, None

    def __enter__(self):
        self.orig = self.kops.flash_attention

        def wrapped(q, k, v, **kw):
            if self.first is None:
                self.first = (q.clone(), k.clone(), v.clone(), kw)
            return self.orig(q, k, v, **kw)

        self.kops.flash_attention = wrapped
        return self

    def __exit__(self, *exc):
        self.kops.flash_attention = self.orig


def attention_work(q, k, causal, window):
    """(operations, bytes) of one attention call on these inputs: 4 D
    operations per visible (query, key) pair (two products), q, k, v read
    and the output written once each."""
    import numpy as np
    from repro_torch.kernels.ref import flash_offset

    b, hq, sq, d = q.shape
    skv = k.shape[2]
    offs = flash_offset(sq, skv, causal)
    i = np.arange(sq)
    hi = np.clip(i + offs + 1, 0, skv)
    lo = np.zeros_like(i) if window is None else np.clip(
        i + offs - window + 1, 0, skv)
    pairs = float(np.maximum(hi - lo, 0).sum()) * b * hq
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return 4.0 * d * pairs, float(nbytes)


def rel_l2(torch, got, exp):
    return float(torch.linalg.vector_norm((got - exp).float())
                 / torch.linalg.vector_norm(exp.float()))


def lm_phase(torch, errs, timings):
    """Serve each LM_ARCHS model through the port's entry point, then hold
    the kernel, the "xla" path and a fresh prefill against what it did.
    Returns (flash launches of the serve runs, the kernel row timed at the
    first model's layer 0)."""
    import dataclasses

    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch import serve
    from repro_torch.models import get_model

    launches, row = 0, None
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        log(f"  {arch}: {cfg.num_layers} layers, d {cfg.d_model}, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}, experts "
            f"{cfg.num_experts} top-{cfg.top_k}, {cfg.dtype}, "
            f"{cfg.params_dense() / 1e9:.2f} B params")
        kf.reset_launches()
        t0 = time.perf_counter()
        with FlashCapture() as cap:
            r = serve.main(["--arch", arch, "--batch", str(LM_BATCH),
                            "--prompt-len", str(LM_PROMPT), "--gen",
                            str(LM_GEN)])
        wall = time.perf_counter() - t0
        n = kf.LAUNCHES["flash_attention"]
        launches += n
        steps = LM_GEN - 1
        timings[f"{arch} serve (init + prefill + decode)"] = wall
        log(f"  {arch} prefill {LM_BATCH}x{LM_PROMPT}: "
            f"{r.prefill_s * 1e3:.1f} ms ({LM_BATCH * LM_PROMPT / r.prefill_s:.0f}"
            f" tokens/s); decode {steps} steps: "
            f"{r.decode_s / steps * 1e3:.2f} ms/token "
            f"({LM_BATCH * steps / r.decode_s:.1f} tokens/s); peak device "
            f"memory {r.peak_bytes / 2**30:.2f} GiB; flash launches {n}")
        if n != cfg.num_layers:
            raise AssertionError(f"{arch}: the prefill launched "
                                 f"flash_attention {n} times, not once per "
                                 f"layer ({cfg.num_layers})")
        if (tuple(r.tokens.shape) != (LM_BATCH, LM_GEN)
                or int(r.tokens.min()) < 0
                or int(r.tokens.max()) >= cfg.vocab_size
                or not bool(torch.isfinite(r.prefill_logits).all())
                or not bool(torch.isfinite(r.last_logits).all())):
            raise AssertionError(f"{arch}: bad tokens or non-finite logits")

        q, k, v, kw = cap.first
        if (tuple(q.shape) != (LM_BATCH, cfg.num_heads, LM_PROMPT,
                               cfg.head_dim)
                or tuple(k.shape) != (LM_BATCH, cfg.num_kv_heads, LM_PROMPT,
                                      cfg.head_dim) or q.dtype != cfg.dtype):
            raise AssertionError(f"{arch}: layer 0 handed the kernel "
                                 f"{tuple(q.shape)} x {tuple(k.shape)}")
        errs.check(torch, "flash_attention", kf.flash_attention(q, k, v, **kw),
                   flash_attention_ref(q, k, v, **kw), False,
                   f"{arch} layer 0 {tuple(q.shape)}/{k.shape[1]}",
                   FLASH_TOL["bfloat16"])
        if row is None:
            row = kernel_row(
                torch, "flash_attention", lambda: kf.flash_attention(q, k, v),
                lambda: flash_attention_ref(q, k, v),
                attention_work(q, k, True, None), BF16_PEAK,
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True,
                                                       enable_gqa=True))
        del q, k, v, cap

        xla = get_model(dataclasses.replace(cfg, attn_impl="xla"))
        cache = xla.init_cache(LM_BATCH, LM_PROMPT, dtype=cfg.dtype)
        t0 = time.perf_counter()
        x_logits, cache = xla.prefill(r.params, r.prompts, cache)
        torch.cuda.synchronize()
        timings[f"{arch} prefill, xla path (comparison)"] = \
            time.perf_counter() - t0
        err = rel_l2(torch, r.prefill_logits, x_logits)
        agree = float((r.prefill_logits.argmax(-1)
                       == x_logits.argmax(-1)).float().mean())
        log(f"  {arch} prefill logits, flash vs xla path: rel L2 {err:.3g}, "
            f"max |diff| {float((r.prefill_logits - x_logits).abs().max()):.3g}"
            f", argmax agreement {agree:.2f}")
        if not err < LM_REL_TOL:
            raise AssertionError(f"{arch}: flash and xla prefill logits "
                                 f"differ by {err:.3g} (rel L2)")
        del cache, x_logits

        # A decode step must equal a fresh prefill of the same tokens, both
        # through the "xla" attention that decode runs (flash vs xla is held
        # above).  For an MoE model that holds only without capacity drops:
        # at decode an expert has max(1, int(B * k * 1.25 / E)) = 1 slot, so
        # the served decode drops pairs that a prefill keeps.  Its check
        # runs one decode step at capacity_factor = E / k (every token fits).
        seq = torch.cat([r.prompts, r.tokens[:, :-1]], dim=1)
        ncfg, dec = dataclasses.replace(cfg, attn_impl="xla"), r.last_logits
        if cfg.num_experts:
            ncfg = dataclasses.replace(
                ncfg, capacity_factor=cfg.num_experts / cfg.top_k)
            m = get_model(ncfg)
            cache = m.init_cache(LM_BATCH, seq.shape[1], dtype=cfg.dtype)
            _, cache = m.prefill(r.params, seq[:, :-1], cache)
            dec, cache = m.decode_step(r.params, seq[:, -1:], cache)
            del cache
        model = get_model(ncfg)
        cache = model.init_cache(LM_BATCH, seq.shape[1], dtype=cfg.dtype)
        f_logits, cache = model.prefill(r.params, seq, cache)
        err = rel_l2(torch, dec, f_logits)
        agree = float((dec.argmax(-1) == f_logits.argmax(-1)).float().mean())
        log(f"  {arch} {'last served' if dec is r.last_logits else 'no-drop'}"
            f" decode step vs a fresh prefill of {seq.shape[1]} tokens: rel "
            f"L2 {err:.3g}, argmax agreement {agree:.2f}")
        if not err < LM_REL_TOL:
            raise AssertionError(f"{arch}: decode logits differ from a "
                                 f"fresh prefill by {err:.3g} (rel L2)")
        del r, cache, f_logits, dec, model, xla
        torch.cuda.empty_cache()
    return launches, row


# --------------------------------- phase 3e --------------------------------

KINDS = ("bfs", "sssp", "bc")
SCORES_EVERY = 4        # bc_scores after every 4th commit (cold first)
COMPACT_EVERY = 4
SEGMENT_BYTES = 1 << 16
# Faults at the two collect points: a seeded Bernoulli stream per point.
# The points' hit sequence is set by the stream's shape alone (which
# collects have a cached prior), not by the graph, so this seed's firings
# -- among them a first attempt and its retry failing in one query -- are
# the same at any size.
FAULT_SEED, FAULT_RATE = 5, 0.05
CRASH_COMMITS, CRASH_AT = 3, 2   # the crash stream tears its third barrier


# Check 8's profiled round: a collect region's CUDA-event time must cover
# the kernels the profiler puts inside it, within 2% + 2 us for the two
# clocks (CUPTI's kernel times against the events' stream times).
REGION_COVER = (1.02, 2.0)


def collect_kernel_us(torch, fn):
    """Run ``fn`` under ``torch.profiler``; returns, in launch order, one
    ``(kind, device us)`` per ``collect:<kind>`` range the device timer
    opened: the summed device time of the kernels launched inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if DEV == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        if DEV == "cuda":
            torch.cuda.synchronize()
    evts = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CPU
                   and e.name.startswith("collect:")),
                  key=lambda e: e.time_range.start)
    return [(e.name[len("collect:"):],
             float(e.device_time_total if hasattr(e, "device_time_total")
                   else e.cuda_time_total)) for e in evts]


def same_result(torch, got, exp):
    """Bit for bit, BC ``delta`` to TOL."""
    for name, a, b in zip(type(exp)._fields, got, exp):
        ok = (torch.allclose(a, b, **TOL) if name == "delta"
              else a.dtype == b.dtype and torch.equal(a, b))
        if not ok:
            return False
    return True


def options_stream(torch, svc, stream, sources, plan, checks):
    """3a's stream through the service with every option on, under
    ``plan``: ``[(kind, src, mode, reply or None, faults fired)]`` and
    the bc_scores outputs by version.  A reply that claims a retry or a
    degraded answer must follow a fault fired in its own query, and a
    degraded reply's version must still be in the ring."""
    from repro_torch.kernels import count_mm as kc
    from repro_torch.resil import InjectedFault, fault_scope

    out, scores, launches, wall = [], {}, 0, 0.0

    def bc_scores():
        nonlocal launches
        kc.reset_launches()
        s, v = svc.bc_scores(src_chunk=SRC_CHUNK)
        torch.cuda.synchronize()
        launches += kc.LAUNCHES["count_mm_masked"]
        scores[v] = s

    bc_scores()
    with fault_scope(plan):
        for i, ops in enumerate(stream):
            t0 = time.perf_counter()
            svc.submit_many(ops)
            svc.flush()
            for j, src in enumerate(sources):
                for kind in KINDS:
                    mode = "cn" if j == i % len(sources) else "icn"
                    fired = plan.fired
                    try:
                        reply = svc.query(kind, src, mode=mode)
                    except InjectedFault:
                        reply = None
                    fired = plan.fired - fired
                    if reply is not None and (reply.retries or
                                              reply.degraded) and not fired:
                        raise AssertionError(
                            f"{kind}({src}) {reply.mode} retries "
                            f"{reply.retries} with no fault fired")
                    if reply is not None and reply.degraded and \
                            svc.ring.get_entry(reply.stale_version) is None:
                        raise AssertionError(
                            f"degraded {kind}({src}) names version "
                            f"{reply.stale_version}, not in the ring")
                    out.append((kind, src, mode, reply, fired))
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            if (i + 1) % SCORES_EVERY == 0:
                bc_scores()
    checks["count_mm_masked launches"] = launches
    return out, scores, wall


def options_phase(torch, np, timings):
    """Phase 3e: GraphService with telemetry, adaptive thresholds, the
    resilience policy, breaker, journal, heartbeat and compaction, on 3a's
    state and stream, held against the bare service.  Returns the
    ``count_mm_masked`` launches of its bc_scores calls."""
    import shutil
    import tempfile
    import urllib.request

    from repro_torch.core import state_to_numpy
    from repro_torch.data import load_rmat_graph
    from repro_torch.engine import GraphService
    from repro_torch.obs import Telemetry
    from repro_torch.obs import report as obs_report
    from repro_torch.obs.expo import validate_openmetrics
    from repro_torch.resil import (P_COLLECT_DELTA, P_COLLECT_DISPATCH,
                                   P_JOURNAL_TORN, FaultPlan, InjectedCrash,
                                   OpJournal, ResiliencePolicy, fault_scope,
                                   journal_meta, recover, verify_service)
    from repro_torch.runtime import HeartbeatMonitor

    state = load_rmat_graph(N_VERTICES, N_EDGES, seed=SEED, device=DEV)
    rng = np.random.default_rng(SEED)
    stream, hot_base = commit_stream(np, rng, N_VERTICES)
    sources = query_sources(torch, state, hot_base)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_3e_")
    try:
        # -- the bare 3a service: the answers every option must leave alone
        bare = GraphService(state, ring_depth=RING_DEPTH,
                            batch_size=BATCH_SIZE)
        answers, bare_scores, t_bare = {}, {}, 0.0
        bare_scores[0] = bare.bc_scores(src_chunk=SRC_CHUNK)[0]
        for i, ops in enumerate(stream):
            t0 = time.perf_counter()
            for kind, src, _, reply in ladder_round(bare, ops, sources, i):
                answers[(kind, src, reply.version)] = reply.result
            torch.cuda.synchronize()
            t_bare += time.perf_counter() - t0
            if (i + 1) % SCORES_EVERY == 0:
                s, v = bare.bc_scores(src_chunk=SRC_CHUNK)
                bare_scores[v] = s
        del bare

        # -- every option on, faults at the collect points
        trace = os.path.join(tmp, "trace.jsonl")
        wal = os.path.join(tmp, "wal.jsonl")
        tel = Telemetry.make(trace_path=trace)
        journal = OpJournal(wal, segment_bytes=SEGMENT_BYTES,
                            meta=journal_meta(state,
                                              {"batch_size": BATCH_SIZE}))
        svc = GraphService(
            state, ring_depth=RING_DEPTH, batch_size=BATCH_SIZE,
            telemetry=tel, adaptive=True,
            policy=ResiliencePolicy(max_retries=1, allow_stale=True),
            breaker=True, journal=journal, monitor=HeartbeatMonitor(),
            compact_every=COMPACT_EVERY)
        plan = FaultPlan(seed=FAULT_SEED, rate=FAULT_RATE,
                         points=(P_COLLECT_DISPATCH, P_COLLECT_DELTA))
        checks = {}
        out, scores, t_opts = options_stream(torch, svc, stream, sources,
                                             plan, checks)
        timings["3e stream, every option off (3a service)"] = t_bare
        timings["3e stream, every option on"] = t_opts

        # 1. same answers as the bare service
        for kind, src, mode, reply, _ in out:
            if reply is None:
                continue
            v = reply.stale_version if reply.degraded else reply.version
            if not same_result(torch, reply.result, answers[(kind, src, v)]):
                raise AssertionError(f"{kind}({src}, {mode}) at version {v} "
                                     f"({reply.mode}) != the bare service")
        for v, s in scores.items():
            if not torch.allclose(s, bare_scores[v], equal_nan=True, **TOL):
                raise AssertionError(f"bc_scores at version {v} != bare")
        modes = {}
        for kind, _, _, reply, _ in out:
            key = (kind, reply.mode if reply is not None else "raised")
            modes[key] = modes.get(key, 0) + 1
        log(f"  {len(out)} replies equal the bare service's at their "
            f"version ({sum(r is not None for *_, r, _ in out)} answered; "
            f"BC delta to 1e-5); {len(scores)} bc_scores to 1e-5")
        log(f"  replies by kind and rung {dict(sorted(modes.items()))}")

        # 2. every caught exception is a fault the plan fired
        st = svc.stats
        log(f"  service stats {st.as_dict()}")
        hits = {p: plan.hits.get(p, 0) for p in plan.points}
        log(f"  faults fired at the collect points {plan.fired} of their "
            f"hits {hits}: {plan.to_schedule()}")
        if st.errors != plan.fired:
            raise AssertionError(f"stats.errors {st.errors} != faults fired "
                                 f"{plan.fired}: a real error was caught")
        if st.retries < 1 or st.degraded < 1:
            raise AssertionError(f"retries {st.retries}, degraded "
                                 f"{st.degraded}: a rung did not run")

        # 3. bc_scores under telemetry launched the kernel
        spans = [r["span"] for r in tel.tracer.records]
        log(f"  bc_scores {dict(svc.bc_scores_stats)}, count_mm_masked "
            f"launches {checks['count_mm_masked launches']}, tile_refresh "
            f"spans {spans.count('tile_refresh')}")
        if checks["count_mm_masked launches"] <= 0:
            raise AssertionError("bc_scores never launched count_mm_masked")
        if svc.bc_scores_stats["delta"] < 1 or "tile_refresh" not in spans:
            raise AssertionError("no delta bc_scores / tile_refresh span")

        # compaction, then a committed tail and pending ops
        t0 = time.perf_counter()
        report = svc.compact_wal()
        timings["3e compaction"] = time.perf_counter() - t0
        log(f"  compaction at version {report['version']}: snapshot "
            f"{report['snapshot_bytes']} bytes in "
            f"{timings['3e compaction'] * 1e3:.1f} ms, segments dropped "
            f"{report['segments_dropped']}, journal rotations "
            f"{journal.rotations}, auto compactions "
            f"{svc.scheduler.stats.compacts}")
        tail_rng = np.random.default_rng(SEED + 1)
        tail, _ = commit_stream(np, tail_rng, N_VERTICES)
        # 8a. the tail's first round under the profiler: every collect's
        # event time covers the kernels launched inside it
        n0 = len(tel.tracer.records)
        regions = collect_kernel_us(torch, lambda: ladder_round(
            svc, tail[0], sources, len(stream)))
        spans = [r for r in tel.tracer.records[n0:]
                 if r["span"] == "collect"]
        if [k for k, _ in regions] != [r["kind"] for r in spans]:
            raise AssertionError(f"profiled collect ranges {regions} do not "
                                 f"match the round's collect spans")
        scale, slack = REGION_COVER
        busy = {}
        for (kind, kern), r in zip(regions, spans):
            if kern > r["device_us"] * scale + slack:
                raise AssertionError(
                    f"collect:{kind} kernels {kern:.1f} us outside its "
                    f"events' {r['device_us']} us: the events do not "
                    f"bracket the work")
            k, d = busy.get(kind, (0.0, 0.0))
            busy[kind] = (k + kern, d + r["device_us"])
        if DEV == "cuda" and not sum(k for k, _ in busy.values()) > 0:
            raise AssertionError("the profiled round ran no kernel")
        log("  profiled round, kernel time / event time of its collects: " +
            ", ".join(f"{kind} {k:.1f} / {d:.1f} us ({k / d:.3f})"
                      for kind, (k, d) in busy.items()))
        svc.submit_many(tail[1][:BATCH_SIZE // 2])

        # 6. the exposition and a scrape
        text = tel.exposition(journal=journal)
        problems = validate_openmetrics(text)
        if problems:
            raise AssertionError(f"exposition: {problems[:5]}")
        with tel.serve(port=0, journal=journal) as srv:
            with urllib.request.urlopen(srv.url, timeout=30) as resp:
                scraped = resp.read().decode()

        def families(t):
            return {ln.split()[2] for ln in t.splitlines()
                    if ln.startswith("# TYPE")}
        if families(scraped) != families(text) or validate_openmetrics(
                scraped):
            raise AssertionError("GET /metrics differs from the exposition")
        log(f"  exposition valid, {len(families(text))} families, "
            f"{len(text.splitlines())} lines; GET {srv.url} the same "
            f"families")

        # latency per kind and rung, from the registry
        for name in ("query_wall_us", "query_device_us"):
            for h in tel.registry.find(name):
                labels = dict(h.labels)
                qs = h.quantiles((0.5, 0.99))
                log(f"  {name} {labels['kind']}/{labels['mode']}: n "
                    f"{h.count}, p50 {qs[0.5]:.1f}, p99 {qs[0.99]:.1f}")
        log(f"  adaptive thresholds {svc.adaptive!r}; breaker "
            f"{svc.breaker!r}; commit stragglers "
            f"{svc.scheduler.stats.stragglers}")
        for key, cost in tel.accountant.snapshot().items():
            if "'cuda'" in key:
                log(f"  cost {key}: {cost}")

        # 7. the report covers the trace; 8. device time is real
        tel.close()
        files = [trace] + sorted(
            os.path.join(tmp, f) for f in os.listdir(tmp)
            if f.startswith("trace.jsonl."))
        records = obs_report.load_many(files)
        rows = obs_report.summarize(records)
        ran = {(k, r.mode) for k, _, _, r, _ in out if r is not None}
        have = {(r["kind"], r["mode"]) for r in rows}
        if not ran <= have:
            raise AssertionError(f"report rows miss {ran - have}")
        log(obs_report.render(rows))
        for r in records:
            done = (r["span"] == "collect" and "mode" in r) or (
                r["span"] == "query" and "error" not in r
                and not r["degraded"])
            # both rounded to 0.1 us; the events lie inside the span
            if done and not 0 < r["device_us"] <= r["wall_us"] + 0.1:
                raise AssertionError(f"span's device time not in (0, wall]: "
                                     f"{r}")
        log(f"  every finished collect and query span carries 0 < device_us "
            f"<= wall_us ({len(records)} records)")

        # 4. drop the service, recover from the snapshot + journal tail
        live = state_to_numpy(svc.ring.latest.state)
        ledger = {f: getattr(svc.scheduler.stats, f) for f in
                  ("ops_submitted", "ops_committed", "batches_committed")}
        ledger["pending"] = svc.scheduler.pending()
        thresholds = svc.adaptive.thresholds()
        version = svc.version
        journal.close()
        del svc, tel
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rec = recover(wal, ring_depth=RING_DEPTH, batch_size=BATCH_SIZE,
                      telemetry=Telemetry.make(), adaptive=True, device=DEV)
        torch.cuda.synchronize()
        timings["3e recovery"] = time.perf_counter() - t0
        got = {f: getattr(rec.scheduler.stats, f) for f in ledger
               if f != "pending"}
        got["pending"] = rec.scheduler.pending()
        if rec.version != version or got != ledger:
            raise AssertionError(f"recovered {rec.version} {got} != live "
                                 f"{version} {ledger}")
        for name, a, b in zip(type(live)._fields, live,
                              state_to_numpy(rec.ring.latest.state)):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"recovered state {name} differs")
        if rec.adaptive.thresholds() != thresholds:
            raise AssertionError(f"thresholds {rec.adaptive.thresholds()} "
                                 f"!= live {thresholds}")
        problems = verify_service(rec)
        if problems:
            raise AssertionError(f"verify_service: {problems}")
        log(f"  recovered version {rec.version} in "
            f"{timings['3e recovery'] * 1e3:.1f} ms: state bit-identical, "
            f"ledger {got}, thresholds {thresholds}, verify_service []")
        del rec

        # 5. a crash tears a barrier
        cwal = os.path.join(tmp, "crash.jsonl")
        csvc = GraphService(state, ring_depth=RING_DEPTH,
                            batch_size=BATCH_SIZE,
                            journal=OpJournal(cwal, meta=journal_meta(
                                state, {"batch_size": BATCH_SIZE})))
        crash_plan = FaultPlan({P_JOURNAL_TORN: [CRASH_AT]})
        try:
            with fault_scope(crash_plan):
                for ops in tail[:CRASH_COMMITS]:
                    csvc.submit_many(ops)
                    csvc.flush()
            raise AssertionError("the torn barrier did not crash")
        except InjectedCrash:
            pass
        csvc.scheduler.journal.close()
        t0 = time.perf_counter()
        crec = recover(cwal, state, ring_depth=RING_DEPTH,
                       batch_size=BATCH_SIZE, device=DEV)
        torch.cuda.synchronize()
        timings["3e crash recovery"] = time.perf_counter() - t0
        whole = state_to_numpy(csvc.ring.get(CRASH_AT))
        same = all(np.array_equal(a, b) for a, b in zip(
            whole, state_to_numpy(crec.ring.latest.state)))
        if crec.version != CRASH_AT or not same or \
                crec.scheduler._log != [tuple(op) for op in tail[CRASH_AT]]:
            raise AssertionError(
                f"crash recovery: version {crec.version}, state "
                f"{'equal' if same else 'differs'}, pending "
                f"{crec.scheduler.pending()}")
        log(f"  torn barrier {CRASH_AT + 1} of {CRASH_COMMITS}: recovered "
            f"version {crec.version} (the ring had {csvc.version}) in "
            f"{timings['3e crash recovery'] * 1e3:.1f} ms, the torn batch's "
            f"{crec.scheduler.pending()} ops pending")
        return checks["count_mm_masked launches"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------- phase 3f --------------------------------

SERVE_CLIENTS, SERVE_QUERIES, SERVE_SOURCES = 4, 48, 16
SERVE_WAVE = 8          # a client waits for its replies every 8 admissions
SERVE_BATCH = 32        # the front end's max_batch, and the lane checks' L
SERVE_PADDED = 17       # lanes of the padded dispatch check (pads to 32)
SERVE_WAIT = 300        # seconds any one wait of phase 3f may take
CHAOS_HITS = (0, 2, 5, 9)   # serve.dispatch hits that fail in the chaos run


def fresh(kind):
    """The single-source query of ``kind``."""
    from repro_torch.core import queries

    return {"bfs": queries.bfs, "sssp": queries.sssp,
            "bc": queries.bc_dependencies}[kind]


def host_reads(torch, fn) -> int:
    """Synchronising device-to-host reads while ``fn`` runs (each warns
    once under ``torch.cuda.set_sync_debug_mode("warn")``)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def launches_by_range(torch, fns):
    """Kernel launches of each thunk of ``fns`` (name -> thunk), all run in
    one ``torch.profiler`` session: the runtime's launch calls inside each
    thunk's ``record_function`` range.  Also returns the kernels the
    session saw on the device, which the ranges' sum should match."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, fn in fns.items():
            with record_function(f"lanes:{name}"):
                fn()
            torch.cuda.synchronize()
    # the raw events: building the profiler's event tree for the
    # sequential calls' ~10^5 ops would take longer than the calls
    events = prof.profiler.kineto_results.events()
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    ranges = {e.name()[len("lanes:"):]: (e.start_ns(), e.end_ns())
              for e in events
              if e.device_type() == cpu and e.name().startswith("lanes:")}
    starts = [e.start_ns() for e in events
              if e.device_type() == cpu and "LaunchKernel" in e.name()]
    device = sum(1 for e in events if e.device_type() == cuda
                 and not e.name().startswith(("Memcpy", "Memset", "lanes:")))
    return {name: sum(a <= t <= b for t in starts)
            for name, (a, b) in ranges.items()}, device


def serve_sources(torch, state, hot_base):
    """``query_sources``' three, then the hot set's vertices by out-degree
    (highest first), SERVE_SOURCES in all."""
    deg = torch.bincount(state.esrc[state.esrc < N_VERTICES].long(),
                         minlength=N_VERTICES)
    size = max(2, int(N_VERTICES * HOT_FRAC))
    order = torch.argsort(deg[hot_base:hot_base + size], descending=True,
                          stable=True).tolist()
    picks = query_sources(torch, state, hot_base)
    for i in order:
        if len(picks) == SERVE_SOURCES:
            break
        if hot_base + i not in picks:
            picks.append(hot_base + i)
    return picks


def serve_schedules(sources):
    """Each client's ``(kind, src)`` list: the kinds cycle BFS/SSSP/BC and
    the sources cycle too, so a client asks every pair once (48 = 3 x 16),
    each client from its own offset."""
    return [[(KINDS[q % 3], sources[(q + 5 * c) % len(sources)])
             for q in range(SERVE_QUERIES)] for c in range(SERVE_CLIENTS)]


def snapshot(state):
    return type(state)(*(t.clone() for t in state))


def serve_run(torch, state, stream, schedules, plan=None):
    """The clients and the updater through one ``AsyncGraphService``; the
    updater commits batch ``i`` of the stream once ``i`` 16ths of the
    replies are in.  Returns the replies ``[(kind, src, reply)]``, the
    states by version, the service, the front end, the telemetry and the
    wall."""
    from repro_torch.engine import GraphService
    from repro_torch.obs import Telemetry
    from repro_torch.resil import ResiliencePolicy, fault_scope
    from repro_torch.serve import AsyncGraphService

    tel = Telemetry.make(hlo=False)
    svc = GraphService(state, ring_depth=RING_DEPTH, batch_size=BATCH_SIZE,
                       telemetry=tel,
                       policy=ResiliencePolicy(max_retries=1)
                       if plan is not None else None)
    states = {0: snapshot(state)}
    replies, errs = [], []

    def client(sched):
        try:
            for w in range(0, len(sched), SERVE_WAVE):
                futs = [(k, s, srv.query_async(k, s))
                        for k, s in sched[w:w + SERVE_WAVE]]
                for k, s, f in futs:
                    replies.append((k, s, f.result(timeout=SERVE_WAIT)))
        except Exception as e:  # reported below, after the joins
            errs.append(e)

    every = sum(map(len, schedules)) // len(stream)

    def updater():
        # commit i once i * every replies are in: the sequential schedule's
        # interleaving, one commit per `every` queries
        try:
            for i, ops in enumerate(stream):
                deadline = time.perf_counter() + SERVE_WAIT
                while len(replies) < i * every and not errs:
                    if time.perf_counter() > deadline:
                        raise TimeoutError("the replies stopped coming")
                    time.sleep(1e-3)
                srv.submit_many(ops)
                for entry in srv.flush():
                    states[entry.version] = snapshot(entry.state)
        except Exception as e:
            errs.append(e)

    import threading

    with fault_scope(plan):
        srv = AsyncGraphService(svc, max_batch=SERVE_BATCH).start()
        try:
            threads = [threading.Thread(target=updater)] + [
                threading.Thread(target=client, args=(sched,))
                for sched in schedules]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=SERVE_WAIT)
                if t.is_alive():
                    raise AssertionError("a client or the updater hung")
            if not srv.drain(timeout=SERVE_WAIT):
                raise AssertionError("the front end did not drain")
            wall = time.perf_counter() - t0
        finally:
            srv.stop(timeout=SERVE_WAIT)
    if errs:
        raise AssertionError(f"phase 3f threads raised: {errs[:3]}")
    return replies, states, svc, srv, tel, wall


def check_replies(torch, replies, states):
    """Every reply ``torch.equal`` (every field, BC delta included) to the
    sequential query on the state at the version it names."""
    seen = {}
    for kind, src, reply in replies:
        v = reply.stale_version if reply.degraded else reply.version
        key = (kind, src, v)
        if key not in seen:
            seen[key] = fresh(kind)(states[v], src)
        for name, a, b in zip(type(seen[key])._fields, reply.result,
                              seen[key]):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(
                    f"{kind}({src}) at version {v} ({reply.mode}): {name} "
                    f"!= the sequential query")
    return len(seen)


def overlapping_commits(records):
    """Commit spans that overlap some dispatch span in host time."""
    disp = [(r["t_s"], r["t_s"] + r["wall_us"] / 1e6) for r in records
            if r["span"] == "dispatch"]
    return sum(1 for r in records if r["span"] == "commit" and any(
        a < r["t_s"] + r["wall_us"] / 1e6 and r["t_s"] < b
        for a, b in disp))


def stream_states(state, stream):
    """The state at every version of ``stream``, each batch committed
    through a plain GraphService: ``{version: state}``."""
    from repro_torch.engine import GraphService

    svc = GraphService(state, ring_depth=RING_DEPTH, batch_size=BATCH_SIZE)
    states = {0: state}
    for ops in stream:
        svc.submit_many(ops)
        for entry in svc.flush():
            states[entry.version] = entry.state
    return states


def serve_lane_inputs(torch, states, sources):
    """SERVE_BATCH sources (the serve sources, then vertices with edges
    drawn from SEED + 2) and, per kind, the delta rung's lanes at the
    newest version with priors from the ring-depth-older one:
    ``{kind: [(src, prior, dirty, cut)]}``, usable lanes only (prior ok;
    BC cut >= 1), as ``classify_local`` would admit them."""
    import numpy as np

    from repro_torch.core import dirty_vertices, queries

    new, old = max(states), max(states) - RING_DEPTH
    state = states[new]
    deg = torch.bincount(state.esrc[state.esrc < N_VERTICES].long(),
                         minlength=N_VERTICES)
    rng = np.random.default_rng(SEED + 2)
    srcs = list(sources)
    while len(srcs) < SERVE_BATCH:
        v = int(rng.integers(0, N_VERTICES))
        if int(deg[v]) > 0 and v not in srcs:
            srcs.append(v)
    dirty = dirty_vertices(states[old], state)
    delta = {}
    for kind in KINDS:
        lanes = []
        for src in srcs:
            prior = fresh(kind)(states[old], src)
            if not bool(prior.ok):
                continue
            cut = None
            if kind == "bc":
                cut = int(queries.bc_level_cut(prior.level, dirty,
                                               state.alive))
                if cut < 1:
                    continue
            lanes.append((src, prior, dirty, cut))
        delta[kind] = lanes
    return state, srcs, delta


def lane_calls(torch, state, srcs, delta):
    """Per kind and rung: ``(one lane-batched call, the same lanes as
    single-source calls)``, as thunks returning lists of results."""
    from repro_torch.core import queries
    from repro_torch.engine import incremental as inc
    from repro_torch.serve.batch import _stack_pad, _unstack

    lanes_fn = {"bfs": queries.bfs_lanes, "sssp": queries.sssp_lanes,
                "bc": queries.bc_dependencies_lanes}
    delta_lanes = {"bfs": inc.delta_bfs_lanes, "sssp": inc.delta_sssp_lanes,
                   "bc": inc.delta_bc_at_cut_lanes}
    delta_one = {"bfs": inc.delta_bfs, "sssp": inc.delta_sssp,
                 "bc": inc._delta_bc_at_cut}
    src_t = torch.tensor(srcs, dtype=torch.int32, device=state.device)
    calls = {}
    for kind in KINDS:
        calls[kind, "full"] = (
            lambda kind=kind: _unstack(lanes_fn[kind](state, src_t),
                                       len(srcs)),
            lambda kind=kind: [fresh(kind)(state, s) for s in srcs])
        lanes = delta[kind]
        ls = torch.tensor([ln[0] for ln in lanes], dtype=torch.int32,
                          device=state.device)
        priors = _stack_pad([ln[1] for ln in lanes], 0)
        third = ([ln[3] for ln in lanes] if kind == "bc"
                 else _stack_pad([ln[2] for ln in lanes], 0))
        calls[kind, "delta"] = (
            lambda kind=kind, ls=ls, priors=priors, third=third, n=len(
                lanes): _unstack(delta_lanes[kind](state, priors, third,
                                                   ls), n),
            lambda kind=kind, lanes=lanes: [
                delta_one[kind](state, p, c if kind == "bc" else d, s)
                for s, p, d, c in lanes])
    return calls


def lane_checks(torch, states, sources):
    """The lane forms bit for bit against sequential calls on the card,
    each kind and rung, at SERVE_BATCH lanes and through the padded
    dispatch (SERVE_PADDED lanes pad to SERVE_BATCH).  Returns the calls
    and their lane counts for ``lane_measure``."""
    from repro_torch.serve import Lane, dispatch_local_group, pad_pow2

    state, srcs, delta = serve_lane_inputs(torch, states, sources)
    calls = lane_calls(torch, state, srcs, delta)
    for (kind, rung), (batched, sequential) in calls.items():
        got, exp = batched(), sequential()
        for i, (a, b) in enumerate(zip(got, exp)):
            for name, x, y in zip(type(b)._fields, a, b):
                if x.dtype != y.dtype or not torch.equal(x, y):
                    raise AssertionError(f"{kind} {rung} lane {i} ({name}) "
                                         f"!= the single-source call")
        if rung == "delta":
            # where the delta answer stands it is the full answer too
            for (src, *_), a in zip(delta[kind], got):
                if kind == "sssp" and bool(a.negcycle):
                    continue
                if not all(torch.equal(x, y) for x, y in
                           zip(a, fresh(kind)(state, src))):
                    raise AssertionError(f"delta {kind}({src}) != full")
        log(f"  {kind} {rung}: {len(got)} lanes == {len(exp)} sequential "
            f"calls bit for bit")
        # the dispatcher's own path, padded
        if rung == "full":
            lanes = [Lane(i, s, "full") for i, s in
                     enumerate(srcs[:SERVE_PADDED])]
        else:
            lanes = [Lane(i, s, "delta", prior=p, dirty=d, cut=c)
                     for i, (s, p, d, c) in
                     enumerate(delta[kind][:SERVE_PADDED])]
        results, sizes = dispatch_local_group(None, kind, state, lanes)
        for ln, res in zip(lanes, results):
            want = exp[ln.index] if ln.mode == rung else \
                fresh(kind)(state, ln.src)
            if not all(torch.equal(x, y) for x, y in zip(res, want)):
                raise AssertionError(f"padded {kind} {rung} lane {ln.index}"
                                     f" != sequential")
        log(f"    padded dispatch {len(lanes)} -> {pad_pow2(len(lanes))} "
            f"lanes {sizes} bit for bit")

    sizes = {(kind, rung): len(delta[kind]) if rung == "delta"
             else len(srcs) for kind, rung in calls}
    return calls, sizes


def lane_measure(torch, calls, sizes, timings):
    """Per kind and rung, per query: wall, host reads and (one profiler
    session for every call) kernel launches of one lane-batched call
    against the same lanes as sequential calls."""
    rows, thunks = {}, {}
    start = time.perf_counter()
    for (kind, rung), (batched, sequential) in calls.items():
        n = sizes[kind, rung]
        row = rows[f"{kind} {rung}"] = {"lanes": n}
        for label, fn in (("batched", batched), ("sequential", sequential)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            row[f"{label}_ms"] = (time.perf_counter() - t0) * 1e3 / n
            row[f"{label}_reads"] = host_reads(torch, fn) / n
            thunks[f"{kind} {rung} {label}"] = fn
    timings["3f lane walls and host reads"] = time.perf_counter() - start
    start = time.perf_counter()
    counts, device = launches_by_range(torch, thunks)
    timings["3f lane profile"] = time.perf_counter() - start
    if not sum(counts.values()):
        raise AssertionError("the profiler saw no kernel launch calls")
    log(f"  profiled lane calls: {sum(counts.values())} launch calls in "
        f"their ranges, {device} kernels on the device")
    for key, row in rows.items():
        for label in ("batched", "sequential"):
            row[f"{label}_launches"] = counts[f"{key} {label}"] / row["lanes"]
        log(f"  {key}, {row['lanes']} lanes, per query batched / sequential:"
            f" launches {row['batched_launches']:.1f} / "
            f"{row['sequential_launches']:.1f}, host reads "
            f"{row['batched_reads']:.2f} / {row['sequential_reads']:.2f}, "
            f"wall {row['batched_ms']:.3f} / {row['sequential_ms']:.3f} ms")
    return rows


def serve_phase(torch, np, timings):
    """Phase 3f: the async serving front end on 3a's graph and stream, four
    clients and an updater; every reply held against the sequential query
    at its version; the lane forms against sequential calls; a chaos run
    under serve.dispatch faults.  Returns the lane rows and the numbers it
    printed, for the summary line."""
    from repro_torch.data import load_rmat_graph
    from repro_torch.engine import GraphService
    from repro_torch.obs import Telemetry
    from repro_torch.resil import P_SERVE_DISPATCH, FaultPlan

    state = load_rmat_graph(N_VERTICES, N_EDGES, seed=SEED, device=DEV)
    rng = np.random.default_rng(SEED)
    stream, hot_base = commit_stream(np, rng, N_VERTICES)
    sources = serve_sources(torch, state, hot_base)
    schedules = serve_schedules(sources)
    n_queries = sum(map(len, schedules))
    log(f"  {SERVE_CLIENTS} clients x {SERVE_QUERIES} queries over sources "
        f"{sources}; {len(stream)} commits of {OPS_PER_COMMIT} ops")
    summary = {"queries": n_queries}

    # -- the lane forms against sequential calls; first, so that every
    # kernel of the lane path is loaded before the front end is timed
    t0 = time.perf_counter()
    calls, sizes = lane_checks(torch, stream_states(state, stream), sources)
    timings["3f lane checks"] = time.perf_counter() - t0

    # -- the clean run
    torch.cuda.reset_peak_memory_stats()
    replies, states, svc, srv, tel, wall = serve_run(torch, state, stream,
                                                     schedules)
    peak = torch.cuda.max_memory_allocated()
    timings["3f front end"] = wall
    checked = check_replies(torch, replies, states)
    st, ss = svc.stats, srv.stats
    tally = {}
    for kind, _, reply in replies:
        tally[kind, reply.mode] = tally.get((kind, reply.mode), 0) + 1
    log(f"  {len(replies)} replies torch.equal to the sequential query at "
        f"their version ({checked} distinct (kind, source, version)); by "
        f"kind and rung {dict(sorted(tally.items()))}")
    log(f"  service {st.as_dict()}; front end dispatches {ss.dispatches}, "
        f"batched {ss.batched_dispatches}, max batch {ss.max_batch_seen}, "
        f"fallbacks {ss.fallbacks}, expired {ss.deadline_expired}")
    hist = {}
    for h in tel.registry.find("serve_batch_size"):
        rung = dict(h.labels)["rung"]
        for n in h.samples:
            hist.setdefault(rung, {}).setdefault(int(n), 0)
            hist[rung][int(n)] += 1
    hist = {r: dict(sorted(c.items())) for r, c in sorted(hist.items())}
    log(f"  lanes per dispatch (lanes: dispatches) {hist}")
    latency = {}
    for h in tel.registry.find("serve_request_us"):
        qs = h.quantiles((0.5, 0.99))
        latency[dict(h.labels)["kind"]] = [qs[0.5], qs[0.99]]
        log(f"  serve_request_us {dict(h.labels)['kind']}: n {h.count}, p50 "
            f"{qs[0.5]:.1f}, p99 {qs[0.99]:.1f}")
    overlap = overlapping_commits(tel.tracer.records)
    log(f"  {overlap} of {len(stream)} commits landed while a dispatch was "
        f"in flight; peak device memory {peak / 2**30:.2f} GiB")
    summary.update(dispatches=ss.dispatches,
                   batched_dispatches=ss.batched_dispatches,
                   max_batch_seen=ss.max_batch_seen, lanes_hist=hist,
                   request_us=latency, overlapping_commits=overlap,
                   peak_gib=peak / 2**30, front_end_s=wall,
                   rungs={f"{k} {m}": n for (k, m), n in tally.items()})
    if len(replies) != n_queries or st.queries != n_queries:
        raise AssertionError(f"{len(replies)} replies, {st.queries} queries "
                             f"for {n_queries} admitted")
    if st.unchanged + st.delta + st.full != st.queries:
        raise AssertionError(f"ladder tallies do not add up: {st.as_dict()}")
    if ss.fallbacks or st.errors:
        raise AssertionError(f"clean run: {ss.fallbacks} fallbacks, "
                             f"{st.errors} errors")
    for rung in ("full", "delta"):
        if not any(n >= 2 for n in hist.get(rung, {})):
            raise AssertionError(f"no batched dispatch on the {rung} rung")
    if svc.ring.pinned_versions():
        raise AssertionError(f"pins left: {svc.ring.pinned_versions()}")
    del svc, srv, tel, replies, states

    # -- the same schedule, one thread, through svc.query
    seq = GraphService(state, ring_depth=RING_DEPTH, batch_size=BATCH_SIZE,
                       telemetry=Telemetry.make(hlo=False))
    order = [q for w in range(0, SERVE_QUERIES, SERVE_WAVE)
             for sched in schedules for q in sched[w:w + SERVE_WAVE]]
    every = len(order) // len(stream)
    t0 = time.perf_counter()
    for i, (kind, src) in enumerate(order):
        if i % every == 0 and i // every < len(stream):
            seq.submit_many(stream[i // every])
            seq.flush()
        seq.query(kind, src)
    torch.cuda.synchronize()
    seq_wall = timings["3f sequential"] = time.perf_counter() - t0
    summary.update(sequential_s=seq_wall, qps=n_queries / wall,
                   sequential_qps=n_queries / seq_wall)
    log(f"  queries/s: front end {n_queries / wall:.1f} ({wall:.3f} s), "
        f"sequential svc.query {n_queries / seq_wall:.1f} ({seq_wall:.3f} "
        f"s); sequential ladder {seq.stats.as_dict()}")
    del seq

    # -- chaos: dispatch faults fall back per request, replies stay exact
    plan = FaultPlan({P_SERVE_DISPATCH: CHAOS_HITS})
    replies, cstates, svc, srv, tel, cwall = serve_run(
        torch, state, stream, schedules, plan=plan)
    timings["3f chaos front end"] = cwall
    check_replies(torch, replies, cstates)
    degraded = sum(r.degraded for *_, r in replies)
    summary.update(chaos_faults=plan.fired, chaos_fallbacks=srv.stats.fallbacks)
    log(f"  chaos: {plan.fired} dispatch faults, {srv.stats.fallbacks} "
        f"fallbacks, {degraded} degraded; {len(replies)} replies exact at "
        f"their version (degraded at their stale version)")
    if not plan.fired or not srv.stats.fallbacks:
        raise AssertionError("the chaos run fell back nowhere")
    if len(replies) != n_queries or svc.ring.pinned_versions():
        raise AssertionError("chaos run lost a reply or left a pin")
    del svc, srv, tel, replies, cstates

    # -- what one lane call launches and reads against sequential calls;
    # last, so that no profiler session runs before the front end and the
    # sequential schedule are timed
    if DEV == "cuda":
        summary["lanes"] = lane_measure(torch, calls, sizes, timings)
    log("  3f " + json.dumps(summary))
    return summary


# --------------------------------- phase 3g --------------------------------

SHARD_WAIT = 300        # seconds any one wait of 3g's front-end check may take


class CollectiveTally:
    """A cost accountant that measures nothing: it keeps only the
    collective bytes the sharded queries deposit (``shard.queries
    ._account``), so the query spans carry them, and the allocator's peak
    statistics stay 3g's to read."""

    def __init__(self):
        self.last = None

    def call(self, key, fn, *args):
        self.last = {}
        return fn(*args)


def shard_telemetry():
    from repro_torch.obs import NullDeviceTimer, Telemetry

    return Telemetry(accountant=CollectiveTally(), profiler=NullDeviceTimer())


def same_single(torch, kind, got, exp):
    """A sharded reply's row 0 against a single-source local reply: every
    field bit for bit, BC delta to TOL, and the agreement flag set."""
    if not bool(got.agree):
        return False
    names = {"bfs": ("ok", "dist", "parent"),
             "sssp": ("ok", "negcycle", "dist", "parent"),
             "bc": ("ok", "level", "sigma", "delta")}[kind]
    for name in names:
        a, b = getattr(got, name)[0], getattr(exp, name)
        ok = (torch.allclose(a, b, **TOL) if name == "delta"
              else a.dtype == b.dtype and torch.equal(a, b))
        if not ok:
            return False
    return True


def rung_walls(tel) -> dict:
    """Median wall (ms) and count of the traced queries per (kind, rung)."""
    by = {}
    for r in tel.tracer.records:
        if r.get("span") == "query" and "error" not in r:
            by.setdefault((r["kind"], r["mode"]), []).append(r["wall_us"])
    return {k: (statistics.median(v) / 1e3, len(v)) for k, v in by.items()}


def shard_stream(torch, svc, bc_scores, stream, sources):
    """3a's stream through ``svc``: a cold ``bc_scores()``, then per commit
    BFS/SSSP/BC from ``sources`` (``ladder_round``), ``bc_scores()`` every
    RING_DEPTH commits.  Returns the replies, the scores by version, the
    bc_scores walls (s) and the stream's wall."""
    replies, scores, score_walls = [], {}, []

    def timed_scores():
        t = time.perf_counter()
        s, v = bc_scores()
        torch.cuda.synchronize()
        score_walls.append(time.perf_counter() - t)
        scores[v] = s

    t0 = time.perf_counter()
    timed_scores()
    for i, ops in enumerate(stream):
        replies.extend(ladder_round(svc, ops, sources, i))
        if (i + 1) % RING_DEPTH == 0:
            timed_scores()
    torch.cuda.synchronize()
    return replies, scores, score_walls, time.perf_counter() - t0


def shard_front_end(torch, svc, sources):
    """The async front end over the sharded service: three clients ask
    BFS/SSSP/BC from ``sources`` while two more commits land; every reply
    must equal the port's single-source query on the state at its version
    and carry the agreement flag.  Returns (replies, serve stats)."""
    import threading

    from repro_torch.core import PUTE
    from repro_torch.serve import AsyncGraphService

    asks = [(kind, [src]) for src in sources for kind in KINDS]
    futs, errs = [], []
    lock = threading.Lock()

    def client(c):
        try:
            for k in range(len(asks)):
                kind, srcs = asks[(c + k) % len(asks)]
                f = srv.query_async(kind, srcs)
                with lock:
                    futs.append((kind, srcs, f))
        except Exception as e:  # the check below reports it
            errs.append(e)

    extra = [[(PUTE, sources[0], sources[2], 1.0)],
             [(PUTE, sources[1], sources[0], 2.0)]]
    srv = AsyncGraphService(svc, max_batch=16).start()
    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for t in threads:
            t.start()
        for ops in extra:
            srv.submit_many(ops)
            srv.flush()
        for t in threads:
            t.join(timeout=SHARD_WAIT)
            if t.is_alive():
                raise AssertionError("3g front end: a client hung")
        if not srv.drain(timeout=SHARD_WAIT):
            raise AssertionError("3g front end: drain timed out")
    finally:
        srv.stop(timeout=SHARD_WAIT)
    if errs:
        raise AssertionError(f"3g front end: clients raised {errs[:3]}")
    torch.cuda.synchronize()
    checked = 0
    for kind, srcs, f in futs:
        reply = f.result(timeout=SHARD_WAIT)
        state = svc.ring.get(reply.version)
        if not reply.validated or not same_single(
                torch, kind, reply.result, fresh(kind)(state, srcs[0])):
            raise AssertionError(f"3g front end: {kind}{srcs} at version "
                                 f"{reply.version} ({reply.mode}) != the "
                                 f"single-source query")
        checked += 1
    if svc.ring.pinned_versions():
        raise AssertionError("3g front end left pins")
    return checked, srv.stats


def sharded_phase(torch, np, timings):
    """Phase 3g: 3a's state and stream through ShardedGraphService on
    SHARDS ranks of the one card, once per bc_mode, every reply held
    against the local GraphService's at the same version; then the front
    end over the sharded service.  Returns the launches of the three
    masked kernels in the sharded runs."""
    from repro_torch.data import load_rmat_graph
    from repro_torch.engine import GraphService
    from repro_torch.kernels import bool_mm as kb
    from repro_torch.kernels import count_mm as kc
    from repro_torch.kernels import minplus_mm as kmp
    from repro_torch.shard import GraphMesh, ShardedGraphService

    state = load_rmat_graph(N_VERTICES, N_EDGES, seed=SEED, device=DEV)
    rng = np.random.default_rng(SEED)
    stream, hot_base = commit_stream(np, rng, N_VERTICES)
    sources = query_sources(torch, state, hot_base)
    mesh = GraphMesh([f"{DEV}:0" if DEV == "cuda" else DEV] * SHARDS)
    log(f"  mesh {mesh}; sources {sources}")

    # -- the local service on the same stream: the answers to hold 3g's
    # against, and 3a's walls per kind and rung (its bc_scores launch
    # count_mm_masked, so it runs before the counts are reset)
    tel = shard_telemetry()
    local = GraphService(state, ring_depth=RING_DEPTH,
                         batch_size=BATCH_SIZE, telemetry=tel)
    want, want_scores, score_walls, wall = shard_stream(
        torch, local, lambda: local.bc_scores(src_chunk=SRC_CHUNK), stream,
        sources)
    walls = {"local": rung_walls(tel)}
    scores_walls = {"local": score_walls}
    timings["3g local stream"] = wall
    log(f"  local GraphService: {len(want)} replies in {wall:.2f} s "
        f"({local.stats.as_dict()})")
    del local
    torch.cuda.empty_cache()

    kb.reset_launches()
    kmp.reset_launches()
    kc.reset_launches()
    peaks, coll, svc = {}, {}, None
    for bc_mode in ("gather", "ring"):
        svc = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tel = shard_telemetry()
        svc = ShardedGraphService(
            state, mesh, use_kernel=True, src_chunk=SRC_CHUNK,
            bc_mode=bc_mode, ring_depth=RING_DEPTH, batch_size=BATCH_SIZE,
            telemetry=tel)
        got, got_scores, score_walls, wall = shard_stream(
            torch, svc, svc.bc_scores, stream, sources)
        peaks[bc_mode] = torch.cuda.max_memory_allocated()
        timings[f"3g sharded stream ({bc_mode})"] = wall
        walls[bc_mode] = rung_walls(tel)
        scores_walls[bc_mode] = score_walls
        for (kind, src, mode, a), (_, _, _, b) in zip(got, want):
            if a.version != b.version or not same_single(torch, kind,
                                                         a.result, b.result):
                raise AssertionError(
                    f"3g {bc_mode}: {kind}({src}) {mode} at version "
                    f"{a.version} ({a.mode}) != the local service's")
        for v, s in got_scores.items():
            if not torch.allclose(s, want_scores[v], equal_nan=True, **TOL):
                err = float((s - want_scores[v]).nan_to_num().abs().max())
                raise AssertionError(f"3g {bc_mode}: bc_scores at version "
                                     f"{v} off by {err}")
        st = svc.stats
        if st.delta < 1 or st.full < 1:
            raise AssertionError(f"3g {bc_mode}: a rung never ran ({st})")
        per = {}
        for r in tel.tracer.records:
            if r.get("span") == "query" and r.get("coll_bytes"):
                per.setdefault(r["kind"], []).append(r["coll_bytes"])
        coll[bc_mode] = {k: statistics.mean(v) for k, v in per.items()}
        log(f"  {bc_mode}: {len(got)} replies == the local service's "
            f"(bc_scores at versions {sorted(got_scores)} to 1e-5) in "
            f"{wall:.2f} s; {st.as_dict()}; peak "
            f"{peaks[bc_mode] / 2**30:.2f} GiB")
    checked, serve = shard_front_end(torch, svc, sources)
    launches = {"bool_mm_masked": kb.LAUNCHES["bool_mm_masked"],
                "minplus_mm_masked": kmp.LAUNCHES["minplus_mm_masked"],
                "count_mm_masked": kc.LAUNCHES["count_mm_masked"]}
    log(f"  front end over the sharded service: {checked} replies == the "
        f"single-source queries at their versions ({serve})")
    log(f"  3g kernel launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"phase 3g never launched {name}")
    log("  bc_scores s, cold / after 8 / after 16 commits: " + "; ".join(
        f"{m} " + " / ".join(f"{t:.3f}" for t in scores_walls[m])
        for m in ("local", "gather", "ring")))
    log("  ms per query, median (count), kind/rung (bc includes bc_scores; "
        "unchanged: a cn query's second collect): local | gather | ring")
    for key in sorted(set().union(*walls.values())):
        cells = [f"{walls[m][key][0]:8.2f} ({walls[m][key][1]:3d})"
                 if key in walls[m] else "       -      "
                 for m in ("local", "gather", "ring")]
        log(f"    {key[0]:4s} {key[1]:9s} " + " | ".join(cells))
    for m in ("gather", "ring"):
        log(f"  {m}: collective bytes per traced query, mean by kind "
            + ", ".join(f"{k} {v:.4g}" for k, v in sorted(coll[m].items())))
    log(f"  peak device memory: gather {peaks['gather'] / 2**30:.2f} GiB, "
        f"ring {peaks['ring'] / 2**30:.2f} GiB")
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
    sources = sorted({src for src, _ in KERNELS.values()})
    build.load_all(sources)
    timings["build"] = time.perf_counter() - t0
    for src in sources:
        text = build.build_logs.get(src, "")
        lines = [ln.strip() for ln in text.splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln or "Performance Loss" in ln
                 or "warning" in ln]
        log(f"  {src}: {lines or 'cached'}")
    log(f"  build {timings['build']:.2f} s ({len(sources)} sources at once)")

    log("== phase 2: kernels against their plain versions")
    errs = ErrLog()
    t0 = time.perf_counter()
    sweep_kernels(torch, np, errs)
    sweep_traversal_kernels(torch, np, errs)
    state = load_rmat_graph(N_VERTICES, N_EDGES, seed=SEED, device=DEV)
    view = build_tile_view(state)
    a, occ, x, g = capture_main_products(torch, state, view)
    rows = main_shape_kernels(torch, view, a, occ, x, errs)
    del a
    torch.cuda.empty_cache()
    rows += main_shape_traversal(torch, state, view, errs)
    torch.cuda.empty_cache()
    band_shape_kernels(torch, state, view, x, g, rows, errs)
    del x, g
    torch.cuda.empty_cache()
    sweep_flash(torch, errs)
    timings["kernels"] = time.perf_counter() - t0

    log("== phase 3a: main path (GraphService)")
    t0 = time.perf_counter()
    launches = main_path(torch, np, state, timings)
    small_oracle_check(torch, np)
    timings["main path total"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    log("== phase 3b: batched BFS/SSSP")
    t0 = time.perf_counter()
    batched = batched_phase(torch, np, state, view, timings)
    timings["batched phase total"] = time.perf_counter() - t0
    del view
    torch.cuda.empty_cache()

    log("== phase 3c: workload (PG-Cn / PG-Icn / static)")
    t0 = time.perf_counter()
    mix = workload_phase(torch, np, timings)
    timings["workload phase total"] = time.perf_counter() - t0
    for name in batched:
        launches[name] = batched[name] + mix[name]
    del state
    torch.cuda.empty_cache()

    log("== phase 3d: LM serving (mistral_nemo_12b, granite_moe_1b)")
    t0 = time.perf_counter()
    launches["flash_attention"], flash_row = lm_phase(torch, errs, timings)
    rows.append(flash_row)
    timings["LM phase total"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    log("== phase 3e: GraphService with every option (telemetry, adaptive, "
        "policy, breaker, journal, heartbeat, compaction)")
    t0 = time.perf_counter()
    launches["count_mm_masked"] += options_phase(torch, np, timings)
    timings["options phase total"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    log("== phase 3f: async serving (AsyncGraphService, lane-batched "
        "dispatch)")
    t0 = time.perf_counter()
    serve_phase(torch, np, timings)
    timings["serve phase total"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    log(f"== phase 3g: sharded tile-grid engine (ShardedGraphService, "
        f"{SHARDS} ranks on one card)")
    t0 = time.perf_counter()
    for name, n in sharded_phase(torch, np, timings).items():
        launches[name] += n
    timings["sharded phase total"] = time.perf_counter() - t0
    for k, v in timings.items():
        log(f"  wall {k}: {v:.2f} s")

    log("== phase 4: report")
    kernels = []
    for row in rows:
        name = row["name"]
        src, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs.max[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "plain_rows": row["plain_rows"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            **{key: row[key] for key in EXTRA_KEYS if key in row}})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
