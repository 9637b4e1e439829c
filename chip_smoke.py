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
                 entry points and through the ops path 3g runs.
                 flash_attention is also held and timed (beside SDPA) at
                 phase 3h's four prefill shapes (FAMILY_FLASH: Zamba2's
                 shared block, Whisper's encoder, decoder self- and
                 cross-attention), its inputs laid out as the models hand
                 them over, and at phase 3i's three (LM2_FLASH: gemma3's
                 layers windowed at 1024 and global, llama4's 40/8 GQA; SDPA
                 beside the windowed one with a boolean band mask), and at
                 the mesh's prefill shapes of phases 3l and 3m (MESH_FLASH:
                 one data row's two sequences; granite's whole prompt, its
                 two halves, mistral's 32/8 GQA at head_dim 128, Zamba2's
                 shared block, Whisper's encoder, decoder self- and
                 cross-attention);
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
  3j. dist    -- the sharded engine across processes (repro_torch.shard
                 .dist): 3g's stream through ShardedGraphService on a
                 DistMesh, SHARDS processes started by dist.spawn on
                 cuda:0 with transport="gloo" (every collective staged
                 through pinned host memory), each holding one band; the
                 processes load the kernels phase 1 built.  Each process
                 runs gather mode on the first GATHER_COMMITS commits
                 (bc_scores at 3g's versions 0 and 8; cut from all COMMITS
                 for the run's time) and ring mode on the first RING_COMMITS,
                 without
                 bc_scores (ring mode moves about 1.3e10 B a BC query
                 through the host), and fails unless every reply
                 equals 3g's local GraphService's at its version (BC
                 delta and bc_scores to 1e-5), the collective bytes of
                 every query equal 3g's ThreadGroup run's, both the delta
                 and the full rung ran, and bool_mm_masked,
                 minplus_mm_masked and count_mm_masked launched in that
                 process.  A failed or hung process fails the phase.
                 Prints the transport, per bc_mode rank 0's ms per query
                 per kind and rung, the stream's collective bytes beside
                 what the transport moved, each process's peak memory and
                 the phase wall; then each process runs the dry run's graph
                 engine cell live on its graph (launch.dryrun
                 .run_graph_cell: BFS, SSSP, BC and ring BC once from one
                 source a rank, vcap 16384 cut from 131072), whose
                 collective bytes per kind must be the same on every rank,
                 and prints them; with SHARDS cards it also runs
                 transport="nccl", one card per rank, else it says so.
                 After the gather stream the same processes serve 3g's
                 front-end schedule through AsyncGraphService on the same
                 service (dist_front_end): rank 0 admits the three
                 clients' 27 requests and the two commits and sequences
                 them, the other processes follow its commands (framed
                 broadcasts, counted as control bytes); every reply must
                 be validated and equal the single-source query at its
                 version on rank 0's card (BC delta to 1e-5), no process
                 may keep a pin, every process must end with the same
                 service tallies and launch bool_mm_masked and
                 minplus_mm_masked, and rank 0 count_mm_masked (a BC
                 query splits its sources over the ranks: a one-source
                 one counts on rank 0).  Prints the serve stats
                 (dispatches, dedup sizes, fallbacks), the replies by kind
                 and rung, the wall and the control bytes beside the
                 collectives' bytes moved;
  3h. LM families -- the SSM, hybrid and encoder-decoder models
                 (FAMILY_ARCHS: mamba2_780m, zamba2_12b, whisper_large_v3)
                 through the serve entry point at full width and depth,
                 random weights from seed 0: batch 4, 32 generated tokens,
                 prompt 2048 (Whisper: 224 decoder tokens over 1500
                 frames drawn from seed 2).  The prefills must launch
                 flash_attention 0 / 6 / 96 times, at exactly the shapes
                 FAMILY_FLASH lists, each first call held against the
                 plain version on its own inputs; tokens in range, logits
                 finite.  Then two forms of the same function: the flash
                 prefill's logits against the "xla" path's (Zamba2,
                 Whisper), and the last decode step's against a fresh
                 prefill of prompt + generated tokens (for Mamba2 the
                 one-step recurrence against the chunked SSD), measured in
                 the served bf16 at full depth, held to LM_REL_TOL on the
                 same weights in float32 at full depth and in bf16 on the
                 first FAMILY_CUT layers (the random-init SSM stacks carry
                 one layer's bf16 rounding into every later one: their
                 full-depth bf16 forms drift apart beyond LM_REL_TOL);
  3i. LM, last configs and training -- gemma3_27b at full size through
                 the serve entry point and llama4_maverick_400b at full
                 width cut to LLAMA4_LAYERS layers (through serve.serve),
                 as 3d serves its models: flash launches exactly 62 / 2,
                 every captured call (gemma3's layer 0, windowed, and layer
                 5, global) against the plain version, flash vs "xla" and
                 the last decode step vs a fresh prefill to LM_REL_TOL
                 (llama4's no-drop check on batch row 0).  Then the
                 trainer's loss and gradients on reduced granite_moe_1b and
                 mamba2_780m held against the CPU (1e-4), and
                 granite_moe_1b trained at full width and depth through
                 repro_torch.launch.train (TRAIN_STEPS steps at TRAIN_SEQ
                 tokens, the largest batch of TRAIN_BATCHES that fits,
                 checkpoints every TRAIN_CKPT_EVERY): finite losses, the
                 last below the first; a RestartableLoop over the same step
                 function crashed at TRAIN_FAIL_AT and resumed must equal
                 the uninterrupted run bit for bit (both under
                 torch.use_deterministic_algorithms); serve --ckpt-dir must
                 give the trained parameters' prefill logits bit for bit.
                 Then a resume from the reference's checkpoint layout
                 (reference_resume): granite_moe_1b at full width cut to
                 REF_RESUME_LAYERS layers trained REF_RESUME_STEPS steps at
                 TRAIN_SEQ tokens, its state written as the reference's
                 trainer writes it (stacked leaves, a manifest: this
                 script's own copy of that writer), served by serve.main
                 --ckpt-dir with the in-memory parameters' prefill logits,
                 and resumed by train.main --ckpt-dir for one more step
                 that must equal the uninterrupted run's bit for bit.
                 Prints step times, tokens/s, the model-FLOP share of the
                 bf16 peak and peak memory;
  3k. LM sharding -- four processes (dist.spawn) on cuda:0 over gloo on a
                 ("data", "model") = LM_MESH mesh (NCCL with one card per
                 rank where there are four cards, else it says so): three
                 sharded steps of reduced granite_moe_1b at batch 4 and 2
                 and qwen3_32b at batch 4 (f32, capacity 8), each held
                 against one process's build_train_step on the card whose
                 loss is the mean over the data rows (the mesh's MoE
                 load-balance loss is a per-row mean, the reference's
                 pmean), with the train-step criteria of
                 tests/test_torch_optim.py (hold_step); an elastic round:
                 the mesh's checkpoint files byte-equal to one process's
                 save of the gathered state, restored on the mesh and on
                 one process, a step from each bit-equal to the step from
                 memory; granite_moe_1b at full width cut to
                 LM_SHARD_LAYERS layers through train.main --mesh single
                 (LM_SHARD_STEPS steps at LM_SHARD_BATCH x LM_SHARD_SEQ,
                 one sequence per process), one more step with rank 0
                 under torch.profiler; the dry run's live train_4k cell at
                 depth 1 and 2.  Every process must hold the same bits; a
                 failed or hung process fails the phase.  Prints step
                 walls, tokens/s, the transport's share, rank 0's busy
                 share, peak memory per process, collective bytes a step
                 counted and moved, the dry run's counted bytes and the
                 kernel launches of 3k's processes (none: training runs
                 attention through "xla");
  3l. LM serving on the mesh -- four processes (dist.spawn) on cuda:0 over
                 gloo on the LM_MESH mesh (NCCL with one card per rank where
                 there are four cards, else it says so), serving in the
                 reference's layout through steps.build_prefill_step(mesh=)
                 and build_decode_step(mesh=): parameters in blocks, each
                 process's block of the KV cache (batch over "data", the
                 SERVE_MAX_LEN = 2080 rows of the sequence split in two
                 blocks over "model", checked), its batch rows over "data".
                 granite_moe_1b at full width and depth and
                 mistral_nemo_12b at full width cut to 2 layers (SERVE_RUNS;
                 bf16, batch 4, prompt 2048, 31 and 4 decode steps), each held
                 against one process's build_prefill_step /
                 build_decode_step on the card on the same seed-0 weights,
                 serve's prompts and the one process's greedy tokens: every
                 step's logits and the gathered cache within LM_REL_TOL,
                 the share of equal argmax printed beside how far the one
                 process's bf16 prefill lies from its float32 one; the MoE
                 at capacity E / k, with the dropped pairs of both runs
                 tallied and checked at 0; granite cut to
                 SERVE_SPLIT_LAYERS layers takes the prompt as two halves
                 (the continuation's gathered prefix) against one
                 process's single prefill.  flash_attention must launch
                 once a layer a prefill (both prefill cases) and never on
                 a decode step, in every process; rank 0's first call of
                 each shape is held against the plain version.  Then
                 reduced granite (capacity 8) and qwen3_32b in float32
                 (SERVE_F32: prompt, continuation, decode steps) against
                 one process on the card to rtol = atol = 1e-4, and the
                 dry run's live prefill_32k and decode_32k cells of
                 granite_moe_1b at depth 1 and 2 at SERVE_DRYRUN_SEQ.
                 The model ranks of a
                 data row must hold the same logits bit for bit; a failed
                 or hung process fails the phase.  Prints prefill walls and
                 decode ms a token (median) beside the one process's and
                 3d's, collective bytes counted and moved a prefill and a
                 decode step, the transport's share, rank 0's busy share of
                 one profiled decode step, peak memory per process and the
                 dry run's counted bytes;
  3m. LM families on the mesh -- the same four processes and mesh serving the
                 SSM, hybrid and encoder-decoder families (FAMILY_MESH_RUNS:
                 mamba2_780m, zamba2_12b at batch 4, prompt 2048;
                 whisper_large_v3 at 224 tokens over 1500 frames into a
                 256-row cache; full width and depth, bf16, 2 greedy decode
                 steps (FAMILY_MESH_DECODE, cut from 8 for the run's time) in
                 the reference's layout: the SSM state's channels (conv) and
                 heads (ssd) and every K/V cache's sequence over "model", each
                 leaf checked split.  Each data row's rows are held against
                 one process on the card serving the same rows on the same
                 seed-0 weights and its greedy tokens: every step's logits and
                 every cache leaf, as the prefill left it and after the decode
                 steps, within LM_REL_TOL, argmax agreement printed beside how
                 far the one process's bf16 prefill lies from its float32 one
                 (tools/mesh_drift.py runs more decode steps, in bf16 and in
                 float32);
                 flash_attention must launch 0 / 6 / 96 times a prefill in
                 every process and never on a decode step, rank 0's first call
                 of each shape held against the plain version.  Then the
                 reduced configs in float32 (FAMILY_MESH_F32: a prompt,
                 Whisper's with frames, a continuation without -- the split
                 cross cache's merged softmax -- and decode steps) against one
                 process on the card to rtol = atol = 1e-4, and the dry run's
                 live prefill_32k and decode_32k cells of the three and
                 long_500k of the two SSM archs at SERVE_DRYRUN_SEQ.  The
                 model ranks of a data row must hold the same logits bit for
                 bit.  Prints what 3l prints;
  4. report   -- one JSON line of kernels, the nvidia-smi line, and as the
                 last line {"ok": true, "device": {...}}.  count_mm_masked's
                 launches are those of 3a, 3e, 3g and 3j (summed over 3j's
                 processes, its graph cell included); bool_mm_masked's and
                 minplus_mm_masked's those of 3b, 3c, 3g and 3j;
                 flash_attention's those of 3d, 3h, 3i, 3l and 3m (summed
                 over 3l's and 3m's processes).  The masked rows
                 carry their band-shape timings under "band" (and
                 count_mm_masked's backward under "band_t"), the
                 flash_attention row 3h's four shapes under "encdec",
                 3i's three under "gemma3_llama4" and the mesh's under
                 "mesh".

It imports nothing of JAX or of the reference package ``repro``.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import Counter, deque

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
              "pack_left_static_ms", "band", "band_t", "encdec",
              "gemma3_llama4", "mesh")
LM_ARCHS = ("mistral_nemo_12b", "granite_moe_1b")
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32
# Two bf16 forward passes that differ only in where they round (the flash
# kernel keeps the probabilities in f32, the "xla" path rounds them to
# bf16; a decode step and a prefill sum their products in other orders)
# agree on the logits to a relative L2 error of about sqrt(layers x
# roundings per layer) x 2^-9; the bound allows 5e-2 (logits of two
# different prompts differ by about 1.4).
LM_REL_TOL = 5e-2
# Phase 3h: the SSM, hybrid and audio encoder-decoder families, served at
# LM_BATCH x LM_PROMPT and LM_GEN tokens; Whisper's decoder prompt is its
# prompt-conditioning limit, 224 tokens, so prompt + LM_GEN stays inside its
# 448-token window, and its encoder reads the config's 1500 frames.
FAMILY_ARCHS = ("mamba2_780m", "zamba2_12b", "whisper_large_v3")
WHISPER_PROMPT = 224
# flash_attention on 3h's prefills (batch LM_BATCH, bf16, head_dim 64): arch,
# caller, heads, Sq, Skv, rows of the cache its K/V are a prefix of (None:
# no cache), causal, launches per prefill.  Mamba2 launches none.
FAMILY_FLASH = (
    ("zamba2_12b", "zamba2 shared block", 32, LM_PROMPT, LM_PROMPT,
     LM_PROMPT + LM_GEN, True, 6),
    ("whisper_large_v3", "whisper encoder", 20, 1500, 1500, None, False, 32),
    ("whisper_large_v3", "whisper decoder self", 20, WHISPER_PROMPT,
     WHISPER_PROMPT, WHISPER_PROMPT + LM_GEN, True, 32),
    ("whisper_large_v3", "whisper cross", 20, WHISPER_PROMPT, 1500, 1500,
     False, 32),
)
FAMILY_HEAD_DIM = 64
# Phase 3i: gemma3_27b at full size, and llama4_maverick_400b at full width
# with its depth cut to LLAMA4_LAYERS (34.4 B parameters, 68.8 GB of bf16
# weights at two layers; three would need about 101 GB), served as 3d
# serves its models.
LM2_ARCHS = ("gemma3_27b", "llama4_maverick_400b")
LLAMA4_LAYERS = 2
# flash_attention on 3i's prefills (batch LM_BATCH, prompt LM_PROMPT, bf16,
# head_dim LM2_HEAD_DIM, K/V the prefix of a cache of LM_PROMPT + LM_GEN
# rows): arch, caller, heads, KV heads, window, launches per prefill.
LM2_FLASH = (
    ("gemma3_27b", "gemma3 local", 32, 16, 1024, 52),
    ("gemma3_27b", "gemma3 global", 32, 16, None, 10),
    ("llama4_maverick_400b", "llama4", 40, 8, None, LLAMA4_LAYERS),
)
LM2_HEAD_DIM = 128
# flash_attention on the mesh's prefills (3l, 3m): one data row's MESH_BATCH
# sequences, bf16.  arch, caller, heads, KV heads, Sq, Skv, head_dim, causal.
MESH_BATCH = 2
MESH_FLASH = (
    ("granite_moe_1b", "3l granite prompt", 16, 8, 2048, 2048, 64, True),
    ("granite_moe_1b", "3l granite first half", 16, 8, 1024, 1024, 64, True),
    ("granite_moe_1b", "3l granite second half", 16, 8, 1024, 2048, 64,
     True),
    ("mistral_nemo_12b", "3l mistral", 32, 8, 2048, 2048, 128, True),
    ("zamba2_12b", "3m zamba2 shared block", 32, 32, 2048, 2048, 64, True),
    ("whisper_large_v3", "3m whisper encoder", 20, 20, 1500, 1500, 64, False),
    ("whisper_large_v3", "3m whisper decoder self", 20, 20, 224, 224, 64,
     True),
    ("whisper_large_v3", "3m whisper cross", 20, 20, 224, 1500, 64, False),
)
# 3i's training: granite_moe_1b at full width and depth, at train_4k's
# sequence; its global batch of 256 is cut to the largest of TRAIN_BATCHES
# that fits the card.  The restart crashes at TRAIN_FAIL_AT and resumes from
# the checkpoint before it.
TRAIN_ARCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = "granite_moe_1b", 4096, 12, 3e-4
TRAIN_BATCHES = (8, 4, 2)
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 4, 9
# The resume from the reference's checkpoint layout: TRAIN_ARCH at full width
# cut to REF_RESUME_LAYERS layers, one sequence of TRAIN_SEQ tokens a step,
# its state written after REF_RESUME_STEPS steps, resumed for one more.
REF_RESUME_LAYERS, REF_RESUME_STEPS = 2, 2
# Reduced configs whose trainer gradients on the card are held against the
# CPU's: the MoE (routing, dropped pairs, load-balance loss) and the SSD.
TRAIN_PARITY_ARCHS = ("granite_moe_1b", "mamba2_780m")
# Depth of 3h's bf16 form checks: Mamba2 layers, hybrid layers (one
# super-block of six and its shared-block invocation), encoder and decoder
# layers of Whisper (all of them: the transformer's bf16 forms agree at full
# depth).
FAMILY_CUT = {"mamba2_780m": 4, "zamba2_12b": 6, "whisper_large_v3": 32}


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
        return err


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


def family_flash_inputs(torch, g, hq, sq, skv, rows, causal, hkv=None,
                        d=FAMILY_HEAD_DIM, batch=LM_BATCH):
    """Random bf16 q, k, v of one prefill shape (``hkv`` KV heads, default
    ``hq``; head_dim ``d``), laid out as the model hands them to the
    kernel: a rotated q or k is contiguous, an unrotated one (cross-
    attention's q, a projected v) a transposed [B, S, H, D] view, and K/V
    held in a cache the prefix of its first ``rows`` rows."""
    hkv = hq if hkv is None else hkv

    def draw(*dims):
        return torch.randn(dims, generator=g, device=DEV).to(torch.bfloat16)

    cross = not causal and rows is not None
    q = (draw(batch, sq, hq, d).transpose(1, 2) if cross
         else draw(batch, hq, sq, d))
    if rows is None:   # the encoder: k rotated, v as projected
        k = draw(batch, hkv, skv, d)
        v = draw(batch, skv, hkv, d).transpose(1, 2)
    else:
        k = draw(batch, hkv, rows, d)[:, :, :skv]
        v = draw(batch, hkv, rows, d)[:, :, :skv]
    return q, k, v


def flash_shape_row(torch, errs, what, q, k, v, causal, window, extra):
    """flash_attention on one prefill shape: held against its plain version
    at the bf16 tolerance, then timed beside SDPA (with a boolean band mask
    where the call is windowed) and its bound.  Returns the sub-row kept
    under an EXTRA_KEYS entry of the kernel row."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels.ref import flash_attention_ref, flash_offset

    kw = dict(causal=causal, window=window)
    err = errs.check(torch, "flash_attention", kf.flash_attention(q, k, v, **kw),
                     flash_attention_ref(q, k, v, **kw), False, what,
                     FLASH_TOL["bfloat16"])
    sq, skv = q.shape[2], k.shape[2]
    if window is None and (not causal or sq == skv):
        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)
    else:
        # A window, or a causal prompt after a prefix: SDPA's is_causal
        # aligns its mask top-left, the kernel's ends at the last key.
        i = torch.arange(sq, device=DEV)[:, None] + flash_offset(sq, skv,
                                                                 causal)
        j = torch.arange(skv, device=DEV)[None]
        band = (j <= i) if causal else torch.ones_like(j > i)
        if window is not None:
            band = band & (j > i - window)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                                  enable_gqa=True)
    row = kernel_row(
        torch, "flash_attention", lambda: kf.flash_attention(q, k, v, **kw),
        lambda: flash_attention_ref(q, k, v, **kw),
        attention_work(q, k, causal, window), BF16_PEAK, library)
    return band_row(row, dict(**extra, q=list(q.shape), kv=list(k.shape),
                              causal=causal, window=window,
                              max_abs_err=err))


def family_flash_shapes(torch, errs):
    """flash_attention at phase 3h's four prefill shapes (FAMILY_FLASH).
    Returns the sub-rows kept under the kernel row's "encdec" key."""
    g = torch.Generator(device=DEV).manual_seed(3)
    out = []
    for arch, caller, hq, sq, skv, rows, causal, n in FAMILY_FLASH:
        q, k, v = family_flash_inputs(torch, g, hq, sq, skv, rows, causal)
        what = (f"{caller} {LM_BATCH}x{hq}x{sq}x{skv}x{FAMILY_HEAD_DIM} "
                f"{'causal' if causal else 'full'}")
        out.append(flash_shape_row(torch, errs, what, q, k, v, causal, None,
                                   dict(arch=arch, caller=caller,
                                        launches_per_prefill=n)))
        del q, k, v
    return out


def lm2_flash_shapes(torch, errs):
    """flash_attention at phase 3i's prefill shapes (LM2_FLASH: gemma3's
    windowed and global layers, llama4's 40/8 GQA).  Returns the sub-rows
    kept under the kernel row's "gemma3_llama4" key."""
    g = torch.Generator(device=DEV).manual_seed(5)
    out = []
    for arch, caller, hq, hkv, window, n in LM2_FLASH:
        q, k, v = family_flash_inputs(torch, g, hq, LM_PROMPT, LM_PROMPT,
                                      LM_PROMPT + LM_GEN, True, hkv,
                                      LM2_HEAD_DIM)
        what = (f"{caller} {LM_BATCH}x{hq}/{hkv}x{LM_PROMPT}x{LM2_HEAD_DIM}"
                f" w={window}")
        out.append(flash_shape_row(torch, errs, what, q, k, v, True, window,
                                   dict(arch=arch, caller=caller,
                                        launches_per_prefill=n)))
        del q, k, v
    return out


def mesh_flash_shapes(torch, errs):
    """flash_attention at the mesh's prefill shapes of phases 3l and 3m
    (MESH_FLASH), on fresh K/V (the fresh rows a prefill attends to, or
    the gathered prefix of a continuation).  Returns the sub-rows kept
    under the kernel row's "mesh" key."""
    g = torch.Generator(device=DEV).manual_seed(7)
    out = []
    for arch, caller, hq, hkv, sq, skv, d, causal in MESH_FLASH:
        q, k, v = family_flash_inputs(torch, g, hq, sq, skv, None, causal,
                                      hkv, d, batch=MESH_BATCH)
        what = (f"{caller} {MESH_BATCH}x{hq}/{hkv}x{sq}x{skv}x{d} "
                f"{'causal' if causal else 'full'}")
        out.append(flash_shape_row(torch, errs, what, q, k, v, causal, None,
                                   dict(arch=arch, caller=caller)))
        del q, k, v
    return out


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
    ``ops.flash_attention`` call (a prefill's layer 0) and of the first call
    of every distinct (q shape, k shape, arguments) in ``calls``, and
    passes every call on unchanged."""

    def __init__(self):
        from repro_torch.kernels import ops as kops

        self.kops, self.first, self.calls = kops, None, {}

    def __enter__(self):
        self.orig = self.kops.flash_attention

        def wrapped(q, k, v, **kw):
            key = (tuple(q.shape), tuple(k.shape), tuple(sorted(kw.items())))
            if key not in self.calls:
                self.calls[key] = (q.clone(), k.clone(), v.clone(), kw)
                if self.first is None:
                    self.first = self.calls[key]
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


def gib(nbytes) -> str:
    return "not measured" if nbytes is None else f"{nbytes / 2**30:.2f} GiB"


# Each served arch's prefill seconds and decode seconds a token (3d, 3h, 3i),
# printed beside 3l's mesh.
SERVED = {}


def served(torch, timings, arch, cfg, run):
    """``run()`` (a serve of ``arch``) under a ``FlashCapture`` with the
    kernel's launch count reset: logs its times, peak memory and launches,
    checks its tokens and logits.  Returns (result, launches, capture)."""
    from repro_torch.kernels import flash_attention as kf

    kf.reset_launches()
    t0 = time.perf_counter()
    with FlashCapture() as cap:
        r = run()
    wall = time.perf_counter() - t0
    n = kf.LAUNCHES["flash_attention"]
    b, steps = r.prompts.shape[0], LM_GEN - 1
    timings[f"{arch} serve (init + prefill + decode)"] = wall
    SERVED[arch] = (r.prefill_s, r.decode_s / steps)
    log(f"  {arch} prefill {b}x{r.prompts.shape[1]}: "
        f"{r.prefill_s * 1e3:.1f} ms ({b * r.prompts.shape[1] / r.prefill_s:.0f}"
        f" tokens/s); decode {steps} steps: "
        f"{r.decode_s / steps * 1e3:.2f} ms/token "
        f"({b * steps / r.decode_s:.1f} tokens/s); peak device "
        f"memory {gib(r.peak_bytes)}; flash launches {n}")
    if (tuple(r.tokens.shape) != (b, LM_GEN)
            or int(r.tokens.min()) < 0
            or int(r.tokens.max()) >= cfg.vocab_size
            or not bool(torch.isfinite(r.prefill_logits).all())
            or not bool(torch.isfinite(r.last_logits).all())):
        raise AssertionError(f"{arch}: bad tokens or non-finite logits")
    return r, n, cap


def lm_forms(torch, timings, arch, cfg, r, no_drop_rows=None):
    """The served prefill's logits against the port's "xla" path on the
    same weights, and the last decode step's against a fresh prefill of
    prompt + generated tokens, both to LM_REL_TOL.  For an MoE model the
    decode check runs one decode step at a capacity that drops nothing,
    on the first ``no_drop_rows`` batch rows (all when None)."""
    import dataclasses

    from repro_torch.models import get_model

    b = r.prompts.shape[0]
    xla = get_model(dataclasses.replace(cfg, attn_impl="xla"))
    cache = xla.init_cache(b, r.prompts.shape[1], dtype=cfg.dtype,
                           device=DEV)
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
    # above).  For an MoE model that holds only without capacity drops: at
    # decode an expert has max(1, int(B * k * 1.25 / E)) = 1 slot, so the
    # served decode drops pairs that a prefill keeps.  Its check runs one
    # decode step at capacity_factor = E / k (every token fits).
    rows = slice(0, no_drop_rows)
    seq = torch.cat([r.prompts, r.tokens[:, :-1]], dim=1)[rows]
    ncfg, dec = dataclasses.replace(cfg, attn_impl="xla"), r.last_logits
    if cfg.num_experts:
        ncfg = dataclasses.replace(
            ncfg, capacity_factor=cfg.num_experts / cfg.top_k)
        m = get_model(ncfg)
        cache = m.init_cache(seq.shape[0], seq.shape[1], dtype=cfg.dtype,
                             device=DEV)
        _, cache = m.prefill(r.params, seq[:, :-1], cache)
        dec, cache = m.decode_step(r.params, seq[:, -1:], cache)
        del cache
    model = get_model(ncfg)
    cache = model.init_cache(seq.shape[0], seq.shape[1], dtype=cfg.dtype,
                             device=DEV)
    f_logits, cache = model.prefill(r.params, seq, cache)
    err = rel_l2(torch, dec, f_logits)
    agree = float((dec.argmax(-1) == f_logits.argmax(-1)).float().mean())
    on = "" if no_drop_rows is None else f" on {seq.shape[0]} batch row(s)"
    log(f"  {arch} {'last served' if dec is r.last_logits else 'no-drop'}"
        f" decode step vs a fresh prefill of {seq.shape[1]} tokens{on}: rel "
        f"L2 {err:.3g}, argmax agreement {agree:.2f}")
    if not err < LM_REL_TOL:
        raise AssertionError(f"{arch}: decode logits differ from a "
                             f"fresh prefill by {err:.3g} (rel L2)")


def lm_phase(torch, errs, timings):
    """Serve each LM_ARCHS model through the port's entry point, then hold
    the kernel, the "xla" path and a fresh prefill against what it did.
    Returns (flash launches of the serve runs, the kernel row timed at the
    first model's layer 0)."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch import serve

    launches, row = 0, None
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        log(f"  {arch}: {cfg.num_layers} layers, d {cfg.d_model}, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}, experts "
            f"{cfg.num_experts} top-{cfg.top_k}, {cfg.dtype}, "
            f"{cfg.params_dense() / 1e9:.2f} B params")
        r, n, cap = served(torch, timings, arch, cfg, lambda: serve.main(
            ["--arch", arch, "--batch", str(LM_BATCH), "--prompt-len",
             str(LM_PROMPT), "--gen", str(LM_GEN)]))
        launches += n
        if n != cfg.num_layers:
            raise AssertionError(f"{arch}: the prefill launched "
                                 f"flash_attention {n} times, not once per "
                                 f"layer ({cfg.num_layers})")

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
        lm_forms(torch, timings, arch, cfg, r)
        del r
        torch.cuda.empty_cache()
    return launches, row


# --------------------------------- phase 3h --------------------------------

def param_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(param_count(v) for v in tree)
    return tree.numel()


def to_float32(torch, tree):
    """A copy of a parameter tree with its bf16 leaves in float32."""
    if isinstance(tree, dict):
        return {k: to_float32(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_float32(torch, v) for v in tree]
    return tree.float() if tree.dtype == torch.bfloat16 else tree


def cut_depth(cfg, params, n):
    """The model's first ``n`` layers: Mamba2 layers; the hybrid's first
    n // attn_every super-blocks (each with its shared-block invocation,
    no tail); n encoder and n decoder layers."""
    import dataclasses

    if cfg.family == "ssm":
        return (dataclasses.replace(cfg, num_layers=n),
                {**params, "layers": params["layers"][:n]})
    if cfg.family == "hybrid":
        ns = n // cfg.attn_every
        p = {k: v for k, v in params.items() if k != "tail"}
        p["blocks"] = params["blocks"][:ns]
        return dataclasses.replace(cfg, num_layers=ns * cfg.attn_every), p
    return (dataclasses.replace(cfg, num_layers=n, encoder_layers=n),
            {**params, "encoder": params["encoder"][:n],
             "decoder": params["decoder"][:n]})


def form_errors(torch, cfg, params, r, prefill_logits, last_logits):
    """Rel L2 of the flash prefill's logits against the "xla" path's (an
    attention family only) and of the last decode step's against a fresh
    "xla" prefill of prompt + generated tokens (for Mamba2: the one-step
    recurrence against the chunked SSD form), on ``r``'s prompts, frames
    and tokens."""
    import dataclasses

    from repro_torch.models import get_model

    extra = {} if r.frames is None else {"frames": r.frames}
    model = get_model(dataclasses.replace(cfg, attn_impl="xla"))
    out = {}
    if flash_per_prefill(cfg):
        cache = model.init_cache(LM_BATCH, r.prompts.shape[1],
                                 dtype=cfg.dtype, device=DEV)
        x_logits, cache = model.prefill(params, r.prompts, cache, **extra)
        out["flash vs xla prefill"] = rel_l2(torch, prefill_logits, x_logits)
        del cache, x_logits
    seq = torch.cat([r.prompts, r.tokens[:, :-1]], dim=1)
    cache = model.init_cache(LM_BATCH, seq.shape[1], dtype=cfg.dtype,
                             device=DEV)
    f_logits, cache = model.prefill(params, seq, cache, **extra)
    out[f"decode vs a fresh prefill of {seq.shape[1]}"] = rel_l2(
        torch, last_logits, f_logits)
    out["argmax agreement"] = float(
        (last_logits.argmax(-1) == f_logits.argmax(-1)).float().mean())
    return out


def fmt_forms(errs) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in errs.items())


def hold_forms(torch, what, cfg, params, r):
    """Serve ``r``'s prompts (and frames) again through ``cfg`` and
    ``params``: a flash prefill, then the decode steps fed ``r``'s tokens;
    its form errors must be under LM_REL_TOL."""
    from repro_torch.models import get_model

    extra = {} if r.frames is None else {"frames": r.frames}
    model = get_model(cfg)
    cache = model.init_cache(LM_BATCH, r.prompts.shape[1] + LM_GEN,
                             dtype=cfg.dtype, device=DEV)
    first, cache = model.prefill(params, r.prompts, cache, **extra)
    logits = first
    for i in range(LM_GEN - 1):
        logits, cache = model.decode_step(params, r.tokens[:, i:i + 1], cache)
    del cache
    if not bool(torch.isfinite(first).all() & torch.isfinite(logits).all()):
        raise AssertionError(f"{what}: non-finite logits")
    errs = form_errors(torch, cfg, params, r, first, logits)
    log(f"  {what}: {fmt_forms(errs)}")
    for key, err in errs.items():
        if key != "argmax agreement" and not err < LM_REL_TOL:
            raise AssertionError(f"{what}: {key} differs by {err:.3g} "
                                 f"(rel L2)")


def flash_per_prefill(cfg) -> int:
    """flash_attention launches of one prefill: none for Mamba2, one per
    shared-block invocation for the hybrid, three per decoder layer
    (self, cross) and encoder layer for the encoder-decoder."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return cfg.encoder_layers + 2 * cfg.num_layers


def families_phase(torch, errs, timings):
    """Serve each FAMILY_ARCHS model through the port's entry point at full
    width and depth, then hold the kernel at every shape the prefill gave it,
    the "xla" attention path and a fresh prefill against what it did.
    Returns the flash launches of the serve runs."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch import serve

    launches = 0
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        prompt = WHISPER_PROMPT if cfg.family == "audio" else LM_PROMPT
        shapes = {(LM_BATCH, hq, sq, skv, causal): n
                  for a, _, hq, sq, skv, _, causal, n in FAMILY_FLASH
                  if a == arch}
        expected = flash_per_prefill(cfg)
        if sum(shapes.values()) != expected:
            raise AssertionError(f"{arch}: FAMILY_FLASH lists "
                                 f"{sum(shapes.values())} launches a "
                                 f"prefill, the config gives {expected}")
        log(f"  {arch} ({cfg.family}): {cfg.num_layers} layers, d "
            f"{cfg.d_model}, ssm state {cfg.ssm_state} x {cfg.ssm_heads} "
            f"heads, attention {cfg.num_heads} heads x {cfg.head_dim} every "
            f"{cfg.attn_every or '-'}, encoder {cfg.encoder_layers} x "
            f"{cfg.encoder_seq}, vocab {cfg.vocab_size}, {cfg.dtype}")
        kf.reset_launches()
        t0 = time.perf_counter()
        with FlashCapture() as cap:
            r = serve.main(["--arch", arch, "--batch", str(LM_BATCH),
                            "--prompt-len", str(prompt), "--gen",
                            str(LM_GEN), "--device", DEV])
        wall = time.perf_counter() - t0
        n = kf.LAUNCHES["flash_attention"]
        launches += n
        steps = LM_GEN - 1
        timings[f"{arch} serve (init + prefill + decode)"] = wall
        frames = "" if r.frames is None else f" + {cfg.encoder_seq} frames"
        peak = gib(r.peak_bytes)
        log(f"  {arch}: {param_count(r.params) / 1e9:.3f} B parameters; "
            f"prefill {LM_BATCH}x{prompt}{frames}: "
            f"{r.prefill_s * 1e3:.1f} ms; decode {steps} steps: "
            f"{r.decode_s / steps * 1e3:.2f} ms/token "
            f"({LM_BATCH * steps / r.decode_s:.1f} tokens/s); peak device "
            f"memory {peak}; flash launches {n}")
        if n != expected:
            raise AssertionError(f"{arch}: the prefill launched "
                                 f"flash_attention {n} times, not {expected}")
        if (tuple(r.tokens.shape) != (LM_BATCH, LM_GEN)
                or int(r.tokens.min()) < 0
                or int(r.tokens.max()) >= cfg.vocab_size
                or not bool(torch.isfinite(r.prefill_logits).all())
                or not bool(torch.isfinite(r.last_logits).all())):
            raise AssertionError(f"{arch}: bad tokens or non-finite logits")

        seen = set()
        for (qs, ks, _), (q, k, v, kwargs) in cap.calls.items():
            seen.add((qs[0], qs[1], qs[2], ks[2], bool(kwargs.get("causal"))))
            if (q.dtype != cfg.dtype or qs[3] != FAMILY_HEAD_DIM
                    or kwargs.get("window") is not None):
                raise AssertionError(f"{arch}: the kernel was handed {qs} x "
                                     f"{ks} {q.dtype} {kwargs}")
            errs.check(torch, "flash_attention",
                       kf.flash_attention(q, k, v, **kwargs),
                       flash_attention_ref(q, k, v, **kwargs), False,
                       f"{arch} {qs}/{ks[1]}x{ks[2]} "
                       f"{'causal' if kwargs.get('causal') else 'full'}",
                       FLASH_TOL["bfloat16"])
        if seen != set(shapes):
            raise AssertionError(f"{arch}: the prefill handed the kernel "
                                 f"{sorted(seen)}, FAMILY_FLASH lists "
                                 f"{sorted(shapes)}")
        del cap

        # Two forms of the same function, compared.  In the served bf16
        # at full depth they are measured only: the random-init SSM stack
        # carries each layer's rounding into every later one, so its bf16
        # forward drifts from its own float32 forward by more than
        # LM_REL_TOL (PERF.md, section 6).  They are held to LM_REL_TOL on
        # the served weights in float32 at full depth, and in bf16 on the
        # first FAMILY_CUT layers.
        served = form_errors(torch, cfg, r.params, r, r.prefill_logits,
                             r.last_logits)
        dt = str(cfg.dtype).split(".")[-1]
        log(f"  {arch} {dt}, full depth (measured): {fmt_forms(served)}")
        c32, p32 = dataclasses.replace(cfg, dtype=torch.float32), \
            to_float32(torch, r.params)
        hold_forms(torch, f"{arch} float32, full depth", c32, p32, r)
        del p32
        ccut, pcut = cut_depth(cfg, r.params, FAMILY_CUT[arch])
        hold_forms(torch, f"{arch} {dt}, first {FAMILY_CUT[arch]} layers",
                   ccut, pcut, r)
        del r, pcut
        torch.cuda.empty_cache()
    return launches


# --------------------------------- phase 3i --------------------------------

def lm2_phase(torch, errs, timings):
    """Serve gemma3_27b through the port's entry point at full size, and
    llama4_maverick_400b at full width with its depth cut to LLAMA4_LAYERS
    (through ``serve.serve``: the CLI has no depth flag, nor has the
    reference's); hold the kernel at every shape the prefill gave it, the
    "xla" path and a fresh prefill against what it did.  llama4's no-drop
    decode check runs on batch row 0 only: at capacity E / k its expert
    buffers for 2079 tokens ([128, 2079, 8192] bf16 a product) fit beside
    the weights for one row, not for four.  Returns the flash launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch import serve

    launches = 0
    for arch in LM2_ARCHS:
        cfg = get_config(arch)
        shapes = {(hq, hkv, win): n for a, _, hq, hkv, win, n in LM2_FLASH
                  if a == arch}
        if cfg.num_experts:
            log(f"  {arch}: depth cut from {cfg.num_layers} to "
                f"{LLAMA4_LAYERS} layers (full width)")
            cfg = dataclasses.replace(cfg, num_layers=LLAMA4_LAYERS)

            def run(cfg=cfg):
                return serve.serve(cfg, batch=LM_BATCH, prompt_len=LM_PROMPT,
                                   gen_len=LM_GEN, device=DEV)
        else:
            def run(arch=arch):
                return serve.main(["--arch", arch, "--batch", str(LM_BATCH),
                                   "--prompt-len", str(LM_PROMPT), "--gen",
                                   str(LM_GEN), "--device", DEV])
        if sum(shapes.values()) != cfg.num_layers:
            raise AssertionError(f"{arch}: LM2_FLASH lists "
                                 f"{sum(shapes.values())} launches a "
                                 f"prefill, the config {cfg.num_layers}")
        log(f"  {arch}: {cfg.num_layers} layers, d {cfg.d_model}, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}, experts "
            f"{cfg.num_experts} top-{cfg.top_k}, window {cfg.window} "
            f"({cfg.local_global} local : 1 global), {cfg.dtype}")
        r, n, cap = served(torch, timings, arch, cfg, run)
        log(f"  {arch}: {param_count(r.params) / 1e9:.3f} B parameters "
            f"({param_count(r.params) * 2 / 1e9:.1f} GB in bf16)")
        launches += n
        if n != cfg.num_layers:
            raise AssertionError(f"{arch}: the prefill launched "
                                 f"flash_attention {n} times, not once per "
                                 f"layer ({cfg.num_layers})")
        seen = set()
        for (qs, ks, _), (q, k, v, kw) in cap.calls.items():
            win = kw.get("window")
            seen.add((qs[1], ks[1], win))
            if (qs != (LM_BATCH, qs[1], LM_PROMPT, LM2_HEAD_DIM)
                    or ks != (LM_BATCH, ks[1], LM_PROMPT, LM2_HEAD_DIM)
                    or q.dtype != cfg.dtype or not kw.get("causal", True)):
                raise AssertionError(f"{arch}: the kernel was handed {qs} x "
                                     f"{ks} {q.dtype} {kw}")
            errs.check(torch, "flash_attention",
                       kf.flash_attention(q, k, v, **kw),
                       flash_attention_ref(q, k, v, **kw), False,
                       f"{arch} {qs}/{ks[1]} w={win}", FLASH_TOL["bfloat16"])
        if seen != set(shapes):
            raise AssertionError(f"{arch}: the prefill handed the kernel "
                                 f"{sorted(seen, key=str)}, LM2_FLASH lists "
                                 f"{sorted(shapes, key=str)}")
        del cap
        lm_forms(torch, timings, arch, cfg, r,
                 no_drop_rows=1 if cfg.num_experts else None)
        del r
        torch.cuda.empty_cache()
    return launches


def state_shapes(torch, cfg):
    """The trainer's {"params", "opt"} as ``meta`` tensors: the structure
    and dtypes a restore needs, without storage."""
    from repro_torch.models import get_model, param_shapes
    from repro_torch.optim import AdamWState
    from repro_torch.optim.tree import tree_map

    params = param_shapes(get_model(cfg))

    def moments():
        return tree_map(lambda p: torch.empty(p.shape, dtype=cfg.moment_dtype,
                                              device="meta"), params)
    return {"params": params, "opt": AdamWState(
        torch.empty((), dtype=torch.int32, device="meta"), moments(),
        moments())}


def prune_checkpoints(d, keep_step):
    """Delete every step directory of the store ``d`` but ``keep_step``'s
    (disk: each granite train state is 13.9 GB)."""
    import shutil

    for name in os.listdir(d):
        if name.startswith("step_") and name != f"step_{keep_step:08d}":
            shutil.rmtree(os.path.join(d, name))


def train_grads_match_cpu(torch, timings):
    """The trainer's reduced configs of TRAIN_PARITY_ARCHS (f32, remat,
    sdpa_chunked) on the card against the same weights and batch on the
    CPU: the loss and every gradient leaf of ``value_and_grad(loss_fn)`` to
    rtol = atol = 1e-4, the tolerance the CPU tests hold the port to
    against the reference.  A capacity factor of 0.5 makes the MoE drop
    pairs, so its scatters' spill rows run on the card, as does the
    embedding's sorted segment-sum gradient."""
    import dataclasses

    from repro_torch.data import SyntheticTokens, shard_batch
    from repro_torch.launch import steps, train
    from repro_torch.models import get_model
    from repro_torch.optim.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    for arch in TRAIN_PARITY_ARCHS:
        cfg = train.train_config(arch, reduced=True)
        if cfg.num_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=0.5)
        model = get_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        batch = SyntheticTokens(cfg.vocab_size, 64, 4, seed=3).batch_at(0)
        out = []
        for dev in ("cpu", DEV):
            loss, grads = steps.value_and_grad(
                model.loss_fn, tree_map(lambda t: t.to(dev), params),
                shard_batch(batch, device=dev))
            out.append((loss.cpu(), [g.cpu() for g in tree_leaves(grads)]))
        (eloss, egrads), (loss, grads) = out
        worst = max(float(((g - e).abs() / (1e-4 + 1e-4 * e.abs())).max())
                    for g, e in zip(grads, egrads))
        log(f"  {arch} (reduced, f32) loss and {len(grads)} gradient leaves "
            f"on the card against the CPU: loss {float(loss):.6f} / "
            f"{float(eloss):.6f}, worst leaf at {worst:.3f} of its "
            f"tolerance")
        torch.testing.assert_close(loss, eloss, rtol=1e-4, atol=0)
        for g, e in zip(grads, egrads):
            torch.testing.assert_close(g, e, rtol=1e-4, atol=1e-4)
    timings["trainer gradients, card against CPU"] = \
        time.perf_counter() - t0


def train_phase(torch, timings):
    """Hold the trainer's gradients on the card against the CPU
    (``train_grads_match_cpu``), then train TRAIN_ARCH at full width and
    depth (``train_run``) in a temporary directory that goes when the
    phase ends, whether it passed or not.  Returns the flash launches of
    ``train_run``'s serves."""
    import shutil
    import tempfile

    train_grads_match_cpu(torch, timings)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        launches = train_run(torch, timings, root)
        shutil.rmtree(root)
        os.makedirs(root)
        return launches + reference_resume(torch, timings, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def train_run(torch, timings, root):
    """Train TRAIN_ARCH at full width and depth through ``train.main`` for
    TRAIN_STEPS steps at TRAIN_SEQ, checkpointing every TRAIN_CKPT_EVERY
    under ``root``; then a RestartableLoop over the same step function,
    initial parameters and schedule, crashed at TRAIN_FAIL_AT and resumed,
    must reproduce the uninterrupted run's last losses and final state bit
    for bit (both runs under torch.use_deterministic_algorithms); then
    ``serve.main --ckpt-dir`` must give the prefill logits of a serve from
    the trained parameters in memory, bit for bit.  Returns the flash
    launches of those two serves."""
    import shutil

    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens, shard_batch
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.launch import serve, train
    from repro_torch.models import get_model
    from repro_torch.optim import adamw_init
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.runtime import RestartableLoop

    d, d2 = os.path.join(root, "train"), os.path.join(root, "restart")
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        for batch in TRAIN_BATCHES:
            try:
                r = train.main(["--arch", TRAIN_ARCH, "--steps",
                                str(TRAIN_STEPS), "--seq", str(TRAIN_SEQ),
                                "--batch", str(batch), "--lr", str(TRAIN_LR),
                                "--ckpt-dir", d, "--ckpt-every",
                                str(TRAIN_CKPT_EVERY), "--log-every", "1",
                                "--device", DEV])
                break
            except torch.cuda.OutOfMemoryError:
                log(f"  {TRAIN_ARCH}: batch {batch} x {TRAIN_SEQ} does not "
                    f"fit the card; cutting the batch")
                shutil.rmtree(d, ignore_errors=True)
                torch.cuda.empty_cache()
        else:
            raise AssertionError(f"{TRAIN_ARCH}: no batch of "
                                 f"{TRAIN_BATCHES} fits")
        timings[f"{TRAIN_ARCH} train.main ({TRAIN_STEPS} steps)"] = \
            time.perf_counter() - t0
        cfg = r.cfg
        med = statistics.median(r.step_s[1:])
        tokens = batch * TRAIN_SEQ
        log(f"  {TRAIN_ARCH}: global batch 256 x {TRAIN_SEQ} cut to {batch} "
            f"x {TRAIN_SEQ}; {TRAIN_STEPS} steps; losses "
            f"{[round(x, 4) for x in r.losses]}")
        log(f"  {TRAIN_ARCH}: step ms {[round(x * 1e3, 1) for x in r.step_s]}"
            f"; median {med * 1e3:.1f} ms ({tokens / med:.0f} tokens/s; "
            f"{r.tokens_per_s:.0f} tokens/s over the run, checkpoints "
            f"included); peak device memory {gib(r.peak_bytes)}; "
            f"6 x {cfg.params_active() / 1e9:.3f} B active params x tokens / "
            f"median step = {6 * cfg.params_active() * tokens / med / 1e12:.1f}"
            f" TFLOP/s, {6 * cfg.params_active() * tokens / med / BF16_PEAK:.3f}"
            f" of {BF16_PEAK / 1e12:.0f}")
        if not all(math.isfinite(x) for x in r.losses):
            raise AssertionError(f"{TRAIN_ARCH}: non-finite loss {r.losses}")
        if not r.losses[-1] < r.losses[0]:
            raise AssertionError(f"{TRAIN_ARCH}: the last loss "
                                 f"{r.losses[-1]} is not below the first "
                                 f"{r.losses[0]}")
        prune_checkpoints(d, TRAIN_STEPS)

        # The same step function, initial parameters and schedule through a
        # RestartableLoop that crashes and resumes.
        t0 = time.perf_counter()
        model = get_model(cfg)
        step_fn = train.make_train_step(model, TRAIN_STEPS, TRAIN_LR)
        ds = SyntheticTokens(cfg.vocab_size, TRAIN_SEQ, batch, seed=0)
        losses = {}

        def loop_step(state, step):
            p, o, m = step_fn(state["params"], state["opt"],
                              shard_batch(ds.batch_at(step), device=DEV))
            losses[step] = float(m["loss"])
            return {"params": p, "opt": o}

        like = state_shapes(torch, cfg)
        params = model.init(torch.Generator(device=DEV).manual_seed(0))
        state = {"params": params, "opt": adamw_init(params,
                                                     cfg.moment_dtype)}
        del params
        loop = RestartableLoop(d2, loop_step, like,
                               ckpt_every=TRAIN_CKPT_EVERY, device=DEV)
        loop.ckpt.keep = 1   # disk: one 13.9 GB state at a time
        try:
            loop.run(state, TRAIN_STEPS, fail_at=TRAIN_FAIL_AT)
            raise AssertionError("the injected failure did not fire")
        except RuntimeError as e:
            if f"injected failure at step {TRAIN_FAIL_AT}" not in str(e):
                raise
        del state
        resumed = latest_step(d2)
        losses.clear()
        loop = RestartableLoop(d2, loop_step, like,
                               ckpt_every=TRAIN_CKPT_EVERY, device=DEV)
        loop.ckpt.keep = 1
        final, done = loop.run(None, TRAIN_STEPS)
        timings[f"{TRAIN_ARCH} RestartableLoop (crash + resume)"] = \
            time.perf_counter() - t0
        want = {s: r.losses[s - r.start_step]
                for s in range(resumed, TRAIN_STEPS)}
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(final), tree_leaves({"params": r.params,
                                             "opt": r.opt})))
        log(f"  restart: crashed at step {TRAIN_FAIL_AT}, resumed from step "
            f"{resumed}, ran to {done}; losses {losses} against the "
            f"uninterrupted run's {want}; final params and optimizer state "
            f"bit-identical: {same}")
        if resumed != TRAIN_FAIL_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY:
            raise AssertionError(f"resumed from step {resumed}")
        if losses != want or not same:
            raise AssertionError("the resumed run differs from the "
                                 "uninterrupted one")
        del final, loop
        shutil.rmtree(d2)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()

    # Serve what training saved, and the trained parameters from memory.
    kf.reset_launches()
    t0 = time.perf_counter()
    args = ["--arch", TRAIN_ARCH, "--batch", str(LM_BATCH), "--prompt-len",
            str(LM_PROMPT), "--gen", "2", "--device", DEV]
    s = serve.main([*args, "--ckpt-dir", d])
    mem = serve.serve(get_config(TRAIN_ARCH), batch=LM_BATCH,
                      prompt_len=LM_PROMPT, gen_len=2, device=DEV,
                      params=r.params)
    timings[f"{TRAIN_ARCH} serve from the checkpoint + from memory"] = \
        time.perf_counter() - t0
    same = torch.equal(s.prefill_logits, mem.prefill_logits)
    log(f"  serve --ckpt-dir (step {s.ckpt_step}) against the trained "
        f"params in memory: prefill logits bit-identical: {same}, tokens "
        f"equal: {torch.equal(s.tokens, mem.tokens)}")
    if s.ckpt_step != TRAIN_STEPS or not same:
        raise AssertionError("serve --ckpt-dir differs from the trained "
                             "parameters")
    return kf.LAUNCHES["flash_attention"]


def stacked(torch, tree):
    """The reference's layout of a port tree: every list of per-layer
    trees stacked into one tree of [L, ...] tensors ([S, K, ...] for a
    list of lists)."""
    if isinstance(tree, list):
        parts = [stacked(torch, t) for t in tree]
        if isinstance(parts[0], dict):
            return {k: stacked(torch, [p[k] for p in parts])
                    for k in parts[0]}
        return torch.stack(parts)
    if isinstance(tree, dict):
        return {k: stacked(torch, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(stacked(torch, v) for v in tree))
    return tree


def save_reference_layout(torch, np, ckpt_dir, step, tree):
    """Write ``tree`` as the reference's trainer writes its state (its
    checkpoint/checkpointer.py save_checkpoint; a copy, this script
    imports nothing of the reference): the per-layer lists stacked, one
    .npy a leaf named by its path (a NamedTuple's field names, dict keys
    sorted), bfloat16 as its raw bits under the descr '<V2', the manifest
    last by an atomic rename, then index.json."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    manifest = {"step": step, "version": 1, "leaves": {}, "time": time.time()}

    def leaf(name, t):
        fn = name.replace("/", ".") + ".npy"
        if t.dtype == torch.bfloat16:
            dtype = "bfloat16"
            with open(os.path.join(d, fn), "wb") as f:
                np.lib.format.write_array_header_1_0(f, {
                    "descr": "<V2", "fortran_order": False,
                    "shape": tuple(t.shape)})
                f.write(t.view(torch.int16).numpy().tobytes())
        else:
            arr = t.numpy()
            np.save(os.path.join(d, fn), arr)
            dtype = str(arr.dtype)
        manifest["leaves"][name] = {"file": fn, "shape": list(t.shape),
                                    "dtype": dtype}

    def walk(x, path):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            for name, child in zip(x._fields, x):
                walk(child, path + (name,))
        elif isinstance(x, dict):
            for key in sorted(x):
                walk(x[key], path + (str(key),))
        else:
            leaf("/".join(path), x.detach().contiguous().cpu())

    walk(stacked(torch, tree), ())
    for name, data in (("manifest.json", manifest),
                       ("index.json", {"latest_step": step, "version": 1})):
        where = d if name == "manifest.json" else ckpt_dir
        tmp = os.path.join(where, name + ".tmp")
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, os.path.join(where, name))
    return manifest


def reference_resume(torch, timings, root):
    """TRAIN_ARCH at full width cut to REF_RESUME_LAYERS layers through
    ``train.main`` (one TRAIN_SEQ sequence a step, under
    torch.use_deterministic_algorithms): REF_RESUME_STEPS + 1 steps from
    memory, and REF_RESUME_STEPS steps whose state goes to ``root`` in
    the reference's layout (save_reference_layout).  ``serve.main
    --ckpt-dir`` on it must give the prefill logits of a serve from the
    in-memory parameters bit for bit; ``train.main --ckpt-dir`` must
    resume at REF_RESUME_STEPS and its step equal the uninterrupted run's
    last step bit for bit.  Returns the flash launches of the serves."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.launch import serve, train
    from repro_torch.optim.tree import tree_leaves

    cut = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=REF_RESUME_LAYERS)
    real = train.get_config, serve.get_config
    train.get_config = serve.get_config = lambda arch: cut
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        args = ["--arch", TRAIN_ARCH, "--seq", str(TRAIN_SEQ), "--batch",
                "1", "--lr", str(TRAIN_LR), "--log-every", "1", "--device",
                DEV]
        total = str(REF_RESUME_STEPS + 1)
        whole = train.main([*args, "--steps", total])
        part = train.main([*args, "--steps", str(REF_RESUME_STEPS)])
        if part.losses != whole.losses[:REF_RESUME_STEPS]:
            raise AssertionError(f"reference resume: the first steps differ "
                                 f"({part.losses} / {whole.losses})")
        manifest = save_reference_layout(torch, np, root, REF_RESUME_STEPS,
                                         {"params": part.params,
                                          "opt": part.opt})
        mem_params = part.params
        del part
        kf.reset_launches()
        serve_args = ["--arch", TRAIN_ARCH, "--batch", str(LM_BATCH),
                      "--prompt-len", str(LM_PROMPT), "--gen", "2",
                      "--device", DEV]
        s = serve.main([*serve_args, "--ckpt-dir", root])
        mem = serve.serve(cut, batch=LM_BATCH, prompt_len=LM_PROMPT,
                          gen_len=2, device=DEV, params=mem_params)
        launches = kf.LAUNCHES["flash_attention"]
        served = torch.equal(s.prefill_logits, mem.prefill_logits)
        del s, mem, mem_params
        resumed = train.main([*args, "--steps", total, "--ckpt-dir", root])
    finally:
        torch.use_deterministic_algorithms(False)
        train.get_config, serve.get_config = real
    wall = time.perf_counter() - t0
    timings[f"{TRAIN_ARCH} resume from the reference's layout"] = wall
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves({"params": resumed.params, "opt": resumed.opt}),
        tree_leaves({"params": whole.params, "opt": whole.opt})))
    stacked_leaves = [n for n in manifest["leaves"]
                      if n.startswith("params/layers/")]
    log(f"  reference layout: {TRAIN_ARCH} cut to {REF_RESUME_LAYERS} "
        f"layers, {len(manifest['leaves'])} leaves ({len(stacked_leaves)} "
        f"stacked params/layers leaves, e.g. {stacked_leaves[0]} "
        f"{manifest['leaves'][stacked_leaves[0]]['shape']}); serve "
        f"--ckpt-dir prefill logits bit-identical to the in-memory "
        f"parameters': {served}; train --ckpt-dir resumed at step "
        f"{resumed.start_step}, loss {resumed.losses} against the "
        f"uninterrupted {whole.losses[REF_RESUME_STEPS:]}, state "
        f"bit-identical: {same}; {wall:.2f} s")
    if not served:
        raise AssertionError("serve --ckpt-dir on the reference's layout "
                             "differs from the in-memory parameters")
    if (resumed.start_step != REF_RESUME_STEPS or not same
            or resumed.losses != whole.losses[REF_RESUME_STEPS:]):
        raise AssertionError("train --ckpt-dir on the reference's layout "
                             "differs from the uninterrupted run")
    return launches


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
    """Run ``fn`` under ``torch.profiler``; returns, in launch order, the
    device us of each ``collect`` range (the profiler range of the
    ``collect`` span): the summed device time of the kernels launched
    inside it."""
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
                   and e.name == "collect"),
                  key=lambda e: e.time_range.start)
    return [float(e.device_time_total if hasattr(e, "device_time_total")
                  else e.cuda_time_total) for e in evts]


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
        spans = sorted((r for r in tel.tracer.records[n0:]
                        if r["span"] == "collect"), key=lambda r: r["id"])
        if len(regions) != len(spans):
            raise AssertionError(f"{len(regions)} profiled collect ranges "
                                 f"for the round's {len(spans)} collect "
                                 f"spans")
        scale, slack = REGION_COVER
        busy = {}
        for kern, r in zip(regions, spans):
            kind = r["kind"]
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
SHARD_WAVE = 3          # a front-end client waits for its replies every 3 asks


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


def shard_stream(torch, svc, bc_scores, stream, sources, sync=True):
    """3a's stream through ``svc``: a cold ``bc_scores()``, then per commit
    BFS/SSSP/BC from ``sources`` (``ladder_round``), ``bc_scores()`` every
    RING_DEPTH commits (none when ``bc_scores`` is None).  Returns the
    replies, the scores by version, the bc_scores walls (s) and the
    stream's wall.  ``sync``: synchronise the card before reading a
    wall."""
    replies, scores, score_walls = [], {}, []
    synchronize = torch.cuda.synchronize if sync else (lambda: None)

    def timed_scores():
        t = time.perf_counter()
        s, v = bc_scores()
        synchronize()
        score_walls.append(time.perf_counter() - t)
        scores[v] = s

    t0 = time.perf_counter()
    if bc_scores is not None:
        timed_scores()
    for i, ops in enumerate(stream):
        replies.extend(ladder_round(svc, ops, sources, i))
        if bc_scores is not None and (i + 1) % RING_DEPTH == 0:
            timed_scores()
    synchronize()
    return replies, scores, score_walls, time.perf_counter() - t0


def shard_front_end(torch, svc, sources, sync=True):
    """The async front end over the sharded service: three clients ask
    BFS/SSSP/BC from ``sources`` in waves of SHARD_WAVE (each wave waits
    for its replies) while two more commits land, the first once a third
    of the replies are in, the second at two thirds, so later requests
    meet a changed graph and collect; every reply must equal the port's
    single-source query on the state at its version and carry the
    agreement flag.  On a DistMesh this is rank 0's part
    (the other ranks follow).  ``sync``: synchronise the card before the
    replies are read.  Returns (replies, serve stats)."""
    import threading

    from repro_torch.core import PUTE
    from repro_torch.serve import AsyncGraphService

    asks = [(kind, [src]) for src in sources for kind in KINDS]
    futs, errs = [], []
    lock = threading.Lock()
    replied = threading.Condition()
    n_replied = [0]

    def note(_):
        with replied:
            n_replied[0] += 1
            replied.notify_all()

    def client(c):
        try:
            for w in range(0, len(asks), SHARD_WAVE):
                wave = []
                for k in range(w, w + SHARD_WAVE):
                    kind, srcs = asks[(c + k) % len(asks)]
                    f = srv.query_async(kind, srcs)
                    f.add_done_callback(note)
                    wave.append(f)
                    with lock:
                        futs.append((kind, srcs, f))
                for f in wave:
                    f.exception(timeout=SHARD_WAIT)
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
        for i, ops in enumerate(extra):
            with replied:
                if not replied.wait_for(
                        lambda: n_replied[0] >= (i + 1) * len(asks),
                        timeout=SHARD_WAIT):
                    raise AssertionError("3g front end: replies stalled")
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
    if sync:
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
    masked kernels in the sharded runs, and what 3j holds its processes
    against: the local service's replies and scores (on the host) and, per
    bc_mode, the collective bytes of every traced query in order."""
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
    peaks, coll, coll_seq, svc = {}, {}, {}, None
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
        coll_seq[bc_mode] = query_coll_bytes(tel)
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
    ref = {"want": [(kind, src, r.version, on_host(r.result))
                    for kind, src, _, r in want],
           "scores": {v: t.cpu() for v, t in want_scores.items()},
           "coll": coll_seq, "stream": stream, "sources": sources}
    return launches, ref


def query_coll_bytes(tel) -> list:
    """The collective bytes of every traced query, in order (0 where a
    query ran no collective)."""
    return [r.get("coll_bytes") or 0 for r in tel.tracer.records
            if r.get("span") == "query"]


def on_host(result):
    """A query result with every field on the host."""
    return type(result)(*(x.cpu() for x in result))


# --------------------------------- phase 3j --------------------------------

DIST_TIMEOUT = 300      # seconds any one collective of 3j may take
DIST_JOIN = 600         # seconds 3j's four processes may take in all
# Ring mode moves about 1.3e10 B a BC query through host memory under gloo
# (3g's counts; 14-21 s a BC collect, 45 s a cold bc_scores on the H100's
# host): 3j's ring run takes the first RING_COMMITS commits of the stream
# and no bc_scores; gather mode runs the first GATHER_COMMITS with
# bc_scores at 3g's versions up to it (0 and 8).  GATHER_COMMITS is cut from
# COMMITS for the run's time: with the front end over the processes the
# whole run took 1197.9 s of its 1200 (NVIDIA H100 80GB HBM3, 700.00 W);
# 3g keeps all COMMITS on thread ranks.
RING_COMMITS = 2
GATHER_COMMITS = 8


def dist_rank(mesh, cfg, stream, sources, ref_path):
    """One process of phase 3j: 3a's state and stream through
    ShardedGraphService on ``mesh`` (this process's rank), once per
    bc_mode, every reply held against 3g's local service's and the
    collective bytes of every query against 3g's ThreadGroup run.
    ``cfg``: the parent's sizes (a spawned process imports this module
    afresh).  Returns per bc_mode the walls, the bytes and the kernel
    launches.  On the CPU (a rehearsal: the wrappers take their plain
    versions, which launch nothing) the launch and memory reads are
    skipped."""
    import torch

    from repro_torch.data import load_rmat_graph
    from repro_torch.kernels import bool_mm as kb
    from repro_torch.kernels import count_mm as kc
    from repro_torch.kernels import minplus_mm as kmp
    from repro_torch.shard import ShardedGraphService

    ref = torch.load(ref_path, weights_only=False)
    dev = mesh.device
    card = dev.type == "cuda"
    globals().update(cfg)  # the sizes as the parent set them
    state = load_rmat_graph(N_VERTICES, N_EDGES, seed=SEED, device=dev)
    want = [(kind, src, v, type(res)(*(x.to(dev) for x in res)))
            for kind, src, v, res in ref["want"]]
    out = {}
    for bc_mode, commits, scored in (("gather", GATHER_COMMITS, True),
                                     ("ring", RING_COMMITS, False)):
        svc = None
        if card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        kb.reset_launches()
        kmp.reset_launches()
        kc.reset_launches()
        tel = shard_telemetry()
        svc = ShardedGraphService(
            state, mesh, use_kernel=True, src_chunk=SRC_CHUNK,
            bc_mode=bc_mode, ring_depth=RING_DEPTH, batch_size=BATCH_SIZE,
            telemetry=tel)
        moved0 = dict(mesh.moved)
        got, got_scores, score_walls, wall = shard_stream(
            torch, svc, svc.bc_scores if scored else None,
            stream[:commits], sources, sync=card)
        moved = {k: v - moved0.get(k, 0) for k, v in mesh.moved.items()
                 if v != moved0.get(k, 0)}
        for (kind, src, mode, a), (_, _, v, b) in zip(got, want):
            if a.version != v or not same_single(torch, kind, a.result, b):
                raise AssertionError(
                    f"3j {bc_mode} rank {mesh.rank}: {kind}({src}) {mode} at "
                    f"version {a.version} ({a.mode}) != 3g's local service's")
        for v, sc in got_scores.items():
            exp = ref["scores"][v].to(dev)
            if not torch.allclose(sc, exp, equal_nan=True, **TOL):
                raise AssertionError(f"3j {bc_mode} rank {mesh.rank}: "
                                     f"bc_scores at version {v} off")
        coll = query_coll_bytes(tel)
        first = 0 if scored else 1  # 3g's stream opens with bc_scores
        if coll != ref["coll"][bc_mode][first:first + len(coll)]:
            raise AssertionError(f"3j {bc_mode} rank {mesh.rank}: collective "
                                 "bytes differ from 3g's ThreadGroup run")
        st = svc.stats
        if st.delta < 1 or st.full < 1:
            raise AssertionError(f"3j {bc_mode}: a rung never ran ({st})")
        launches = {"bool_mm_masked": kb.LAUNCHES["bool_mm_masked"],
                    "minplus_mm_masked": kmp.LAUNCHES["minplus_mm_masked"],
                    "count_mm_masked": kc.LAUNCHES["count_mm_masked"]}
        for name, n in launches.items():
            if card and n <= 0:
                raise AssertionError(f"3j {bc_mode} rank {mesh.rank} never "
                                     f"launched {name}")
        out[bc_mode] = {
            "replies": len(got), "commits": commits, "scored": scored,
            "wall": wall,
            "walls": {f"{k}/{m}": v for (k, m), v in rung_walls(tel).items()},
            "score_walls": score_walls, "coll_bytes": sum(coll),
            "moved": moved, "launches": launches, "stats": st.as_dict(),
            "peak": torch.cuda.max_memory_allocated(dev) if card else 0}
        if bc_mode == "gather":
            out["front_end"] = dist_front_end(torch, mesh, svc, tel,
                                              sources, card)
        tel.close()
    # the dry run's graph engine cell, live on this graph (vcap cut)
    from repro_torch.launch import dryrun

    for k in (kb, kmp, kc):
        k.reset_launches()
    t0 = time.perf_counter()
    cell = dryrun.run_graph_cell(mesh, state, src_chunk=SRC_CHUNK)
    cell["wall"] = time.perf_counter() - t0
    cell["launches"] = {"bool_mm_masked": kb.LAUNCHES["bool_mm_masked"],
                        "minplus_mm_masked": kmp.LAUNCHES["minplus_mm_masked"],
                        "count_mm_masked": kc.LAUNCHES["count_mm_masked"]}
    out["graph_cell"] = cell
    return out


def dist_front_end(torch, mesh, svc, tel, sources, card):
    """3j's front end on one process: 3g's schedule (shard_front_end)
    through AsyncGraphService on ``svc``, rank 0 admitting and sequencing,
    the other ranks following its commands.  Fails unless no pin is left
    and, on the card, bool_mm_masked and minplus_mm_masked launched here
    (the bands are split over the ranks) and, on rank 0, count_mm_masked:
    a BC query splits its sources over the ranks (padded with dead
    sources), so a one-source BC collect counts on rank 0 alone.  Returns
    the replies checked (rank 0), the commands followed, the wall, the
    serve and service tallies, the dedup sizes, what the transport moved
    in it by op (the commands and the collects' rung messages under
    "control") and the launches."""
    from repro_torch.kernels import bool_mm as kb
    from repro_torch.kernels import count_mm as kc
    from repro_torch.kernels import minplus_mm as kmp
    from repro_torch.serve import AsyncGraphService

    for k in (kb, kmp, kc):
        k.reset_launches()
    moved0, n0 = dict(mesh.moved), len(tel.tracer.records)
    dedup = tel.registry.find("serve_batch_size", rung="dedup")
    sizes0 = {id(h): len(h.samples) for h in dedup}
    t0 = time.perf_counter()
    if mesh.rank == 0:
        checked, stats = shard_front_end(torch, svc, sources, sync=card)
        commands = None
    else:
        checked, srv = 0, AsyncGraphService(svc, max_batch=16)
        commands = srv.follow()
        stats = srv.stats
        if card:
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if svc.ring.pinned_versions():
        raise AssertionError(f"3j front end: rank {mesh.rank} left pins on "
                             f"{svc.ring.pinned_versions()}")
    launches = {"bool_mm_masked": kb.LAUNCHES["bool_mm_masked"],
                "minplus_mm_masked": kmp.LAUNCHES["minplus_mm_masked"],
                "count_mm_masked": kc.LAUNCHES["count_mm_masked"]}
    for name, n in launches.items():
        if (card and n <= 0
                and (mesh.rank == 0 or name != "count_mm_masked")):
            raise AssertionError(f"3j front end: rank {mesh.rank} never "
                                 f"launched {name}")
    return {
        "replies": checked, "commands": commands, "wall": wall,
        "serve": {k: getattr(stats, k) for k in (
            "admitted", "dispatches", "batched_dispatches", "fallbacks",
            "deadline_expired", "max_batch_seen")},
        "stats": svc.stats.as_dict(),
        "rungs": dict(Counter(
            f"{r['kind']}/{r['mode']}" for r in tel.tracer.records[n0:]
            if r.get("span") == "query" and "mode" in r)),
        "dedup_sizes": [x for h in tel.registry.find(
            "serve_batch_size", rung="dedup")
            for x in h.samples[sizes0.get(id(h), 0):]],
        "moved": {k: v - moved0.get(k, 0) for k, v in mesh.moved.items()
                  if v != moved0.get(k, 0)},
        "launches": launches}


def report_front_end(outs, transport):
    """3j's front-end lines: rank 0's replies, serve stats and wall, the
    control bytes moved beside the collectives' (host staging apart);
    every process must end with the same service tallies."""
    fe = [o["front_end"] for o in outs]
    if any(f["stats"] != fe[0]["stats"] for f in fe):
        raise AssertionError("3j front end: the processes' service tallies "
                             f"differ: {[f['stats'] for f in fe]}")
    r0 = fe[0]
    log(f"  {transport} front end (AsyncGraphService, rank 0 sequencing): "
        f"{r0['replies']} replies == the single-source queries at their "
        f"versions in {r0['wall']:.2f} s (rank 0; followers "
        f"{', '.join('%.2f' % f['wall'] for f in fe[1:])} s, "
        f"{fe[1]['commands'] if len(fe) > 1 else 0} commands); serve "
        f"{r0['serve']}; dedup sizes {r0['dedup_sizes']}; replies by kind "
        f"and rung {r0['rungs']}; {r0['stats']}")
    moved = r0["moved"]
    coll = sum(v for k, v in moved.items()
               if k not in ("control", "host-staging"))
    log(f"    moved by the transport (rank 0): control {moved.get('control', 0)}"
        f" B (commands and rung messages) beside {coll:.4g} B of collectives "
        f"({', '.join(f'{k} {v:.4g}' for k, v in sorted(moved.items()))});"
        " launches " + "; ".join(f"rank {r} {f['launches']}"
                                 for r, f in enumerate(fe)))


def dist_phase(torch, np, timings, ref):
    """Phase 3j: 3g's stream through ShardedGraphService on a DistMesh, one
    process per rank (dist.spawn, SHARDS processes on cuda:0 over gloo;
    NCCL with one card per rank where there are SHARDS cards).  The
    kernels were built in phase 1: the processes load them from
    kernels/_build.  Returns the launches of the three masked kernels,
    summed over the processes."""
    import tempfile

    from repro_torch.shard import spawn

    stream, sources = ref["stream"], ref["sources"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_3j_")
    ref_path = os.path.join(tmp, "ref.pt")
    torch.save({k: ref[k] for k in ("want", "scores", "coll")}, ref_path)
    runs = [("gloo", f"{DEV}:0" if DEV == "cuda" else DEV)]
    if torch.cuda.device_count() >= SHARDS:
        runs.append(("nccl", None))
    else:
        log(f"  NCCL not run: it needs one card per rank, {SHARDS} cards; "
            f"this machine has {torch.cuda.device_count()}")
    launches = {}
    try:
        for transport, device in runs:
            torch.cuda.empty_cache()
            log(f"  transport {transport}: {SHARDS} processes on "
                f"{device or 'one card each'}; gather mode on the first "
                f"{GATHER_COMMITS} of {COMMITS} commits with bc_scores at 3g's "
                f"versions, ring mode on the first {RING_COMMITS} and no "
                f"bc_scores")
            t0 = time.perf_counter()
            outs = spawn(dist_rank, SHARDS, device=device,
                         transport=transport, timeout=DIST_TIMEOUT,
                         join_timeout=DIST_JOIN,
                         args=(dist_cfg(), stream, sources, ref_path))
            wall = time.perf_counter() - t0
            timings[f"3j {transport} (spawn to join)"] = wall
            report_dist(outs, transport)
            report_front_end(outs, transport)
            report_graph_cell(outs, transport)
            for out in outs:
                for mode in out.values():
                    for name, n in mode["launches"].items():
                        launches[name] = launches.get(name, 0) + n
    finally:
        os.remove(ref_path)
        os.rmdir(tmp)
    log(f"  3j kernel launches, summed over the processes {launches}")
    return launches


def dist_cfg() -> dict:
    """The sizes 3j's processes run at, as this process has them."""
    names = ("N_VERTICES", "N_EDGES", "SEED", "COMMITS", "GATHER_COMMITS",
             "RING_COMMITS",
             "SRC_CHUNK", "RING_DEPTH", "BATCH_SIZE")
    return {k: globals()[k] for k in names}


def report_graph_cell(outs, transport):
    """The dry run's live graph cell: each kind's collective bytes, the
    same on every rank (each runs the same collectives), and its wall."""
    from repro_torch.launch import dryrun

    cells = [o["graph_cell"] for o in outs]
    for kind in dryrun.GRAPH_KINDS:
        if any(c[kind] != cells[0][kind] for c in cells) or not cells[0][kind]:
            raise AssertionError(f"3j graph cell {kind}: collective bytes "
                                 f"{[c[kind] for c in cells]}")
    c = cells[0]
    log(f"  {transport} dry run's graph cell, vcap {c['vcap']} (cut from "
        f"{c['reduced']['vcap'][0]}; vp {c['vp']}), {c['n_sources']} "
        f"sources, {c['wall']:.1f} s (rank 0): counted bytes a rank " +
        "; ".join(f"{k} {c[k]}" for k in dryrun.GRAPH_KINDS))


def report_dist(outs, transport):
    """3j's lines: per bc_mode, rank 0's ms per query per kind and rung,
    the stream's collective bytes beside what the transport moved, each
    process's peak memory."""
    for mode in ("gather", "ring"):
        r0 = outs[0][mode]
        log(f"  {transport} {mode}: {r0['replies']} replies per process == "
            f"3g's local service's ({r0['commits']} commits) in "
            f"{r0['wall']:.2f} s (rank 0); {r0['stats']}")
        log("    ms per query, median (count), rank 0: " + "; ".join(
            f"{k} {v[0]:.2f} ({v[1]})" for k, v in sorted(r0["walls"].items())))
        if r0["scored"]:
            log("    bc_scores s: " + " / ".join(
                f"{t:.3f}" for t in r0["score_walls"]))
        log(f"    collective bytes (counted, as 3g) {r0['coll_bytes']:.4g}; "
            f"moved by the transport: " + ", ".join(
                f"{k} {v:.4g}" for k, v in sorted(r0["moved"].items())))
        log("    peak device memory per process: " + ", ".join(
            f"{o[mode]['peak'] / 2**30:.2f} GiB" for o in outs))


# --------------------------------- phase 3k --------------------------------

# LM sharding on a ("data", "model") mesh of LM_MESH processes on the one card
# (gloo; NCCL with one card per rank where there are four cards).  Parity:
# reduced granite_moe_1b and qwen3_32b (float32) at capacity 8 (nothing
# drops), LM_PARITY_STEPS steps at batch 4 and granite once more at batch 2
# (the batch replicates over "model"), every step held against one process
# on the card.  Then granite_moe_1b at full width through train.main
# --mesh at train_4k's sequence, one sequence per process, LM_SHARD_STEPS
# steps, its depth cut to LM_SHARD_LAYERS of 24 (the MoE's all-to-alls and
# psum move about 1.3 GB a layer per process through host memory per step),
# and the dry run's live cell at depth 1 and 2.
LM_MESH = (2, 2)
LM_PARITY = (("granite_moe_1b", 4), ("qwen3_32b", 4), ("granite_moe_1b", 2))
LM_PARITY_SEQ, LM_PARITY_STEPS, LM_PARITY_CAPACITY = 32, 3, 8.0
LM_PARITY_KW = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)
LM_SHARD_ARCH, LM_SHARD_SEQ, LM_SHARD_BATCH = "granite_moe_1b", 4096, 4
LM_SHARD_STEPS, LM_SHARD_LAYERS = 3, 4
LM_DRYRUN_SEQ = None    # the dry run's cell at train_4k's own sequence
LM_TIMEOUT, LM_JOIN = 300, 900


def lm_parity_config(arch):
    import dataclasses

    from repro_torch.configs import get_config, reduced
    # attention through sdpa_chunked, as the trainer runs it: the flash
    # kernel has no backward
    cfg = dataclasses.replace(reduced(get_config(arch)), attn_impl="xla")
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=LM_PARITY_CAPACITY)
    return cfg


def rows_mean_model(model, n_rows):
    """``model`` whose loss is the mean of its loss on each of ``n_rows``
    equal splits of the batch: what the mesh's step computes, whose
    load-balance loss is a mean over data rows (the reference's pmean),
    where no token is 0 (every split then has the same token count)."""
    import dataclasses

    def loss_fn(params, batch):
        parts = [{k: v.chunk(n_rows, dim=1 if k == "positions" else 0)[i]
                  for k, v in batch.items()} for i in range(n_rows)]
        return sum(model.loss_fn(params, b) for b in parts) / n_rows
    return dataclasses.replace(model, loss_fn=loss_fn)


def lm_state_like(torch, tree):
    return [t.detach().float().cpu() for t in tree]


def lm_shard_rank(mesh, cfg, ckpt_root):
    """One process of phase 3k (module docstring): the parity steps, the
    elastic checkpoint round, full-width training through train.main and
    the dry run's live cell.  ``cfg``: the parent's sizes."""
    import dataclasses
    import torch

    from repro_torch.checkpoint import Checkpointer, restore_checkpoint
    from repro_torch.data import SyntheticTokens, shard_batch
    from repro_torch.launch import dryrun, mesh as meshlib, steps, train
    from repro_torch.models import get_model, param_shapes
    from repro_torch.optim import AdamWState, adamw_init
    from repro_torch.optim.tree import tree_leaves

    globals().update(cfg)
    meshlib.make_production_mesh(mesh, shape=LM_MESH)
    dev, card = mesh.device, mesh.device.type == "cuda"
    tally = mesh.group()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    out = {"parity": [], "rank": mesh.rank}

    def whole(lp, lo, p_sh):
        return (lm_state_like(torch, tree_leaves(steps.gather_state(lp, p_sh))),
                lm_state_like(torch, tree_leaves(steps.gather_state(lo.m, p_sh))),
                lm_state_like(torch, tree_leaves(steps.gather_state(lo.v, p_sh))))

    for arch, batch in LM_PARITY:
        pcfg = lm_parity_config(arch)
        model = get_model(pcfg)
        p0 = tree_map_to(torch, model.init(torch.Generator().manual_seed(0)),
                         dev)
        o0 = adamw_init(p0, pcfg.moment_dtype)
        p_sh, o_sh = steps.train_state_shardings(model, mesh, p0, o0)
        lp, lo = steps.local_state(p0, p_sh), steps.local_state(o0, o_sh)
        del p0, o0
        step = steps.build_train_step(model, mesh=mesh, **LM_PARITY_KW)
        ds = SyntheticTokens(pcfg.vocab_size, LM_PARITY_SEQ, batch, seed=1)
        run = {"arch": arch, "batch": batch, "losses": [], "states": []}
        for i in range(LM_PARITY_STEPS):
            lp, lo, met = step(lp, lo, shard_batch(ds.batch_at(i), mesh=mesh))
            run["losses"].append(float(met["loss"]))
            run["states"].append(whole(lp, lo, p_sh))
        out["parity"].append(run)
        if (arch, batch) == LM_PARITY[0]:
            # The elastic round: save from the mesh; rank 0 also saves the
            # gathered state alone; restore on the mesh and step again.
            state, sh = {"params": lp, "opt": lo}, {"params": p_sh,
                                                    "opt": o_sh}
            mdir = os.path.join(ckpt_root, "mesh")
            Checkpointer(mdir).save(LM_PARITY_STEPS, state, blocking=True,
                                    mesh=mesh, shardings=sh)
            gathered = steps.gather_state(state, sh)
            if mesh.rank == 0:
                Checkpointer(os.path.join(ckpt_root, "one")).save(
                    LM_PARITY_STEPS, gathered, blocking=True)
            mesh.barrier()
            pspecs = model.specs()
            specs = {"params": pspecs, "opt": AdamWState(
                step=meshlib.P(), m=pspecs, v=pspecs)}
            back = restore_checkpoint(mdir, LM_PARITY_STEPS, gathered,
                                      device=dev, mesh=mesh, specs=specs)
            b = shard_batch(ds.batch_at(LM_PARITY_STEPS), mesh=mesh)
            a1, ao, am = step(lp, lo, b)
            b1, bo, bm = step(back["params"], back["opt"], b)
            out["elastic"] = {
                "restored_equal": all(torch.equal(x, y) for x, y in zip(
                    tree_leaves(back), tree_leaves(state))),
                "step_equal": float(am["loss"]) == float(bm["loss"]) and all(
                    torch.equal(x, y) for x, y in zip(
                        tree_leaves((a1, ao)), tree_leaves((b1, bo)))),
                "loss": float(am["loss"])}
            del gathered, back, a1, ao, b1, bo
        del lp, lo
    if card:
        torch.cuda.empty_cache()

    # granite_moe_1b at full width through the trainer on the mesh
    real = train.get_config
    train.get_config = lambda a: dataclasses.replace(
        real(a), num_layers=LM_SHARD_LAYERS)
    try:
        if card:
            torch.cuda.reset_peak_memory_stats(dev)
        t_before = mesh.transport_s
        r = train.main(["--arch", LM_SHARD_ARCH, "--steps",
                        str(LM_SHARD_STEPS), "--seq", str(LM_SHARD_SEQ),
                        "--batch", str(LM_SHARD_BATCH), "--mesh", "single",
                        "--mesh-shape", "x".join(map(str, LM_MESH)),
                        "--log-every", "1", "--device", dev.type], mesh=mesh)
        out["train"] = {
            "losses": r.losses, "step_s": r.step_s,
            "tokens_per_s": r.tokens_per_s,
            "peak": r.peak_bytes or 0, "collectives": r.collectives,
            "moved": r.moved, "transport_s": mesh.transport_s - t_before,
            "layers": r.cfg.num_layers, "params": sum(
                t.numel() for t in tree_leaves(param_shapes(
                    get_model(r.cfg))))}
        if card:   # one more step, rank 0's under torch.profiler
            step_fn = train.make_train_step(get_model(r.cfg),
                                            LM_SHARD_STEPS + 1, 3e-4,
                                            mesh=mesh)
            ds = SyntheticTokens(r.cfg.vocab_size, LM_SHARD_SEQ,
                                 LM_SHARD_BATCH, seed=0)
            b = shard_batch(ds.batch_at(LM_SHARD_STEPS), mesh=mesh)
            out["train"]["profiled"] = profiled_step(
                torch, lambda: step_fn(r.params, r.opt, b), mesh.rank == 0)
        del r
    finally:
        train.get_config = real
    if card:
        torch.cuda.empty_cache()

    # the dry run's live cell: depth 1 and 2 at full width, extrapolated
    t0 = time.perf_counter()
    rec = dryrun.run_cell(LM_SHARD_ARCH, "train_4k", mesh, out_dir=None,
                          seq=LM_DRYRUN_SEQ)
    out["dryrun"] = {k: rec[k] for k in ("depth1", "depth2", "full",
                                          "units", "reduced", "batch",
                                          "seq")}
    out["dryrun"]["wall"] = time.perf_counter() - t0
    kernels = kernel_launches()
    out["kernel_launches"] = kernels
    torch.use_deterministic_algorithms(False)
    return out


def profiled_step(torch, fn, profile: bool) -> dict:
    """``fn()`` (a train step), under ``torch.profiler`` where ``profile``:
    its wall, the summed device time of its kernels and of its copies,
    and its kernel launches, from the raw kineto events (the event tree
    of a step's ~10^5 ops would take longer to build than the step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not profile:
        fn()
        torch.cuda.synchronize()
        return {"wall": time.perf_counter() - t0}
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    cuda = [e for e in events if e.device_type() == DeviceType.CUDA]
    copies = [e for e in cuda if e.name().startswith(("Memcpy", "Memset"))]
    kernel_ns = sum(e.end_ns() - e.start_ns() for e in cuda) - sum(
        e.end_ns() - e.start_ns() for e in copies)
    return {"wall": wall, "kernel_s": kernel_ns / 1e9,
            "copy_s": sum(e.end_ns() - e.start_ns() for e in copies) / 1e9,
            "kernels": len(cuda) - len(copies)}


def tree_map_to(torch, tree, dev):
    from repro_torch.optim.tree import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count in this process."""
    from repro_torch.kernels import bool_mm, count_mm, flash_attention
    from repro_torch.kernels import minplus_mm
    out = {}
    for mod in (bool_mm, count_mm, minplus_mm, flash_attention):
        out.update(mod.LAUNCHES)
    return out


def lm_shard_cfg() -> dict:
    names = ("LM_MESH", "LM_PARITY", "LM_PARITY_SEQ", "LM_PARITY_STEPS",
             "LM_PARITY_CAPACITY", "LM_PARITY_KW", "LM_SHARD_ARCH",
             "LM_SHARD_SEQ", "LM_SHARD_BATCH", "LM_SHARD_STEPS",
             "LM_SHARD_LAYERS", "LM_DRYRUN_SEQ")
    return {k: globals()[k] for k in names}


# AdamW's step divides each gradient element by its own RMS: where that
# RMS is near eps (1e-8) the step is lr * g / (|g| + eps) of a near-
# cancelling sum, whose f32 reassociation (the mesh sums in another order)
# moves the step by a sizeable share of lr.  hold_step holds the parameter
# change of an element whose sqrt(v_hat) is below ILL_RMS (and not 0: a
# zero gradient steps by the weight decay alone) through its moments only.
ILL_RMS = 1e-6


def hold_step(np, what, got, want, step, ill_before=None):
    """tests/test_torch_optim.py::test_train_step_matches_reference's
    criteria: the loss to rtol 1e-5; each moment leaf to rtol 1e-4 and an
    atol of 1e-4 of its largest; each parameter leaf's change from p0 to
    5% of its largest change (where AdamW's step is well conditioned,
    ILL_RMS), all but a thousandth of its elements to rtol 1e-4 + 1e-3 of
    that change; both bounds skip the elements ill-conditioned at this step
    or an earlier one (ILL_RMS; ``ill_before``, the masks of the step
    before), held by their moments.  Returns the masks."""
    (gl, (gp, gm, gv)), (wl, (wp, wm, wv)), p0 = got, want[:2], want[2]
    np.testing.assert_allclose(gl, wl, rtol=1e-5, err_msg=f"{what} loss")
    for g, w in zip(gm + gv, wm + wv):
        g, w = g.numpy(), w.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"{what} moment")
    ill = []
    bc2 = 1.0 - 0.95 ** (step + 1)
    for i, (g, w, p, v) in enumerate(zip(gp, wp, p0, wv)):
        dg, dw = (g - p).numpy(), (w - p).numpy()
        top = np.abs(dw).max()
        v = v.numpy()
        bad = (v > 0) & (np.sqrt(v / bc2) < ILL_RMS)
        if ill_before is not None:
            bad |= ill_before[i]
        ill.append(bad)
        ok = ~bad
        np.testing.assert_allclose(dg[ok], dw[ok], rtol=0, atol=0.05 * top,
                                   err_msg=f"{what} param change")
        off = ok & (np.abs(dg - dw) > 1e-4 * np.abs(dw) + 1e-3 * top)
        if off.sum() > 1e-3 * off.size:
            raise AssertionError(f"{what}: {int(off.sum())} of {off.size} "
                                 "parameter elements off")
    return ill


def lm_parity_reference(torch, np, arch, batch, n_rows):
    """One process on the card: build_train_step on the rows-mean loss,
    LM_PARITY_STEPS steps from the same seed; the loss and whole state
    after each, and the initial parameters."""
    from repro_torch.data import SyntheticTokens, shard_batch
    from repro_torch.launch import steps
    from repro_torch.models import get_model
    from repro_torch.optim import adamw_init
    from repro_torch.optim.tree import tree_leaves

    cfg = lm_parity_config(arch)
    model = rows_mean_model(get_model(cfg), n_rows)
    p = tree_map_to(torch, model.init(torch.Generator().manual_seed(0)), DEV)
    p0 = lm_state_like(torch, tree_leaves(p))
    o = adamw_init(p, cfg.moment_dtype)
    step = steps.build_train_step(model, **LM_PARITY_KW)
    ds = SyntheticTokens(cfg.vocab_size, LM_PARITY_SEQ, batch, seed=1)
    out = []
    for i in range(LM_PARITY_STEPS):
        p, o, met = step(p, o, shard_batch(ds.batch_at(i), device=DEV))
        out.append((float(met["loss"]),
                    (lm_state_like(torch, tree_leaves(p)),
                     lm_state_like(torch, tree_leaves(o.m)),
                     lm_state_like(torch, tree_leaves(o.v)))))
    elastic = None
    if (arch, batch) == LM_PARITY[0]:
        b = shard_batch(ds.batch_at(LM_PARITY_STEPS), device=DEV)
        elastic = (step, {"params": p, "opt": o}, b)
    return out, p0, elastic


def lm_tree_from(torch, like, state):
    """``like``'s train state ({"params", "opt"}) with the leaves of
    ``state`` (params, m, v lists, float32 on the host) in its dtypes on
    the card, the step counter ``LM_PARITY_STEPS``."""
    from repro_torch.optim import AdamWState
    from repro_torch.optim.tree import tree_flatten

    def put(tree, leaves):
        old, unflatten = tree_flatten(tree)
        return unflatten([x.to(device=DEV, dtype=o.dtype)
                          for x, o in zip(leaves, old)])
    p, m, v = state
    o = like["opt"]
    return {"params": put(like["params"], p), "opt": AdamWState(
        step=torch.full_like(o.step, LM_PARITY_STEPS), m=put(o.m, m),
        v=put(o.v, v))}


def lm_shard_phase(torch, np, timings):
    """Phase 3k (module docstring).  Every failure fails the phase: a
    failed or hung process raises SpawnError."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.shard import spawn

    n = math.prod(LM_MESH)
    runs = [("gloo", f"{DEV}:0" if DEV == "cuda" else DEV)]
    if DEV == "cuda" and torch.cuda.device_count() >= n:
        runs.append(("nccl", None))
    else:
        log(f"  NCCL not run: it needs one card per rank, {n} cards; this "
            f"machine has {torch.cuda.device_count() if DEV == 'cuda' else 0}")
    full = get_config(LM_SHARD_ARCH)
    log(f"  {LM_SHARD_ARCH} at full width (d {full.d_model}, "
        f"{full.num_heads}/{full.num_kv_heads} heads, {full.num_experts} "
        f"experts, ff {full.d_ff}, vocab {full.vocab_size}); depth cut to "
        f"{LM_SHARD_LAYERS} of {full.num_layers} layers; batch 256 x "
        f"{LM_SHARD_SEQ} cut to {LM_SHARD_BATCH} x {LM_SHARD_SEQ} (one "
        f"sequence per process)")
    for transport, device in runs:
        root = tempfile.mkdtemp(prefix="chip_smoke_3k_")
        try:
            t0 = time.perf_counter()
            outs = spawn(lm_shard_rank, n, device=device, transport=transport,
                         timeout=LM_TIMEOUT, join_timeout=LM_JOIN,
                         args=(lm_shard_cfg(), root))
            timings[f"3k {transport} (spawn to join)"] = \
                time.perf_counter() - t0
            lm_shard_check(torch, np, outs, root, transport)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def lm_shard_check(torch, np, outs, root, transport):
    """3k's checks and lines, in this process, on what the mesh's processes
    returned."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.optim.tree import tree_leaves

    r0 = outs[0]
    for o in outs[1:]:      # the same bits in every process
        for a, b in zip(o["parity"], r0["parity"]):
            if a["losses"] != b["losses"] or not all(
                    torch.equal(x, y) for s1, s2 in zip(a["states"],
                                                        b["states"])
                    for t1, t2 in zip(s1, s2) for x, y in zip(t1, t2)):
                raise AssertionError(f"3k {transport}: rank {o['rank']}'s "
                                     "parity state differs from rank 0's")
    for run in r0["parity"]:
        arch, batch = run["arch"], run["batch"]
        want, p0, elastic = lm_parity_reference(torch, np, arch, batch,
                                                LM_MESH[0])
        ill = None
        for i, (got, exp) in enumerate(zip(zip(run["losses"],
                                               run["states"]), want)):
            ill = hold_step(np, f"3k {transport} {arch} batch {batch} "
                            f"step {i}", got, (*exp, p0), i, ill)
        ill = sum(int(m.sum()) for m in ill)
        size = sum(m.numel() for m in p0)
        log(f"  {transport} parity {arch} (reduced, f32, capacity "
            f"{LM_PARITY_CAPACITY}) batch {batch}: {LM_PARITY_STEPS} steps "
            f"against one process's build_train_step on the rows-mean loss: "
            f"losses {[round(x, 6) for x in run['losses']]} vs "
            f"{[round(w[0], 6) for w in want]}; moments and parameter "
            f"changes within the train-step criteria ({ill} of {size} "
            f"elements ill-conditioned, sqrt(v_hat) < {ILL_RMS} at some "
            f"step, held by their moments)")
        if elastic is not None:
            # one process: the mesh's files restored, against the mesh's
            # gathered state in memory, and one step from each
            step, like, b = elastic
            mem = lm_tree_from(torch, like, run["states"][-1])
            el = r0["elastic"]
            files = sorted(os.listdir(os.path.join(
                root, "mesh", f"step_{LM_PARITY_STEPS:08d}")))
            same_files = all(open(os.path.join(
                root, "mesh", f"step_{LM_PARITY_STEPS:08d}", f), "rb").read()
                == open(os.path.join(root, "one",
                                     f"step_{LM_PARITY_STEPS:08d}", f),
                        "rb").read()
                for f in files if f != "manifest.json")
            back = restore_checkpoint(os.path.join(root, "mesh"),
                                      LM_PARITY_STEPS, like, device=DEV)
            same_state = all(torch.equal(x, y) for x, y in zip(
                tree_leaves((back["params"], back["opt"].m, back["opt"].v)),
                tree_leaves((mem["params"], mem["opt"].m, mem["opt"].v))))
            a1, _, am = step(mem["params"], mem["opt"], b)
            b1, _, bm = step(back["params"], back["opt"], b)
            one_ok = same_state and float(am["loss"]) == float(
                bm["loss"]) and all(torch.equal(x, y) for x, y in zip(
                    tree_leaves(a1), tree_leaves(b1)))
            log(f"  {transport} elastic: the mesh's files == one process's "
                f"save of the gathered state ({len(files)} files): "
                f"{same_files}; restored on the mesh == the state: "
                f"{el['restored_equal']}; a step from it == the step from "
                f"memory: {el['step_equal']}; restored on one process, a "
                f"step == the step from memory: {one_ok}")
            if not (same_files and el["restored_equal"] and el["step_equal"]
                    and one_ok):
                raise AssertionError(f"3k {transport}: the elastic "
                                     "checkpoint round failed")
    tr = r0["train"]
    tokens = LM_SHARD_BATCH * LM_SHARD_SEQ
    med = statistics.median(tr["step_s"][1:])
    log(f"  {transport} {LM_SHARD_ARCH} {tr['layers']} layers "
        f"({tr['params'] / 1e9:.3f} B params) on a "
        f"{'x'.join(map(str, LM_MESH))} mesh: losses "
        f"{[round(x, 4) for x in tr['losses']]}; step s "
        f"{[round(x, 2) for x in tr['step_s']]}; median {med:.2f} s "
        f"({tokens / med:.0f} tokens/s; {tr['tokens_per_s']:.0f} over the "
        f"run); in the transport {tr['transport_s']:.2f} s of "
        f"{sum(tr['step_s']):.2f} s (rank 0)")
    log("    peak device memory per process: " + ", ".join(
        f"{o['train']['peak'] / 2**30:.2f} GiB" for o in outs))
    pr = tr.get("profiled")
    if pr and "kernel_s" in pr:
        log(f"    one more step, rank 0 under torch.profiler: {pr['wall']:.2f}"
            f" s; its kernels {pr['kernel_s']:.3f} s of device time "
            f"({pr['kernels']} launches; busy {pr['kernel_s'] / pr['wall']:.3f}"
            f"), its copies {pr['copy_s']:.3f} s")
    per = LM_SHARD_STEPS
    log(f"    collective bytes a step (rank 0), counted: " + ", ".join(
        f"{k} {v / per:.4g}" for k, v in sorted(tr["collectives"].items())
        if v) + "; moved by the transport: " + ", ".join(
        f"{k} {v / per:.4g}" for k, v in sorted(tr["moved"].items()) if v))
    if not all(math.isfinite(x) for x in tr["losses"]):
        raise AssertionError(f"3k: non-finite loss {tr['losses']}")
    dr = r0["dryrun"]
    log(f"  {transport} dry run, {LM_SHARD_ARCH} train_4k at full width, "
        f"batch {dr['reduced']['batch'][0]} cut to {dr['batch']} x "
        f"{dr['seq']} ({dr['wall']:.1f} s): counted bytes a rank, depth 1 "
        f"{dr['depth1']['collectives']}, depth 2 "
        f"{dr['depth2']['collectives']}, extrapolated to {dr['units']} "
        f"layers {dr['full']['collectives']}")
    launched = {k: v for o in outs for k, v in o["kernel_launches"].items()
                if v}
    log(f"  {transport} kernel launches in 3k's processes: "
        f"{launched or 'none'} (training runs attention through 'xla')")
    log(f"  nvidia-smi: {nvidia_smi()}")


# --------------------------------- phase 3l --------------------------------

# Sharded prefill and decode on the LM_MESH mesh of processes on the one card
# (gloo; NCCL with one card per rank where there are four cards), in the
# reference's serving layout: parameters in blocks, the KV cache's batch over
# "data" and its sequence over "model", the batch rows over "data".  Each run
# is held against one process's build_prefill_step / build_decode_step on the
# card, on the same seed-0 weights, the same prompts (serve's draw) and the
# one process's greedy tokens.  SERVE_RUNS: arch, layers kept (None: all),
# decode steps, and whether the mesh takes the prompt as two halves (the
# continuation's gathered prefix, held against the one process's single
# prefill; granite's cut to SERVE_SPLIT_LAYERS layers, since a full-depth
# prefill moves about 3e10 B through gloo's host staging).  Every run's
# cache holds SERVE_MAX_LEN rows, split in two blocks over "model".  The
# MoE serves at capacity E / k, at which neither the one process's dense
# dispatch nor the mesh's buckets can drop a pair; both tallies are checked
# at 0.  SERVE_F32: reduced configs (float32; granite at its capacity) held
# to SERVE_F32_TOL: a prompt, a continuation and decode steps.  The dry
# run's prefill_32k and decode_32k cells run at SERVE_DRYRUN_SEQ.
SERVE_SPLIT_LAYERS = 4
SERVE_RUNS = (("granite_moe_1b", None, LM_GEN - 1, False),
              ("granite_moe_1b", SERVE_SPLIT_LAYERS, 0, True),
              ("mistral_nemo_12b", 2, 4, False))
SERVE_MAX_LEN = LM_PROMPT + LM_GEN      # 1040 rows a process
SERVE_F32 = (("granite_moe_1b", 8.0), ("qwen3_32b", None))
SERVE_F32_PROMPT, SERVE_F32_CONT, SERVE_F32_DECODE = 24, 8, 4
SERVE_F32_TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_DRYRUN_ARCH, SERVE_DRYRUN_SEQ = "granite_moe_1b", 4096
SERVE_REDUCED = False   # True: every run at its reduced config (rehearsal)


def serve_config(arch, layers=None):
    """3l's config of ``arch``: reduced where SERVE_REDUCED, cut to
    ``layers`` layers, its MoE at capacity E / k."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    cfg = get_config(arch)
    if SERVE_REDUCED:
        cfg = reduced(cfg)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if cfg.num_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    return cfg


def serve_f32_config(arch, capacity):
    import dataclasses

    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config(arch))
    if capacity is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity)
    return cfg


def serve_prompts(torch, cfg, prompt_len):
    """serve.serve's prompts: LM_BATCH rows of uniform tokens from a
    generator seeded 1."""
    draw = torch.Generator(device=DEV).manual_seed(1)
    return torch.randint(1, cfg.vocab_size, (LM_BATCH, prompt_len),
                         generator=draw, device=DEV)


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def serve_one_process(torch, cfg, prompts, n_dec, max_len, chunks=(),
                      floor=False, frames=None):
    """One process on the card: the prompt (with Whisper's ``frames``;
    then each continuation of ``chunks``) and ``n_dec`` greedy decode
    steps, through build_prefill_step / build_decode_step.  Returns every
    step's logits and wall, the greedy tokens, the cache (``k``, ``v``
    where it has them; every leaf by path under ``cache``, and as the
    first prefill left it under ``prefill_cache``) and the dropped pairs;
    with ``floor``, also how far the prefill's logits lie from the same
    prefill in float32 on the same weights (what bf16 rounding alone
    moves)."""
    from repro_torch.launch import steps
    from repro_torch.models import get_model, moe

    model = get_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    cache = model.init_cache(prompts.shape[0], max_len, dtype=cfg.dtype,
                             device=DEV)
    prefill = steps.build_prefill_step(model)
    decode = steps.build_decode_step(model)
    rec = {"logits": [], "walls": [], "tokens": []}

    def run(step, t, **extra):
        nonlocal cache
        sync(torch, DEV)
        t0 = time.perf_counter()
        logits, cache = step(params, cache, {"tokens": t, **extra})
        sync(torch, DEV)
        rec["walls"].append(time.perf_counter() - t0)
        rec["logits"].append(logits.float().cpu())
        return logits

    with moe.drop_tally() as drops:
        logits = run(prefill, prompts, **({} if frames is None
                                          else {"frames": frames}))
        rec["prefill_cache"] = {p: t.to("cpu", copy=True)
                                for p, t in cache_leaves(cache).items()}
        for c in chunks:
            logits = run(prefill, c)
        for _ in range(n_dec):
            tok = logits[:, -1].argmax(-1)[:, None]
            rec["tokens"].append(tok.cpu())
            logits = run(decode, tok)
        rec["drops"] = int(torch.stack(drops).sum()) if drops else 0
    rec["tokens"] = (torch.cat(rec["tokens"], dim=1) if rec["tokens"]
                     else torch.zeros((prompts.shape[0], 0), dtype=torch.long))
    rec["cache"] = {p: t.to("cpu", copy=True)
                    for p, t in cache_leaves(cache).items()}
    rec.update((k, rec["cache"][f"/{k}"]) for k in ("k", "v")
               if f"/{k}" in rec["cache"])
    del cache
    if floor:
        import dataclasses

        f32 = get_model(dataclasses.replace(cfg, dtype=torch.float32))
        params = to_float32(torch, params)
        cache = f32.init_cache(prompts.shape[0], prompts.shape[1],
                               dtype=torch.float32, device=DEV)
        b = {"tokens": prompts}
        if frames is not None:
            b["frames"] = frames
        logits, _ = steps.build_prefill_step(f32)(params, cache, b)
        rec["floor"] = rel_l2(torch, rec["logits"][0], logits.cpu())
    del params
    return rec


def lm_serve_rank(mesh, cfg, feeds):
    """One process of phase 3l (module docstring): SERVE_RUNS and SERVE_F32
    on its blocks, and the dry run's live serving cells.  ``cfg``: the
    parent's sizes; ``feeds``: the prompts and the one process's greedy
    tokens of each run."""
    import torch

    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import dryrun, mesh as meshlib

    globals().update(cfg)
    meshlib.make_production_mesh(mesh, shape=LM_MESH)
    card = mesh.device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    # Flash calls: the wrapper's launch count on the card; on the CPU (a
    # rehearsal) its plain version launches nothing, so the calls.
    calls, real = [], kops.flash_attention

    def counted(*a, **kw):
        calls.append(tuple(a[1].shape))
        return real(*a, **kw)
    kops.flash_attention = counted
    kf.reset_launches()
    flash = (lambda: kf.LAUNCHES["flash_attention"]) if card else (
        lambda: len(calls))
    out = {"rank": mesh.rank, "coords": mesh.coords, "runs": [], "f32": []}
    for i, ((arch, layers, _, _), feed) in enumerate(zip(SERVE_RUNS,
                                                         feeds["runs"])):
        with FlashCapture() as cap:
            run = mesh_serve(torch, mesh, serve_config(arch, layers), feed,
                             SERVE_MAX_LEN, flash, profile=i == 0)
        if mesh.rank == 0:      # the kernel's inputs, held in the parent
            run["captured"] = [tuple(x.cpu() if hasattr(x, "cpu") else x
                                     for x in c) for c in cap.calls.values()]
        out["runs"].append(run)
    for (arch, capacity), feed in zip(SERVE_F32, feeds["f32"]):
        out["f32"].append(mesh_serve(
            torch, mesh, serve_f32_config(arch, capacity), feed,
            SERVE_F32_PROMPT + SERVE_F32_CONT + SERVE_F32_DECODE, flash))
    out["dryrun"] = {}
    for shape in ("prefill_32k", "decode_32k"):
        t0 = time.perf_counter()
        rec = dryrun.run_cell(SERVE_DRYRUN_ARCH, shape, mesh, out_dir=None,
                              seq=SERVE_DRYRUN_SEQ,
                              cfg=serve_config(SERVE_DRYRUN_ARCH)
                              if SERVE_REDUCED else None)
        out["dryrun"][shape] = {k: rec[k] for k in (
            "depth1", "depth2", "full", "units", "reduced", "batch", "seq")}
        out["dryrun"][shape]["wall"] = time.perf_counter() - t0
    out["launches"] = flash()
    kops.flash_attention = real
    torch.use_deterministic_algorithms(False)
    return out


def mesh_serve(torch, mesh, cfg, feed, max_len, flash, profile=False):
    """One run of 3l on this process's blocks: the prompt, each
    continuation of ``feed["chunks"]`` and a decode step per fed token.
    Per step: this process's logits, wall, flash launches, collective
    bytes counted and moved, time in the transport; the cache block, the
    dropped pairs, the peak memory; with ``profile`` one more decode step,
    rank 0's under torch.profiler."""
    from repro_torch.data import shard_batch
    from repro_torch.launch import steps
    from repro_torch.models import get_model, moe

    dev, card = mesh.device, mesh.device.type == "cuda"
    tally = mesh.group()
    model = get_model(cfg)
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    params = steps.local_state(
        model.init(torch.Generator(device=dev).manual_seed(0)),
        steps.mesh_param_shardings(model, mesh))
    prefill = steps.build_prefill_step(model, mesh=mesh)
    decode = steps.build_decode_step(model, mesh=mesh)
    prompts, tokens = feed["prompts"], feed["tokens"]
    cache = steps.local_cache(model, mesh, prompts.shape[0], max_len,
                              dtype=cfg.dtype)
    if cache["k"].shape[3] * LM_MESH[1] != max_len:
        raise AssertionError(f"3l: the cache of {max_len} rows is not split "
                             f"over 'model' ({tuple(cache['k'].shape)})")
    out = {"layers": cfg.num_layers, "block": tuple(cache["k"].shape),
           "steps": [], "logits": []}

    def batch(t):
        return shard_batch({"tokens": t}, mesh=mesh, full_batch=False)

    def run(step, t):
        nonlocal cache
        bt = batch(t)
        n0, c0, m0 = flash(), dict(tally.bytes), dict(tally.moved)
        s0 = mesh.transport_s
        sync(torch, dev)
        t0 = time.perf_counter()
        logits, cache = step(params, cache, bt)
        sync(torch, dev)
        out["steps"].append({
            "wall": time.perf_counter() - t0, "flash": flash() - n0,
            "transport_s": mesh.transport_s - s0,
            "bytes": {k: v - c0.get(k, 0) for k, v in tally.bytes.items()
                      if v > c0.get(k, 0)},
            "moved": {k: v - m0.get(k, 0) for k, v in tally.moved.items()
                      if v > m0.get(k, 0)}})
        out["logits"].append(logits.float().cpu())

    with moe.drop_tally() as drops:
        run(prefill, prompts)
        for c in feed.get("chunks", ()):
            run(prefill, c)
        for j in range(tokens.shape[1]):
            run(decode, tokens[:, j:j + 1])
        out["k"], out["v"] = (cache[k].to("cpu", copy=True)
                              for k in ("k", "v"))
        out["peak"] = torch.cuda.max_memory_allocated(dev) if card else 0
        if profile:     # every process steps; rank 0 under the profiler
            bt = batch(tokens[:, -1:])
            if card:
                out["profiled"] = profiled_step(
                    torch, lambda: decode(params, cache, bt), mesh.rank == 0)
            else:
                decode(params, cache, bt)
        out["drops"] = int(torch.stack(drops).sum()) if drops else 0
    del params, cache
    return out


def lm_serve_cfg() -> dict:
    names = ("LM_MESH", "LM_TIMEOUT", "SERVE_RUNS", "SERVE_MAX_LEN",
             "SERVE_F32", "SERVE_F32_PROMPT", "SERVE_F32_CONT",
             "SERVE_F32_DECODE", "SERVE_DRYRUN_ARCH", "SERVE_DRYRUN_SEQ",
             "SERVE_REDUCED")
    return {k: globals()[k] for k in names}


def serve_references(torch, timings):
    """The one-process runs 3l's mesh is held against, on the card: each
    SERVE_RUNS entry (a split one as the single prefill) and each SERVE_F32
    one.  Returns (references, feeds), the feeds as numpy arrays for the
    processes."""
    refs, feeds = {"runs": [], "f32": []}, {"runs": [], "f32": []}
    for arch, layers, n_dec, split in SERVE_RUNS:
        cfg = serve_config(arch, layers)
        prompts = serve_prompts(torch, cfg, LM_PROMPT)
        t0 = time.perf_counter()
        ref = serve_one_process(torch, cfg, prompts, n_dec, SERVE_MAX_LEN,
                                floor=not split)
        timings[f"3l {arch} ({cfg.num_layers} layers) one process"] = \
            time.perf_counter() - t0
        refs["runs"].append(ref)
        p = prompts.cpu().numpy()
        half = p.shape[1] // 2
        feeds["runs"].append(
            {"prompts": p[:, :half], "chunks": [p[:, half:]],
             "tokens": ref["tokens"].numpy()} if split else
            {"prompts": p, "tokens": ref["tokens"].numpy()})
        torch.cuda.empty_cache()
    for arch, capacity in SERVE_F32:
        cfg = serve_f32_config(arch, capacity)
        prompts = serve_prompts(torch, cfg, SERVE_F32_PROMPT + SERVE_F32_CONT)
        head, tail = (prompts[:, :SERVE_F32_PROMPT],
                      prompts[:, SERVE_F32_PROMPT:])
        ref = serve_one_process(
            torch, cfg, head, SERVE_F32_DECODE,
            SERVE_F32_PROMPT + SERVE_F32_CONT + SERVE_F32_DECODE,
            chunks=(tail,))
        refs["f32"].append(ref)
        feeds["f32"].append({"prompts": head.cpu().numpy(),
                             "chunks": [tail.cpu().numpy()],
                             "tokens": ref["tokens"].numpy()})
    return refs, feeds


def lm_serve_phase(torch, errs, timings):
    """Phase 3l (module docstring).  Returns the flash_attention launches
    of the mesh's processes.  Every failure fails the phase: a failed or
    hung process raises SpawnError."""
    from repro_torch.shard import spawn

    n = math.prod(LM_MESH)
    runs = [("gloo", f"{DEV}:0" if DEV == "cuda" else DEV)]
    if DEV == "cuda" and torch.cuda.device_count() >= n:
        runs.append(("nccl", None))
    else:
        log(f"  NCCL not run: it needs one card per rank, {n} cards; this "
            f"machine has {torch.cuda.device_count() if DEV == 'cuda' else 0}")
    for arch, layers, n_dec, split in SERVE_RUNS:
        cfg = serve_config(arch, layers)
        log(f"  {arch}: {cfg.num_layers} layers, d {cfg.d_model}, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, "
            f"vocab {cfg.vocab_size}, experts {cfg.num_experts} top-"
            f"{cfg.top_k}, capacity {cfg.capacity_factor}, {cfg.dtype}; "
            f"batch {LM_BATCH}, prompt {LM_PROMPT}"
            f"{' as two halves' if split else ''}, {n_dec} decode steps, "
            f"cache {SERVE_MAX_LEN} rows")
    t0 = time.perf_counter()
    refs, feeds = serve_references(torch, timings)
    timings["3l one-process references"] = time.perf_counter() - t0
    launches = 0
    for transport, device in runs:
        t0 = time.perf_counter()
        outs = spawn(lm_serve_rank, n, device=device, transport=transport,
                     timeout=LM_TIMEOUT, join_timeout=LM_JOIN,
                     args=(lm_serve_cfg(), feeds))
        timings[f"3l {transport} (spawn to join)"] = time.perf_counter() - t0
        launches += lm_serve_check(torch, errs, outs, refs, transport)
        torch.cuda.empty_cache()
    return launches


def whole_cache(torch, outs, key, run, which="runs"):
    """The whole cache [L, B, KV, S, D] from the processes' blocks."""
    rows = []
    for d in range(LM_MESH[0]):
        blocks = [o[which][run][key] for o in outs
                  if o["coords"]["data"] == d]
        rows.append(torch.cat(blocks, dim=3))
    return torch.cat(rows, dim=1)


def mesh_logits(torch, outs, run, which="runs"):
    """Every step's logits of the whole batch: the data rows' blocks of
    the model-rank-0 processes."""
    firsts = sorted((o for o in outs if o["coords"]["model"] == 0),
                    key=lambda o: o["coords"]["data"])
    return [torch.cat([o[which][run]["logits"][j] for o in firsts])
            for j in range(len(firsts[0][which][run]["logits"]))]


def lm_serve_check(torch, errs, outs, refs, transport):
    """3l's checks and lines, in this process, on what the processes
    returned.  Returns the flash launches summed over the processes."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels.ref import flash_attention_ref

    for o in outs:              # the same bits on the model ranks of a row
        twin = next(p for p in outs if p is not o
                    and p["coords"]["data"] == o["coords"]["data"])
        for which in ("runs", "f32"):
            for a, b in zip(o[which], twin[which]):
                if not all(torch.equal(x, y) for x, y in zip(a["logits"],
                                                             b["logits"])):
                    raise AssertionError(f"3l {transport}: rank {o['rank']}"
                                         "'s logits differ from its twin's")
    for i, (arch, layers, n_dec, split) in enumerate(SERVE_RUNS):
        ref, cfg = refs["runs"][i], serve_config(arch, layers)
        runs = [o["runs"][i] for o in outs]
        nl = cfg.num_layers
        want = (nl, LM_BATCH // LM_MESH[0], cfg.num_kv_heads,
                SERVE_MAX_LEN // LM_MESH[1], cfg.head_dim)
        flashes = [nl, nl] if split else [nl] + [0] * n_dec
        for r in runs:
            if r["block"] != want:
                raise AssertionError(f"3l {arch}: cache block {r['block']}, "
                                     f"not {want}")
            if [s["flash"] for s in r["steps"]] != flashes:
                raise AssertionError(
                    f"3l {arch}: flash launches a step "
                    f"{[s['flash'] for s in r['steps']]}, not {flashes}")
            if r["drops"] or ref["drops"]:
                raise AssertionError(f"3l {arch}: pairs dropped (mesh "
                                     f"{r['drops']}, one process "
                                     f"{ref['drops']}) at capacity "
                                     f"{cfg.capacity_factor}")
        got = mesh_logits(torch, outs, i)
        pairs = [(got[-1], ref["logits"][0])] if split else list(
            zip(got, ref["logits"]))
        l2 = [rel_l2(torch, g, w) for g, w in pairs]
        agree = statistics.mean(float((g.argmax(-1) == w.argmax(-1))
                                      .float().mean()) for g, w in pairs)
        kv = [rel_l2(torch, whole_cache(torch, outs, key, i), ref[key])
              for key in ("k", "v")]
        what = (f"the prompt as {LM_PROMPT // 2} + {LM_PROMPT // 2} (the "
                f"continuation's gathered prefix) vs one process's single "
                f"prefill: last logits rel L2 {l2[0]:.3g}" if split else
                f"logits rel L2 max {max(l2):.3g} over {len(l2)} steps "
                f"(prefill {l2[0]:.3g}; one process's bf16 prefill is "
                f"{ref['floor']:.3g} from its float32 one)")
        log(f"  {transport} {arch} ({nl} layers) on the mesh vs one process: "
            f"{what}, argmax agreement {agree:.3f}; gathered cache rel L2 k "
            f"{kv[0]:.3g} v {kv[1]:.3g}; cache block {want} a process; "
            f"flash launches a step {flashes}; dropped pairs 0 (mesh and "
            f"one process)")
        if not (max(l2) < LM_REL_TOL and max(kv) < LM_REL_TOL):
            raise AssertionError(f"3l {arch}: the mesh's logits or cache "
                                 f"differ from one process's")
        report_serve(runs[0], runs, ref, arch, transport,
                     full=layers is None and not split)
        for q, k, v, kw in runs[0].get("captured", []):
            q, k, v = q.to(DEV), k.to(DEV), v.to(DEV)
            errs.check(torch, "flash_attention",
                       kf.flash_attention(q, k, v, **kw),
                       flash_attention_ref(q, k, v, **kw), False,
                       f"3l {arch} {tuple(q.shape)} x {k.shape[2]}",
                       FLASH_TOL[str(q.dtype).split(".")[-1]])
    for i, (arch, capacity) in enumerate(SERVE_F32):
        ref, nl = refs["f32"][i], serve_f32_config(arch, capacity).num_layers
        got = mesh_logits(torch, outs, i, "f32")
        worst = max(float((g - w).abs().max()) for g, w in zip(
            got, ref["logits"]))
        same = all(torch.allclose(g, w, **SERVE_F32_TOL) for g, w in zip(
            got, ref["logits"])) and all(torch.allclose(
                whole_cache(torch, outs, key, i, "f32"), ref[key],
                **SERVE_F32_TOL) for key in ("k", "v"))
        drops = sum(o["f32"][i]["drops"] for o in outs) + ref["drops"]
        flashes = [s["flash"] for s in outs[0]["f32"][i]["steps"]]
        log(f"  {transport} f32 reduced {arch} (capacity {capacity}): "
            f"{len(got)} steps (prompt {SERVE_F32_PROMPT}, continuation "
            f"{SERVE_F32_CONT}, {SERVE_F32_DECODE} decode) on the mesh vs "
            f"one process on the card: logits max |diff| {worst:.3g}; "
            f"logits and cache within rtol = atol = "
            f"{SERVE_F32_TOL['rtol']}: {same}; flash launches a step "
            f"{flashes}; dropped pairs {drops}")
        if (not same or drops
                or flashes != [nl, nl] + [0] * SERVE_F32_DECODE):
            raise AssertionError(f"3l f32 {arch}: the mesh differs from one "
                                 "process")
    for shape, dr in outs[0]["dryrun"].items():
        log(f"  {transport} dry run, {SERVE_DRYRUN_ARCH} {shape} at full "
            f"width, batch {dr['reduced']['batch'][0]} cut to {dr['batch']} "
            f"x {dr['seq']} ({dr['wall']:.1f} s): counted bytes a rank, depth "
            f"1 {dr['depth1']['collectives']}, depth 2 "
            f"{dr['depth2']['collectives']}, extrapolated to {dr['units']} "
            f"layers {dr['full']['collectives']}")
    launched = sum(o["launches"] for o in outs)
    log(f"  {transport} flash_attention launches in 3l's processes: "
        f"{launched} ({', '.join(str(o['launches']) for o in outs)})")
    log(f"  nvidia-smi: {nvidia_smi()}")
    return launched


def report_serve(r0, runs, ref, arch, transport, full):
    """3l's measured lines of one run: rank 0's walls, bytes and transport
    share, the busy share of its profiled decode step, the processes'
    peak memory, beside the one process's walls (and, at full depth, 3d's
    serve of the same model in this run)."""
    steps = r0["steps"]
    dec = steps[1:] if ref["tokens"].shape[1] else []

    def per(key, rows):
        tot = {}
        for s in rows:
            for k, v in s[key].items():
                tot[k] = tot.get(k, 0) + v
        return ", ".join(f"{k} {v / len(rows):.4g}"
                         for k, v in sorted(tot.items()))
    first = steps[:len(steps) - len(dec)]
    share = (sum(s["transport_s"] for s in steps)
             / sum(s["wall"] for s in steps))
    walls = " + ".join(f"{s['wall'] * 1e3:.1f}" for s in first)
    line = (f"    {transport} {arch}: prefill {walls} ms (one process "
            f"{ref['walls'][0] * 1e3:.1f} ms)")
    if dec:
        line += (f"; decode median "
                 f"{statistics.median(s['wall'] for s in dec) * 1e3:.2f} ms"
                 f"/token over {len(dec)} steps (one process "
                 f"{statistics.median(ref['walls'][1:]) * 1e3:.2f})")
    log(line + f"; in the transport {share:.3f} of the steps' wall (rank 0)")
    if full and arch in SERVED:
        p, d = SERVED[arch]
        log(f"      phase 3d's serve of {arch} at capacity 1.25, this run: "
            f"prefill {p * 1e3:.1f} ms, decode {d * 1e3:.2f} ms/token")
    log(f"      collective bytes a prefill (rank 0), counted: "
        f"{per('bytes', first)}; moved: {per('moved', first)}")
    if dec:
        log(f"      a decode step, counted: {per('bytes', dec)}; moved: "
            f"{per('moved', dec)}")
    pr = r0.get("profiled")
    if pr and "kernel_s" in pr:
        log(f"      one more decode step, rank 0 under torch.profiler: "
            f"{pr['wall'] * 1e3:.1f} ms; its kernels "
            f"{pr['kernel_s'] * 1e3:.2f} ms of device time "
            f"({pr['kernels']} launches; busy "
            f"{pr['kernel_s'] / pr['wall']:.3f}), its copies "
            f"{pr['copy_s'] * 1e3:.2f} ms")
    log("      peak device memory per process: " + ", ".join(
        f"{r['peak'] / 2**30:.2f} GiB" for r in runs))


# --------------------------------- phase 3m --------------------------------

# Sharded serving of the SSM, hybrid and encoder-decoder families on the
# LM_MESH mesh of processes on the one card (gloo), in the reference's layout:
# parameters in blocks, the cache's batch over "data" and, over "model", the
# SSM state's channels (conv) and heads (ssd) and the K/V caches' sequence
# (Zamba2's shared block, Whisper's self- and cross-attention), the batch rows
# over "data".  FAMILY_MESH_RUNS: arch, prompt, cache rows (room for the
# decode steps and the profiled one, split in two); each at full width and
# depth in bf16, LM_BATCH rows and FAMILY_MESH_DECODE greedy decode steps (cut
# from 8 for the run's time: a step gathers 2.2e9 to 3.1e9 B of parameters
# through gloo, 4.4 to 8 s), Whisper's prompt over the config's 1500 frames
# drawn from a generator seeded 2; one more decode step of the first, rank 0's
# under the profiler.  Each data row's rows are held against one process on
# the card serving the same rows (the products of a mesh process's shapes: a
# random-init SSM stack carries every rounding into each later layer) on the
# same seed-0 weights and that process's greedy tokens.  FAMILY_MESH_F32: the
# reduced configs in float32 (a prompt, with Whisper's frames, a continuation
# without, decode steps) held to SERVE_F32_TOL against one process on the
# whole batch.  FAMILY_MESH_CELLS: the dry run's serving cells, at
# SERVE_DRYRUN_SEQ.
FAMILY_MESH_DECODE = 2
FAMILY_MESH_RUNS = (
    ("mamba2_780m", LM_PROMPT, LM_PROMPT + 2 * FAMILY_MESH_DECODE),
    ("zamba2_12b", LM_PROMPT, LM_PROMPT + 2 * FAMILY_MESH_DECODE),
    ("whisper_large_v3", WHISPER_PROMPT, 256))
FAMILY_MESH_F32 = FAMILY_ARCHS
FAMILY_MESH_CELLS = (
    ("mamba2_780m", ("prefill_32k", "decode_32k", "long_500k")),
    ("zamba2_12b", ("prefill_32k", "decode_32k", "long_500k")),
    ("whisper_large_v3", ("prefill_32k", "decode_32k")))


def cache_leaves(tree, prefix="") -> dict:
    """A cache's tensors (or its shardings' specs) by path; the fill
    ``idx`` and an absent hybrid ``tail`` give nothing."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(cache_leaves(v, f"{prefix}/{k}"))
        return out
    if hasattr(tree, "spec"):
        return {prefix: tuple(tree.spec)}
    return {prefix: tree} if hasattr(tree, "shape") else {}


def family_frames(torch, cfg):
    """Whisper's frames [LM_BATCH, encoder_seq, d] from a generator seeded
    2 (serve's draw), or None."""
    if not cfg.encoder_layers:
        return None
    draw = torch.Generator(device=DEV).manual_seed(2)
    return torch.randn((LM_BATCH, cfg.encoder_seq, cfg.d_model),
                       generator=draw, device=DEV)


def family_mesh_rank(mesh, cfg, feeds):
    """One process of phase 3m (the block above): FAMILY_MESH_RUNS and
    FAMILY_MESH_F32 on its blocks, and the dry run's live serving cells.
    ``cfg``: the parent's sizes; ``feeds``: the prompts, frames and the
    one process's greedy tokens of each run."""
    import torch

    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import dryrun, mesh as meshlib

    globals().update(cfg)
    meshlib.make_production_mesh(mesh, shape=LM_MESH)
    card = mesh.device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    # Flash calls: the wrapper's launch count on the card; on the CPU (a
    # rehearsal) its plain version launches nothing, so the calls.
    calls, real = [], kops.flash_attention

    def counted(*a, **kw):
        calls.append(tuple(a[1].shape))
        return real(*a, **kw)
    kops.flash_attention = counted
    kf.reset_launches()
    flash = (lambda: kf.LAUNCHES["flash_attention"]) if card else (
        lambda: len(calls))
    out = {"rank": mesh.rank, "coords": mesh.coords, "runs": [], "f32": []}
    for i, ((arch, _, max_len), feed) in enumerate(zip(FAMILY_MESH_RUNS,
                                                       feeds["runs"])):
        with FlashCapture() as cap:
            run = family_serve(torch, mesh, serve_config(arch), feed,
                               max_len, flash, profile=i == 0)
        if mesh.rank == 0:      # the kernel's inputs, held in the parent
            run["captured"] = [tuple(x.cpu() if hasattr(x, "cpu") else x
                                     for x in c) for c in cap.calls.values()]
        out["runs"].append(run)
    for arch, feed in zip(FAMILY_MESH_F32, feeds["f32"]):
        out["f32"].append(family_serve(
            torch, mesh, serve_f32_config(arch, None), feed,
            SERVE_F32_PROMPT + SERVE_F32_CONT + SERVE_F32_DECODE, flash))
    out["dryrun"] = {}
    for arch, shapes in FAMILY_MESH_CELLS:
        for shape in shapes:
            t0 = time.perf_counter()
            rec = dryrun.run_cell(arch, shape, mesh, out_dir=None,
                                  seq=SERVE_DRYRUN_SEQ,
                                  cfg=serve_config(arch)
                                  if SERVE_REDUCED else None)
            out["dryrun"][(arch, shape)] = {k: rec[k] for k in (
                "depth1", "depth2", "full", "units", "reduced", "batch",
                "seq")}
            out["dryrun"][(arch, shape)]["wall"] = time.perf_counter() - t0
    out["launches"] = flash()
    kops.flash_attention = real
    torch.use_deterministic_algorithms(False)
    return out


def family_serve(torch, mesh, cfg, feed, max_len, flash, profile=False):
    """One run of 3m on this process's blocks: the prompt (with Whisper's
    frames), each continuation of ``feed["chunks"]`` and a decode step per
    fed token.  Per step: this process's logits, wall, flash launches,
    collective bytes counted and moved, time in the transport; every
    cache leaf's block and spec, the peak memory; with ``profile`` one
    more decode step, rank 0's under torch.profiler."""
    from repro_torch.data import shard_batch
    from repro_torch.launch import steps
    from repro_torch.models import get_model

    dev, card = mesh.device, mesh.device.type == "cuda"
    tally = mesh.group()
    model = get_model(cfg)
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    params = steps.local_state(
        model.init(torch.Generator(device=dev).manual_seed(0)),
        steps.mesh_param_shardings(model, mesh))
    prefill = steps.build_prefill_step(model, mesh=mesh)
    decode = steps.build_decode_step(model, mesh=mesh)
    prompts, tokens = feed["prompts"], feed["tokens"]
    cache = steps.local_cache(model, mesh, prompts.shape[0], max_len,
                              dtype=cfg.dtype)
    out = {"layers": cfg.num_layers, "steps": [], "logits": []}

    def run(step, b):
        nonlocal cache
        bt = shard_batch(b, mesh=mesh, full_batch=False)
        n0, c0, m0 = flash(), dict(tally.bytes), dict(tally.moved)
        s0 = mesh.transport_s
        sync(torch, dev)
        t0 = time.perf_counter()
        logits, cache = step(params, cache, bt)
        sync(torch, dev)
        out["steps"].append({
            "wall": time.perf_counter() - t0, "flash": flash() - n0,
            "transport_s": mesh.transport_s - s0,
            "bytes": {k: v - c0.get(k, 0) for k, v in tally.bytes.items()
                      if v > c0.get(k, 0)},
            "moved": {k: v - m0.get(k, 0) for k, v in tally.moved.items()
                      if v > m0.get(k, 0)}})
        out["logits"].append(logits.float().cpu())

    first = {"tokens": prompts}
    if feed.get("frames") is not None:
        first["frames"] = feed["frames"]
    run(prefill, first)
    out["prefill_cache"] = {p: t.to("cpu", copy=True)
                            for p, t in cache_leaves(cache).items()}
    for c in feed.get("chunks", ()):
        run(prefill, {"tokens": c})
    for j in range(tokens.shape[1]):
        run(decode, {"tokens": tokens[:, j:j + 1]})
    out["cache"] = {p: t.to("cpu", copy=True)
                    for p, t in cache_leaves(cache).items()}
    out["specs"] = cache_leaves(cache.shardings)
    out["peak"] = torch.cuda.max_memory_allocated(dev) if card else 0
    if profile:     # every process steps; rank 0 under the profiler
        bt = shard_batch({"tokens": tokens[:, -1:]}, mesh=mesh,
                         full_batch=False)
        if card:
            out["profiled"] = profiled_step(
                torch, lambda: decode(params, cache, bt), mesh.rank == 0)
        else:
            decode(params, cache, bt)
    del params, cache
    return out


def family_mesh_cfg() -> dict:
    names = ("LM_MESH", "LM_TIMEOUT", "LM_BATCH", "FAMILY_MESH_RUNS",
             "FAMILY_MESH_F32", "FAMILY_MESH_CELLS", "SERVE_F32_PROMPT",
             "SERVE_F32_CONT", "SERVE_F32_DECODE", "SERVE_DRYRUN_SEQ",
             "SERVE_REDUCED")
    return {k: globals()[k] for k in names}


def family_references(torch, timings):
    """The one-process runs 3m's mesh is held against, on the card: each
    FAMILY_MESH_RUNS model on each data row's rows, and each
    FAMILY_MESH_F32 one on the whole batch.  Returns (references, feeds),
    the feeds as numpy arrays for the processes."""
    refs, feeds = {"runs": [], "f32": []}, {"runs": [], "f32": []}
    rows = LM_BATCH // LM_MESH[0]
    for arch, prompt, max_len in FAMILY_MESH_RUNS:
        cfg = serve_config(arch)
        prompts, frames = serve_prompts(torch, cfg, prompt), \
            family_frames(torch, cfg)
        t0 = time.perf_counter()
        parts = [serve_one_process(
            torch, cfg, prompts[r:r + rows], FAMILY_MESH_DECODE, max_len,
            floor=r == 0, frames=None if frames is None
            else frames[r:r + rows]) for r in range(0, LM_BATCH, rows)]
        timings[f"3m {arch} one process (each data row's rows)"] = \
            time.perf_counter() - t0
        refs["runs"].append(parts)
        feeds["runs"].append({
            "prompts": prompts.cpu().numpy(),
            "frames": None if frames is None else frames.cpu().numpy(),
            "tokens": torch.cat([p["tokens"] for p in parts]).numpy()})
        del frames
        torch.cuda.empty_cache()
    n = SERVE_F32_PROMPT + SERVE_F32_CONT
    for arch in FAMILY_MESH_F32:
        cfg = serve_f32_config(arch, None)
        prompts, frames = serve_prompts(torch, cfg, n), \
            family_frames(torch, cfg)
        head, tail = (prompts[:, :SERVE_F32_PROMPT],
                      prompts[:, SERVE_F32_PROMPT:])
        ref = serve_one_process(torch, cfg, head, SERVE_F32_DECODE,
                                n + SERVE_F32_DECODE, chunks=(tail,),
                                frames=frames)
        refs["f32"].append(ref)
        feeds["f32"].append({
            "prompts": head.cpu().numpy(), "chunks": [tail.cpu().numpy()],
            "frames": None if frames is None else frames.cpu().numpy(),
            "tokens": ref["tokens"].numpy()})
    return refs, feeds


def family_mesh_phase(torch, errs, timings):
    """Phase 3m (the block above FAMILY_MESH_DECODE).  Returns the
    flash_attention launches of the mesh's processes.  Every failure fails
    the phase: a failed or hung process raises SpawnError."""
    from repro_torch.shard import spawn

    n = math.prod(LM_MESH)
    for arch, prompt, max_len in FAMILY_MESH_RUNS:
        cfg = serve_config(arch)
        frames = f" over {cfg.encoder_seq} frames" if cfg.encoder_layers \
            else ""
        log(f"  {arch} ({cfg.family}): {cfg.num_layers} layers, d "
            f"{cfg.d_model}, {cfg.dtype}; batch {LM_BATCH}, prompt {prompt}"
            f"{frames}, {FAMILY_MESH_DECODE} decode steps, cache {max_len} "
            f"rows")
    log(f"  gloo only: {n} processes on {DEV}:0 (NCCL needs one card a "
        f"rank)")
    t0 = time.perf_counter()
    refs, feeds = family_references(torch, timings)
    timings["3m one-process references"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = spawn(family_mesh_rank, n, device=f"{DEV}:0" if DEV == "cuda"
                 else DEV, transport="gloo", timeout=LM_TIMEOUT,
                 join_timeout=LM_JOIN, args=(family_mesh_cfg(), feeds))
    timings["3m gloo (spawn to join)"] = time.perf_counter() - t0
    launched = family_mesh_check(torch, errs, outs, refs)
    torch.cuda.empty_cache()
    return launched


def row_whole(torch, outs, which, i, d, path, key="cache"):
    """Data row ``d``'s whole leaf at ``path`` of ``key`` (the cache at
    the end, or as the first prefill left it): its processes' blocks
    joined along the dimensions the leaf's spec splits over "model"."""
    row = sorted((o for o in outs if o["coords"]["data"] == d),
                 key=lambda o: o["coords"]["model"])
    spec = row[0][which][i]["specs"][path]
    x = [o[which][i][key][path] for o in row]
    dims = [k for k, e in enumerate(spec) if e == "model"]
    return torch.cat(x, dim=dims[0]) if dims else x[0]


def family_mesh_check(torch, errs, outs, refs):
    """3m's checks and lines, in this process, on what the processes
    returned.  Returns the flash launches summed over the processes."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels.ref import flash_attention_ref

    for o in outs:              # the same bits on the model ranks of a row
        twin = next(p for p in outs if p is not o
                    and p["coords"]["data"] == o["coords"]["data"])
        for which in ("runs", "f32"):
            for a, b in zip(o[which], twin[which]):
                if not all(torch.equal(x, y) for x, y in zip(a["logits"],
                                                             b["logits"])):
                    raise AssertionError(f"3m: rank {o['rank']}'s logits "
                                         "differ from its twin's")
    rows = LM_BATCH // LM_MESH[0]
    for i, (arch, prompt, max_len) in enumerate(FAMILY_MESH_RUNS):
        parts, cfg = refs["runs"][i], serve_config(arch)
        runs = [o["runs"][i] for o in outs]
        want = [flash_per_prefill(cfg)] + [0] * FAMILY_MESH_DECODE
        for r in runs:
            split = [p for p, sp in r["specs"].items() if "model" in sp]
            if sorted(split) != sorted(r["cache"]) or not split:
                raise AssertionError(f"3m {arch}: cache leaves not split over "
                                     f"'model': {r['specs']}")
            if [s["flash"] for s in r["steps"]] != want:
                raise AssertionError(
                    f"3m {arch}: flash launches a step "
                    f"{[s['flash'] for s in r['steps']]}, not {want}")
            if not all(bool(torch.isfinite(x).all()) for x in r["logits"]):
                raise AssertionError(f"3m {arch}: non-finite logits")
        l2, agree, at_prefill, at_end = [], [], {}, {}
        for d, ref in enumerate(parts):
            got = [o["runs"][i]["logits"] for o in outs
                   if o["coords"] == {"data": d, "model": 0}][0]
            l2 += [rel_l2(torch, g, w) for g, w in zip(got, ref["logits"])]
            agree += [float((g.argmax(-1) == w.argmax(-1)).float().mean())
                      for g, w in zip(got, ref["logits"])]
            for key, l2s in (("prefill_cache", at_prefill),
                             ("cache", at_end)):
                for path, whole in ref[key].items():
                    mine = row_whole(torch, outs, "runs", i, d, path, key)
                    if tuple(mine.shape) != tuple(whole.shape):
                        raise AssertionError(f"3m {arch} {path}: blocks give "
                                             f"{tuple(mine.shape)}, not "
                                             f"{tuple(whole.shape)}")
                    l2s[path] = max(l2s.get(path, 0.0),
                                    rel_l2(torch, mine, whole))
        blocks = {p: tuple(t.shape) for p, t in runs[0]["cache"].items()}
        log(f"  gloo {arch} ({cfg.num_layers} layers) on the mesh vs one "
            f"process on each data row's {rows} rows: logits rel L2 max "
            f"{max(l2):.3g} over {len(l2) // len(parts)} steps (prefill "
            f"{max(l2[0], l2[len(l2) // 2]):.3g}; one process's bf16 prefill "
            f"is {parts[0]['floor']:.3g} from its float32 one), argmax "
            f"agreement {statistics.mean(agree):.3f}; cache rel L2 after the "
            f"prefill " + ", ".join(f"{p} {v:.3g}" for p, v in sorted(
                at_prefill.items())) + "; after the decode steps "
            + ", ".join(f"{p} {v:.3g}" for p, v in sorted(at_end.items())))
        log(f"    blocks a process (split over 'model'): {blocks}; flash "
            f"launches a step {want}")
        if not (max(l2) < LM_REL_TOL
                and max(at_prefill.values()) < LM_REL_TOL
                and max(at_end.values()) < LM_REL_TOL):
            raise AssertionError(f"3m {arch}: the mesh's logits or cache "
                                 f"differ from one process's")
        report_serve(runs[0], runs, parts[0], arch, "gloo", full=False)
        for q, k, v, kw in runs[0].get("captured", []):
            q, k, v = q.to(DEV), k.to(DEV), v.to(DEV)
            errs.check(torch, "flash_attention",
                       kf.flash_attention(q, k, v, **kw),
                       flash_attention_ref(q, k, v, **kw), False,
                       f"3m {arch} {tuple(q.shape)} x {k.shape[2]}",
                       FLASH_TOL[str(q.dtype).split(".")[-1]])
    for i, arch in enumerate(FAMILY_MESH_F32):
        ref = refs["f32"][i]
        cfg = serve_f32_config(arch, None)
        got = [torch.cat([o["f32"][i]["logits"][j] for o in sorted(
            (o for o in outs if o["coords"]["model"] == 0),
            key=lambda o: o["coords"]["data"])]) for j in range(
                len(ref["logits"]))]
        worst = max(float((g - w).abs().max()) for g, w in zip(
            got, ref["logits"]))
        same = all(torch.allclose(g, w, **SERVE_F32_TOL)
                   for g, w in zip(got, ref["logits"]))
        for path, whole in ref["cache"].items():
            mine = torch.cat([row_whole(torch, outs, "f32", i, d, path)
                              for d in range(LM_MESH[0])],
                             dim=[k for k, e in enumerate(
                                 outs[0]["f32"][i]["specs"][path])
                                 if e == "data"][0])
            same = same and torch.allclose(mine, whole, **SERVE_F32_TOL)
        flashes = [s["flash"] for s in outs[0]["f32"][i]["steps"]]
        fpp = flash_per_prefill(cfg)
        want = [fpp, fpp - cfg.encoder_layers - cfg.num_layers
                if cfg.encoder_layers else fpp] + [0] * SERVE_F32_DECODE
        log(f"  gloo f32 reduced {arch}: {len(got)} steps (prompt "
            f"{SERVE_F32_PROMPT}{', frames' if cfg.encoder_layers else ''},"
            f" continuation {SERVE_F32_CONT}, {SERVE_F32_DECODE} decode) on "
            f"the mesh vs one process on the card: logits max |diff| "
            f"{worst:.3g}; logits and cache within rtol = atol = "
            f"{SERVE_F32_TOL['rtol']}: {same}; flash launches a step "
            f"{flashes}")
        if not same or flashes != want:
            raise AssertionError(f"3m f32 {arch}: the mesh differs from one "
                                 f"process (flash launches {flashes}, not "
                                 f"{want})")
    for (arch, shape), dr in outs[0]["dryrun"].items():
        cut = dr["reduced"].get("batch")
        log(f"  gloo dry run, {arch} {shape} at full width, batch "
            f"{f'{cut[0]} cut to ' if cut else ''}{dr['batch']} x "
            f"{dr['seq']} ({dr['wall']:.1f} s): counted bytes a rank, depth "
            f"1 {dr['depth1']['collectives']}, depth 2 "
            f"{dr['depth2']['collectives']}, extrapolated to {dr['units']} "
            f"units {dr['full']['collectives']}")
    launched = sum(o["launches"] for o in outs)
    log(f"  gloo flash_attention launches in 3m's processes: {launched} "
        f"({', '.join(str(o['launches']) for o in outs)})")
    log(f"  nvidia-smi: {nvidia_smi()}")
    return launched


def main() -> int:
    # cuBLAS is deterministic only with a fixed workspace (3i's training
    # runs under torch.use_deterministic_algorithms); set before the first
    # cuBLAS call.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    family_rows = family_flash_shapes(torch, errs)
    lm2_rows = lm2_flash_shapes(torch, errs)
    mesh_rows = mesh_flash_shapes(torch, errs)
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
    flash_row["mesh"] = mesh_rows
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
    shard_launches, shard_ref = sharded_phase(torch, np, timings)
    for name, n in shard_launches.items():
        launches[name] += n
    timings["sharded phase total"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    log(f"== phase 3j: sharded engine across processes (DistMesh, {SHARDS} "
        f"processes)")
    t0 = time.perf_counter()
    for name, n in dist_phase(torch, np, timings, shard_ref).items():
        launches[name] += n
    del shard_ref
    timings["dist phase total"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    log(f"== phase 3h: LM serving, SSM / hybrid / encoder-decoder "
        f"({', '.join(FAMILY_ARCHS)})")
    t0 = time.perf_counter()
    launches["flash_attention"] += families_phase(torch, errs, timings)
    flash_row["encdec"] = family_rows
    timings["LM families phase total"] = time.perf_counter() - t0

    log(f"== phase 3i: LM serving ({LM2_ARCHS[0]}, {LM2_ARCHS[1]} at "
        f"{LLAMA4_LAYERS} layers) and training ({TRAIN_ARCH})")
    t0 = time.perf_counter()
    launches["flash_attention"] += lm2_phase(torch, errs, timings)
    launches["flash_attention"] += train_phase(torch, timings)
    flash_row["gemma3_llama4"] = lm2_rows
    timings["LM 3i phase total"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    log(f"== phase 3k: LM sharding ({LM_SHARD_ARCH}, "
        f"{'x'.join(map(str, LM_MESH))} (data, model) mesh of processes)")
    t0 = time.perf_counter()
    lm_shard_phase(torch, np, timings)
    timings["LM shard phase total"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    log(f"== phase 3l: sharded prefill and decode "
        f"({', '.join(r[0] for r in SERVE_RUNS)}, "
        f"{'x'.join(map(str, LM_MESH))} (data, model) mesh of processes)")
    t0 = time.perf_counter()
    launches["flash_attention"] += lm_serve_phase(torch, errs, timings)
    timings["LM serve shard phase total"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    log(f"== phase 3m: sharded serving of the SSM, hybrid and "
        f"encoder-decoder families ({', '.join(FAMILY_ARCHS)}, "
        f"{'x'.join(map(str, LM_MESH))} (data, model) mesh of processes)")
    t0 = time.perf_counter()
    launches["flash_attention"] += family_mesh_phase(torch, errs, timings)
    timings["LM families shard phase total"] = time.perf_counter() - t0
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
