// Tropical (min, +) product for Hopper (sm_90a):
//   out[s, j] = min_k d[s, k] + w[k, j],   +inf the identity.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/minplus_mm.py:
//   minplus_mm        (_kernel, pallas_call at :74)
//   minplus_mm_masked (_masked_kernel, pallas_call at :110)
// They carry the multi-source Bellman-Ford (repro.core.queries.
// sssp_batched_dense): one product of the distances d [S, V] against the
// live weights w [V, V] (+inf = no edge) per relax pass.  Two shapes
// matter: S = 2048 sources (the batched query) and one source padded to
// the row granule BM = 8 (the Section 5 workload's static mode, which makes
// most of the launches).
//
// Exactness.  Each candidate d + w is one IEEE FP32 add (__fadd_rn),
// rounded once, and min (fminf) is exact, so no order of reduction changes
// a value: the kernel equals the plain broadcast-and-amin bit for bit, and
// splitting K across CTAs, merged by a second min pass, changes nothing.
// The source is compiled without --use_fast_math, and the add feeds fminf,
// never a multiply, so nothing is contracted.  inf + finite stays inf;
// weights may be negative but are never -inf, so no NaN arises.  Zero ties
// (an output whose least candidates are +0 and -0, e.g. 1 + -1 and -0 +
// -0): fminf (min.f32) takes -0 as the smaller, so the kernel writes -0
// whatever the order of the candidates, in every form and split
// (tests/test_torch_cuda.py checks the bit patterns).  The plain version's
// torch.minimum / amin keep the operand order's zero instead, so only
// values, not zero signs, are compared with it.
//
// Bound (H100 SXM, 700 W).  There is no tensor-core form of (min, +):
// every (s, k, j) costs one FP32 add and one min on the CUDA cores, two
// issue slots at the card's 33.5e12 non-FMA FP32 instructions/s.  S = 2048,
// K = N = 16384: 1.1e12 instructions, 32.8 ms.  One row (the static shape):
// 0.016 ms of arithmetic, but the 1 GiB of w must be read once, 0.320 ms.
//
// Design.  Both forms stage their operands through a ring of shared-memory
// stages filled by cp.async, one k-step of BK = 16 per stage, so the next
// stages load while the current one computes; one __syncthreads per stage.
// A CTA first reads its masks once (the masked form) and writes a bitmap of
// its live k-steps to shared memory; the ring loads and the compute loop
// walk only those steps.  The launcher picks the form by m:
//
// * wide (m >= SKINNY_BELOW = 88): one CTA of 256 threads per 128 x 128
//   output tile, an 8 x 8 register micro-tile of running minima per thread read
//   from shared memory as float4s (128 add/min per 4 vector loads).  d is
//   transposed first into scratch (dT [K][mp], rows m.. mp of +inf), so
//   both tiles of a stage are rows of 128 contiguous floats that cp.async
//   copies as they are.  A ragged last row block reads +inf rows and is
//   not stored.  Few row blocks (m near 128) also split K, to fill the card.
//   In the masked form the CTA's 16 row granules each keep their own
//   dmask bit: a live k-step gives a dead granule's rows +inf in place of
//   d, which leaves their minima as they are, bit for bit, so the kernel
//   skips exactly the (granule, k-step) blocks that the plain version does.
// * skinny (m < SKINNY_BELOW): one CTA per (8-row granule, 128-column
//   panel, K split).  Its 8 warps take two k-rows of each stage apiece, one
//   float4 of columns per lane, and meet in a cross-warp min at the end.
//   K is split so that about 8 CTAs per SM stream w at the HBM rate, each
//   with SSTAGES - 1 stages in flight; the granules of one panel and split
//   run next to each other (blockIdx.x fastest), sharing w in L2.
//
// With more than one split, each writes its partial minima to scratch
// [splits][m][n] and merge_splits_kernel takes the min over the splits.
// The accumulators start at +inf and are always written, so a fully
// skipped tile is +inf, as the dense kernel gives it.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 8;              // row granule: rows of d and of dmask
constexpr int BN = 128;            // output columns per CTA
constexpr int BK = 16;             // k-step: one ring stage, one mask entry
constexpr int THREADS = 256;
constexpr int WM = 128;            // wide form: output rows per CTA
constexpr int WSTAGES = 4;
constexpr int WSTAGE_FLOATS = BK * WM + BK * BN;  // dT tile, then w tile
constexpr int SSTAGES = 6;
constexpr int SSTAGE_FLOATS = BK * BN + BM * BK;  // w tile, then d tile
// m below this runs the skinny form: it streams w once per granule (from
// L2 after the first), 0.26 ms per granule at K = N = 16384, where the wide
// form pads to 128 rows, 2.87 ms at m = 128 (tools/minplus_mm_shapes.py).
constexpr int SKINNY_BELOW = 88;
constexpr int MIN_SPLIT_STEPS = 8;  // least k-steps of one K split
constexpr size_t SMEM_MAX = 232448;  // what a block may use on an H100

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float relax(float acc, float d, float w) {
  return fminf(acc, __fadd_rn(d, w));
}

__device__ __forceinline__ float4 min4(float4 a, float4 b) {
  return make_float4(fminf(a.x, b.x), fminf(a.y, b.y), fminf(a.z, b.z),
                     fminf(a.w, b.w));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row (or column) of micro-tile entry i of thread t: two runs of four.
__device__ __forceinline__ int split_index(int t, int i, int half) {
  return (i < 4) ? 4 * t + i : half + 4 * t + (i - 4);
}

// The masked forms' live steps.  Bit i % 32 of bits[i / 32]: k-step kb0 +
// i of this CTA is live, i.e. some of the CTA's G row granules g0 ..
// (those below ngran) has a nonzero dmask entry there and the w block of
// column panel bj has a nonzero wmask entry; gmask[i] (G > 1) keeps which
// granules.  Every warp takes whole words, one step per lane, so the masks
// are read once, in parallel, before the ring starts.
template <int G>
__device__ void live_steps(uint32_t* bits, uint16_t* gmask,
                           const int32_t* __restrict__ dmask,
                           const int32_t* __restrict__ wmask, int g0,
                           int ngran, int kb0, int nsteps, int nbk, int nbn,
                           int bj) {
  const int nwords = (nsteps + 31) / 32;
  for (int wd = threadIdx.x / 32; wd < nwords; wd += THREADS / 32) {
    const int i = 32 * wd + threadIdx.x % 32;
    bool on = i < nsteps;
    if (on) {
      const int kb = kb0 + i;
      uint32_t g = 0;
#pragma unroll
      for (int r = 0; r < G; ++r) {
        if (g0 + r < ngran && dmask[(size_t)(g0 + r) * nbk + kb] != 0)
          g |= 1u << r;
      }
      on = g != 0 && wmask[(size_t)kb * nbn + bj] != 0;
      if (G > 1) gmask[i] = static_cast<uint16_t>(g);
    }
    const uint32_t b = __ballot_sync(0xffffffffu, on);
    if (threadIdx.x % 32 == 0) bits[wd] = b;
  }
}

__device__ __forceinline__ int count_steps(const uint32_t* bits, int nsteps) {
  int steps = 0;
  for (int wd = 0; wd < (nsteps + 31) / 32; ++wd) steps += __popc(bits[wd]);
  return steps;
}

// Walks the set bits of a live-step bitmap in order (the same walk in every
// thread, so its branches are uniform).
struct Cursor {
  const uint32_t* bits;
  int word;
  uint32_t cur;
  __device__ explicit Cursor(const uint32_t* b) : bits(b), word(0), cur(b[0]) {}
  __device__ int next() {
    while (cur == 0) cur = bits[++word];
    const int b = __ffs(cur) - 1;
    cur &= cur - 1;
    return 32 * word + b;
  }
};

// One stage of the wide form: the thread's 8 x 8 minima over BK k-rows.
// kSel: the masked form's rare stage where one of the warp's two row
// granules is dead, whose rows then see +inf for d.
template <bool kSel>
__device__ __forceinline__ void wide_stage(float (&acc)[8][8],
                                           const float* __restrict__ st,
                                           int tx, int ty, bool lo, bool hi) {
  const float* dt = st;
  const float* wt = st + BK * WM;
  const float4 inf4 = make_float4(inf_f(), inf_f(), inf_f(), inf_f());
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float4 d0 = *reinterpret_cast<const float4*>(dt + kk * WM + 4 * ty);
    float4 d1 =
        *reinterpret_cast<const float4*>(dt + kk * WM + WM / 2 + 4 * ty);
    if (kSel) {
      if (!lo) d0 = inf4;
      if (!hi) d1 = inf4;
    }
    const float4 w0 = *reinterpret_cast<const float4*>(wt + kk * BN + 4 * tx);
    const float4 w1 =
        *reinterpret_cast<const float4*>(wt + kk * BN + BN / 2 + 4 * tx);
    const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = relax(acc[i][j], dv[i], wv[j]);
  }
}

// Wide form.  dT: d transposed, [k][mp]; out: [m][n] (or this split's
// partial, out + split * m * n).  Grid (row blocks, column panels, splits).
template <bool kMasked>
__global__ void __launch_bounds__(THREADS, 2)
wide_kernel(const float* __restrict__ dT, const float* __restrict__ w,
            float* __restrict__ out, const int32_t* __restrict__ dmask,
            const int32_t* __restrict__ wmask, int m, int mp, int k, int n,
            int per_split) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  uint32_t* bits = reinterpret_cast<uint32_t*>(ring + WSTAGES * WSTAGE_FLOATS);
  const int bi = blockIdx.x, bj = blockIdx.y, split = blockIdx.z;
  const int nbk = k / BK;
  const int kb0 = split * per_split;
  const int nsteps = min(per_split, nbk - kb0);
  const int nwords = (nsteps + 31) / 32;
  uint16_t* gmask = reinterpret_cast<uint16_t*>(bits + (nwords > 0 ? nwords : 1));
  int steps = nsteps;
  if constexpr (kMasked) {
    live_steps<WM / BM>(bits, gmask, dmask, wmask, bi * (WM / BM), m / BM,
                        kb0, nsteps, nbk, n / BN, bj);
    __syncthreads();
    steps = count_steps(bits, nsteps);
  }

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32;  // its rows lie in granules warp, 8 + warp
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = inf_f();

  // A stage is 16 rows of 32 float4s per tile: two of each tile per thread.
  // The stage's row is a 64-bit base, the thread's place in it a 32-bit
  // offset: 64-bit offsets cost the registers that made ptxas spill.
  const float* dsrc = dT + (size_t)bi * WM;
  const float* wsrc = w + (size_t)bj * BN;
  auto issue = [&](int slot, int kb) {
    float* st = ring + slot * WSTAGE_FLOATS;
    const size_t k0 = (size_t)kb * BK;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = threadIdx.x + THREADS * q;
      const int r = c / 32;
      const int c4 = 4 * (c % 32);
      cp_async16(st + r * WM + c4, dsrc + k0 * mp + (r * mp + c4));
      cp_async16(st + BK * WM + r * BN + c4, wsrc + k0 * n + (r * n + c4));
    }
  };

  // The dense form walks every step of its split; the masked one the live
  // steps of its bitmap, with a second walk for their granule bits.
  Cursor load(bits), use(bits);
  auto step = [&](int s) { return kb0 + (kMasked ? load.next() : s); };
#pragma unroll
  for (int s = 0; s < WSTAGES - 1; ++s) {
    if (s < steps) issue(s, step(s));
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<WSTAGES - 2>();
    __syncthreads();  // stage i landed; stage i - 1's slot is free
    const int j = i + WSTAGES - 1;
    if (j < steps) issue(j % WSTAGES, step(j));
    cp_async_commit();
    const float* st = ring + (i % WSTAGES) * WSTAGE_FLOATS;
    if constexpr (kMasked) {
      const uint32_t g = gmask[use.next()];
      const bool lo = (g >> warp) & 1u;
      const bool hi = (g >> (8 + warp)) & 1u;
      if (lo && hi) {
        wide_stage<false>(acc, st, tx, ty, true, true);
      } else if (lo || hi) {
        wide_stage<true>(acc, st, tx, ty, lo, hi);
      }
    } else {
      wide_stage<false>(acc, st, tx, ty, true, true);
    }
  }
  cp_async_wait<0>();

  float* dst = out + (size_t)split * m * n;
  const int col0 = bj * BN;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = bi * WM + split_index(ty, i, WM / 2);
    if (row >= m) continue;
    float* rp = dst + (size_t)row * n + col0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = make_float4(acc[i][4 * h + 0], acc[i][4 * h + 1],
                                   acc[i][4 * h + 2], acc[i][4 * h + 3]);
      *reinterpret_cast<float4*>(rp + split_index(tx, 4 * h, BN / 2)) = v;
    }
  }
}

// Skinny form.  d: [m][k]; out as the wide form's.  Grid (row granules,
// column panels, splits).
template <bool kMasked>
__global__ void __launch_bounds__(THREADS, 3)
skinny_kernel(const float* __restrict__ d, const float* __restrict__ w,
              float* __restrict__ out, const int32_t* __restrict__ dmask,
              const int32_t* __restrict__ wmask, int m, int k, int n,
              int per_split) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  uint32_t* bits = reinterpret_cast<uint32_t*>(ring + SSTAGES * SSTAGE_FLOATS);
  const int bi = blockIdx.x, bj = blockIdx.y, split = blockIdx.z;
  const int nbk = k / BK;
  const int kb0 = split * per_split;
  const int nsteps = min(per_split, nbk - kb0);
  int steps = nsteps;
  if constexpr (kMasked) {
    live_steps<1>(bits, nullptr, dmask, wmask, bi, m / BM, kb0, nsteps, nbk,
                  n / BN, bj);
    __syncthreads();
    steps = count_steps(bits, nsteps);
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc[BM][4];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = inf_f();

  // A stage: w's 16 rows of 32 float4s (two per thread), then d's 8 rows of
  // 4 float4s (the first warp).
  const float* dsrc = d + (size_t)bi * BM * k;
  const float* wsrc = w + (size_t)bj * BN;
  auto issue = [&](int slot, int kb) {
    float* st = ring + slot * SSTAGE_FLOATS;
    const int k0 = kb * BK;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = threadIdx.x + THREADS * q;
      const int r = c / 32;
      const int c4 = 4 * (c % 32);
      cp_async16(st + r * BN + c4, wsrc + (size_t)(k0 + r) * n + c4);
    }
    if (threadIdx.x < 32) {
      const int r = threadIdx.x / 4;
      const int c4 = 4 * (threadIdx.x % 4);
      cp_async16(st + BK * BN + r * BK + c4, dsrc + (size_t)r * k + k0 + c4);
    }
  };

  Cursor load(bits);
  auto step = [&](int s) { return kb0 + (kMasked ? load.next() : s); };
#pragma unroll
  for (int s = 0; s < SSTAGES - 1; ++s) {
    if (s < steps) issue(s, step(s));
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<SSTAGES - 2>();
    __syncthreads();
    const int j = i + SSTAGES - 1;
    if (j < steps) issue(j % SSTAGES, step(j));
    cp_async_commit();
    const float* st = ring + (i % SSTAGES) * SSTAGE_FLOATS;
    // This warp's k-rows of the stage: 2 warp, 2 warp + 1.
    const float* wt = st + 2 * warp * BN + 4 * lane;
    const float4 w0 = *reinterpret_cast<const float4*>(wt);
    const float4 w1 = *reinterpret_cast<const float4*>(wt + BN);
    const float* dt = st + BK * BN + 2 * warp;
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const float2 dv = *reinterpret_cast<const float2*>(dt + r * BK);
      acc[r][0] = relax(acc[r][0], dv.x, w0.x);
      acc[r][1] = relax(acc[r][1], dv.x, w0.y);
      acc[r][2] = relax(acc[r][2], dv.x, w0.z);
      acc[r][3] = relax(acc[r][3], dv.x, w0.w);
      acc[r][0] = relax(acc[r][0], dv.y, w1.x);
      acc[r][1] = relax(acc[r][1], dv.y, w1.y);
      acc[r][2] = relax(acc[r][2], dv.y, w1.z);
      acc[r][3] = relax(acc[r][3], dv.y, w1.w);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is reused for the cross-warp min

  float* red = ring;  // [warp][row][BN]
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    *reinterpret_cast<float4*>(red + (warp * BM + r) * BN + 4 * lane) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  const int r = threadIdx.x / 32;
  const int c4 = 4 * (threadIdx.x % 32);
  float4 v = *reinterpret_cast<const float4*>(red + r * BN + c4);
#pragma unroll
  for (int wv = 1; wv < THREADS / 32; ++wv)
    v = min4(v, *reinterpret_cast<const float4*>(red + (wv * BM + r) * BN + c4));
  float* dst = out + (size_t)split * m * n;
  *reinterpret_cast<float4*>(dst + (size_t)(bi * BM + r) * n + bj * BN + c4) =
      v;
}

// out[i] = min over the splits of part[s][i], as float4s (n4 per split).
__global__ void merge_splits_kernel(const float4* __restrict__ part,
                                    float4* __restrict__ out, long long n4,
                                    int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 v = part[i];
    for (int s = 1; s < splits; ++s) v = min4(v, part[s * n4 + i]);
    out[i] = v;
  }
}

// dT[kk][r] = d[r][kk] for r < m, +inf for m <= r < mp: 32 x 32 tiles.
__global__ void __launch_bounds__(256)
transpose_kernel(const float* __restrict__ d, float* __restrict__ dT, int m,
                 int mp, int k) {
  __shared__ float t[32][33];
  const int k0 = blockIdx.x * 32;
  const int r0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = r0 + ty + 8 * q;
    const int kk = k0 + tx;
    t[ty + 8 * q][tx] =
        (r < m && kk < k) ? d[(size_t)r * k + kk] : inf_f();
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int kk = k0 + ty + 8 * q;
    if (kk < k) dT[(size_t)kk * mp + r0 + tx] = t[tx][ty + 8 * q];
  }
}

// How one product runs: its form, K split and scratch.
struct Plan {
  bool skinny;
  int rblocks;        // row blocks (granules for the skinny form)
  int mp;             // wide form: rows of dT
  int splits, per_split;
  size_t scratch;     // floats: dT (wide), then the partials (splits > 1)
  size_t smem;        // dynamic shared memory of the main kernel
};

int plan(int m, int k, int n, bool masked, Plan* p) {
  if (m <= 0 || k < 0 || n <= 0 || m % BM || k % BK || n % BN ||
      n / BN > 65535 || (long long)m * n > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  p->skinny = m < SKINNY_BELOW;
  p->rblocks = p->skinny ? m / BM : (m + WM - 1) / WM;
  p->mp = p->skinny ? 0 : p->rblocks * WM;
  if (p->mp / 32 > 65535) return (int)cudaErrorInvalidValue;
  const int nbk = k / BK;
  const long long ctas = (long long)p->rblocks * (n / BN);
  // Skinny: about 8 CTAs per SM stream w.  Wide: fill the two resident
  // CTAs per SM once, without a second, partial wave.
  long long want = p->skinny ? (8LL * sms + ctas - 1) / ctas
                             : (2LL * sms) / ctas;
  const int most = nbk / MIN_SPLIT_STEPS;
  if (want > most) want = most;
  if (want < 1) want = 1;
  p->per_split = nbk == 0 ? 0 : (int)((nbk + want - 1) / want);
  p->splits = nbk == 0 ? 1 : (nbk + p->per_split - 1) / p->per_split;
  if (p->splits > 65535) return (int)cudaErrorInvalidValue;
  p->scratch = (p->skinny ? 0 : (size_t)k * p->mp) +
               (p->splits > 1 ? (size_t)p->splits * m * n : 0);
  const int nwords = (p->per_split + 31) / 32;
  const size_t words = sizeof(uint32_t) * (nwords > 0 ? nwords : 1);
  p->smem = p->skinny
                ? sizeof(float) * SSTAGES * SSTAGE_FLOATS + words
                : sizeof(float) * WSTAGES * WSTAGE_FLOATS + words +
                      (masked ? sizeof(uint16_t) * p->per_split : 0);
  if (p->smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  return 0;
}

template <bool kMasked>
int run(const float* d, const float* w, float* out, float* scratch,
        const int32_t* dmask, const int32_t* wmask, int m, int k, int n,
        cudaStream_t stream) {
  Plan p;
  const int bad = plan(m, k, n, kMasked, &p);
  if (bad != 0) return bad;
  float* part = p.splits > 1
                    ? scratch + (p.skinny ? 0 : (size_t)k * p.mp)
                    : out;
  const dim3 grid(p.rblocks, n / BN, p.splits);
  cudaError_t e;
  if (p.skinny) {
    e = cudaFuncSetAttribute(skinny_kernel<kMasked>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p.smem);
    if (e != cudaSuccess) return (int)e;
    skinny_kernel<kMasked><<<grid, THREADS, p.smem, stream>>>(
        d, w, part, dmask, wmask, m, k, n, p.per_split);
  } else {
    if (k > 0) {
      transpose_kernel<<<dim3((k + 31) / 32, p.mp / 32), 256, 0, stream>>>(
          d, scratch, m, p.mp, k);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    e = cudaFuncSetAttribute(wide_kernel<kMasked>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p.smem);
    if (e != cudaSuccess) return (int)e;
    wide_kernel<kMasked><<<grid, THREADS, p.smem, stream>>>(
        scratch, w, part, dmask, wmask, m, p.mp, k, n, p.per_split);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return (int)e;
  const long long n4 = (long long)m * n / 4;
  const long long want = (n4 + 255) / 256;
  merge_splits_kernel<<<(int)(want < 8192 ? want : 8192), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(out),
      n4, p.splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The block shape the wrappers pad to and coarsen the masks to: {BM, BN, BK}
// (BM the row granule: both forms take any m that is a multiple of it).
void minplus_mm_block_shape(int* shape) {
  shape[0] = BM;
  shape[1] = BN;
  shape[2] = BK;
}

// Floats of device scratch that a product of these shapes needs, into
// *floats.  Returns cudaErrorInvalidValue for shapes the kernels refuse.
int minplus_mm_scratch(int m, int k, int n, long long* floats) {
  Plan p;
  const int bad = plan(m, k, n, false, &p);
  if (bad != 0) return bad;
  *floats = (long long)p.scratch;
  return 0;
}

// out[m, n] = min_k d[m, k] + w[k, n]; row-major, contiguous, f32, 16-byte
// aligned, on the device; scratch holds minplus_mm_scratch(m, k, n) floats.
// Returns the launches' cudaError_t (0 on success).
int minplus_mm(const float* d, const float* w, float* out, float* scratch,
               int m, int k, int n, cudaStream_t stream) {
  return run<false>(d, w, out, scratch, nullptr, nullptr, m, k, n, stream);
}

// As minplus_mm, skipping every (row granule, k-step, column panel) block
// whose dmask[m / BM, k / BK] or wmask[k / BK, n / BN] entry (int32) is
// zero.
int minplus_mm_masked(const float* d, const float* w, float* out,
                      float* scratch, const int32_t* dmask,
                      const int32_t* wmask, int m, int k, int n,
                      cudaStream_t stream) {
  return run<true>(d, w, out, scratch, dmask, wmask, m, k, n, stream);
}

}  // extern "C"
