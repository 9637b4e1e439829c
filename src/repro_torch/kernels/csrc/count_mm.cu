// Counting-semiring product for Hopper (sm_90a): out = s @ a in f32, as an
// exact split onto bf16 tensor cores (wgmma) fed by TMA.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/count_mm.py:
//   count_mm        (_kernel, pallas_call at :66)
//   count_mm_masked (_masked_kernel, pallas_call at :101)
// They carry the batched Brandes sweep (repro.core.queries.bc_batched_dense):
// one forward product of the frontier sigma against the adjacency A and one
// backward product of the dependency flow against A^T per BFS level.
//
// The split.  Any f32 x is hi + mid + lo with three bf16 pieces: hi is x
// with its low 16 bits cleared (a bf16 by truncation), mid the same of
// x - hi, lo = x - hi - mid rounded to bf16, which is exact for every
// x of magnitude 2^-110 or more and for zero.  The left operand s is split
// by split3_kernel below into three planes on every call; the right
// operand a is split once by the wrapper (kernels/count_mm.py
// right_planes) into one plane when it is exact in bf16 (the {0,1}
// adjacency of the main path) or three otherwise.  The product sums
// s_i @ a_j over the terms i + j <= 2 (j < the planes of a) in f32: at
// most 3 products per k-step against a {0,1} adjacency, 6 against a
// general a.  The dropped terms (i + j >= 3) are below 2^-24 of |s||a|,
// within the f32 product's own rounding.
//
// Exactness.  Path counts are integers carried in f32 and must stay exact
// below 2^24.  For an integer count every piece is a non-negative integer,
// so every partial sum of the products is an integer no larger than the
// true sum: below 2^24 nothing rounds, and the forward sigma is bit-exact.
// That exactness carries the bit-identity of sigma between the delta and
// the cold sweep.  The backward flow (1 + delta) / sigma is a general
// float: there the identity rests on determinism and row independence.
// Each output element is summed by one thread, over the k-steps in
// ascending order and within a step the terms in a fixed order, from its
// own row of the s planes and column of the a planes only: no split-K, no
// atomics.  A skipped block contributes exact zeros, which leave an f32
// accumulator unchanged, so whether the other rows of a slab are live
// never changes a row's result.
//
// Bound.  At the main path's shapes (S = 2048 sources x V = 16384) the
// exact function costs 3 bf16 products of 2 S V V operations at the bf16
// tensor rate (989 TFLOP/s on an H100 SXM at 700 W): 3.34 ms dense, where
// the old FP32 SIMT design could not pass 16.4 ms (67 TFLOP/s).
//
// Design.  One CTA per 128 x 128 output tile, 288 threads: warpgroups 0
// and 1 each own 64 output rows, and one thread of the producer warp after
// them starts the TMA loads.  Per k-step of 64, the 128 x 64 s planes and
// the a planes (stored N x K, K contiguous, so both operands are K-major)
// arrive by TMA into a ring of 3 stages (2 for three a planes) guarded by
// full/empty mbarriers; each consumer runs 4 wgmma m64n128k16 per term
// into 64 fresh f32 registers (the smallest terms first), waits, releases
// the stage and adds them into its 64 f32 accumulators by round-to-nearest
// (the tensor cores' own adds round toward zero; see the consumer).  The
// split kernel records which 128 x 64 slabs of s have a nonzero mid or lo
// piece, and which have any nonzero entry; a k-step loads and multiplies
// only the planes it needs (counts below 256 are hi alone, so the forward
// sweep mostly runs one product, not three).  At its start the CTA's
// warps read its row of those flags, one k-step per lane, into bitmaps in
// shared memory: which k-steps have a mid and a lo piece, and which are
// live.  In the masked form a k-step is live where the slab of s holds a
// nonzero entry, amask[k / 64, n / 128] is set and the caller's
// smask[m / 128, k / 64], where given, is set too; the dense form takes
// every k-step.  The producer and the consumers then walk the live bits
// in the same ascending order, so no mask is read inside the ring and a
// dead k-step costs nothing.  The accumulator starts at zero and is always
// written, so a tile with no live k-step is zeros.  The grid runs the row
// blocks fastest, so the CTAs on the card at once share their a columns
// in L2.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;             // output rows per CTA
constexpr int BN = 128;             // output columns per CTA
constexpr int BK = 64;              // k-step: one 128-byte swizzled row
constexpr int THREADS = 288;        // two consumer warpgroups + a producer warp
constexpr int TILE = BM * BK * 2;   // bytes of one 128 x 64 bf16 tile
constexpr int X_PLANES = 3;

constexpr size_t SMEM_MAX = 232448;  // what a block may use on an H100

// The ring, its alignment slack and barriers; the three bitmaps of k-steps
// (live, mid, lo: one bit per k-step, ceil(k / BK / 32) words each) follow.
template <int kPA>
struct Cfg {
  static constexpr int kStages = kPA == 1 ? 3 : 2;
  static constexpr int kStageBytes = (X_PLANES + kPA) * TILE;
  static constexpr size_t kRing =
      (size_t)kStages * kStageBytes + 1024 + 2 * kStages * sizeof(uint64_t);
  static size_t smem(int k) {
    return kRing + 3 * sizeof(uint32_t) * ((k / BK + 31) / 32);
  }
};

// The truncation split of s [m][k] (m % BM == 0, k % BK == 0) into
// planes[3][m][k], and flags[f][m / BM][k / BK] |= 1 for each slab that
// has a nonzero mid piece (f = 0), lo piece (f = 1) or entry (f = 2:
// x != 0, so -0 is no entry; flags is zeroed first).  A half-warp's 64
// elements lie in one slab, so one atomic per flag and half-warp.
__global__ void split3_kernel(const float4* __restrict__ s,
                              __nv_bfloat16* __restrict__ planes,
                              int32_t* __restrict__ flags, int k,
                              long long n4, int nbk, int nbm) {
  const long long n = 4 * n4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    const float4 v = s[i];
    const float x[4] = {v.x, v.y, v.z, v.w};
    __nv_bfloat16 p[3][4];
    bool nz_mid = false, nz_lo = false, nz_any = false;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      nz_any |= (__float_as_uint(x[e]) & 0x7FFFFFFFu) != 0;
      const uint32_t hb = __float_as_uint(x[e]) & 0xFFFF0000u;
      const float r = x[e] - __uint_as_float(hb);      // exact
      const uint32_t mb = __float_as_uint(r) & 0xFFFF0000u;
      const float lo = r - __uint_as_float(mb);        // exact
      p[0][e] = __ushort_as_bfloat16((unsigned short)(hb >> 16));
      p[1][e] = __ushort_as_bfloat16((unsigned short)(mb >> 16));
      p[2][e] = __float2bfloat16_rn(lo);
      nz_mid |= mb != 0;
      nz_lo |= lo != 0.0f;
    }
    // n4 is a multiple of 32 (m * k / 4 with m % 128 == 0), so every lane
    // of a warp runs the same iterations.
    const unsigned mid_lanes = __ballot_sync(0xffffffffu, nz_mid);
    const unsigned lo_lanes = __ballot_sync(0xffffffffu, nz_lo);
    const unsigned any_lanes = __ballot_sync(0xffffffffu, nz_any);
    if (threadIdx.x % 16 == 0) {
      const int shift = threadIdx.x % 32;  // this half-warp's 16 lanes
      const long long e0 = 4 * i;
      const size_t slab =
          (size_t)(e0 / k / BM) * nbk + (size_t)(e0 % k / BK);
      const size_t plane = (size_t)nbm * nbk;
      if ((mid_lanes >> shift) & 0xFFFFu) atomicOr(&flags[slab], 1);
      if ((lo_lanes >> shift) & 0xFFFFu) atomicOr(&flags[plane + slab], 1);
      if ((any_lanes >> shift) & 0xFFFFu)
        atomicOr(&flags[2 * plane + slab], 1);
    }
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(planes + pl * n + 4 * i);
      dst[0] = __halves2bfloat162(p[pl][0], p[pl][1]);
      dst[1] = __halves2bfloat162(p[pl][2], p[pl][3]);
    }
  }
}

template <int kPA, bool kMasked>
__global__ void __launch_bounds__(THREADS, 1)
count_mm_kernel(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap ta,
                float* __restrict__ out, const int32_t* __restrict__ xflags,
                const int32_t* __restrict__ smask,
                const int32_t* __restrict__ amask,
                unsigned long long* __restrict__ tally, int m, int k,
                int n) {
  using C = Cfg<kPA>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kStages *
                                               C::kStageBytes);
  uint64_t* empty = full + C::kStages;

  // The warpgroup index through a shuffle, so that the compiler sees it as
  // uniform across the warp: a wgmma on a path it cannot prove uniform is
  // serialized.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int bi = blockIdx.x;          // row block (fastest: shares a in L2)
  const int bj = blockIdx.y;          // column block
  const int nbk = k / BK;
  const int nbn = n / BN;
  const int nwords = (nbk + 31) / 32;
  uint32_t* live_bits = reinterpret_cast<uint32_t*>(empty + C::kStages);
  uint32_t* mid_bits = live_bits + nwords;
  uint32_t* lo_bits = mid_bits + nwords;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer
    }
    hopper::fence_barrier_init();
  }
  // Bit kb % 32 of word kb / 32: k-step kb is live for this tile, or the
  // slab of s at (bi, kb) has a nonzero mid or lo piece (plane 0 is always
  // taken; a dead plane's terms add exact zeros, so they are neither
  // loaded nor multiplied).  Every warp takes whole words, one k-step per
  // lane, so the flags and masks are read once, in parallel, before the
  // ring starts, and never inside it.
  const size_t plane = (size_t)(m / BM) * nbk;
  const int32_t* xrow = xflags + (size_t)bi * nbk;
  for (int w = threadIdx.x / 32; w < nwords; w += THREADS / 32) {
    const int kb = 32 * w + threadIdx.x % 32;
    bool on = false, mid = false, lo = false;
    if (kb < nbk) {
      mid = xrow[kb] != 0;
      lo = xrow[plane + kb] != 0;
      on = !kMasked || ((xrow[2 * plane + kb] != 0) &
                        (smask == nullptr ||
                         smask[(size_t)bi * nbk + kb] != 0) &
                        (amask[(size_t)kb * nbn + bj] != 0));
    }
    const uint32_t on_bits = __ballot_sync(0xffffffffu, on);
    const uint32_t mid_lanes = __ballot_sync(0xffffffffu, mid);
    const uint32_t lo_lanes = __ballot_sync(0xffffffffu, lo);
    if (threadIdx.x % 32 == 0) {
      live_bits[w] = on_bits;
      mid_bits[w] = mid_lanes;
      lo_bits[w] = lo_lanes;
    }
  }
  __syncthreads();

  // The planes of s that k-step 32 w + b needs: bit i for plane i.
  auto planes_of = [](uint32_t mid, uint32_t lo, int b) {
    return 1 | (int)((mid >> b) & 1) << 1 | (int)((lo >> b) & 1) << 2;
  };

  if (wg == 2) {  // the producer warp
    if (tid != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    unsigned long long steps = 0;
    for (int w = 0; w < nwords; ++w) {
      const uint32_t mid = mid_bits[w], lo = lo_bits[w];
      for (uint32_t bits = live_bits[w]; bits != 0; bits &= bits - 1) {
        const int b = __ffs(bits) - 1;
        const int kb = 32 * w + b;
        const int xp = planes_of(mid, lo, b);
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        hopper::mbar_expect_tx(&full[stage],
                               (__popc(xp) + kPA) * TILE);
        uint8_t* base = smem + stage * C::kStageBytes;
#pragma unroll
        for (int i = 0; i < X_PLANES; ++i)
          if ((xp >> i) & 1)
            hopper::tma_load_3d(base + i * TILE, &tx, &full[stage], kb * BK,
                                bi * BM, i);
#pragma unroll
        for (int j = 0; j < kPA; ++j)
          hopper::tma_load_3d(base + (X_PLANES + j) * TILE, &ta,
                              &full[stage], kb * BK, bj * BN, j);
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
        ++steps;
      }
    }
    // The tally of live (k-step, tile) pairs and of tiles with none.
    if (kMasked && tally != nullptr) {
      atomicAdd(&tally[0], steps);
      if (steps == 0) atomicAdd(&tally[1], 1ull);
    }
    return;
  }

  // Consumer warpgroup c owns output rows 64 c .. 64 c + 63 of the tile.
  // The tensor cores add each wgmma into its accumulator rounding toward
  // zero, so a long run of them drifts by an ulp of the running sum per
  // instruction.  Each k-step therefore sums into a fresh `part`, the
  // smallest terms first (i + j descending) so they meet a small sum, and
  // `part` joins `acc` by one round-to-nearest add.
  const int c = wg;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  // The live k-steps in the producer's order, and each one's planes, read
  // from the bitmaps.  Broadcast from lane 0, so that the compiler sees
  // the loops and branches around the wgmmas as uniform.
  int stage = 0;
  uint32_t phase = 0;
  for (int w = 0; w < nwords; ++w) {
    const uint32_t live = __shfl_sync(0xffffffffu, live_bits[w], 0);
    const uint32_t mid = __shfl_sync(0xffffffffu, mid_bits[w], 0);
    const uint32_t lo = __shfl_sync(0xffffffffu, lo_bits[w], 0);
    for (uint32_t bits = live; bits != 0; bits &= bits - 1) {
      const int xp = planes_of(mid, lo, __ffs(bits) - 1);
      hopper::mbar_wait(&full[stage], phase);
      const uint32_t base = hopper::smem_u32(smem + stage * C::kStageBytes);
#pragma unroll
      for (int i = 0; i < 64; ++i) part[i] = 0.0f;
      hopper::wgmma_fence();
#pragma unroll
      for (int order = 2; order >= 0; --order) {
#pragma unroll
        for (int j = 0; j < kPA; ++j) {
          const int i = order - j;  // the term s_i a_j, i + j == order
          if (i < 0 || !((xp >> i) & 1)) continue;
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t da = hopper::desc_sw128(
                base + i * TILE + c * (TILE / 2) + kk * 32, 16, 1024);
            const uint64_t db = hopper::desc_sw128(
                base + (X_PLANES + j) * TILE + kk * 32, 16, 1024);
            hopper::wgmma_m64n128k16_ss<0>(part, da, db);
          }
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(part);
      if (tid == 0) hopper::mbar_arrive(&empty[stage]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row = bi * BM + c * 64 + warp * 16 + lane / 4;
  const int col0 = bj * BN + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j;
    *reinterpret_cast<float2*>(out + (size_t)row * n + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (size_t)(row + 8) * n + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

bool bad_shape(int m, int k, int n, int planes_a) {
  return m <= 0 || k < 0 || n <= 0 || m % BM || k % BK || n % BN ||
         n / BN > 65535 || (planes_a != 1 && planes_a != 3) ||
         Cfg<1>::smem(k) > SMEM_MAX || Cfg<3>::smem(k) > SMEM_MAX;
}

template <int kPA, bool kMasked>
int run(const float* s, __nv_bfloat16* s_planes, int32_t* x_flags,
        const __nv_bfloat16* a_planes, float* out, const int32_t* smask,
        const int32_t* amask, unsigned long long* tally, int m, int k, int n,
        cudaStream_t stream) {
  if (k == 0) return (int)cudaMemsetAsync(out, 0, sizeof(float) * m * n,
                                          stream);
  const int nbm = m / BM, nbk = k / BK;
  cudaError_t err = cudaMemsetAsync(
      x_flags, 0, sizeof(int32_t) * 3 * nbm * nbk, stream);
  if (err != cudaSuccess) return (int)err;
  const long long n4 = (long long)m * k / 4;
  const int blocks = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  split3_kernel<<<blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(s), s_planes, x_flags, k, n4, nbk, nbm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap tx, ta;
  const uint64_t xdims[3] = {(uint64_t)k, (uint64_t)m, X_PLANES};
  const uint64_t xstr[2] = {(uint64_t)k * 2, (uint64_t)m * k * 2};
  const uint64_t adims[3] = {(uint64_t)k, (uint64_t)n, (uint64_t)kPA};
  const uint64_t astr[2] = {(uint64_t)k * 2, (uint64_t)n * k * 2};
  if (!hopper::make_map_bf16(&tx, s_planes, 3, xdims, xstr, BM) ||
      !hopper::make_map_bf16(&ta, a_planes, 3, adims, astr, BN))
    return (int)cudaErrorInvalidValue;

  const size_t smem = Cfg<kPA>::smem(k);
  err = cudaFuncSetAttribute(count_mm_kernel<kPA, kMasked>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(m / BM, n / BN);
  count_mm_kernel<kPA, kMasked><<<grid, THREADS, smem, stream>>>(
      tx, ta, out, x_flags, smask, amask, tally, m, k, n);
  return (int)cudaGetLastError();
}

template <bool kMasked>
int dispatch(const float* s, void* s_planes, int32_t* x_flags,
             const void* a_planes, int planes_a, float* out,
             const int32_t* smask, const int32_t* amask, long long* tally,
             int m, int k, int n, cudaStream_t stream) {
  if (bad_shape(m, k, n, planes_a)) return (int)cudaErrorInvalidValue;
  auto* sp = static_cast<__nv_bfloat16*>(s_planes);
  auto* ap = static_cast<const __nv_bfloat16*>(a_planes);
  auto* t = reinterpret_cast<unsigned long long*>(tally);
  if (planes_a == 1)
    return run<1, kMasked>(s, sp, x_flags, ap, out, smask, amask, t, m, k,
                           n, stream);
  return run<3, kMasked>(s, sp, x_flags, ap, out, smask, amask, t, m, k, n,
                         stream);
}

}  // namespace

extern "C" {

// The block shape the wrappers pad to and coarsen the masks to: {BM, BN, BK}.
void count_mm_block_shape(int* shape) {
  shape[0] = BM;
  shape[1] = BN;
  shape[2] = BK;
}

// out[m, n] = s[m, k] @ a[k, n]: s row-major f32; s_planes scratch for
// 3 x m x k bf16 and x_flags for 3 x (m / BM) x (k / BK) int32; a_planes
// the right operand's planes_a (1 or 3) bf16 planes, each n x k (a
// transposed, k contiguous); out row-major f32; all on the device.
// Returns the launches' cudaError_t (0 on success).
int count_mm(const float* s, void* s_planes, int32_t* x_flags,
             const void* a_planes, int planes_a, float* out, int m, int k,
             int n, cudaStream_t stream) {
  return dispatch<false>(s, s_planes, x_flags, a_planes, planes_a, out,
                         nullptr, nullptr, nullptr, m, k, n, stream);
}

// As count_mm, skipping every (k-step, output tile) pair whose slab of s
// (m / BM, k / BK) holds no nonzero entry, or whose amask[k / BK, n / BN]
// entry (int32) is zero, or, where smask is not null, whose
// smask[m / BM, k / BK] entry is zero.  Where tally is not null, its two
// int64 counters gain the live pairs and the tiles that had none.
int count_mm_masked(const float* s, void* s_planes, int32_t* x_flags,
                    const void* a_planes, int planes_a, float* out,
                    const int32_t* smask, const int32_t* amask,
                    long long* tally, int m, int k, int n,
                    cudaStream_t stream) {
  return dispatch<true>(s, s_planes, x_flags, a_planes, planes_a, out, smask,
                        amask, tally, m, k, n, stream);
}

}  // extern "C"
