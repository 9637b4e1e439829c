// Boolean-semiring product for Hopper (sm_90a): out = (f @ a) > 0 as f32
// {0,1}, as an exact int8 product on the tensor cores (wgmma, s32
// accumulators) fed by TMA from operands packed to one byte per entry.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/bool_mm.py:
//   bool_mm        (_kernel, pallas_call at :79)
//   bool_mm_masked (_masked_kernel, pallas_call at :113)
// They carry the multi-source BFS (repro.core.queries.bfs_batched_dense): one
// product of the {0,1} frontier f [S, V] against the live adjacency a [V, V]
// per BFS level.  Two shapes matter: S = 2048 sources (the batched query)
// and M = 128, one source padded to a row block (the Section 5 workload's
// static mode, which makes most of the launches).
//
// Packing.  pack_rows_kernel turns the f32 frontier into int8 [M][K] on every
// call; pack_cols_kernel turns the adjacency, once per prepared right
// operand, into int8 [N][K] = a transposed (8-bit wgmma reads both operands
// K-major only).  Both store (x != 0).  So the kernel computes "some k
// with f[s, k] != 0 and a[k, j] != 0", which is (f @ a) > 0 for the
// nonnegative {0,1} operands every caller passes (the reference's
// contract).
//
// Exactness.  Each s32 accumulator sums at most K products of {0,1}, at
// most 16384 < 2^31 on the main path (K < 2^31 in general), and integer
// sums are exact in any order, so several k-steps may be in flight into the
// same accumulator: no partial sums, no rounding.  The epilogue writes
// acc > 0 as f32, equal to the plain (f @ a) > 0 bit for bit.
//
// Bound (H100 SXM, 700 W: 1979 TOP/s int8 dense, 3.35 TB/s).  S = 2048, K =
// N = 16384: 2 S K N = 1.1e12 operations, 0.556 ms; the bytes (f32 f and
// out, int8 a) need 0.16 ms.  M = 128: 0.035 ms of operations, but the
// 256 MiB packed adjacency must be read once: 0.085 ms with f and out.
//
// Design.  One CTA per 128 x 128 output tile, 288 threads: consumer
// warpgroups 0 and 1 each own 64 output rows, and one thread of the
// producer warp after them starts the TMA loads.  A k-step is BK = 128
// int8, one 128-byte swizzled row: the 128 x 128 tiles of packed f and of
// packed a (16 KiB each) arrive by TMA into a ring of STAGES stages guarded
// by full/empty mbarriers.  Each consumer issues 4 wgmma m64n128k32 per
// k-step straight into its 64 s32 accumulators, commits, and waits only
// until one group is left in flight before it releases the stage of the
// previous k-step, so the tensor cores always hold the next k-step's
// products while the stage of the last one is refilled.  The grid runs the
// row blocks fastest, so the CTAs resident together share a column panel
// of packed a in L2 (S = 2048: 16 row blocks per panel).  At M = 128 there
// is one row block: 128 CTAs on 132 SMs, each streaming its own 2 MiB
// panel of packed a from HBM (f, 2 MiB, stays in L2); STAGES = 6 keeps 5
// k-steps (160 KiB) of loads in flight per SM, which that streaming needs
// to reach the HBM rate.  BM = 128 (two 64-row warpgroups) serves both
// shapes: at M = 128 nothing is padded.  The masked form skips every
// k-step whose fmask[m / BM, k / BK] or amask[k / BK, n / BN] is zero: at
// its start the CTA's warps read its row of fmask and column of amask in
// parallel into a bitmap of live k-steps in shared memory, the producer
// loads only those, and the consumers run as many k-steps as it counts,
// so no mask read waits inside the ring.  The accumulators start at zero
// and are always written, so a fully skipped tile is zeros.

#include "hopper.cuh"

namespace {

constexpr int BM = 128;            // output rows per CTA
constexpr int BN = 128;            // output columns per CTA
constexpr int BK = 128;            // k-step: one 128-byte swizzled row of int8
constexpr int THREADS = 288;       // two consumer warpgroups + a producer warp
constexpr int TILE = 128 * BK;     // bytes of one 128 x 128 int8 tile
constexpr int STAGES = 6;
constexpr int STAGE_BYTES = 2 * TILE;  // the f tile, then the a tile
// The ring, its alignment slack and barriers; the live-k-step bitmap (one
// bit per k-step, ceil(k / BK / 32) words) follows.
constexpr size_t SMEM_RING =
    (size_t)STAGES * STAGE_BYTES + 1024 + 2 * STAGES * sizeof(uint64_t);
constexpr size_t SMEM_MAX = 232448;  // what a block may use on an H100
constexpr int PT = 64;             // square tile of the transposing pack

__device__ __forceinline__ uint32_t nz4(float4 v) {
  return (v.x != 0.0f ? 1u : 0u) | (v.y != 0.0f ? 1u : 0u) << 8 |
         (v.z != 0.0f ? 1u : 0u) << 16 | (v.w != 0.0f ? 1u : 0u) << 24;
}

// out[i] = (x[i] != 0) as int8, 16 entries per thread and iteration
// (n16 = entries / 16).
__global__ void pack_rows_kernel(const float4* __restrict__ x,
                                 uint4* __restrict__ out, long long n16) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n16; i += (long long)gridDim.x * blockDim.x) {
    out[i] = make_uint4(nz4(x[4 * i]), nz4(x[4 * i + 1]), nz4(x[4 * i + 2]),
                        nz4(x[4 * i + 3]));
  }
}

// out[j][r] = (a[r][j] != 0) as int8 for a [k][n]: one 64 x 64 tile per
// block, read as rows of float4 and written as rows of 32-bit words through
// a shared tile (row stride 68 bytes: word-aligned, and the transposing
// byte stores of a warp spread over the banks).
__global__ void __launch_bounds__(256)
pack_cols_kernel(const float* __restrict__ a, uint8_t* __restrict__ out,
                 int k, int n) {
  __shared__ __align__(16) uint8_t t[PT][PT + 4];  // t[column][row]
  const int r0 = blockIdx.y * PT;
  const int c0 = blockIdx.x * PT;
  for (int idx = threadIdx.x; idx < PT * PT / 4; idx += blockDim.x) {
    const int r = idx / (PT / 4);
    const int c = 4 * (idx % (PT / 4));
    const float4 v =
        *reinterpret_cast<const float4*>(a + (size_t)(r0 + r) * n + c0 + c);
    t[c][r] = v.x != 0.0f;
    t[c + 1][r] = v.y != 0.0f;
    t[c + 2][r] = v.z != 0.0f;
    t[c + 3][r] = v.w != 0.0f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < PT * PT / 4; idx += blockDim.x) {
    const int c = idx / (PT / 4);
    const int w = idx % (PT / 4);
    *reinterpret_cast<uint32_t*>(out + (size_t)(c0 + c) * k + r0 + 4 * w) =
        *reinterpret_cast<const uint32_t*>(&t[c][4 * w]);
  }
}

template <bool kMasked>
__global__ void __launch_bounds__(THREADS, 1)
bool_mm_kernel(const __grid_constant__ CUtensorMap tf,
               const __grid_constant__ CUtensorMap ta,
               float* __restrict__ out, const int32_t* __restrict__ fmask,
               const int32_t* __restrict__ amask, int k, int n) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  uint32_t* live_bits = reinterpret_cast<uint32_t*>(empty + STAGES);

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

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer
    }
    hopper::fence_barrier_init();
  }
  // Bit kb % 32 of word kb / 32: k-step kb is live for this tile.  Every
  // warp takes whole words, one mask pair per lane, so the masks are read
  // once, in parallel, before the ring starts, and never inside it.
  for (int w = threadIdx.x / 32; w < nwords; w += THREADS / 32) {
    const int kb = 32 * w + threadIdx.x % 32;
    const bool on = kb < nbk && (!kMasked ||
                                 (fmask[(size_t)bi * nbk + kb] != 0 &&
                                  amask[(size_t)kb * nbn + bj] != 0));
    const uint32_t bits = __ballot_sync(0xffffffffu, on);
    if (threadIdx.x % 32 == 0) live_bits[w] = bits;
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp
    if (tid != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int w = 0; w < nwords; ++w) {
      for (uint32_t bits = live_bits[w]; bits != 0; bits &= bits - 1) {
        const int kb = 32 * w + __ffs(bits) - 1;
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        hopper::mbar_expect_tx(&full[stage], STAGE_BYTES);
        uint8_t* base = smem + stage * STAGE_BYTES;
        hopper::tma_load_2d(base, &tf, &full[stage], kb * BK, bi * BM);
        hopper::tma_load_2d(base + TILE, &ta, &full[stage], kb * BK,
                            bj * BN);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumer warpgroup c owns output rows 64 c .. 64 c + 63 of the tile.
  const int c = wg;
  int32_t acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  // Only the count of live k-steps matters here: the producer loads them
  // into the ring in order.  Broadcast from lane 0, so that the compiler
  // sees the loop around the wgmmas as uniform.
  int steps = 0;
  for (int w = 0; w < nwords; ++w) steps += __popc(live_bits[w]);
  steps = __shfl_sync(0xffffffffu, steps, 0);
  int stage = 0, held = -1;  // held: the stage the group in flight reads
  uint32_t phase = 0;
  for (int i = 0; i < steps; ++i) {
    hopper::mbar_wait(&full[stage], phase);
    const uint32_t base = hopper::smem_u32(smem + stage * STAGE_BYTES);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      const uint64_t da =
          hopper::desc_sw128(base + c * (TILE / 2) + kk * 32, 16, 1024);
      const uint64_t db = hopper::desc_sw128(base + TILE + kk * 32, 16, 1024);
      hopper::wgmma_m64n128k32_s8(acc, da, db);
    }
    hopper::wgmma_commit();
    // One group (this k-step's) may stay in flight: the previous one has
    // finished reading its stage, which goes back to the producer.
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc);
    if (held >= 0 && tid == 0) hopper::mbar_arrive(&empty[held]);
    held = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row = bi * BM + c * 64 + warp * 16 + lane / 4;
  const int col0 = bj * BN + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j;
    *reinterpret_cast<float2*>(out + (size_t)row * n + col) =
        make_float2(acc[4 * j] > 0 ? 1.0f : 0.0f,
                    acc[4 * j + 1] > 0 ? 1.0f : 0.0f);
    *reinterpret_cast<float2*>(out + (size_t)(row + 8) * n + col) =
        make_float2(acc[4 * j + 2] > 0 ? 1.0f : 0.0f,
                    acc[4 * j + 3] > 0 ? 1.0f : 0.0f);
  }
}

size_t smem_bytes(int k) {
  return SMEM_RING + sizeof(uint32_t) * ((k / BK + 31) / 32);
}

bool bad_shape(int m, int k, int n) {
  return m <= 0 || k < 0 || n <= 0 || m % BM || k % BK || n % BN ||
         n / BN > 65535 || smem_bytes(k) > SMEM_MAX;
}

int pack_rows(const float* x, void* out, long long entries,
              cudaStream_t stream) {
  const long long n16 = entries / 16;
  const long long want = (n16 + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  if (blocks == 0) return 0;
  pack_rows_kernel<<<blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), static_cast<uint4*>(out), n16);
  return (int)cudaGetLastError();
}

template <bool kMasked>
int run(const float* f, void* f_packed, const void* a_packed, float* out,
        const int32_t* fmask, const int32_t* amask, int m, int k, int n,
        cudaStream_t stream) {
  if (bad_shape(m, k, n)) return (int)cudaErrorInvalidValue;
  if (k == 0)
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * m * n, stream);
  int err = pack_rows(f, f_packed, (long long)m * k, stream);
  if (err != 0) return err;

  CUtensorMap tf, ta;
  const uint64_t fdims[2] = {(uint64_t)k, (uint64_t)m};
  const uint64_t adims[2] = {(uint64_t)k, (uint64_t)n};
  const uint64_t stride[1] = {(uint64_t)k};
  if (!hopper::make_map_u8(&tf, f_packed, 2, fdims, stride, BM) ||
      !hopper::make_map_u8(&ta, a_packed, 2, adims, stride, BN))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(k);
  cudaError_t e = cudaFuncSetAttribute(
      bool_mm_kernel<kMasked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(m / BM, n / BN);
  bool_mm_kernel<kMasked><<<grid, THREADS, smem, stream>>>(
      tf, ta, out, fmask, amask, k, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The block shape the wrappers pad to and coarsen the masks to: {BM, BN, BK}.
void bool_mm_block_shape(int* shape) {
  shape[0] = BM;
  shape[1] = BN;
  shape[2] = BK;
}

// out[m, k] = (x[m, k] != 0) as int8; x f32, both contiguous, 16-byte
// aligned, on the device; m * k a multiple of 16.
int bool_mm_pack_left(const float* x, void* out, int m, int k,
                      cudaStream_t stream) {
  if (m < 0 || k < 0 || ((long long)m * k) % 16)
    return (int)cudaErrorInvalidValue;
  return pack_rows(x, out, (long long)m * k, stream);
}

// out[n, k] = (a[k, n] != 0) as int8 (a transposed); a f32, both
// contiguous, 16-byte aligned, on the device; k and n multiples of 64.
int bool_mm_pack_right(const float* a, void* out, int k, int n,
                       cudaStream_t stream) {
  if (k < 0 || n < 0 || k % PT || n % PT || k / PT > 65535)
    return (int)cudaErrorInvalidValue;
  if (k == 0 || n == 0) return 0;
  pack_cols_kernel<<<dim3(n / PT, k / PT), 256, 0, stream>>>(
      a, static_cast<uint8_t*>(out), k, n);
  return (int)cudaGetLastError();
}

// out[m, n] = (f[m, k] @ a[k, n]) > 0 as f32 {0,1}: f row-major f32;
// f_packed scratch for m x k int8; a_packed = bool_mm_pack_right(a), n x k
// int8; out row-major f32; all contiguous, 16-byte aligned, on the device.
// Returns the launches' cudaError_t (0 on success).
int bool_mm(const float* f, void* f_packed, const void* a_packed, float* out,
            int m, int k, int n, cudaStream_t stream) {
  return run<false>(f, f_packed, a_packed, out, nullptr, nullptr, m, k, n,
                    stream);
}

// As bool_mm, skipping every (k-step, output tile) pair whose
// fmask[m / BM, k / BK] or amask[k / BK, n / BN] entry (int32) is zero.
int bool_mm_masked(const float* f, void* f_packed, const void* a_packed,
                   float* out, const int32_t* fmask, const int32_t* amask,
                   int m, int k, int n, cudaStream_t stream) {
  return run<true>(f, f_packed, a_packed, out, fmask, amask, m, k, n, stream);
}

}  // extern "C"
