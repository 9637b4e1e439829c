// Boolean-semiring product for Hopper (sm_90a): out = (f @ a) > 0 on {0,1} f32.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/bool_mm.py:
//   bool_mm        (_kernel, pallas_call at :79)
//   bool_mm_masked (_masked_kernel, pallas_call at :113)
// They carry the multi-source BFS (repro.core.queries.bfs_batched_dense): one
// product of the {0,1} frontier f [S, V] against the live adjacency a [V, V]
// per BFS level.
//
// Exactness.  The operands are {0,1} (or at least nonnegative), so every
// term is >= 0 and "sum > 0" is "some term > 0", whatever the order of
// summation; a sum of at most K < 2^24 ones is exact in FP32 anyway.  The
// kernel accumulates FP32 FMAs and thresholds in the epilogue, as the
// Pallas kernel does, so it equals (f @ a > 0) bit for bit.
//
// Bound.  {0,1} is exact in int8, fp8 and bf16, so the least time the card
// could take is the int8 tensor-core rate (1979 TOP/s on an H100 SXM):
// 2*S*K*N / 1979e12 s, about 0.56 ms at S = 2048, K = N = 16384, just above
// the 0.4 ms the f32 operands need at 3.35 TB/s.  This kernel runs on the
// CUDA cores in FP32 (67 TFLOP/s), so it sits about 30x above that bound.
// The redesign is a wgmma (or mma.sync) int8 product on operands packed to
// one byte per entry, with TMA staging; not built yet.
//
// Design.  A shared-memory-tiled SIMT product: one block of 256 threads per
// 128x128 output tile, the sum over k a loop inside the block (the TPU's
// sequential k grid axis), a k-step of 16 staged in shared memory, and an
// 8x8 register micro-tile per thread read from shared memory as float4s
// (64 FMAs per 4 vector loads).  A thread owns rows {4ty..4ty+3} and
// {64+4ty..64+4ty+3} and the same split of columns, so a warp's vector loads
// hit two addresses of the f tile (broadcast) and 16 consecutive float4s of
// the a tile.  The f tile is stored transposed with 4 floats of padding per
// row (16-byte rows stay aligned, the transposing store spreads over the
// banks).  The masked form reads one fmask[i_blk, k_blk] and one
// amask[k_blk, j_blk] per k-step and skips the loads and the FMAs when
// either is zero; the test is uniform across the block, so there is no
// divergence.  The accumulator is always zeroed and the threshold always
// written, so a fully skipped tile is all zeros.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 128;           // output rows per block
constexpr int BN = 128;           // output columns per block
constexpr int BK = 16;            // k-step staged in shared memory
constexpr int TM = 8;             // micro-tile rows per thread
constexpr int TN = 8;             // micro-tile columns per thread
constexpr int TX = BN / TN;       // 16 threads across
constexpr int TY = BM / TM;       // 16 threads down
constexpr int THREADS = TX * TY;  // 256
constexpr int PAD = 4;            // floats of padding per transposed row

// Row (or column) of micro-tile entry i of thread t: two runs of four.
__device__ __forceinline__ int split_index(int t, int i, int half) {
  return (i < 4) ? 4 * t + i : half + 4 * t + (i - 4);
}

template <bool kMasked>
__global__ void __launch_bounds__(THREADS)
bool_mm_kernel(const float* __restrict__ f, const float* __restrict__ a,
               float* __restrict__ out, const int32_t* __restrict__ fmask,
               const int32_t* __restrict__ amask, int m, int k, int n) {
  __shared__ __align__(16) float f_tile[BK][BM + PAD];  // f_tile[kk][row]
  __shared__ __align__(16) float a_tile[BK][BN];

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int bi = blockIdx.y;
  const int bj = blockIdx.x;
  const int row0 = bi * BM;
  const int col0 = bj * BN;
  const int nbk = k / BK;
  const int nbn = n / BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int kb = 0; kb < nbk; ++kb) {
    if (kMasked) {
      // Uniform across the block: every thread takes the same branch, so
      // the __syncthreads below stay matched.
      if (fmask[(size_t)bi * nbk + kb] == 0 ||
          amask[(size_t)kb * nbn + bj] == 0) {
        continue;
      }
    }
    const int k0 = kb * BK;
    // Half a warp covers one row of the f slab: 64-byte coalesced reads.
    for (int idx = threadIdx.x; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK;
      const int c = idx % BK;
      f_tile[c][r] = f[(size_t)(row0 + r) * k + (k0 + c)];
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
      const int r = idx / BN;
      const int c = idx % BN;
      a_tile[r][c] = a[(size_t)(k0 + r) * n + (col0 + c)];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 f0 = *reinterpret_cast<const float4*>(&f_tile[kk][4 * ty]);
      const float4 f1 =
          *reinterpret_cast<const float4*>(&f_tile[kk][BM / 2 + 4 * ty]);
      const float4 a0 = *reinterpret_cast<const float4*>(&a_tile[kk][4 * tx]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_tile[kk][BN / 2 + 4 * tx]);
      const float fv[TM] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
      const float av[TN] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(fv[i], av[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Threshold epilogue: one float4 store per run of four columns.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float* row = out + (size_t)(row0 + split_index(ty, i, BM / 2)) * n + col0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 v;
      v.x = acc[i][4 * h + 0] > 0.0f ? 1.0f : 0.0f;
      v.y = acc[i][4 * h + 1] > 0.0f ? 1.0f : 0.0f;
      v.z = acc[i][4 * h + 2] > 0.0f ? 1.0f : 0.0f;
      v.w = acc[i][4 * h + 3] > 0.0f ? 1.0f : 0.0f;
      *reinterpret_cast<float4*>(row + split_index(tx, 4 * h, BN / 2)) = v;
    }
  }
}

bool bad_shape(int m, int k, int n) {
  return m <= 0 || k < 0 || n <= 0 || m % BM || k % BK || n % BN ||
         m / BM > 65535;
}

}  // namespace

extern "C" {

// The block shape the wrappers pad to and coarsen the masks to: {BM, BN, BK}.
void bool_mm_block_shape(int* shape) {
  shape[0] = BM;
  shape[1] = BN;
  shape[2] = BK;
}

// out[m, n] = (f[m, k] @ a[k, n]) > 0 as f32 {0,1}; row-major, contiguous,
// f32, 16-byte aligned, on the device.  Returns the launch's cudaError_t.
int bool_mm(const float* f, const float* a, float* out, int m, int k, int n,
            cudaStream_t stream) {
  if (bad_shape(m, k, n)) return (int)cudaErrorInvalidValue;
  const dim3 grid(n / BN, m / BM);
  bool_mm_kernel<false><<<grid, THREADS, 0, stream>>>(f, a, out, nullptr,
                                                      nullptr, m, k, n);
  return (int)cudaGetLastError();
}

// As bool_mm, skipping every (k-step, output tile) pair whose
// fmask[m / BM, k / BK] or amask[k / BK, n / BN] entry (int32) is zero.
int bool_mm_masked(const float* f, const float* a, float* out,
                   const int32_t* fmask, const int32_t* amask, int m, int k,
                   int n, cudaStream_t stream) {
  if (bad_shape(m, k, n)) return (int)cudaErrorInvalidValue;
  const dim3 grid(n / BN, m / BM);
  bool_mm_kernel<true><<<grid, THREADS, 0, stream>>>(f, a, out, fmask, amask,
                                                     m, k, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
