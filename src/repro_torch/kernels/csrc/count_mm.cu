// Counting-semiring product for Hopper (sm_90a): out = s @ a in full FP32.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/count_mm.py:
//   count_mm        (_kernel, pallas_call at :66)
//   count_mm_masked (_masked_kernel, pallas_call at :101)
// They carry the batched Brandes sweep (repro.core.queries.bc_batched_dense):
// one forward product of the frontier sigma against the adjacency A and one
// backward product of the dependency flow against A^T per BFS level.
//
// Exactness.  Path counts are integers carried in f32 and must stay exact
// below 2^24, so the product runs as FP32 FMAs on the CUDA cores.  TF32
// (10-bit mantissa) would round counts above 2^11 and break the
// bit-identity of sigma between the delta and the cold sweep.  Each output
// element sums its k terms in one fixed order (k ascending), so a result
// depends only on its own row of s: the delta path, which feeds rows at
// different levels through one product, reproduces the cold path bit for
// bit.  A skipped block contributes exact zeros, so skipping never changes
// a sum either.
//
// Bound.  Dense FP32 has no tensor-core path on Hopper, so at the main
// path's shapes (S = 2048 sources x V = 16384) the product is bound by the
// FP32 FMA rate (67 TFLOP/s on an H100 SXM at 700 W), not by the 3.35 TB/s
// of device memory: 2*S*V*V FLOPs over 4*(S*V + V*V + S*V) bytes is about
// 800 FLOPs per byte, far above the card's 20 FP32 FLOPs per byte.
//
// Design.  A plain shared-memory-tiled SIMT product: one block of 256
// threads per 64x64 output tile, the sum over k a loop inside the block (the
// TPU's sequential k grid axis), a k-step of 32 staged in shared memory,
// and a 4x4 register micro-tile per thread (16 FMAs per 8 shared loads).
// The s tile is stored transposed with one column of padding so the
// transposing store is free of bank conflicts.  The masked form reads one
// smask[i_blk, k_blk] and one amask[k_blk, j_blk] per k-step and skips the
// loads and the FMAs when either is zero; the test is uniform across the
// block, so there is no divergence.  The accumulator is always zeroed and
// written, so a fully skipped tile is zeros.  Faster forms (an exact 3-way
// bf16 split on wgmma with FP32 accumulation, TMA staging) are later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 64;            // output rows per block
constexpr int BN = 64;            // output columns per block
constexpr int BK = 32;            // k-step staged in shared memory
constexpr int TM = 4;             // micro-tile rows per thread
constexpr int TN = 4;             // micro-tile columns per thread
constexpr int TX = BN / TN;       // 16 threads across
constexpr int TY = BM / TM;       // 16 threads down
constexpr int THREADS = TX * TY;  // 256

template <bool kMasked>
__global__ void __launch_bounds__(THREADS)
count_mm_kernel(const float* __restrict__ s, const float* __restrict__ a,
                float* __restrict__ out, const int32_t* __restrict__ smask,
                const int32_t* __restrict__ amask, int m, int k, int n) {
  __shared__ float s_tile[BK][BM + 1];  // transposed: s_tile[kk][row]
  __shared__ float a_tile[BK][BN];

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
      if (smask[(size_t)bi * nbk + kb] == 0 ||
          amask[(size_t)kb * nbn + bj] == 0) {
        continue;
      }
    }
    const int k0 = kb * BK;
    // One warp covers one row of the s tile: coalesced 128-byte reads.
    for (int idx = threadIdx.x; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK;
      const int c = idx % BK;
      s_tile[c][r] = s[(size_t)(row0 + r) * k + (k0 + c)];
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
      const int r = idx / BN;
      const int c = idx % BN;
      a_tile[r][c] = a[(size_t)(k0 + r) * n + (col0 + c)];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float sv[TM];
      float av[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) sv[i] = s_tile[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) av[j] = a_tile[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(sv[i], av[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      out[(size_t)(row0 + ty + i * TY) * n + (col0 + tx + j * TX)] = acc[i][j];
}

bool bad_shape(int m, int k, int n) {
  return m <= 0 || k < 0 || n <= 0 || m % BM || k % BK || n % BN ||
         m / BM > 65535;
}

}  // namespace

extern "C" {

// The block shape the wrappers pad to and coarsen the masks to: {BM, BN, BK}.
void count_mm_block_shape(int* shape) {
  shape[0] = BM;
  shape[1] = BN;
  shape[2] = BK;
}

// out[m, n] = s[m, k] @ a[k, n]; row-major, contiguous, f32, on the device.
// Returns the launch's cudaError_t (0 on success).
int count_mm(const float* s, const float* a, float* out, int m, int k, int n,
             cudaStream_t stream) {
  if (bad_shape(m, k, n)) return (int)cudaErrorInvalidValue;
  const dim3 grid(n / BN, m / BM);
  count_mm_kernel<false><<<grid, THREADS, 0, stream>>>(s, a, out, nullptr,
                                                       nullptr, m, k, n);
  return (int)cudaGetLastError();
}

// As count_mm, skipping every (k-step, output tile) pair whose
// smask[m / BM, k / BK] or amask[k / BK, n / BN] entry (int32) is zero.
int count_mm_masked(const float* s, const float* a, float* out,
                    const int32_t* smask, const int32_t* amask, int m, int k,
                    int n, cudaStream_t stream) {
  if (bad_shape(m, k, n)) return (int)cudaErrorInvalidValue;
  const dim3 grid(n / BN, m / BM);
  count_mm_kernel<true><<<grid, THREADS, 0, stream>>>(s, a, out, smask, amask,
                                                      m, k, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
