// Tropical (min, +) product for Hopper (sm_90a):
//   out[s, j] = min_k d[s, k] + w[k, j],   +inf the identity.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/minplus_mm.py:
//   minplus_mm        (_kernel, pallas_call at :74)
//   minplus_mm_masked (_masked_kernel, pallas_call at :110)
// They carry the multi-source Bellman-Ford (repro.core.queries.
// sssp_batched_dense): one product of the distances d [S, V] against the
// live weights w [V, V] (+inf = no edge) per relax pass.
//
// Exactness.  Each candidate d + w is one IEEE FP32 add, rounded once, and
// min is exact, so no order of reduction changes a value: the kernel equals
// the plain broadcast-and-amin bit for bit.  The source is compiled
// without --use_fast_math, and the add feeds fminf, never a multiply, so
// nothing is contracted.  inf + finite stays inf; weights may be negative
// but are never -inf, so no NaN arises.
//
// Bound.  There is no tensor-core form of (min, +): every (s, k, j) costs
// one FP32 add and one min on the CUDA cores.  At the card's non-FMA FP32
// instruction rate (half of 67 TFLOP/s: 33.5e12 instructions/s on an
// H100 SXM) the least time is 2*S*K*N / 33.5e12 s, about 33 ms at
// S = 2048, K = N = 16384, far above the 0.4 ms its bytes need.
//
// Design.  A shared-memory-tiled SIMT product: one block of 256 threads per
// 128x128 output tile, the k loop inside the block (the TPU's sequential k
// grid axis), a k-step of 16 staged in shared memory, and an 8x8 register
// micro-tile of running minima per thread, read from shared memory as
// float4s (128 add/min per 4 vector loads).  The thread layout, the
// transposed d tile and its padding are those of bool_mm.cu.  The masked
// form reads one dmask[i_blk, k_blk] (the d slab holds a finite entry) and
// one wmask[k_blk, j_blk] (the w block holds a finite entry) per k-step and
// skips the loads and the arithmetic when either is zero; the test is
// uniform across the block.  The accumulator starts at +inf and is always
// written, so a fully skipped tile is +inf, as the dense kernel gives it.

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
minplus_mm_kernel(const float* __restrict__ d, const float* __restrict__ w,
                  float* __restrict__ out, const int32_t* __restrict__ dmask,
                  const int32_t* __restrict__ wmask, int m, int k, int n) {
  __shared__ __align__(16) float d_tile[BK][BM + PAD];  // d_tile[kk][row]
  __shared__ __align__(16) float w_tile[BK][BN];

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
    for (int j = 0; j < TN; ++j) acc[i][j] = __int_as_float(0x7f800000);

  for (int kb = 0; kb < nbk; ++kb) {
    if (kMasked) {
      // Uniform across the block: every thread takes the same branch, so
      // the __syncthreads below stay matched.
      if (dmask[(size_t)bi * nbk + kb] == 0 ||
          wmask[(size_t)kb * nbn + bj] == 0) {
        continue;
      }
    }
    const int k0 = kb * BK;
    for (int idx = threadIdx.x; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK;
      const int c = idx % BK;
      d_tile[c][r] = d[(size_t)(row0 + r) * k + (k0 + c)];
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
      const int r = idx / BN;
      const int c = idx % BN;
      w_tile[r][c] = w[(size_t)(k0 + r) * n + (col0 + c)];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 d0 = *reinterpret_cast<const float4*>(&d_tile[kk][4 * ty]);
      const float4 d1 =
          *reinterpret_cast<const float4*>(&d_tile[kk][BM / 2 + 4 * ty]);
      const float4 w0 = *reinterpret_cast<const float4*>(&w_tile[kk][4 * tx]);
      const float4 w1 =
          *reinterpret_cast<const float4*>(&w_tile[kk][BN / 2 + 4 * tx]);
      const float dv[TM] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      const float wv[TN] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fminf(acc[i][j], __fadd_rn(dv[i], wv[j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float* row = out + (size_t)(row0 + split_index(ty, i, BM / 2)) * n + col0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = make_float4(acc[i][4 * h + 0], acc[i][4 * h + 1],
                                   acc[i][4 * h + 2], acc[i][4 * h + 3]);
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
void minplus_mm_block_shape(int* shape) {
  shape[0] = BM;
  shape[1] = BN;
  shape[2] = BK;
}

// out[m, n] = min_k d[m, k] + w[k, n]; row-major, contiguous, f32, 16-byte
// aligned, on the device.  Returns the launch's cudaError_t (0 on success).
int minplus_mm(const float* d, const float* w, float* out, int m, int k,
               int n, cudaStream_t stream) {
  if (bad_shape(m, k, n)) return (int)cudaErrorInvalidValue;
  const dim3 grid(n / BN, m / BM);
  minplus_mm_kernel<false><<<grid, THREADS, 0, stream>>>(d, w, out, nullptr,
                                                         nullptr, m, k, n);
  return (int)cudaGetLastError();
}

// As minplus_mm, skipping every (k-step, output tile) pair whose
// dmask[m / BM, k / BK] or wmask[k / BK, n / BN] entry (int32) is zero.
int minplus_mm_masked(const float* d, const float* w, float* out,
                      const int32_t* dmask, const int32_t* wmask, int m, int k,
                      int n, cudaStream_t stream) {
  if (bad_shape(m, k, n)) return (int)cudaErrorInvalidValue;
  const dim3 grid(n / BN, m / BM);
  minplus_mm_kernel<true><<<grid, THREADS, 0, stream>>>(d, w, out, dmask,
                                                        wmask, m, k, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
