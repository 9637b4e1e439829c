// Causal GQA flash attention for Hopper (sm_90a), FP32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/flash_attention.py:
//   flash_attention (_kernel, pallas_call at :124)
// It carries the prefill attention of the decoder-only LM
// (repro_torch.models.layers.attention, sq > 1): q [B, Hq, Sq, D] against
// the filled prefix of the KV cache, k/v [B, Hkv, Skv, D].
//
// Function.  out[b, h, i] = sum_j p_ij v[b, h / group, j] with p the softmax
// over the visible keys j of s_ij = scale * q_i . k_j, where j is visible iff
//   j <= i + offs,  j < Skv,  i < Sq,  and (with a window)  j > i + offs - W,
// exactly the masks of the Pallas kernel (:64-66).  offs = Skv - Sq aligns
// the causal mask at the ends; the wrapper passes the reference's padded kv
// length for non-causal attention (:116-117).  The online softmax keeps the
// reference's -inf guards (:69-76) and a row with no visible key ends as 0
// (:80-81).  Inputs are f32 or bf16 (all one type); everything is computed in
// f32 and the output is written in the inputs' type.
//
// Bound.  At the prefill shape of mistral_nemo_12b (B 4, Hq 32, Hkv 8,
// S 2048, D 128) the causal work is 4 * B * Hq * D * S(S+1)/2 = 137 GFLOP
// against about 168 MB of q, k, v and output: 0.14 ms at the bf16 tensor
// rate (989 TFLOP/s), 0.05 ms at 3.35 TB/s.  This first form runs FP32 FMAs
// on the CUDA cores, whose ceiling is 2.05 ms (67 TFLOP/s); wgmma and TMA
// come in a later redesign.
//
// Design.  One block of 256 threads per (b * Hq + h, 64-row query tile); the
// TPU's sequential kv grid axis becomes a loop inside the block over the kv
// tiles from the first to the last one any row of the tile can see, so fully
// masked tiles (above the diagonal, outside the window) are never touched.
// K/V are read through the kv head h / group with the caller's batch, head
// and row strides: no repeated K/V and no copy of the cache prefix.  Per kv
// tile of 64 keys: Q (loaded once), K, then V (in the same buffer) and the
// probabilities P are staged in shared memory as f32, rows padded by one
// float against bank conflicts; each thread owns a 4 x 4 micro-tile of the
// 64 x 64 scores (rows ty + 16 i, columns tx + 16 j) and 4 x D/16 outputs.
// Row max and row sum are reduced over the 16 threads of a half-warp with
// shuffles.  Ragged edges are masked in the kernel: rows past Sq are never
// written, keys past Skv are loaded as zeros and masked to -inf.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per kv tile
constexpr int TX = 16;              // threads across (score columns)
constexpr int TY = 16;              // threads down (score rows)
constexpr int THREADS = TX * TY;    // 256
constexpr int RM = BQ / TY;         // 4 score rows per thread
constexpr int CN = BK / TX;         // 4 score columns per thread
constexpr int PP = BK + 1;          // padded row of P

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int hq, group, sq, skv;
  long long q_sb, q_sh, q_ss;       // element strides of q: batch, head, row
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int offs;                         // causal offset (Skv - Sq, or padded Skv)
  int window;                       // sliding window; 0 = none
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even
}

// Max / sum over the 16 lanes of a half-warp (the threads of one score row).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [r0, r0 + 64) of a [rows, D] matrix with row stride `rs` into
// shared memory (row stride D + 1) as f32; rows at or past `n` are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long rs, int r0, int n) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    const int row = r0 + r;
    dst[r * DP + c] = row < n ? to_f32(src[(long long)row * rs + c]) : 0.0f;
  }
}

template <typename T, int D>
size_t smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + BK) * (D + 1) + (size_t)BQ * PP);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(Params p) {
  constexpr int DP = D + 1;
  constexpr int DC = D / TX;        // output columns per thread
  const float NEG_INF = -__int_as_float(0x7f800000);

  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][DP]
  float* kv = qs + BQ * DP;         // [BK][DP]: K, then V, of one kv tile
  float* ps = kv + BK * DP;         // [BQ][PP]: probabilities of the tile

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  // The longest causal rows first, so the block scheduler ends evenly.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / p.group;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.out) + (long long)bh * p.sq * D;

  load_tile<T, D>(qs, qg, p.q_ss, q0, p.sq);

  // Keys any row of this tile can see: [k_lo, k_hi).
  const int q_last = min(q0 + BQ, p.sq) - 1;
  const int k_hi = min(p.skv, q_last + p.offs + 1);
  const int k_lo = p.window > 0 ? max(0, q0 + p.offs - p.window + 1) : 0;

  float m[RM], l[RM], acc[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // Q is in; the last tile's P and V are read
    load_tile<T, D>(kv, kg, p.k_ss, k0, p.skv);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RM], kk[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = qs[(ty + i * TY) * DP + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kk[j] = kv[(tx + j * TX) * DP + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kk[j], s[i][j]);
    }
    __syncthreads();  // every thread is done with K
    load_tile<T, D>(kv, vg, p.v_ss, k0, p.skv);

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + i * TY;
      const int qpos = q0 + r;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + tx + j * TX;
        bool vis = kpos <= qpos + p.offs && kpos < p.skv && qpos < p.sq;
        if (p.window > 0) vis = vis && kpos > qpos + p.offs - p.window;
        s[i][j] = vis ? s[i][j] * p.scale : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_cur = fmaxf(m[i], row_max(mt));
      const float alpha = m[i] == NEG_INF ? 0.0f : expf(m[i] - m_cur);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float pv = m_cur == NEG_INF ? 0.0f : expf(s[i][j] - m_cur);
        ps[r * PP + tx + j * TX] = pv;
        rs += pv;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_cur;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // V and P are in

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pr[RM], vv[DC];
#pragma unroll
      for (int i = 0; i < RM; ++i) pr[i] = ps[(ty + i * TY) * PP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = kv[kk * DP + tx + c * TX];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qpos = q0 + ty + i * TY;
    if (qpos >= p.sq) continue;
    const float li = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(og + (long long)qpos * D + tx + c * TX, acc[i][c] / li);
  }
}

template <typename T, int D>
int launch(const Params& p, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + BQ - 1) / BQ, b * p.hq);
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const Params& p, int b, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, b, stream);
    case 32: return launch<T, 32>(p, b, stream);
    case 64: return launch<T, 64>(p, b, stream);
    case 128: return launch<T, 128>(p, b, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The tiling the wrapper checks against: {BQ, BK, THREADS}.
void flash_attention_block_shape(int* shape) {
  shape[0] = BQ;
  shape[1] = BK;
  shape[2] = THREADS;
}

// out [B, Hq, Sq, D] (contiguous) = attention of q [B, Hq, Sq, D] over
// k, v [B, Hkv, Skv, D], each given by its batch, head and row strides in
// elements (the last dimension contiguous).  dtype 0 = f32, 1 = bf16 for
// q, k, v and out alike.  window <= 0 means no window.  Returns the
// launch's cudaError_t (0 on success).
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int dtype, int b, int hq, int hkv, int sq, int skv, int d,
                    long long q_sb, long long q_sh, long long q_ss,
                    long long k_sb, long long k_sh, long long k_ss,
                    long long v_sb, long long v_sh, long long v_ss, int offs,
                    int window, float scale, cudaStream_t stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || sq <= 0 || skv <= 0 ||
      (long long)b * hq > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{q,    k,    v,    out,  hq,   hq / hkv, sq,     skv,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,     v_sb,   v_sh,
           v_ss, offs, window > 0 ? window : 0,    scale};
  if (dtype == 0) return dispatch_d<float>(p, b, d, stream);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(p, b, d, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
