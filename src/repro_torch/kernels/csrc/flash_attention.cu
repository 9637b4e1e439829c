// Causal GQA flash attention for Hopper (sm_90a).
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
// (:80-81).  Inputs are f32 or bf16 (all one type); scores, softmax and the
// output sum are f32, and the output is written in the inputs' type.
//
// Bound.  At the prefill shape of mistral_nemo_12b (B 4, Hq 32, Hkv 8,
// S 2048, D 128) the causal work is 4 * B * Hq * D * S(S+1)/2 = 137 GFLOP
// against about 168 MB of q, k, v and output: 0.14 ms at the bf16 tensor
// rate (989 TFLOP/s), 0.05 ms at 3.35 TB/s.  The two-term P below costs
// 6 D operations per visible pair, so this design's own ceiling is 0.21 ms.
//
// Two bodies, chosen by the inputs' dtype inside the one C entry point (a
// dispatch, not a fallback: a bf16 call never reaches the f32 body).
//
// bf16 (the served dtype; the only one the LM path sends): flash_wgmma.
// * Work split.  One CTA per (b * Hq + h, 128 query rows), the longest
//   causal rows first; 288 threads: warpgroups 0 and 1 each own 64 query
//   rows, and one thread of the producer warp after them starts the TMA
//   loads.
// * Loads.  Q once, then K and V tiles of 64 keys into a 3-stage ring with
//   full (K and V apart) and empty mbarriers.  The tensor maps are 4-D
//   (D, S, H, B) over the caller's real strides, so the cache prefix is
//   read in place; the wrapper refuses a base or stride TMA cannot take
//   (16 bytes).  Rows past Sq or Skv, and columns past D, load as zeros:
//   a head dim below 64 runs as 64 with zero columns.  Tiles that no row of
//   the CTA can see are never loaded; a consumer skips the products of a
//   tile none of its 64 rows can see.
// * S = Q K^T.  wgmma m64n64k16, Q and K from shared memory (K-major), into
//   32 f32 accumulators per thread.
// * Online softmax in registers on the accumulator fragment, in the base-2
//   domain (scale * log2 e folded in): row max over the four lanes of a
//   quad, the reference's -inf guards, a per-thread partial row sum reduced
//   over the quad at the end.  Only tiles that cross the diagonal, the
//   window's edge or Skv are masked.
// * P V.  P is split into p_hi (p truncated to bf16) and p_lo = bf16(p -
//   p_hi); both go through wgmma m64nDk16 from registers (the accumulator
//   fragment of S is the A fragment, no shuffles) against V in shared
//   memory (N-major), into one f32 accumulator.  P keeps about 16 bits, as
//   the reference's f32 P does; one bf16 P would cost 2^-9 relative, which
//   near-zero outputs cannot hold to the tolerance.
// * Pipeline.  Within a consumer, S of tile t + 1 and P V of tile t are in
//   flight together and the softmax of t + 1 runs while P V of t is on the
//   tensor cores.  Tiles are 64 keys: a thread gets at most 168 registers
//   here, which hold the output (64), S (32) and the two P terms (32) of a
//   64-key tile; a 128-key tile spilled registers and ran slower on the
//   card, and a 224-register cap did not launch.
//
// f32: flash_simt, the FP32 SIMT body of the port's first form.  Tensor
// cores cannot hold f32 inputs to 3e-5 and no served path sends f32.  One
// block of 256 threads per (b * Hq + h, 64-row query tile), a loop over the
// visible kv tiles of 64 keys, Q, K, V and P staged in shared memory as f32
// (rows padded by one float), a 4 x 4 micro-tile of scores per thread, row
// max and sum over half-warps with shuffles.

#include <cuda_bf16.h>

#include <cmath>

#include "hopper.cuh"

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
  int d;                            // head dim
};

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
// shared memory (row stride D + 1); rows at or past `n` are zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long rs, int r0, int n) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    const int row = r0 + r;
    dst[r * DP + c] = row < n ? src[(long long)row * rs + c] : 0.0f;
  }
}

template <int D>
size_t simt_smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + BK) * (D + 1) + (size_t)BQ * PP);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_simt(Params p) {
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

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* og = static_cast<float*>(p.out) + (long long)bh * p.sq * D;

  load_tile<D>(qs, qg, p.q_ss, q0, p.sq);

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
    load_tile<D>(kv, kg, p.k_ss, k0, p.skv);
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
    load_tile<D>(kv, vg, p.v_ss, k0, p.skv);

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
      og[(long long)qpos * D + tx + c * TX] = acc[i][c] / li;
  }
}


template <int D>
int launch_simt(const Params& p, int b, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_simt<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + BQ - 1) / BQ, b * p.hq);
  flash_simt<D><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ------------------------------ bf16: wgmma -------------------------------

constexpr int WQ = 128;              // query rows per CTA
constexpr int WSTAGES = 3;           // K/V ring depth
constexpr int WK = 64;               // keys per kv tile
constexpr int WTHREADS = 288;        // two consumer warpgroups + a producer warp
constexpr int PANEL_Q = WQ * 128;    // bytes of a [128 rows][64] bf16 panel

// DP: the head dim as the kernel runs it (64 or 128).
template <int DP>
struct WCfg {
  static constexpr int kPanels = DP / 64;
  static constexpr int kPanelK = WK * 128;  // bytes of a [64 keys][64] panel
  static constexpr int kQBytes = kPanels * PANEL_Q;
  static constexpr int kKBytes = kPanels * kPanelK;  // one K or V tile
  static constexpr int kStageBytes = 2 * kKBytes;
  static constexpr size_t kSmem = (size_t)kQBytes + WSTAGES * kStageBytes +
                                  1024 + (1 + 3 * WSTAGES) * sizeof(uint64_t);
};

// The kv tiles [t0, t1) holding a key that some row in [r0, r1] can see.
__device__ __forceinline__ void key_tiles(const Params& p, int r0, int r1,
                                          int& t0, int& t1) {
  const int k_hi = min(p.skv, r1 + p.offs + 1);
  const int k_lo = p.window > 0 ? max(0, r0 + p.offs - p.window + 1) : 0;
  t0 = k_lo / WK;
  t1 = k_hi > k_lo ? (k_hi + WK - 1) / WK : t0;
}

// Two f32 into one register of two bf16 (the first in the low half): p_hi
// truncated, and p_lo = p - p_hi rounded.
__device__ __forceinline__ void split_pair(float e0, float e1, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t h0 = __float_as_uint(e0) & 0xFFFF0000u;
  const uint32_t h1 = __float_as_uint(e1) & 0xFFFF0000u;
  hi = (h0 >> 16) | h1;
  __nv_bfloat162 l2 = __floats2bfloat162_rn(e0 - __uint_as_float(h0),
                                            e1 - __uint_as_float(h1));
  lo = *reinterpret_cast<uint32_t*>(&l2);
}

template <int DP>
__device__ __forceinline__ void pv_wgmma(float (&o)[DP / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DP == 128)
    hopper::wgmma_m64n128k16_rs<1>(o, a, db);
  else
    hopper::wgmma_m64n64k16_rs<1>(o, a, db);
}

// Start o += (p_hi + p_lo) V for the V tile at shared address vs (not
// committed): per k-slice of 16 keys, p_hi then p_lo.
template <int DP>
__device__ __forceinline__ void start_pv(float (&o)[DP / 2],
                                         const uint32_t (&ph)[WK / 16][4],
                                         const uint32_t (&pl)[WK / 16][4],
                                         uint32_t vs) {
  hopper::wgmma_fence();
#pragma unroll
  for (int s16 = 0; s16 < WK / 16; ++s16) {
    const uint64_t db = hopper::desc_sw128(vs + s16 * 2048, WK * 128, 1024);
    pv_wgmma<DP>(o, ph[s16], db);
    pv_wgmma<DP>(o, pl[s16], db);
  }
}

// Rows a and b of the output so far, scaled to a new row max.
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float alpha_a,
                                        float alpha_b) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    o[4 * i] *= alpha_a;
    o[4 * i + 1] *= alpha_a;
    o[4 * i + 2] *= alpha_b;
    o[4 * i + 3] *= alpha_b;
  }
}

// The rows of a consumer thread: the accumulator rows row_a (d[4 j + 0..1])
// and row_a + 8 (d[4 j + 2..3]) of the group starting at r0, its lane in
// the quad, and the score scale in the base-2 domain.
struct Rows {
  int r0, row_a, qd;
  float sl2;
};

// The online softmax of one thread's two rows (max and partial sum in the
// base-2 domain, with the reference's -inf guards).
struct Softmax {
  float m_a = -INFINITY, m_b = -INFINITY;
  float l_a = 0.0f, l_b = 0.0f;
  float alpha_a = 0.0f, alpha_b = 0.0f;  // the rescale the tile asks for

  // Scores of the kv tile at k0 -> probabilities, in place.  Only a tile
  // that crosses the diagonal, Skv or the window's edge for some row of the
  // group is masked.
  __device__ __forceinline__ void tile(float (&s)[WK / 2], const Params& p,
                                       const Rows& r, int k0) {
    const float NEG_INF = -__int_as_float(0x7f800000);
    const bool edge = k0 + WK - 1 > r.r0 + p.offs || k0 + WK > p.skv ||
                      (p.window > 0 && k0 <= r.r0 + 63 + p.offs - p.window);
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int j = 0; j < WK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * r.sl2;
        if (edge) {
          const int col = k0 + 8 * j + 2 * r.qd + (e & 1);
          const int row = e < 2 ? r.row_a : r.row_a + 8;
          bool vis = col <= row + p.offs && col < p.skv;
          if (p.window > 0) vis = vis && col > row + p.offs - p.window;
          if (!vis) x = NEG_INF;
        }
        s[4 * j + e] = x;
        if (e < 2)
          mx_a = fmaxf(mx_a, x);
        else
          mx_b = fmaxf(mx_b, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    alpha_a = m_a == NEG_INF ? 0.0f : exp2f(m_a - mn_a);
    alpha_b = m_b == NEG_INF ? 0.0f : exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float rs_a = 0.0f, rs_b = 0.0f;
#pragma unroll
    for (int j = 0; j < WK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn_a : mn_b;
        const float pv = mn == NEG_INF ? 0.0f : exp2f(s[4 * j + e] - mn);
        s[4 * j + e] = pv;
        if (e < 2)
          rs_a += pv;
        else
          rs_b += pv;
      }
    }
    l_a = l_a * alpha_a + rs_a;
    l_b = l_b * alpha_b + rs_b;
  }
};

// P (f32, the accumulator fragment of S) as the A fragments of the four
// k-slices of 16 keys, twice: p_hi and p_lo.
__device__ __forceinline__ void pack_p(const float (&s)[WK / 2],
                                       uint32_t (&ph)[WK / 16][4],
                                       uint32_t (&pl)[WK / 16][4]) {
#pragma unroll
  for (int s16 = 0; s16 < WK / 16; ++s16)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int e = 4 * (2 * s16 + half) + 2 * rr;
        split_pair(s[e], s[e + 1], ph[s16][2 * half + rr],
                   pl[s16][2 * half + rr]);
      }
}

// Start S = Q K^T of one kv tile into fresh accumulators (the first
// product overwrites them; not committed).
template <int DP>
__device__ __forceinline__ void start_s(float (&s)[WK / 2], uint32_t qbase,
                                        uint32_t ks) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint64_t da = hopper::desc_sw128(
        qbase + (kk / 4) * PANEL_Q + (kk % 4) * 32, 16, 1024);
    const uint64_t db = hopper::desc_sw128(
        ks + (kk / 4) * (WK * 128) + (kk % 4) * 32, 16, 1024);
    hopper::wgmma_m64n64k16_ss<0>(s, da, db, kk > 0);
  }
}

template <int DP>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, Params p) {
  using C = WCfg<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* kv = qs + C::kQBytes;     // stage s: K, then V, of one kv tile
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv + WSTAGES *
                                                 C::kStageBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + WSTAGES;
  uint64_t* empty = v_full + WSTAGES;

  // The warpgroup index through a shuffle, so that the compiler sees it
  // (and all that follows from it) as uniform across the warp: a wgmma on a
  // path it cannot prove uniform is serialized.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  // The longest causal rows first, so the CTA scheduler ends evenly.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * WQ;
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / p.group;
  int t0, t1;
  key_tiles(p, q0, min(q0 + WQ, p.sq) - 1, t0, t1);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < WSTAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp
    if (tid != 0) return;
    hopper::mbar_expect_tx(q_full, C::kQBytes);
    for (int pn = 0; pn < C::kPanels; ++pn)
      hopper::tma_load_4d(qs + pn * PANEL_Q, &tq, q_full, pn * 64, q0, h, b);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = t0; t < t1; ++t) {
      hopper::mbar_wait(&empty[stage], phase ^ 1);
      uint8_t* ks = kv + stage * C::kStageBytes;
      hopper::mbar_expect_tx(&k_full[stage], C::kKBytes);
      for (int pn = 0; pn < C::kPanels; ++pn)
        hopper::tma_load_4d(ks + pn * C::kPanelK, &tk, &k_full[stage],
                            pn * 64, t * WK, hk, b);
      hopper::mbar_expect_tx(&v_full[stage], C::kKBytes);
      for (int pn = 0; pn < C::kPanels; ++pn)
        hopper::tma_load_4d(ks + C::kKBytes + pn * C::kPanelK, &tv,
                            &v_full[stage], pn * 64, t * WK, hk, b);
      if (++stage == WSTAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // Consumer warpgroup c owns query rows r0 .. r0 + 63.  Its tiles are
  // pipelined: S of tile t + 1 and P V of tile t are in flight together,
  // and the softmax of t + 1 runs while P V of t is still on the tensor
  // cores (it touches neither the output nor P of t).
  const int c = wg;
  const int r0 = q0 + 64 * c;
  const Rows rows{r0, r0 + (tid / 32) * 16 + (tid % 32) / 4, tid % 4,
                  p.scale * 1.4426950408889634f};  // scale * log2(e)
  int lo = t1, hi = t1;  // the tiles [lo, hi) some row of this group sees
  if (r0 < p.sq) {
    int my_t0, my_t1;
    key_tiles(p, r0, min(r0 + 63, p.sq - 1), my_t0, my_t1);
    lo = max(t0, my_t0);
    hi = max(lo, min(t1, my_t1));
  }

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float sacc[WK / 2];
  uint32_t ph[WK / 16][4], pl[WK / 16][4];
  Softmax sm;
  const uint32_t qbase = hopper::smem_u32(qs) + c * (PANEL_Q / 2);
  const uint32_t kv0 = hopper::smem_u32(kv);

  int stage = 0;
  uint32_t phase = 0;
  auto advance = [&] {
    if (++stage == WSTAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  // A tile no row of this group sees: released once it has landed.
  auto pass = [&] {
    hopper::mbar_wait(&k_full[stage], phase);
    hopper::mbar_wait(&v_full[stage], phase);
    if (tid == 0) hopper::mbar_arrive(&empty[stage]);
    advance();
  };

  hopper::mbar_wait(q_full, 0);
  for (int t = t0; t < lo; ++t) pass();
  if (lo < hi) {
    hopper::mbar_wait(&k_full[stage], phase);
    start_s<DP>(sacc, qbase, kv0 + stage * C::kStageBytes);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    sm.tile(sacc, p, rows, lo * WK);
    pack_p(sacc, ph, pl);  // o is zero: no rescale
    // Steady state: S of t + 1, then P V of t; the softmax of t + 1 while
    // P V of t runs.  The last tile's P V follows the loop.
    for (int t = lo; t + 1 < hi; ++t) {
      const int ns = stage + 1 == WSTAGES ? 0 : stage + 1;
      hopper::mbar_wait(&k_full[ns], ns == 0 ? phase ^ 1 : phase);
      start_s<DP>(sacc, qbase, kv0 + ns * C::kStageBytes);
      hopper::wgmma_commit();
      hopper::mbar_wait(&v_full[stage], phase);
      start_pv<DP>(o, ph, pl, kv0 + stage * C::kStageBytes + C::kKBytes);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // S of t + 1 is done, P V of t may not be
      hopper::fence_regs(sacc);
      sm.tile(sacc, p, rows, (t + 1) * WK);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      if (tid == 0) hopper::mbar_arrive(&empty[stage]);
      advance();
      rescale(o, sm.alpha_a, sm.alpha_b);
      pack_p(sacc, ph, pl);
    }
    hopper::mbar_wait(&v_full[stage], phase);
    start_pv<DP>(o, ph, pl, kv0 + stage * C::kStageBytes + C::kKBytes);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    if (tid == 0) hopper::mbar_arrive(&empty[stage]);
    advance();
  }
  for (int t = hi; t < t1; ++t) pass();

  float l_a = sm.l_a, l_b = sm.l_b;
  const int row_a = rows.row_a, row_b = rows.row_a + 8, qd = rows.qd;
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float la = l_a == 0.0f ? 1.0f : l_a;
  const float lb = l_b == 0.0f ? 1.0f : l_b;
  __nv_bfloat16* og =
      static_cast<__nv_bfloat16*>(p.out) + (long long)bh * p.sq * p.d;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = 8 * i + 2 * qd;
    if (col >= p.d) continue;
    if (row_a < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)row_a * p.d + col) =
          __floats2bfloat162_rn(o[4 * i] / la, o[4 * i + 1] / la);
    if (row_b < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)row_b * p.d + col) =
          __floats2bfloat162_rn(o[4 * i + 2] / lb, o[4 * i + 3] / lb);
  }
}

template <int DP>
int launch_wgmma(const Params& p, int b, int hkv, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const uint64_t qdims[4] = {(uint64_t)p.d, (uint64_t)p.sq, (uint64_t)p.hq,
                             (uint64_t)b};
  const uint64_t kdims[4] = {(uint64_t)p.d, (uint64_t)p.skv, (uint64_t)hkv,
                             (uint64_t)b};
  const uint64_t qstr[3] = {2ull * p.q_ss, 2ull * p.q_sh, 2ull * p.q_sb};
  const uint64_t kstr[3] = {2ull * p.k_ss, 2ull * p.k_sh, 2ull * p.k_sb};
  const uint64_t vstr[3] = {2ull * p.v_ss, 2ull * p.v_sh, 2ull * p.v_sb};
  if (!hopper::make_map_bf16(&tq, p.q, 4, qdims, qstr, WQ) ||
      !hopper::make_map_bf16(&tk, p.k, 4, kdims, kstr, WK) ||
      !hopper::make_map_bf16(&tv, p.v, 4, kdims, vstr, WK))
    return (int)cudaErrorInvalidValue;
  using C = WCfg<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + WQ - 1) / WQ, b * p.hq);
  flash_wgmma<DP><<<grid, WTHREADS, C::kSmem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The f32 body's tiling, which the wrapper checks: {BQ, BK, THREADS}.
void flash_attention_block_shape(int* shape) {
  shape[0] = BQ;
  shape[1] = BK;
  shape[2] = THREADS;
}

// out [B, Hq, Sq, D] (contiguous) = attention of q [B, Hq, Sq, D] over
// k, v [B, Hkv, Skv, D], each given by its batch, head and row strides in
// elements (the last dimension contiguous).  dtype 0 = f32 (the SIMT
// body), 1 = bf16 (the wgmma body; base and strides multiples of 16
// bytes) for q, k, v and out alike.  window <= 0 means no window.
// Returns the launch's cudaError_t (0 on success).
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
           v_ss, offs, window > 0 ? window : 0,    scale,  d};
  if (dtype == 0) {
    switch (d) {
      case 16: return launch_simt<16>(p, b, stream);
      case 32: return launch_simt<32>(p, b, stream);
      case 64: return launch_simt<64>(p, b, stream);
      case 128: return launch_simt<128>(p, b, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (d) {
      case 16:
      case 32:
      case 64: return launch_wgmma<64>(p, b, hkv, stream);
      case 128: return launch_wgmma<128>(p, b, hkv, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
