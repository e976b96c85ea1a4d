// The backward of the GQA flash attention (flash_attention.cu) for Hopper
// (sm_90a): dq, dk and dv of o = softmax(q k^T / sqrt(D)) v with q
// [B,Sq,Hq,D], k/v [B,Sk,Hkv,D], causal (aligned bottom-right, as the
// forward) or bidirectional. fp32, bf16 and fp16 inputs, fp32 accumulation,
// gradients in the input type.
//
// It replaces no TPU kernel: the reference's training differentiates its
// plain blockwise attention (src/repro/models/layers.py::blockwise_attention)
// with JAX autodiff, and the Pallas forward (flash_attention_pallas) has no
// backward. A plain backward at the training shape (S = 4096) would hold
// [B, S, H, S] fp32 scores, so it is a kernel here.
//
// FlashAttention-2's backward, P recomputed from the forward's row
// log-sum-exp (lse, fp32 [B, Hq, Sq], written by the forward launch):
//   delta = rowsum(dO * O)                     (pre-pass, fp32)
//   P     = exp(S * scale - lse), S = Q K^T
//   dV    = P^T dO,  dP = dO V^T,  dS = P * (dP - delta)
//   dK    = scale * dS^T Q,  dQ = scale * dS K
// Two kernels after the pre-pass, neither with atomics, so a gradient is
// bitwise the same run to run:
//   dk/dv: one block per (batch * kv head, 64 keys); the loop inside the
//     block walks the packed query rows (row = position * G + group, as the
//     forward packs them) of all G query heads of the kv head, from the
//     first row that can see the block's first key, so the GQA sum over G
//     happens in registers;
//   dq:    one block per (batch * kv head, 64 packed rows), looping over the
//     key tiles up to the last one any of its rows sees, as the forward.
// Tiles wholly in the causal future are never visited. Rows past the end,
// keys past Sk and the padding of D (to a multiple of 32 in 16 bits, to
// 32 / 64 / 128 in fp32) are staged as zeros; P is masked to 0 there.
//
// What bounds it on the H100: at the training shape (qwen3-1.7b: B 2,
// S 4096, 16 / 8 heads of 128, causal) the five products over the visible
// pairs are 0.34 TFLOP a call against 202 MB of q, k, v, o, dO, lse and
// gradients: 0.35 ms at the bf16 tensor-core rate against 0.06 ms of bytes,
// so it is bound by operations. This design computes S and dP twice (in
// both kernels), seven products where five would do.
//
// bf16 / fp16: the tensor cores through mma.sync m16n8k16 (fp32
// accumulate), four warps; every operand is read from shared memory by
// ldmatrix (q / dO / k / v tiles in the input type, 16-byte cp.async where
// rows are 16-byte aligned, double-buffered along the loop), and the score
// tiles stay in registers: P and dS become A fragments of the next product
// in registers, rounded to the input type first (the forward rounds P
// before P V the same way). In the dk/dv kernel a warp owns 16 keys and
// computes the transposed tiles S^T = K Q^T and dP^T = V dO^T directly, so
// P^T and dS^T feed dV += P^T dO and dK += dS^T Q without a transpose.
// mma.sync, not wgmma: a simple kernel first (wgmma and TMA come later).
//
// fp32 keeps true fp32 operands, no TF32 (the reference's 2e-6): the same
// blocks on the CUDA cores, 256 threads as 16 x 16, tiles staged in shared
// memory transposed with a pitch of 65 so that both the row and the column
// walks are free of bank conflicts, P^T and dS through shared memory. The
// score and dP dot products over D are carried in fp64 (each product of two
// fp32 values exact), and P and dS are formed in fp64 and rounded once, so
// their error does not grow with D; the gradients' sums over the rows or
// keys are fp32 FMA, a tile's sum first, then added to the total. An fp32
// backward holds the same arithmetic carried in fp64 within 2e-6 that way
// at the training depth, where two fp32 orders of those dot products (the
// plain version's among them) differ by up to 4e-6.

#include "common.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The operands are contiguous [B, S, H, D] tensors: a row of a head is
// (b * S + s) * H + h, D elements long.
__device__ __forceinline__ long long row_off(int b, int s, int S, int H,
                                             int h, int D) {
  return (((long long)b * S + s) * H + h) * D;
}

// ------------------------------------------------------------ pre-pass --

// delta[b, hq, s] = sum_d dO[b, s, hq, d] * O[b, s, hq, d] in fp32: one warp
// a row (b, s, hq), lanes along D, a shuffle reduction.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, int B, int S, int H, int D) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * S * H) return;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc += to_f32(o[row * D + d]) * to_f32(dout[row * D + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bs = row / H;          // b * S + s
    const int s = (int)(bs % S), b = (int)(bs / S);
    delta[((long long)b * H + h) * S + s] = acc;
  }
}

// ---------------------------------------------- fp32 on the CUDA cores --

constexpr int FR = 64;         // packed query rows or keys per tile
constexpr int FP = FR + 1;     // pitch of a transposed tile
constexpr int F_THREADS = 256; // 16 x 16

template <int DMAX>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * (4 * (size_t)DMAX * FP + 2 * (size_t)FR * FP + 2 * FR);
}

// [FR][D] rows of a head, transposed into dst[d * FP + r] (zeros past D,
// and for a null row).
template <int DMAX, typename Src>
__device__ __forceinline__ void stage_t(float* dst, int D, Src src) {
  for (int idx = threadIdx.x; idx < FR * DMAX; idx += F_THREADS) {
    const int r = idx / DMAX, d = idx % DMAX;
    const float* p = src(r);
    dst[d * FP + r] = (p != nullptr && d < D) ? p[d] : 0.f;
  }
}

template <int DMAX>
__global__ void __launch_bounds__(F_THREADS)
flash_bwd_dkdv_fma(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int Sq, int Sk, int Hkv, int G,
                   int D, int causal, float scale) {
  extern __shared__ float smem[];
  float* Kt = smem;                 // [DMAX][FP]: k^T of the block's keys
  float* Vt = Kt + DMAX * FP;
  float* Qt = Vt + DMAX * FP;       // q^T of the tile's packed rows
  float* dOt = Qt + DMAX * FP;
  float* Ps = dOt + DMAX * FP;      // [FR rows][FP]: P of (row, key)
  float* dSs = Ps + FR * FP;        // dS of (row, key)
  float* Ls = dSs + FR * FP;        // the tile's rows' lse
  float* Dl = Ls + FR;              // and delta

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int k0 = blockIdx.y * FR;
  const int Hq = Hkv * G, n_rows = Sq * G, shift = Sk - Sq;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;

  stage_t<DMAX>(Kt, D, [&](int c) -> const float* {
    return k0 + c < Sk ? k + row_off(b, k0 + c, Sk, Hkv, h, D) : nullptr;
  });
  stage_t<DMAX>(Vt, D, [&](int c) -> const float* {
    return k0 + c < Sk ? v + row_off(b, k0 + c, Sk, Hkv, h, D) : nullptr;
  });

  // this thread: keys tr + 16 i of the block; rows tc + 16 j of a tile and
  // columns d = tc + 16 j of dk / dv
  float dka[4][DMAX / 16], dva[4][DMAX / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) dka[i][j] = dva[i][j] = 0.f;

  const int first = causal ? max(0, k0 - shift) * G : 0;
  for (int r0 = first / FR * FR; r0 < n_rows; r0 += FR) {
    __syncthreads();   // the previous tile's reads are done
    auto qrow = [&](const float* base, int r) -> const float* {
      const int row = r0 + r;
      if (row >= n_rows) return nullptr;
      return base + row_off(b, row / G, Sq, Hq, h * G + row % G, D);
    };
    stage_t<DMAX>(Qt, D, [&](int r) { return qrow(q, r); });
    stage_t<DMAX>(dOt, D, [&](int r) { return qrow(dout, r); });
    for (int r = tid; r < FR; r += F_THREADS) {
      const int row = r0 + r;
      const long long at = row < n_rows
          ? ((long long)b * Hq + h * G + row % G) * Sq + row / G : -1;
      Ls[r] = at >= 0 ? lse[at] : 0.f;
      Dl[r] = at >= 0 ? delta[at] : 0.f;
    }
    __syncthreads();

    double s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0;
    for (int d = 0; d < D; ++d) {
      float ka[4], va[4], qb[4], ob[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = Kt[d * FP + tr + 16 * i];
        va[i] = Vt[d * FP + tr + 16 * i];
        qb[i] = Qt[d * FP + tc + 16 * i];
        ob[i] = dOt[d * FP + tc + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fma((double)ka[i], (double)qb[j], s[i][j]);
          dp[i][j] = fma((double)va[i], (double)ob[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tr + 16 * i, r = tc + 16 * j, row = r0 + r;
        const bool ok = row < n_rows && key < Sk &&
                        (!causal || key <= row / G + shift);
        const double p = ok ? exp(s[i][j] * scale - Ls[r]) : 0.0;
        Ps[r * FP + tr + 16 * i] = (float)p;
        dSs[r * FP + tr + 16 * i] = (float)(p * (dp[i][j] - Dl[r]));
      }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over the tile's rows: the tile's sums
    // first, then added to the totals (two levels keep the fp32 rounding of
    // a long sum near a blocked product's)
    float tk[4][DMAX / 16], tv[4][DMAX / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) tk[i][j] = tv[i][j] = 0.f;
    const int n_r = min(FR, n_rows - r0);
    for (int r = 0; r < n_r; ++r) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Ps[r * FP + tr + 16 * i];
        ds[i] = dSs[r * FP + tr + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) {
        const int d = tc + 16 * j;
        const float ov = dOt[d * FP + r], qv = Qt[d * FP + r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tv[i][j] = fmaf(p[i], ov, tv[i][j]);
          tk[i][j] = fmaf(ds[i], qv, tk[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) {
        dva[i][j] += tv[i][j];
        dka[i][j] += tk[i][j];
      }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + tr + 16 * i;
    if (key >= Sk) continue;
    const long long at = row_off(b, key, Sk, Hkv, h, D);
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) {
      const int d = tc + 16 * j;
      if (d < D) {
        dk[at + d] = dka[i][j] * scale;
        dv[at + d] = dva[i][j];
      }
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(F_THREADS)
flash_bwd_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int Sq, int Sk, int Hkv, int G, int D, int causal,
                 float scale) {
  extern __shared__ float smem[];
  float* Qt = smem;                 // [DMAX][FP]: q^T of the block's rows
  float* dOt = Qt + DMAX * FP;
  float* Kt = dOt + DMAX * FP;      // k^T of the tile's keys
  float* Vt = Kt + DMAX * FP;
  float* dSs = Vt + DMAX * FP;      // [FR rows][FP]: dS of (row, key)

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int row0 = blockIdx.y * FR;
  const int Hq = Hkv * G, n_rows = Sq * G, shift = Sk - Sq;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;

  auto qrow = [&](const float* base, int r) -> const float* {
    const int row = row0 + r;
    if (row >= n_rows) return nullptr;
    return base + row_off(b, row / G, Sq, Hq, h * G + row % G, D);
  };
  stage_t<DMAX>(Qt, D, [&](int r) { return qrow(q, r); });
  stage_t<DMAX>(dOt, D, [&](int r) { return qrow(dout, r); });

  // this thread: rows tr + 16 i; keys tc + 16 j of a tile and columns
  // d = tc + 16 j of dq
  int lim[4];
  float lr[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + tr + 16 * i;
    lim[i] = row >= n_rows ? -1 : (causal ? row / G + shift : Sk - 1);
    const long long at = row < n_rows
        ? ((long long)b * Hq + h * G + row % G) * Sq + row / G : -1;
    lr[i] = at >= 0 ? lse[at] : 0.f;
    dl[i] = at >= 0 ? delta[at] : 0.f;
  }
  const int last_row = min(row0 + FR, n_rows) - 1;
  const int kv_end = causal ? min(Sk, last_row / G + shift + 1) : Sk;

  float acc[4][DMAX / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += FR) {
    __syncthreads();   // the previous tile's reads are done (q staged)
    stage_t<DMAX>(Kt, D, [&](int c) -> const float* {
      return k0 + c < Sk ? k + row_off(b, k0 + c, Sk, Hkv, h, D) : nullptr;
    });
    stage_t<DMAX>(Vt, D, [&](int c) -> const float* {
      return k0 + c < Sk ? v + row_off(b, k0 + c, Sk, Hkv, h, D) : nullptr;
    });
    __syncthreads();

    double s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0;
    for (int d = 0; d < D; ++d) {
      float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qt[d * FP + tr + 16 * i];
        oa[i] = dOt[d * FP + tr + 16 * i];
        kb[i] = Kt[d * FP + tc + 16 * i];
        vb[i] = Vt[d * FP + tc + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fma((double)qa[i], (double)kb[j], s[i][j]);
          dp[i][j] = fma((double)oa[i], (double)vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const double p =
            k0 + c <= lim[i] ? exp(s[i][j] * scale - lr[i]) : 0.0;
        dSs[(tr + 16 * i) * FP + c] = (float)(p * (dp[i][j] - dl[i]));
      }
    __syncthreads();

    // dQ += dS K over the tile's keys (the tile's sum first, as above)
    float tq[4][DMAX / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) tq[i][j] = 0.f;
    const int n_c = min(FR, kv_end - k0);
    for (int c = 0; c < n_c; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(tr + 16 * i) * FP + c];
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) {
        const float kv = Kt[(tc + 16 * j) * FP + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) tq[i][j] = fmaf(ds[i], kv, tq[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) acc[i][j] += tq[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + tr + 16 * i;
    if (row >= n_rows) continue;
    float* out = dq + row_off(b, row / G, Sq, Hq, h * G + row % G, D);
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) {
      const int d = tc + 16 * j;
      if (d < D) out[d] = acc[i][j] * scale;
    }
  }
}

// ------------------------------------------ bf16 / fp16 tensor cores --

constexpr int BKV = 64;        // keys per dk/dv block (4 warps x 16)
constexpr int BQ = 32;         // packed query rows per dk/dv tile
constexpr int QR = 64;         // packed query rows per dq block (4 x 16)
constexpr int BK = 64;         // keys per dq tile
constexpr int TC_THREADS = 128;

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16*, float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(__half*, float a, float b) {
  __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ROWS rows of a tile into shared memory (pitch DP + 8): row r's source is
// src(r) (null: zeros), D values, zeros from D to DP.
template <typename T, int DP, int ROWS, typename Src>
__device__ __forceinline__ void stage_rows(T* dst, int D, bool vec, Src src) {
  constexpr int LDS = DP + 8;
  if (vec) {
    constexpr int chunks = DP / 8;
    for (int idx = threadIdx.x; idx < ROWS * chunks; idx += TC_THREADS) {
      const int r = idx / chunks, d = (idx % chunks) * 8;
      const T* p = src(r);
      T* t = dst + r * LDS + d;
      if (p != nullptr && d < D) cp_async_16(t, p + d);
      else *reinterpret_cast<uint4*>(t) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DP; idx += TC_THREADS) {
      const int r = idx / DP, d = idx % DP;
      const T* p = src(r);
      dst[r * LDS + d] = (p != nullptr && d < D) ? p[d] : from_f32<T>(0.f);
    }
  }
}

// Fragments of m16n8k16 from a tile X in shared memory (row pitch LDS):
// the A operand, rows m0..m0+15 x columns k0..k0+15 of X [m][k];
template <int LDS, typename T>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const T* X, int m0,
                                       int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, X + (m0 + lane % 16) * LDS + k0 + (lane / 16) * 8);
}
// the B operand of the n-tiles n0..n0+7 ({b[0], b[1]}) and n0+8..n0+15
// ({b[2], b[3]}) over k0..k0+15, from X [n][k] (B = X^T) ...
template <int LDS, typename T>
__device__ __forceinline__ void b_frag_nk(uint32_t (&b)[4], const T* X,
                                          int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(b, X + (n0 + lane % 8 + (lane / 16) * 8) * LDS + k0 +
                     ((lane / 8) % 2) * 8);
}
// ... or from X [k][n] (B = X)
template <int LDS, typename T>
__device__ __forceinline__ void b_frag_kn(uint32_t (&b)[4], const T* X,
                                          int k0, int n0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(b, X + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * LDS +
                           n0 + (lane / 16) * 8);
}

// c[2 kk], c[2 kk + 1] (C fragments of 16 rows x 16 columns) as the A
// fragment of the next product, rounded to T.
template <typename T>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack2((T*)nullptr, c0[0], c0[1]);
  a[1] = pack2((T*)nullptr, c0[2], c0[3]);
  a[2] = pack2((T*)nullptr, c1[0], c1[1]);
  a[3] = pack2((T*)nullptr, c1[2], c1[3]);
}

template <int DP>
constexpr size_t dkdv_smem_bytes() {
  return 2 * (size_t)(DP + 8) * (2 * BKV + 4 * BQ) + sizeof(float) * 4 * BQ;
}

template <typename T, int DP>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dkdv_tc(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int Sq, int Sk, int Hkv, int G, int D,
                  int causal, float scale, int vec) {
  constexpr int LDS = DP + 8;
  constexpr int KD = DP / 16;
  constexpr int NT = BQ / 8;   // n-tiles of a score tile
  constexpr bool HALF = std::is_same<T, __half>::value;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);     // [BKV][LDS]
  T* Vs = Ks + BKV * LDS;                     // [BKV][LDS]
  T* Qs = Vs + BKV * LDS;                     // [2][BQ][LDS]
  T* dOs = Qs + 2 * BQ * LDS;                 // [2][BQ][LDS]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * LDS);   // [2][BQ]
  float* Dl = Ls + 2 * BQ;                                     // [2][BQ]

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int k0 = blockIdx.y * BKV;
  const int Hq = Hkv * G, n_rows = Sq * G, shift = Sk - Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale_log2 = scale * LOG2E;

  stage_rows<T, DP, BKV>(Ks, D, vec, [&](int c) -> const T* {
    return k0 + c < Sk ? k + row_off(b, k0 + c, Sk, Hkv, h, D) : nullptr;
  });
  stage_rows<T, DP, BKV>(Vs, D, vec, [&](int c) -> const T* {
    return k0 + c < Sk ? v + row_off(b, k0 + c, Sk, Hkv, h, D) : nullptr;
  });
  const int first = (causal ? max(0, k0 - shift) * G : 0) / BQ * BQ;
  const int n_tiles = (n_rows - first + BQ - 1) / BQ;
  auto stage_q = [&](int buf, int r0) {
    auto qrow = [&](const T* base, int r) -> const T* {
      const int row = r0 + r;
      if (row >= n_rows) return nullptr;
      return base + row_off(b, row / G, Sq, Hq, h * G + row % G, D);
    };
    stage_rows<T, DP, BQ>(Qs + buf * BQ * LDS, D, vec,
                          [&](int r) { return qrow(q, r); });
    stage_rows<T, DP, BQ>(dOs + buf * BQ * LDS, D, vec,
                          [&](int r) { return qrow(dout, r); });
    for (int r = threadIdx.x; r < BQ; r += TC_THREADS) {
      const int row = r0 + r;
      const long long at = row < n_rows
          ? ((long long)b * Hq + h * G + row % G) * Sq + row / G : -1;
      Ls[buf * BQ + r] = at >= 0 ? lse[at] * LOG2E : 0.f;
      Dl[buf * BQ + r] = at >= 0 ? delta[at] : 0.f;
    }
  };
  if (n_tiles > 0) stage_q(0, first);
  cp_async_commit();

  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int r0 = first + t * BQ;
    if (t + 1 < n_tiles) {
      stage_q((t + 1) & 1, r0 + BQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + (t & 1) * BQ * LDS;
    const T* dOt = dOs + (t & 1) * BQ * LDS;
    const float* Lt = Ls + (t & 1) * BQ;
    const float* Dt = Dl + (t & 1) * BQ;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x BQ rows
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t ka[4], va[4];
      a_frag<LDS>(ka, Ks, warp * 16, kd * 16);
      a_frag<LDS>(va, Vs, warp * 16, kd * 16);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t bq[4], bo[4];
        b_frag_nk<LDS>(bq, Qt, jp * 16, kd * 16);
        b_frag_nk<LDS>(bo, dOt, jp * 16, kd * 16);
        const uint32_t q0[2] = {bq[0], bq[1]}, q1[2] = {bq[2], bq[3]};
        const uint32_t o0[2] = {bo[0], bo[1]}, o1[2] = {bo[2], bo[3]};
        mma_16816<HALF>(s[2 * jp], ka, q0);
        mma_16816<HALF>(s[2 * jp + 1], ka, q1);
        mma_16816<HALF>(dp[2 * jp], va, o0);
        mma_16816<HALF>(dp[2 * jp + 1], va, o1);
      }
    }

    // P^T and dS^T = P^T * (dP^T - delta), element (key, row)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + warp * 16 + lane / 4 + 8 * (e >> 1);
        const int r = 8 * j + 2 * (lane % 4) + (e & 1), row = r0 + r;
        const bool ok = row < n_rows && key < Sk &&
                        (!causal || key <= row / G + shift);
        const float p = ok ? exp2f(s[j][e] * scale_log2 - Lt[r]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - Dt[r]);
      }

    // dV += P^T dO and dK += dS^T Q, 16 rows per k-step
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t pa[4], da[4];
      c_to_a<T>(pa, s[2 * kk], s[2 * kk + 1]);
      c_to_a<T>(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int jp = 0; jp < KD; ++jp) {
        uint32_t bo[4], bq[4];
        b_frag_kn<LDS>(bo, dOt, kk * 16, jp * 16);
        b_frag_kn<LDS>(bq, Qt, kk * 16, jp * 16);
        const uint32_t o0[2] = {bo[0], bo[1]}, o1[2] = {bo[2], bo[3]};
        const uint32_t q0[2] = {bq[0], bq[1]}, q1[2] = {bq[2], bq[3]};
        mma_16816<HALF>(dva[2 * jp], pa, o0);
        mma_16816<HALF>(dva[2 * jp + 1], pa, o1);
        mma_16816<HALF>(dka[2 * jp], da, q0);
        mma_16816<HALF>(dka[2 * jp + 1], da, q1);
      }
    }
    __syncthreads();   // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + lane / 4 + 8 * i;
    if (key >= Sk) continue;
    const long long at = row_off(b, key, Sk, Hkv, h, D);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * (lane % 4) + e;
        if (d < D) {
          dk[at + d] = from_f32<T>(dka[j][2 * i + e] * scale);
          dv[at + d] = from_f32<T>(dva[j][2 * i + e]);
        }
      }
  }
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  return 2 * (size_t)(DP + 8) * (2 * QR + 4 * BK);
}

template <typename T, int DP>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_tc(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int Sq, int Sk, int Hkv, int G, int D,
                int causal, float scale, int vec) {
  constexpr int LDS = DP + 8;
  constexpr int KD = DP / 16;
  constexpr bool HALF = std::is_same<T, __half>::value;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);     // [QR][LDS]
  T* dOs = Qs + QR * LDS;                     // [QR][LDS]
  T* Ks = dOs + QR * LDS;                     // [2][BK][LDS]
  T* Vs = Ks + 2 * BK * LDS;                  // [2][BK][LDS]

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int row0 = blockIdx.y * QR;
  const int Hq = Hkv * G, n_rows = Sq * G, shift = Sk - Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale_log2 = scale * LOG2E;

  const int last_row = min(row0 + QR, n_rows) - 1;
  const int kv_end = causal ? min(Sk, last_row / G + shift + 1) : Sk;
  const int n_tiles = (kv_end + BK - 1) / BK;

  auto qrow = [&](const T* base, int r) -> const T* {
    const int row = row0 + r;
    if (row >= n_rows) return nullptr;
    return base + row_off(b, row / G, Sq, Hq, h * G + row % G, D);
  };
  stage_rows<T, DP, QR>(Qs, D, vec, [&](int r) { return qrow(q, r); });
  stage_rows<T, DP, QR>(dOs, D, vec, [&](int r) { return qrow(dout, r); });
  auto stage_kv = [&](int buf, int c0) {
    stage_rows<T, DP, BK>(Ks + buf * BK * LDS, D, vec, [&](int c) -> const T* {
      return c0 + c < Sk ? k + row_off(b, c0 + c, Sk, Hkv, h, D) : nullptr;
    });
    stage_rows<T, DP, BK>(Vs + buf * BK * LDS, D, vec, [&](int c) -> const T* {
      return c0 + c < Sk ? v + row_off(b, c0 + c, Sk, Hkv, h, D) : nullptr;
    });
  };
  if (n_tiles > 0) stage_kv(0, 0);
  cp_async_commit();

  // this thread's two rows of the warp's 16: lane / 4 and lane / 4 + 8
  int lim[2];
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + lane / 4 + 8 * i;
    lim[i] = row >= n_rows ? -1 : (causal ? row / G + shift : Sk - 1);
    const long long at = row < n_rows
        ? ((long long)b * Hq + h * G + row % G) * Sq + row / G : -1;
    l2[i] = at >= 0 ? lse[at] * LOG2E : 0.f;
    dl[i] = at >= 0 ? delta[at] : 0.f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * BK;
    if (t + 1 < n_tiles) {
      stage_kv((t + 1) & 1, c0 + BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + (t & 1) * BK * LDS;
    const T* Vt = Vs + (t & 1) * BK * LDS;

    // S = Q K^T and dP = dO V^T: the warp's 16 rows x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qa[4], oa[4];
      a_frag<LDS>(qa, Qs, warp * 16, kd * 16);
      a_frag<LDS>(oa, dOs, warp * 16, kd * 16);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bk[4], bv[4];
        b_frag_nk<LDS>(bk, Kt, jp * 16, kd * 16);
        b_frag_nk<LDS>(bv, Vt, jp * 16, kd * 16);
        const uint32_t k0f[2] = {bk[0], bk[1]}, k1f[2] = {bk[2], bk[3]};
        const uint32_t v0f[2] = {bv[0], bv[1]}, v1f[2] = {bv[2], bv[3]};
        mma_16816<HALF>(s[2 * jp], qa, k0f);
        mma_16816<HALF>(s[2 * jp + 1], qa, k1f);
        mma_16816<HALF>(dp[2 * jp], oa, v0f);
        mma_16816<HALF>(dp[2 * jp + 1], oa, v1f);
      }
    }

    // dS = P * (dP - delta), P = exp(S * scale - lse)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, key = c0 + 8 * j + 2 * (lane % 4) + (e & 1);
        const float p =
            key <= lim[i] ? exp2f(s[j][e] * scale_log2 - l2[i]) : 0.f;
        dp[j][e] = p * (dp[j][e] - dl[i]);
      }

    // dQ += dS K, 16 keys per k-step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da[4];
      c_to_a<T>(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int jp = 0; jp < KD; ++jp) {
        uint32_t bk[4];
        b_frag_kn<LDS>(bk, Kt, kk * 16, jp * 16);
        const uint32_t k0f[2] = {bk[0], bk[1]}, k1f[2] = {bk[2], bk[3]};
        mma_16816<HALF>(acc[2 * jp], da, k0f);
        mma_16816<HALF>(acc[2 * jp + 1], da, k1f);
      }
    }
    __syncthreads();   // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + lane / 4 + 8 * i;
    if (row >= n_rows) continue;
    T* out = dq + row_off(b, row / G, Sq, Hq, h * G + row % G, D);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * (lane % 4) + e;
        if (d < D) out[d] = from_f32<T>(acc[j][2 * i + e] * scale);
      }
  }
}

// ------------------------------------------------------------ launches --

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, Hkv, G, D, causal, vec;
  float scale;
};

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int launch_delta(const Args& a, cudaStream_t s) {
  const int H = a.Hkv * a.G;
  const long long rows = (long long)a.B * a.Sq * H;
  flash_bwd_delta<T><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta,
      a.B, a.Sq, H, a.D);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_fma(const Args& a, cudaStream_t s) {
  static bool sized = false;   // the attributes once per instantiation
  const size_t smem = fma_smem_bytes<DMAX>();
  cudaError_t e;
  if (!sized) {
    if ((e = set_smem(flash_bwd_dkdv_fma<DMAX>, smem)) != cudaSuccess ||
        (e = set_smem(flash_bwd_dq_fma<DMAX>, smem)) != cudaSuccess)
      return (int)e;
    sized = true;
  }
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v),
              *dout = static_cast<const float*>(a.dout);
  flash_bwd_dkdv_fma<DMAX><<<dim3(a.B * a.Hkv, (a.Sk + FR - 1) / FR),
                              F_THREADS, smem, s>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.Sq, a.Sk, a.Hkv, a.G, a.D, a.causal,
      a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_dq_fma<DMAX><<<dim3(a.B * a.Hkv, (a.Sq * a.G + FR - 1) / FR),
                            F_THREADS, smem, s>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq), a.Sq, a.Sk,
      a.Hkv, a.G, a.D, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_tc(const Args& a, cudaStream_t s) {
  static bool sized = false;   // the attributes once per instantiation
  cudaError_t e;
  if (!sized) {
    if ((e = set_smem(flash_bwd_dkdv_tc<T, DP>, dkdv_smem_bytes<DP>())) !=
            cudaSuccess ||
        (e = set_smem(flash_bwd_dq_tc<T, DP>, dq_smem_bytes<DP>())) !=
            cudaSuccess)
      return (int)e;
    sized = true;
  }
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v),
          *dout = static_cast<const T*>(a.dout);
  flash_bwd_dkdv_tc<T, DP><<<dim3(a.B * a.Hkv, (a.Sk + BKV - 1) / BKV),
                             TC_THREADS, dkdv_smem_bytes<DP>(), s>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.Sq, a.Sk, a.Hkv, a.G, a.D, a.causal, a.scale,
      a.vec);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_dq_tc<T, DP><<<dim3(a.B * a.Hkv, (a.Sq * a.G + QR - 1) / QR),
                           TC_THREADS, dq_smem_bytes<DP>(), s>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.Sq, a.Sk,
      a.Hkv, a.G, a.D, a.causal, a.scale, a.vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_tc(const Args& a, cudaStream_t s) {
  int e = launch_delta<T>(a, s);
  if (e != 0) return e;
  // D padded to a multiple of 32 (the staging zero-fills the pad): half
  // the instantiations of the forward's multiples of 16, which keeps this
  // source's build, the longest of the port's, near the others'
  switch ((a.D + 31) / 32) {
    case 1: return launch_tc<T, 32>(a, s);
    case 2: return launch_tc<T, 64>(a, s);
    case 3: return launch_tc<T, 96>(a, s);
    case 4: return launch_tc<T, 128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_fma(const Args& a, cudaStream_t s) {
  int e = launch_delta<float>(a, s);
  if (e != 0) return e;
  if (a.D <= 32) return launch_fma<32>(a, s);
  if (a.D <= 64) return launch_fma<64>(a, s);
  return launch_fma<128>(a, s);
}

}  // namespace

// dq [B,Sq,Hkv*G,D], dk / dv [B,Sk,Hkv,D] of o = attention(q, k, v) given
// dout (dO, o's shape) and the forward's lse (fp32 [B, Hkv*G, Sq]). Every
// tensor is contiguous; delta is fp32 scratch of lse's shape. causal:
// bottom-right mask (needs Sq <= Sk). dtype: 0 fp32, 1 bf16, 2 fp16.
// Launches the delta pre-pass, the dk/dv kernel and the dq kernel on
// `stream` in that order. Returns the first failing cudaError_t (0 on
// success); never synchronises.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int Hkv, int G,
                                   int D, int causal, int dtype,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || G <= 0 || D <= 0 ||
      D > 128 || (causal && Sq > Sk) || (long long)Sq * G > 65535LL * QR ||
      Sk > 65535LL * BKV)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dout) % 16 == 0;
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse),
               static_cast<float*>(delta), dq, dk, dv, B, Sq, Sk, Hkv, G, D,
               causal, (int)vec, 1.0f / sqrtf((float)D)};
  switch (dtype) {
    case 0: return dispatch_fma(a, s);
    case 1: return dispatch_tc<__nv_bfloat16>(a, s);
    case 2: return dispatch_tc<__half>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
