// Causal or bidirectional GQA flash attention for Hopper (sm_90a): the
// dense-cache engine's prefill attention.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _flash_kernel): o = softmax(q k^T / sqrt(D)) v with q [B,Sq,Hq,D],
// k/v [B,Sk,Hkv,D], the G = Hq/Hkv query heads of one kv head packed into
// the rows of a block, fp32 online softmax (m, l, acc), tiles wholly in the
// causal future skipped, the diagonal tile masked, rows with l == 0 guarded.
// fp32, bf16 and fp16 inputs; output in the input type.
//
// The causal mask is aligned bottom-right: key j is visible to query i when
// j <= i + (Sk - Sq), the mask of a prompt chunk at start Sk - Sq over the
// cache prefix [0, Sk). With Sq == Sk it is the Pallas kernel's mask.
// Any D <= 128; the scale is 1 / sqrt(D) of the true D.
//
// The device-start entry: with `start` (an int32 on the card) the chunk's
// queries sit at [*start, *start + Sq) of a cache of Sk rows, so k/v are
// the whole cache layer and the kernel reads only [0, *start + Sq): every
// bound that the host-start launch takes from Sk it takes from
// kv_len = min(Sk, *start + Sq), so the output is bitwise that of the
// host-start launch on the prefix k[:, :*start + Sq]. The grid does not
// depend on the start, so one CUDA graph serves a chunk at any start.
//
// What bounds it on the H100. At the engine's prefill chunks (llama3-8b:
// 256 queries over 256 keys, 44 over 300, 32 / 8 heads, D = 128; zamba2-2.7b:
// 512 over 512, 88 over 600, 32 / 32 heads, D = 80; bf16) the function is
// bound by its bytes and by latency: 5.2 MB of q/k/v/o at llama3's 256 x 256
// (1.6 us at 3.35 TB/s) against 0.54 GFLOP of unmasked products (0.5 us at
// the bf16 tensor-core rate).
//
// Design. One block per (batch * kv head, 64 packed query rows); a packed
// row is (position, group), row = position * G + group, so one block holds
// 64 / G positions of all G heads that share a kv head, and every k/v tile
// it loads serves all of them. The kv sweep is a loop inside the block (the
// TPU's sequential grid axis) that stops at the last tile any row of the
// block can see, so the causal future costs nothing.
//
// bf16 / fp16: the tensor cores through mma.sync m16n8k16 (fp32
// accumulate). Four warps of 16 packed rows each. q is loaded once and kept
// in registers as A fragments (ldmatrix); 64-key tiles of k and v stay in
// the input type in shared memory, double-buffered with cp.async (16-byte
// copies where D * 2 is a multiple of 16 and the operands are 16-byte
// aligned, element by element otherwise), padded along D to a multiple of
// 16 with zeros (zamba2's D = 80 is 5 k-steps) and along rows by 16 bytes
// so ldmatrix is conflict-free: 87 KB at D = 128, so two blocks share an
// SM. S = Q K^T stays in registers (k by ldmatrix, v by ldmatrix.trans); the
// online softmax reduces each row over the quad of lanes that holds it; P
// becomes the A fragments of the P V product in registers, rounded to the
// input type (FlashAttention-2's register reuse; the reference keeps P in
// fp32), and O accumulates in fp32 registers. mma.sync, not wgmma: at these
// shapes the products are a fraction of the bytes' time, and its fragments
// let P stay in registers without wgmma's register-A layout constraints.
//
// fp32 keeps true fp32 products (the reference's 2e-6 tolerance): the same
// blocks on the CUDA cores in fp32 FMA, tiles staged to shared memory as
// fp32, S as a 4 x 4 register tile per thread, the row statistics reduced by
// shuffles across the 16 lanes that share a row, P through shared memory.

#include "common.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace {

constexpr int R = 64;          // packed query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 row groups x 16 lanes
constexpr int RI = R / 16;     // rows per thread
constexpr int CJ = BK / 16;    // score columns per thread
constexpr float NEG_INF = -1e30f;

struct Strides {               // element strides of [B, S, H, D] operands
  long long q_b, q_s, k_b, k_s, v_b, v_s, o_b, o_s;
};

// Shared memory, all fp32: Qt [DMAX][R] (q transposed), Kt [DMAX][BK]
// (k transposed), Vs [BK][DMAX], Pt [BK][R] (probabilities transposed).
template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)DMAX * R + (size_t)DMAX * BK +
                          (size_t)BK * DMAX + (size_t)BK * R);
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, const int* __restrict__ start, int Sq,
          int Sk, int Hkv, int G, int D, Strides st, int causal,
          float scale) {
  extern __shared__ float smem[];
  float* Qt = smem;
  float* Kt = Qt + DMAX * R;
  float* Vs = Kt + DMAX * BK;
  float* Pt = Vs + BK * DMAX;

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int row0 = blockIdx.y * R;
  const int n_rows = Sq * G;
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int kv_len = start != nullptr ? min(Sk, *start + Sq) : Sk;
  const int shift = kv_len - Sq;  // bottom-right alignment of the causal mask
  const float* qb = q + b * st.q_b;
  const float* kb = k + b * st.k_b + (long long)h * D;
  const float* vb = v + b * st.v_b + (long long)h * D;

  for (int idx = tid; idx < R * DMAX; idx += THREADS) {
    const int r = idx / DMAX, d = idx % DMAX, row = row0 + r;
    float val = 0.f;
    if (row < n_rows && d < D) {
      const int pos = row / G, g = row % G;
      val = qb[pos * st.q_s + (long long)(h * G + g) * D + d];
    }
    Qt[d * R + r] = val;
  }

  // the last key each of this thread's rows may see (-1: an empty row)
  int lim[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + rg + 16 * i;
    lim[i] = row >= n_rows ? -1 : (causal ? row / G + shift : kv_len - 1);
  }
  const int last_row = min(row0 + R, n_rows) - 1;
  const int kv_end =
      causal ? min(kv_len, last_row / G + shift + 1) : kv_len;

  float m[RI], l[RI], acc[RI][DMAX / 16];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();   // the previous tile's reads are done (Qt staged)
    for (int idx = tid; idx < BK * DMAX; idx += THREADS) {
      const int c = idx / DMAX, d = idx % DMAX, key = k0 + c;
      float kv = 0.f, vv = 0.f;   // zeros past kv_len: 0 * garbage is NaN
      if (key < kv_len && d < D) {
        kv = kb[key * st.k_s + d];
        vv = vb[key * st.v_s + d];
      }
      Kt[d * BK + c] = kv;
      Vs[c * DMAX + d] = vv;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[RI], bk[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = Qt[d * R + rg + 16 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) bk[j] = Kt[d * BK + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int key = k0 + cg + 16 * j;
        s[i][j] = key <= lim[i] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int key = k0 + cg + 16 * j;
        const float p = key <= lim[i] ? expf(s[i][j] - m_new) : 0.f;
        Pt[(cg + 16 * j) * R + rg + 16 * i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    const int n_keys = min(BK, kv_end - k0);
    for (int c = 0; c < n_keys; ++c) {
      float p[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = Pt[c * R + rg + 16 * i];
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) {
        const float vv = Vs[c * DMAX + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + rg + 16 * i;
    if (row >= n_rows) continue;
    const int pos = row / G, g = row % G;
    const float den = l[i] == 0.f ? 1.f : l[i];
    if (lse != nullptr && cg == 0)
      lse[((long long)b * Hkv * G + h * G + g) * Sq + pos] =
          l[i] == 0.f ? INFINITY : m[i] + logf(l[i]);
    float* orow = o + b * st.o_b + pos * st.o_s + (long long)(h * G + g) * D;
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) {
      const int d = cg + 16 * j;
      if (d < D) orow[d] = acc[i][j] / den;
    }
  }
}

template <int DMAX>
int launch_fma(const void* q, const void* k, const void* v, void* o,
               float* lse, const int* start, int B, int Sq, int Sk, int Hkv,
               int G, int D, const Strides& st, int causal, cudaStream_t s) {
  const size_t smem = smem_bytes<DMAX>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * Hkv, (Sq * G + R - 1) / R);
  flash_fwd<DMAX><<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, start, Sq,
      Sk, Hkv, G, D, st, causal, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// ------------------------------------------ bf16 / fp16 tensor-core body --

constexpr int TC_THREADS = 128;   // 4 warps x 16 packed rows = R

// Shared memory in the input type: Q [R][LDS], K and V [2][BK][LDS], with
// a row pitch LDS = DP + 8 (16 bytes more than D padded to DP, an odd
// number of 16-byte units, so ldmatrix's eight rows hit distinct banks).
template <int DP>
constexpr size_t tc_smem_bytes() {
  return 2 * (size_t)(DP + 8) * (R + 4 * BK);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16*, float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(__half*, float a, float b) {
  __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// rows [0, 64) of a tile in shared memory (pitch DP + 8): row r's source
// is src(r) (null: zeros), D values, zeros from D to DP.
template <typename T, int DP, typename Src>
__device__ __forceinline__ void stage_rows(T* dst, int D, bool vec, Src src) {
  constexpr int LDS = DP + 8;
  if (vec) {
    const int chunks = DP / 8;
    for (int idx = threadIdx.x; idx < 64 * chunks; idx += TC_THREADS) {
      const int r = idx / chunks, d = (idx % chunks) * 8;
      const T* p = src(r);
      T* t = dst + r * LDS + d;
      if (p != nullptr && d < D) cp_async_16(t, p + d);
      else *reinterpret_cast<uint4*>(t) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * DP; idx += TC_THREADS) {
      const int r = idx / DP, d = idx % DP;
      const T* p = src(r);
      dst[r * LDS + d] = (p != nullptr && d < D) ? p[d] : from_f32<T>(0.f);
    }
  }
}

// DP: D padded to a multiple of 16, so every loop over D is unrolled
// without a guard.
template <typename T, int DP>
__global__ void __launch_bounds__(TC_THREADS)
flash_tc(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
         const int* __restrict__ start, int Sq, int Sk, int Hkv, int G, int D,
         Strides st, int causal, float scale, int vec) {
  constexpr int LDS = DP + 8;
  constexpr int KD = DP / 16;   // k-steps of Q K^T, pairs of P V n-tiles
  constexpr bool HALF = std::is_same<T, __half>::value;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + R * LDS;                      // [2][BK][LDS]
  T* Vs = Ks + 2 * BK * LDS;                 // [2][BK][LDS]

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int row0 = blockIdx.y * R;
  const int n_rows = Sq * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kv_len = start != nullptr ? min(Sk, *start + Sq) : Sk;
  const int shift = kv_len - Sq;  // bottom-right alignment of the causal mask
  const float scale_log2 = scale * 1.4426950408889634f;
  const T* qb = q + b * st.q_b;
  const T* kb = k + b * st.k_b + (long long)h * D;
  const T* vb = v + b * st.v_b + (long long)h * D;

  const int last_row = min(row0 + R, n_rows) - 1;
  const int kv_end =
      causal ? min(kv_len, last_row / G + shift + 1) : kv_len;
  const int n_tiles = (kv_end + BK - 1) / BK;

  stage_rows<T, DP>(Qs, D, vec, [&](int r) -> const T* {
    const int row = row0 + r;
    if (row >= n_rows) return nullptr;
    return qb + (row / G) * st.q_s + (long long)(h * G + row % G) * D;
  });
  auto stage_kv = [&](int buf, int k0) {
    stage_rows<T, DP>(Ks + buf * BK * LDS, D, vec, [&](int r) -> const T* {
      return k0 + r < kv_len ? kb + (k0 + r) * st.k_s : nullptr;
    });
    stage_rows<T, DP>(Vs + buf * BK * LDS, D, vec, [&](int r) -> const T* {
      return k0 + r < kv_len ? vb + (k0 + r) * st.v_s : nullptr;
    });
  };
  if (n_tiles > 0) stage_kv(0, 0);
  cp_async_commit();

  // this thread's two rows of the warp's 16: lane / 4 and lane / 4 + 8
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + lane / 4 + 8 * i;
    lim[i] = row >= n_rows ? -1 : (causal ? row / G + shift : kv_len - 1);
  }
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[KD][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    if (t + 1 < n_tiles) {
      stage_kv((t + 1) & 1, k0 + BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + (t & 1) * BK * LDS;
    const T* Vt = Vs + (t & 1) * BK * LDS;
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldmatrix_x4(qf[kd], Qs + (warp * 16 + lane % 16) * LDS + kd * 16 +
                                (lane / 16) * 8);
    }

    // S = Q K^T for the warp's 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Kt + (jp * 16 + lane % 8 + (lane / 16) * 8) * LDS +
                            kd * 16 + ((lane / 8) % 2) * 8);
        const uint32_t b0[2] = {bk[0], bk[1]}, b1[2] = {bk[2], bk[3]};
        mma_16816<HALF>(s[2 * jp], qf[kd], b0);
        mma_16816<HALF>(s[2 * jp + 1], qf[kd], b1);
      }
    }

    // online softmax over the tile, in base 2 (scores scaled by
    // log2(e) / sqrt(D)); a row lives in a quad of lanes
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * (lane % 4) + e;
          float& x = s[j][2 * i + e];
          x = key <= lim[i] ? x * scale_log2 : NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * (lane % 4) + e;
          float& x = s[j][2 * i + e];
          x = key <= lim[i] ? exp2f(x - m_new) : 0.f;
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = exp2f(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[j][2 * i] *= corr;
        acc[j][2 * i + 1] *= corr;
      }
    }

    // O += P V: P's C fragments become A fragments, 16 keys per k-step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack2((T*)nullptr, s[2 * kk][0], s[2 * kk][1]),
          pack2((T*)nullptr, s[2 * kk][2], s[2 * kk][3]),
          pack2((T*)nullptr, s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack2((T*)nullptr, s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < KD; ++jp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                       LDS + jp * 16 + (lane / 16) * 8);
        const uint32_t b0[2] = {bv[0], bv[1]}, b1[2] = {bv[2], bv[3]};
        mma_16816<HALF>(acc[2 * jp], pa, b0);
        mma_16816<HALF>(acc[2 * jp + 1], pa, b1);
      }
    }
    __syncthreads();   // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + lane / 4 + 8 * i;
    if (row >= n_rows) continue;
    const int pos = row / G, g = row % G;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    // the row's natural log-sum-exp for the backward: m and l are in base 2
    if (lse != nullptr && lane % 4 == 0)
      lse[((long long)b * Hkv * G + h * G + g) * Sq + pos] =
          l[i] == 0.f ? INFINITY : (m[i] + log2f(l[i])) * 0.6931471805599453f;
    T* orow = o + b * st.o_b + pos * st.o_s + (long long)(h * G + g) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * (lane % 4) + e;
        if (d < D) orow[d] = from_f32<T>(acc[j][2 * i + e] * inv);
      }
  }
}

template <typename T, int DP>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, const int* start, int B, int Sq, int Sk, int Hkv,
              int G, int D, const Strides& st, int causal, int vec,
              cudaStream_t s) {
  const size_t smem = tc_smem_bytes<DP>();
  static bool sized = false;   // the attribute once per instantiation
  cudaError_t e;
  if (!sized) {
    e = cudaFuncSetAttribute(flash_tc<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  dim3 grid(B * Hkv, (Sq * G + R - 1) / R);
  flash_tc<T, DP><<<grid, TC_THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, start, Sq, Sk, Hkv,
      G, D, st, causal, 1.0f / sqrtf((float)D), vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_tc(const void* q, const void* k, const void* v, void* o,
                float* lse, const int* start, int B, int Sq, int Sk, int Hkv,
                int G, int D, const Strides& st, int causal, int vec,
                cudaStream_t s) {
#define FLASH_TC_DP(dp)                                                     \
  case dp / 16:                                                             \
    return launch_tc<T, dp>(q, k, v, o, lse, start, B, Sq, Sk, Hkv, G, D,   \
                            st, causal, vec, s);
  switch ((D + 15) / 16) {
    FLASH_TC_DP(16) FLASH_TC_DP(32) FLASH_TC_DP(48) FLASH_TC_DP(64)
    FLASH_TC_DP(80) FLASH_TC_DP(96) FLASH_TC_DP(112) FLASH_TC_DP(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_TC_DP
}

int dispatch_fma(const void* q, const void* k, const void* v, void* o,
                 float* lse, const int* start, int B, int Sq, int Sk, int Hkv,
                 int G, int D, const Strides& st, int causal, cudaStream_t s) {
  if (D <= 32) return launch_fma<32>(q, k, v, o, lse, start, B, Sq, Sk, Hkv, G, D, st, causal, s);
  if (D <= 64) return launch_fma<64>(q, k, v, o, lse, start, B, Sq, Sk, Hkv, G, D, st, causal, s);
  return launch_fma<128>(q, k, v, o, lse, start, B, Sq, Sk, Hkv, G, D, st, causal, s);
}

}  // namespace

// o [B,Sq,Hkv*G,D] = attention(q [B,Sq,Hkv*G,D], k/v [B,Sk,Hkv,D]). Each
// operand has unit stride along D and stride D between heads; *_bs and *_ss
// are its batch and sequence strides in elements (a cache prefix view keeps
// its parent's). causal: bottom-right mask (needs Sq <= Sk). dtype: 0 fp32,
// 1 bf16, 2 fp16. lse: null, or fp32 [B, Hkv*G, Sq] that receives each
// row's natural log-sum-exp of the scaled scores (+inf for a row that sees
// no key), which the backward (flash_attention_bwd.cu) recomputes P from.
// start: null (the host start Sk - Sq), or an int32 on the card, the
// chunk's first position in a causal attention over the whole cache (the
// device-start entry; the caller keeps 0 <= *start <= Sk - Sq).
// Returns the cudaError_t of the launch (0 on success); never synchronises.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, const void* start,
                                   int B, int Sq, int Sk,
                                   int Hkv, int G, int D, long long q_bs,
                                   long long q_ss,
                                   long long k_bs, long long k_ss,
                                   long long v_bs, long long v_ss,
                                   long long o_bs, long long o_ss, int causal,
                                   int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || G <= 0 || D <= 0 ||
      D > 128 || (causal && Sq > Sk) || (long long)Sq * G > 65535LL * R ||
      (start != nullptr && !causal))
    return (int)cudaErrorInvalidValue;
  const Strides st{q_bs, q_ss, k_bs, k_ss, v_bs, v_ss, o_bs, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* L = static_cast<float*>(lse);
  const int* at = static_cast<const int*>(start);
  // 16-byte copies where every row of q, k and v starts 16-byte aligned
  const bool vec = D % 8 == 0 && q_bs % 8 == 0 && q_ss % 8 == 0 &&
                   k_bs % 8 == 0 && k_ss % 8 == 0 && v_bs % 8 == 0 &&
                   v_ss % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  switch (dtype) {
    case 0: return dispatch_fma(q, k, v, o, L, at, B, Sq, Sk, Hkv, G, D, st, causal, s);
    case 1: return dispatch_tc<__nv_bfloat16>(q, k, v, o, L, at, B, Sq, Sk, Hkv, G, D, st, causal, vec, s);
    case 2: return dispatch_tc<__half>(q, k, v, o, L, at, B, Sq, Sk, Hkv, G, D, st, causal, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
