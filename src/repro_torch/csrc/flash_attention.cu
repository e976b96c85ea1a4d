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
// Any D <= 128 is taken as it is (no padding to 128, so no q rescale).
//
// What bounds it on the H100. At the engine's prefill chunks (llama3-8b:
// 256 queries over 256 keys, 44 over 300; 32 / 8 heads, D = 128, bf16) the
// function is bound by its bytes: 5.2 MB of q/k/v/o at 256 x 256 (1.6 us at
// 3.35 TB/s) against 0.54 GFLOP of unmasked products (0.5 us at the bf16
// tensor-core rate). This first version multiplies on the CUDA cores in
// fp32 FMA from shared memory, so it is bound by FMA issue and shared-memory
// reads instead: wgmma on bf16 tiles, TMA and a pipeline of k/v tiles are
// later work.
//
// Design. One block per (batch * kv head, 64 packed query rows); a packed
// row is (position, group), row = position * G + group, so one block holds
// 64 / G positions of all G heads that share a kv head, and every k/v tile
// it loads serves all of them. The kv sweep is a loop inside the block (the
// TPU's sequential grid axis): 64 keys per tile staged to shared memory as
// fp32, S = Q K^T as a 4 x 4 register tile per thread, the online-softmax
// row statistics reduced by shuffles across the 16 lanes that share a row,
// P written to shared memory, and O accumulated in registers (4 rows x
// D/16 columns per thread). The loop stops at the last tile that any row of
// the block can see, so the causal future costs nothing.

#include "common.cuh"

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

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int Hkv,
          int G, int D, Strides st, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qt = smem;
  float* Kt = Qt + DMAX * R;
  float* Vs = Kt + DMAX * BK;
  float* Pt = Vs + BK * DMAX;

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int row0 = blockIdx.y * R;
  const int n_rows = Sq * G;
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int shift = Sk - Sq;   // bottom-right alignment of the causal mask
  const T* qb = q + b * st.q_b;
  const T* kb = k + b * st.k_b + (long long)h * D;
  const T* vb = v + b * st.v_b + (long long)h * D;

  for (int idx = tid; idx < R * DMAX; idx += THREADS) {
    const int r = idx / DMAX, d = idx % DMAX, row = row0 + r;
    float val = 0.f;
    if (row < n_rows && d < D) {
      const int pos = row / G, g = row % G;
      val = to_f32(qb[pos * st.q_s + (long long)(h * G + g) * D + d]);
    }
    Qt[d * R + r] = val;
  }

  // the last key each of this thread's rows may see (-1: an empty row)
  int lim[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + rg + 16 * i;
    lim[i] = row >= n_rows ? -1 : (causal ? row / G + shift : Sk - 1);
  }
  const int last_row = min(row0 + R, n_rows) - 1;
  const int kv_end = causal ? min(Sk, last_row / G + shift + 1) : Sk;

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
      float kv = 0.f, vv = 0.f;   // zeros past Sk: 0 * garbage would be NaN
      if (key < Sk && d < D) {
        kv = to_f32(kb[key * st.k_s + d]);
        vv = to_f32(vb[key * st.v_s + d]);
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
    T* orow = o + b * st.o_b + pos * st.o_s + (long long)(h * G + g) * D;
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) {
      const int d = cg + 16 * j;
      if (d < D) orow[d] = from_f32<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int Hkv, int G, int D, const Strides& st, int causal,
           cudaStream_t s) {
  const size_t smem = smem_bytes<DMAX>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * Hkv, (Sq * G + R - 1) / R);
  flash_fwd<T, DMAX><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, Hkv, G, D, st,
      causal, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int Hkv, int G, int D, const Strides& st,
               int causal, cudaStream_t s) {
  if (D <= 32) return launch<T, 32>(q, k, v, o, B, Sq, Sk, Hkv, G, D, st, causal, s);
  if (D <= 64) return launch<T, 64>(q, k, v, o, B, Sq, Sk, Hkv, G, D, st, causal, s);
  return launch<T, 128>(q, k, v, o, B, Sq, Sk, Hkv, G, D, st, causal, s);
}

}  // namespace

// o [B,Sq,Hkv*G,D] = attention(q [B,Sq,Hkv*G,D], k/v [B,Sk,Hkv,D]). Each
// operand has unit stride along D and stride D between heads; *_bs and *_ss
// are its batch and sequence strides in elements (a cache prefix view keeps
// its parent's). causal: bottom-right mask (needs Sq <= Sk). dtype: 0 fp32,
// 1 bf16, 2 fp16. Returns the cudaError_t of the launch (0 on success);
// never synchronises.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Sk, int Hkv,
                                   int G, int D, long long q_bs, long long q_ss,
                                   long long k_bs, long long k_ss,
                                   long long v_bs, long long v_ss,
                                   long long o_bs, long long o_ss, int causal,
                                   int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || G <= 0 || D <= 0 ||
      D > 128 || (causal && Sq > Sk) || (long long)Sq * G > 65535LL * R)
    return (int)cudaErrorInvalidValue;
  const Strides st{q_bs, q_ss, k_bs, k_ss, v_bs, v_ss, o_bs, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, B, Sq, Sk, Hkv, G, D, st, causal, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, Hkv, G, D, st, causal, s);
    case 2: return dispatch_d<__half>(q, k, v, o, B, Sq, Sk, Hkv, G, D, st, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
