// Single-token GQA decode attention over a dense KV cache, for Hopper
// (sm_90a): the dense-cache engine's decode attention, as split-KV
// flash-decoding.
//
// Replaces src/repro/kernels/decode_attention/kernel.py::decode_attention_pallas
// (body _decode_kernel): o[b, g] = softmax(q[b, g] k[b, :length]^T / sqrt(D))
// v[b, :length] with q [B,Hq,D], caches [B,Smax,Hkv,D] and one valid
// length for the whole batch. The TPU kernel takes the length by scalar
// prefetch; here it is read by every block from an int32 on the device, so
// a decode loop never brings it to the host. Keys at or past the length
// are never read. Any Smax is taken (the Pallas kernel needs a multiple of
// its block), any D <= 128 and at most 8 query heads per kv head. fp32,
// bf16 and fp16 inputs; fp32 softmax statistics; output in the input type;
// rows with no valid key (length 0) give 0, as the Pallas kernel's guard
// does.
//
// What bounds it on the H100. Decode streams the valid prefix of both
// caches once: at llama3-8b (8 kv heads, D = 128, bf16, length ~300) that
// is ~1.2 MB per layer, ~0.37 us at 3.35 TB/s, against ~1.2 MFLOP. So the
// work is bytes and, at these sizes, the latency of the first loads: the
// kernel has to put many independent loads in flight on many SMs at once.
//
// Design. Pass 1 runs a grid of (n_split, Hkv, B) blocks, n_split fixed by
// the host from B, Hkv, Smax and the SM count (ops.decode_split_plan), never
// from the length. Each block reads *length and takes its equal share,
// ceil(length / n_split) keys, of [0, length); a block whose share is empty
// writes an empty partial (m = -inf, l = 0). Inside a block a key's row is
// read by a group of lanes with one 16-byte load each (8 bf16 / fp16 or 4
// fp32 values; element loads where an operand is not 16-byte aligned), so
// a warp reads 32 / group keys per load instruction and U such rows of K
// and of V (4, or 2 at G > 4) are in flight before the first score is
// needed. The group's G partial dot products of its U keys are reduced by
// one shuffle chain, then scaled by log2(e) / sqrt(D), and each group keeps
// its own fp32 online softmax (exp2f; one rescale per U keys). The block
// merges its groups' (m, l, acc) through shared memory in a fixed order and
// writes the split's fp32 partial to a scratch buffer the wrapper allocates.
// Pass 2, launched from the same entry, combines the partials of each
// (batch, query head) in split order: M = max m_i, L = sum l_i 2^(m_i - M),
// o = sum acc_i 2^(m_i - M) / L (0 where L is 0). No float atomics, so two
// runs give the same bits. Tensor cores are not used: one query row and at
// most 8 heads per kv head make a product too thin for them.

#include "common.cuh"

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_G = 8;        // query heads per kv head
constexpr int DMAX = 128;
constexpr int MAX_SPLIT = 64;   // the combine stages (m, l) in shared memory
static_assert(MAX_SPLIT <= THREADS && DMAX <= THREADS,
              "the combine: one thread a split, then one a d");
constexpr float LOG2E = 1.4426950408889634f;

// CH elements of a row per 16-byte chunk (VEC), else one element per chunk;
// CPL chunks per lane: a row of D <= 128 elements over at most 32 lanes.
template <typename T, bool VEC>
struct Layout {
  static constexpr int CH = VEC ? 16 / (int)sizeof(T) : 1;
  static constexpr int CPL = VEC ? 1 : DMAX / 32;
};

template <typename T, bool VEC>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p,
                                           float (&f)[Layout<T, VEC>::CH]) {
  if constexpr (!VEC) {
    f[0] = to_f32(__ldg(p));
  } else if constexpr (sizeof(T) == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 two;
      if constexpr (sizeof(T) == 2 && std::is_same<T, __half>::value)
        two = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      else
        two = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = two.x;
      f[2 * i + 1] = two.y;
    }
  }
}

// Pass 1: the fp32 partial (m, l, acc[G, D]) of one split of one (batch, kv
// head): part_ml[(bh * n_split + split) * G + g] = {m, l} (m in log2 units),
// part_acc[((bh * n_split + split) * G + g) * D + d].
template <typename T, bool VEC, int GT>
__global__ void __launch_bounds__(THREADS, 1)
decode_split(const T* __restrict__ q, const T* __restrict__ kc,
             const T* __restrict__ vc, float2* __restrict__ part_ml,
             float* __restrict__ part_acc, const int* __restrict__ length,
             int Smax, int G, int D, int tpk_log2, long long q_b,
             long long k_b, long long k_s, long long v_b, long long v_s,
             float scale_log2) {
  using L = Layout<T, VEC>;
  constexpr int CH = L::CH, CPL = L::CPL;
  constexpr int U = GT >= 8 ? 2 : 4;     // keys in flight per lane group
  // streams x D <= THREADS x CH x CPL
  __shared__ float accs[THREADS * 8 * GT];
  __shared__ float ms[THREADS][GT], ls[THREADS][GT], ws[THREADS][GT];
  __shared__ float Ms[GT], Ls[GT];

  const int split = blockIdx.x, n_split = gridDim.x;
  const int h = blockIdx.y, Hkv = gridDim.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tpk = 1 << tpk_log2, kpw = 32 >> tpk_log2;
  const int gi = lane >> tpk_log2, li = lane & (tpk - 1);
  const int stream = warp * kpw + gi, n_streams = WARPS * kpw;

  const int len = min(max(*length, 0), Smax);
  const int share = (len + n_split - 1) / n_split;
  const int k0 = split * share, k1 = min(k0 + share, len);

  const T* kb = kc + b * k_b + (long long)h * D;
  const T* vb = vc + b * v_b + (long long)h * D;

  float qr[GT][CPL][CH], acc[GT][CPL][CH], m[GT], l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int d0 = (li + c * tpk) * CH;
      float f[CH];
      if (g < G && d0 < D) {
        load_chunk<T, VEC>(q + b * q_b + (long long)(h * G + g) * D + d0, f);
      } else {
#pragma unroll
        for (int e = 0; e < CH; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < CH; ++e) {
        qr[g][c][e] = f[e];
        acc[g][c][e] = 0.f;
      }
    }
  }

  // step t of warp w covers keys k0 + w kpw + t U n_streams + u n_streams
  // + gi, u < U: warp-uniform bounds, so every lane joins each shuffle
  for (int base = k0 + warp * kpw; base < k1; base += U * n_streams) {
    float kr[U][CPL][CH], vr[U][CPL][CH];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * n_streams + gi;
      ok[u] = j < k1;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int d0 = (li + c * tpk) * CH;
        if (ok[u] && d0 < D) {
          load_chunk<T, VEC>(kb + j * k_s + d0, kr[u][c]);
          load_chunk<T, VEC>(vb + j * v_s + d0, vr[u][c]);
        } else {
#pragma unroll
          for (int e = 0; e < CH; ++e) kr[u][c][e] = vr[u][c][e] = 0.f;
        }
      }
    }
    float s[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int e = 0; e < CH; ++e) part = fmaf(qr[g][c][e], kr[u][c][e], part);
        s[u][g] = part;
      }
    for (int off = tpk >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GT; ++g)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < GT; ++g) s[u][g] *= scale_log2;
    if (!ok[0]) continue;            // this group's keys of the step are past k1
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g >= G) break;
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) m_new = fmaxf(m_new, s[u][g]);
      const float corr = exp2f(m[g] - m_new);   // 0 while m is -inf
      float p[U], psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = ok[u] ? exp2f(s[u][g] - m_new) : 0.f;
        psum += p[u];
      }
      l[g] = fmaf(l[g], corr, psum);
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < CH; ++e) {
          float a = acc[g][c][e] * corr;
#pragma unroll
          for (int u = 0; u < U; ++u) a = fmaf(p[u], vr[u][c][e], a);
          acc[g][c][e] = a;
        }
      m[g] = m_new;
    }
  }

  // merge the block's streams in stream order
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g >= G) break;
    if (li == 0) {
      ms[stream][g] = m[g];
      ls[stream][g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int d0 = (li + c * tpk) * CH;
#pragma unroll
      for (int e = 0; e < CH; ++e)
        if (d0 + e < D) accs[(stream * G + g) * D + d0 + e] = acc[g][c][e];
    }
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float M = -INFINITY;
    for (int st = 0; st < n_streams; ++st) M = fmaxf(M, ms[st][g]);
    float Lsum = 0.f;
#pragma unroll 4
    for (int st = 0; st < n_streams; ++st) {    // n_streams: 4 .. 128
      const float w = ls[st][g] == 0.f ? 0.f : exp2f(ms[st][g] - M);
      ws[st][g] = w;
      Lsum = fmaf(ls[st][g], w, Lsum);
    }
    Ms[g] = M;
    Ls[g] = Lsum;
  }
  __syncthreads();
  const long long row = ((long long)(b * Hkv + h) * n_split + split) * G;
  for (int idx = threadIdx.x; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float a = 0.f;
#pragma unroll 4
    for (int st = 0; st < n_streams; ++st)
      a = fmaf(accs[(st * G + g) * D + d], ws[st][g], a);
    part_acc[row * D + idx] = a;
  }
  if (threadIdx.x < G)
    part_ml[row + threadIdx.x] = make_float2(Ms[threadIdx.x], Ls[threadIdx.x]);
}

// Pass 2: one block per (query head, batch) combines the n_split partials
// in split order and writes o in the input type. Each thread reads the
// (m, l) pairs from shared memory and forms the weights itself, so the only
// barrier is the one after staging them; thread d owns o[..., d].
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine(const float2* __restrict__ part_ml,
               const float* __restrict__ part_acc, T* __restrict__ o,
               int G, int D, int n_split, long long o_b) {
  __shared__ float2 ml[MAX_SPLIT];
  const int hq = blockIdx.x, Hq = gridDim.x, b = blockIdx.y;
  const int Hkv = Hq / G, h = hq / G, g = hq % G;
  const long long base = (long long)(b * Hkv + h) * n_split;   // split 0
  if (threadIdx.x < n_split)
    ml[threadIdx.x] = part_ml[(base + threadIdx.x) * G + g];
  __syncthreads();
  const int d = threadIdx.x;
  if (d >= D) return;
  float M = -INFINITY;
  for (int i = 0; i < n_split; ++i) M = fmaxf(M, ml[i].x);
  const float* acc = part_acc + (base * G + g) * D + d;   // split i at + i G D
  // in batches of 8 splits whose loads are all issued before the sums;
  // a split past n_split adds 0 * 0, so the sum stays in split order
  float L = 0.f, a = 0.f;
  for (int i0 = 0; i0 < n_split; i0 += 8) {
    float av[8], lv[8], wv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j;
      const bool in = i < n_split;
      av[j] = in ? acc[(long long)i * G * D] : 0.f;
      lv[j] = in ? ml[i].y : 0.f;
      wv[j] = lv[j] == 0.f ? 0.f : exp2f(ml[i].x - M);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      L = fmaf(lv[j], wv[j], L);
      a = fmaf(av[j], wv[j], a);
    }
  }
  o[b * o_b + (long long)hq * D + d] =
      from_f32<T>(L == 0.f ? 0.f : __fdividef(a, L));
}

template <typename T, bool VEC, int GT>
cudaError_t launch_split(dim3 grid, const void* q, const void* kc,
                         const void* vc, float2* ml, float* acc,
                         const int* length, int Smax, int G, int D,
                         int tpk_log2, long long q_b, long long k_b,
                         long long k_s, long long v_b, long long v_s,
                         float scale_log2, cudaStream_t s) {
  decode_split<T, VEC, GT><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), ml, acc, length, Smax, G, D, tpk_log2, q_b,
      k_b, k_s, v_b, v_s, scale_log2);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_g(dim3 grid, int G, const void* q, const void* kc,
                     const void* vc, float2* ml, float* acc, const int* length,
                     int Smax, int D, int tpk_log2, long long q_b,
                     long long k_b, long long k_s, long long v_b, long long v_s,
                     float scale_log2, cudaStream_t s) {
#define DECODE_SPLIT(GT)                                                       \
  launch_split<T, VEC, GT>(grid, q, kc, vc, ml, acc, length, Smax, G, D,       \
                           tpk_log2, q_b, k_b, k_s, v_b, v_s, scale_log2, s)
  if (G == 1) return DECODE_SPLIT(1);
  if (G == 2) return DECODE_SPLIT(2);
  if (G <= 4) return DECODE_SPLIT(4);
  return DECODE_SPLIT(8);
#undef DECODE_SPLIT
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const void* q, const void* kc, const void* vc, void* o,
           const int* length, void* scratch, int B, int Smax, int Hkv, int G,
           int D, int n_split, long long q_b, long long k_b, long long k_s,
           long long v_b, long long v_s, long long o_b, cudaStream_t s) {
  constexpr int CH = 16 / (int)sizeof(T);
  // 16-byte loads where every row and head starts on a 16-byte boundary
  const bool vec = aligned16(q) && aligned16(kc) && aligned16(vc) &&
                   D % CH == 0 && q_b % CH == 0 && k_b % CH == 0 &&
                   k_s % CH == 0 && v_b % CH == 0 && v_s % CH == 0;
  const int chunks = vec ? D / CH : D;
  int tpk_log2 = 0;
  while ((1 << tpk_log2) < chunks && tpk_log2 < 5) ++tpk_log2;
  float2* ml = static_cast<float2*>(scratch);
  float* acc = reinterpret_cast<float*>(ml + (size_t)B * Hkv * n_split * G);
  const float scale_log2 = LOG2E / sqrtf((float)D);
  const dim3 grid(n_split, Hkv, B);
  cudaError_t e =
      vec ? launch_g<T, true>(grid, G, q, kc, vc, ml, acc, length, Smax, D,
                              tpk_log2, q_b, k_b, k_s, v_b, v_s, scale_log2, s)
          : launch_g<T, false>(grid, G, q, kc, vc, ml, acc, length, Smax, D,
                               tpk_log2, q_b, k_b, k_s, v_b, v_s, scale_log2, s);
  if (e != cudaSuccess) return (int)e;
  decode_combine<T><<<dim3(Hkv * G, B), THREADS, 0, s>>>(
      ml, acc, static_cast<T*>(o), G, D, n_split, o_b);
  return (int)cudaGetLastError();
}

}  // namespace

// o [B,Hkv*G,D] = decode attention of q [B,Hkv*G,D] over the first *length
// rows of k/v caches [B,Smax,Hkv,D], in n_split key splits (1..64). Each
// operand has unit stride along D and stride D between heads; q_b, k_b/k_s,
// v_b/v_s and o_b are batch and sequence strides in elements. length points
// to one int32 on the device. scratch is an fp32 buffer of
// B * Hkv * n_split * G * (D + 2) values. dtype: 0 fp32, 1 bf16, 2 fp16.
// Launches the split pass and the combine; returns the cudaError_t of the
// launches (0 on success); never synchronises.
extern "C" int decode_attention_fwd(const void* q, const void* kc,
                                    const void* vc, void* o, const void* length,
                                    void* scratch, int B, int Smax, int Hkv,
                                    int G, int D, int n_split, long long q_b,
                                    long long k_b, long long k_s, long long v_b,
                                    long long v_s, long long o_b, int dtype,
                                    void* stream) {
  if (B <= 0 || B > 65535 || Smax <= 0 || Hkv <= 0 || Hkv > 65535 || G <= 0 ||
      G > MAX_G || D <= 0 || D > DMAX || n_split < 1 || n_split > MAX_SPLIT ||
      length == nullptr || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(length);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, kc, vc, o, len, scratch, B, Smax, Hkv, G, D, n_split, q_b, k_b, k_s, v_b, v_s, o_b, s);
    case 1: return launch<__nv_bfloat16>(q, kc, vc, o, len, scratch, B, Smax, Hkv, G, D, n_split, q_b, k_b, k_s, v_b, v_s, o_b, s);
    case 2: return launch<__half>(q, kc, vc, o, len, scratch, B, Smax, Hkv, G, D, n_split, q_b, k_b, k_s, v_b, v_s, o_b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
