// Single-token GQA decode attention over a dense KV cache, for Hopper
// (sm_90a): the dense-cache engine's decode attention.
//
// Replaces src/repro/kernels/decode_attention/kernel.py::decode_attention_pallas
// (body _decode_kernel): o[b, g] = softmax(q[b, g] k[b, :length]^T / sqrt(D))
// v[b, :length] with q [B,Hq,D], caches [B,Smax,Hkv,D] and one valid
// length for the whole batch. The TPU kernel takes the length by scalar
// prefetch; here it is read by every block from an int32 on the device, so
// a decode loop never brings it to the host. Keys at or past the length
// are never read. Any Smax is taken (the Pallas kernel needs a multiple of
// its block), any D <= 128 and at most 8 query heads per kv head. fp32,
// bf16 and fp16 inputs; fp32 online softmax; output in the input type.
//
// What bounds it on the H100. Decode streams the valid prefix of both
// caches once: at llama3-8b (8 kv heads, D = 128, bf16, length ~300) that
// is ~1.2 MB per layer, ~0.37 us at 3.35 TB/s, against ~1.2 MFLOP. This
// first version runs one block per (batch, kv head): 8 blocks on 132 SMs
// at B = 1, so it cannot draw the card's bandwidth; splitting the cache
// over blocks with a combine pass (flash-decoding) is the later redesign.
//
// Design. Inside a block the keys are split over 8 warps (key j to warp
// j mod 8), each warp keeping its own fp32 online softmax (m, l, acc) for
// the G query heads; a lane holds D/32 of the head dimension, so a key's
// G dot products are one FMA pass and a 5-step shuffle reduction. At the
// end the 8 partial softmaxes are combined through shared memory (the
// TPU's sequential kv axis carried its state in VMEM instead). Rows whose
// l is 0 (length 0) give 0, as the Pallas kernel's guard does.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_G = 8;       // query heads per kv head
constexpr int DMAX = 128;
constexpr int EPL = DMAX / 32; // head-dim elements per lane
constexpr float NEG_INF = -1e30f;

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_fwd(const T* __restrict__ q, const T* __restrict__ kc,
           const T* __restrict__ vc, T* __restrict__ o,
           const int* __restrict__ length, int Smax, int Hkv, int G, int D,
           long long q_b, long long k_b, long long k_s, long long v_b,
           long long v_s, long long o_b, float scale) {
  __shared__ float ms[WARPS][MAX_G], ls[WARPS][MAX_G];
  __shared__ float accs[WARPS][MAX_G][DMAX];

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = min(max(*length, 0), Smax);
  const T* kb = kc + b * k_b + (long long)h * D;
  const T* vb = vc + b * v_b + (long long)h * D;

  float qr[MAX_G][EPL], m[MAX_G], l[MAX_G], acc[MAX_G][EPL];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane + 32 * e;
      qr[g][e] = (g < G && d < D)
                     ? to_f32(q[b * q_b + (long long)(h * G + g) * D + d])
                     : 0.f;
      acc[g][e] = 0.f;
    }
  }

  for (int j = warp; j < len; j += WARPS) {
    float kr[EPL], vr[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane + 32 * e;
      kr[e] = d < D ? to_f32(kb[j * k_s + d]) : 0.f;
      vr[e] = d < D ? to_f32(vb[j * v_s + d]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;   // uniform across the block
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) part = fmaf(qr[g][e], kr[e], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const float s = part * scale;
      const float m_new = fmaxf(m[g], s);
      const float corr = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * corr + p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vr[e], acc[g][e] * corr);
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      ms[warp][g] = m[g];
      ls[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) accs[warp][g][lane + 32 * e] = acc[g][e];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, ms[w][g]);
    float L = 0.f, acc_d = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(ms[w][g] - M);
      L = fmaf(ls[w][g], f, L);
      acc_d = fmaf(accs[w][g][d], f, acc_d);
    }
    o[b * o_b + (long long)(h * G + g) * D + d] =
        from_f32<T>(L == 0.f ? 0.f : acc_d / L);
  }
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, void* o,
           const int* length, int B, int Smax, int Hkv, int G, int D,
           long long q_b, long long k_b, long long k_s, long long v_b,
           long long v_s, long long o_b, cudaStream_t s) {
  decode_fwd<T><<<B * Hkv, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<T*>(o), length, Smax, Hkv, G, D,
      q_b, k_b, k_s, v_b, v_s, o_b, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// o [B,Hkv*G,D] = decode attention of q [B,Hkv*G,D] over the first *length
// rows of k/v caches [B,Smax,Hkv,D]. Each operand has unit stride along D
// and stride D between heads; q_b, k_b/k_s, v_b/v_s and o_b are batch and
// sequence strides in elements. length points to one int32 on the device.
// dtype: 0 fp32, 1 bf16, 2 fp16. Returns the cudaError_t of the launch
// (0 on success); never synchronises.
extern "C" int decode_attention_fwd(const void* q, const void* kc,
                                    const void* vc, void* o, const void* length,
                                    int B, int Smax, int Hkv, int G, int D,
                                    long long q_b, long long k_b, long long k_s,
                                    long long v_b, long long v_s, long long o_b,
                                    int dtype, void* stream) {
  if (B <= 0 || Smax <= 0 || Hkv <= 0 || G <= 0 || G > MAX_G || D <= 0 ||
      D > DMAX || length == nullptr)
    return (int)cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(length);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, kc, vc, o, len, B, Smax, Hkv, G, D, q_b, k_b, k_s, v_b, v_s, o_b, s);
    case 1: return launch<__nv_bfloat16>(q, kc, vc, o, len, B, Smax, Hkv, G, D, q_b, k_b, k_s, v_b, v_s, o_b, s);
    case 2: return launch<__half>(q, kc, vc, o, len, B, Smax, Hkv, G, D, q_b, k_b, k_s, v_b, v_s, o_b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
