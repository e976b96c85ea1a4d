// Weight-only quantized aligned-path GEMMs for Hopper (sm_90a).
//
// Replaces two kernels of src/repro/kernels/hetero_matmul/kernel.py:
//   quant_matmul_pallas (body _mm_kernel_quant): y = x @ (wq * scale), wq
//     int8 [K,N], one fp32 scale per output column;
//   q4_matmul_pallas (body _mm_kernel_q4): the same with two int4 codes per
//     byte along K, packed row r holding K rows 2r (low nibble) and 2r+1
//     (high nibble), each sign-extended.
// x is [M,K] in fp32, bf16 or fp16; y is [M,N] in x's type; fp32
// accumulation. M, K and N are multiples of 128 (the caller pads, as the
// reference's HeteroCtx._mxu_quant does).
//
// Operands are strided: x and the codes are row-major with a leading
// dimension, so the weight strategy's column slice wq[:, :n] of a wider
// code tensor, and its scale slice, arrive as views without a copy.
//
// What bounds it on the H100. At the serving path's shapes (a 128- or
// 256-token prefill chunk against a 4096 x n code block: wq n=2560, w_gate
// n=8960) the work is bound by operations at the bf16 tensor-core rate
// (w_gate, M=256: 18.8 GFLOP in 19.0 us against 43 MB moved in 13.0 us
// with int8 codes, 25 MB in 7.5 us with int4). This first version does not reach that: it multiplies on the
// CUDA cores in fp32 FMA (67 TFLOP/s peak), so it is bound by FMA issue,
// as the fp GEMM of hetero_matmul.cu is. fp32 activations get true fp32
// products (no TF32), which the reference's fp32 tolerance (2e-6) needs.
//
// Design. Output-stationary, the reference's only order for these
// kernels: one block per 128 x 128 output tile, the k loop inside the
// block in slices of 16 (even, so a slice never starts mid-byte of the
// packed codes). Each slice stages x as fp32 and the weight dequantized
// once, float(code) * scale[n], into shared memory; every thread then
// accumulates an 8 x 8 register tile and the block stores once. This
// replaces the TPU's sequential grid with its VMEM scratch accumulator.
// wgmma on dequantized bf16 tiles, TMA and a pipeline are later work.

#include "common.cuh"

#include <cstdint>

namespace {

constexpr int BM = 128;        // output tile rows
constexpr int BN = 128;        // output tile columns
constexpr int BK = 16;         // k slice staged per shared-memory round (even)
constexpr int THREADS = 256;   // 16 x 16 threads, 8 x 8 outputs each
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int PAD = 4;         // shared row padding against bank conflicts

// Sign-extended nibbles of one packed byte, on 32-bit integers.
__device__ __forceinline__ int nibble_lo(int8_t b) {
  return static_cast<int>(static_cast<unsigned>(static_cast<int>(b)) << 28) >> 28;
}
__device__ __forceinline__ int nibble_hi(int8_t b) { return static_cast<int>(b) >> 4; }

template <typename T, bool Q4>
__global__ void __launch_bounds__(THREADS)
quant_mm(const T* __restrict__ x, const int8_t* __restrict__ wq,
         const float* __restrict__ scale, T* __restrict__ y, int N, int K,
         long long ldx, long long ldw) {
  __shared__ float Xs[BK * (BM + PAD)];   // [kk][m], fp32
  __shared__ float Ws[BK * (BN + PAD)];   // [kk][n], dequantized fp32
  __shared__ float Ss[BN];                // this tile's column scales
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;
  for (int j = threadIdx.x; j < BN; j += THREADS) Ss[j] = scale[n0 + j];
  __syncthreads();

  float acc[TM][TN] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    // x slice: 16 consecutive threads walk one row's contiguous k
    for (int idx = threadIdx.x; idx < BK * BM; idx += THREADS) {
      const int m = idx / BK, kk = idx % BK;
      Xs[kk * (BM + PAD) + m] = to_f32(x[(m0 + m) * ldx + k0 + kk]);
    }
    // weight slice, dequantized once: consecutive threads walk n
    if (Q4) {
      const long long r0 = k0 / 2;          // k0 is even: a whole byte row
      for (int idx = threadIdx.x; idx < (BK / 2) * BN; idx += THREADS) {
        const int r = idx / BN, j = idx % BN;
        const int8_t b = wq[(r0 + r) * ldw + n0 + j];
        Ws[(2 * r) * (BN + PAD) + j] = (float)nibble_lo(b) * Ss[j];
        Ws[(2 * r + 1) * (BN + PAD) + j] = (float)nibble_hi(b) * Ss[j];
      }
    } else {
      for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
        const int kk = idx / BN, j = idx % BN;
        Ws[kk * (BN + PAD) + j] = (float)wq[(k0 + kk) * ldw + n0 + j] * Ss[j];
      }
    }
    __syncthreads();
    // one slice's partial, then added to acc, as the reference adds one
    // tile product per k step
    float part[TM][TN] = {};
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = Xs[kk * (BM + PAD) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Ws[kk * (BN + PAD) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      y[(m0 + ty + 16 * i) * N + n0 + tx + 16 * j] = from_f32<T>(acc[i][j]);
}

template <bool Q4>
int launch(const void* x, const void* wq, const float* scale, void* y, int M,
           int N, int K, long long ldx, long long ldw, int dtype,
           cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0 || M % BM || N % BN || K % BM)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, M / BM);
  const int8_t* W = static_cast<const int8_t*>(wq);
  switch (dtype) {
    case 0:
      quant_mm<float, Q4><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(x), W, scale, static_cast<float*>(y), N, K,
          ldx, ldw);
      break;
    case 1:
      quant_mm<__nv_bfloat16, Q4><<<grid, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), W, scale,
          static_cast<__nv_bfloat16*>(y), N, K, ldx, ldw);
      break;
    case 2:
      quant_mm<__half, Q4><<<grid, THREADS, 0, s>>>(
          static_cast<const __half*>(x), W, scale, static_cast<__half*>(y), N,
          K, ldx, ldw);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// y[M,N] = x[M,K] @ (wq[K,N] * scale[N]). x[m,k] is x[m*ldx + k];
// wq[k,n] is wq[k*ldw + n] (int8); scale is fp32 with unit stride; y is
// contiguous [M,N] in x's type. dtype: 0 fp32, 1 bf16, 2 fp16. Returns the
// cudaError_t of the launch (0 on success); never synchronises.
extern "C" int quant_matmul_int8(const void* x, const void* wq,
                                 const float* scale, void* y, int M, int N,
                                 int K, long long ldx, long long ldw, int dtype,
                                 void* stream) {
  return launch<false>(x, wq, scale, y, M, N, K, ldx, ldw, dtype,
                       static_cast<cudaStream_t>(stream));
}

// The same with packed int4 codes: wq4 is [K/2, N] int8 with row stride
// ldw, packed row r holding K rows 2r (low nibble) and 2r+1 (high nibble).
extern "C" int quant_matmul_q4(const void* x, const void* wq4,
                               const float* scale, void* y, int M, int N,
                               int K, long long ldx, long long ldw, int dtype,
                               void* stream) {
  return launch<true>(x, wq4, scale, y, M, N, K, ldx, ldw, dtype,
                      static_cast<cudaStream_t>(stream));
}
