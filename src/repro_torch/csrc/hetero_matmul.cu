// Aligned-path ("MXU", the paper's NPU) GEMM for Hopper (sm_90a).
//
// Replaces src/repro/kernels/hetero_matmul/kernel.py::matmul_pallas and its
// two bodies, _mm_kernel_output_stationary and _mm_kernel_weight_stationary:
// y[M,N] = x[M,K] @ w[K,N] with fp32 accumulation, for fp32, bf16 and fp16
// inputs, output in the input type. M, K and N are multiples of 128 (the
// caller pads, as the reference's HeteroCtx._mxu does).
//
// Operands are strided: each is row-major with a leading dimension, or the
// transpose of one (trans flag). The caller passes column slices w[:, a:b]
// and the order exchange's w.T / x.T without copying them.
//
// What bounds it on the H100. At the serving path's shapes (M of a prefill
// chunk, 128..512 rows, against a 4096 x n weight block) the work is
// memory-bound by the weight stream (w_gate, M=256, n=7168: 64.5 MB in
// 19 us, 15 GFLOP in 15 us at the bf16 tensor-core rate). This first
// version does not reach that: it multiplies on the CUDA cores in fp32 FMA
// (67 TFLOP/s peak, not the tensor cores' 989), so it is bound by FMA issue.
// fp32 inputs get true fp32 products (no TF32), which the reference's fp32
// tolerance (2e-6) needs; bf16/fp16 products are exact in fp32.
//
// Design. Output-stationary (the serving path's order): one block per
// 128 x 128 output tile, the k loop inside the block in slices of 16
// staged through shared memory as fp32, an 8 x 8 register accumulator per
// thread (64 FMAs per 16 shared loads), one store. This replaces the TPU's
// sequential grid with its VMEM scratch accumulator. Weight-stationary:
// one block per 128 x 128 weight tile (the reference's bk x bn), resident
// in shared memory while the block sweeps every m tile; fp32 partial
// products go into an fp32 buffer by atomicAdd (blocks run in no order, so
// the revisit-and-accumulate of the TPU grid becomes an unordered sum),
// then a cast pass writes the output type. wgmma, TMA and a pipeline are
// later work.

#include "common.cuh"

#include <type_traits>

namespace {

constexpr int BM = 128;        // output tile rows
constexpr int BN = 128;        // output tile columns
constexpr int BK = 16;         // k slice staged per shared-memory round
constexpr int WS_BK = 128;     // weight-stationary resident tile depth
constexpr int THREADS = 256;   // 16 x 16 threads, 8 x 8 outputs each
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int PAD = 4;         // shared row padding against bank conflicts

// Stage a KT x JT block of an operand into shared memory as fp32, k-major:
// S[kk * LDS + j] = op(j0 + j, k0 + kk), where j is the operand's
// non-contracted index (m for x, n for w). op(j, k) lives at p[j * ld + k]
// when k is the contiguous index (k_contig), else at p[k * ld + j].
// Consecutive threads walk the contiguous index, so reads coalesce.
template <typename T, int KT, int JT, int LDS>
__device__ __forceinline__ void stage(float* S, const T* __restrict__ p,
                                      long long ld, bool k_contig,
                                      long long j0, long long k0) {
  for (int idx = threadIdx.x; idx < KT * JT; idx += THREADS) {
    int j, kk;
    if (k_contig) { j = idx / KT; kk = idx % KT; }
    else          { kk = idx / JT; j = idx % JT; }
    const long long jj = j0 + j, kg = k0 + kk;
    S[kk * LDS + j] = to_f32(p[k_contig ? jj * ld + kg : kg * ld + jj]);
  }
}

// acc += Xs[kk][rows] (x) Ws[kk][cols] over KT staged k values. Thread
// (ty, tx) owns rows ty + 16 i and columns tx + 16 j, so a warp's reads of
// one k row hit 32 distinct banks (B) or broadcast (A). The slice is summed
// into a fresh partial first and then added to acc, as the reference adds
// one tile product per k step: over K = 4096 this keeps the fp32 rounding
// well inside the fp32 tolerance.
template <int KT>
__device__ __forceinline__ void fma_slice(float (&acc)[TM][TN], const float* As,
                                          const float* Bs, int ty, int tx) {
  float part[TM][TN] = {};
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = As[kk * (BM + PAD) + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = Bs[kk * (BN + PAD) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mm_output_stationary(const T* __restrict__ a, const T* __restrict__ b,
                     T* __restrict__ c, int N, int K, long long lda,
                     long long ldb, bool a_kc, bool b_kc) {
  __shared__ float As[BK * (BM + PAD)];
  __shared__ float Bs[BK * (BN + PAD)];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;
  float acc[TM][TN] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    stage<T, BK, BM, BM + PAD>(As, a, lda, a_kc, m0, k0);
    stage<T, BK, BN, BN + PAD>(Bs, b, ldb, b_kc, n0, k0);
    __syncthreads();
    fma_slice<BK>(acc, As, Bs, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      c[(m0 + ty + 16 * i) * N + n0 + tx + 16 * j] = from_f32<T>(acc[i][j]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mm_weight_stationary(const T* __restrict__ a, const T* __restrict__ b,
                     float* __restrict__ out, int M, int N, long long lda,
                     long long ldb, bool a_kc, bool b_kc) {
  extern __shared__ float smem[];
  float* Ws = smem;                          // [WS_BK][BN + PAD], resident
  float* Xs = smem + WS_BK * (BN + PAD);     // [BK][BM + PAD], streamed
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long n0 = (long long)blockIdx.x * BN;
  const long long k0 = (long long)blockIdx.y * WS_BK;
  stage<T, WS_BK, BN, BN + PAD>(Ws, b, ldb, b_kc, n0, k0);
  for (long long m0 = 0; m0 < M; m0 += BM) {
    float acc[TM][TN] = {};
    for (int kk0 = 0; kk0 < WS_BK; kk0 += BK) {
      stage<T, BK, BM, BM + PAD>(Xs, a, lda, a_kc, m0, k0 + kk0);
      __syncthreads();
      fma_slice<BK>(acc, Xs, Ws + kk0 * (BN + PAD), ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        atomicAdd(&out[(m0 + ty + 16 * i) * N + n0 + tx + 16 * j], acc[i][j]);
  }
}

template <typename T>
__global__ void cast_from_f32(const float* __restrict__ src, T* __restrict__ dst,
                              long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = from_f32<T>(src[i]);
}

template <typename T>
int launch(const void* a, const void* b, void* c, void* scratch, int M, int N,
           int K, long long lda, long long ldb, bool a_kc, bool b_kc,
           int stationary, cudaStream_t s) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  if (stationary == 0) {
    dim3 grid(N / BN, M / BM);
    mm_output_stationary<T><<<grid, THREADS, 0, s>>>(A, B, static_cast<T*>(c),
                                                    N, K, lda, ldb, a_kc, b_kc);
    return (int)cudaGetLastError();
  }
  // fp32 output accumulates in place; other types through the fp32 scratch
  float* acc = std::is_same<T, float>::value ? static_cast<float*>(c)
                                             : static_cast<float*>(scratch);
  cudaError_t e = cudaMemsetAsync(acc, 0, (size_t)M * N * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  const int smem = (WS_BK * (BN + PAD) + BK * (BM + PAD)) * (int)sizeof(float);
  e = cudaFuncSetAttribute(mm_weight_stationary<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / BN, K / WS_BK);
  mm_weight_stationary<T><<<grid, THREADS, smem, s>>>(A, B, acc, M, N, lda, ldb,
                                                      a_kc, b_kc);
  e = cudaGetLastError();
  if (e != cudaSuccess || std::is_same<T, float>::value) return (int)e;
  const long long n = (long long)M * N;
  cast_from_f32<T><<<(int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096), 256,
                     0, s>>>(acc, static_cast<T*>(c), n);
  return (int)cudaGetLastError();
}

}  // namespace

// y[M,N] = op_a(a) @ op_b(b). op_a(a)[m,k] is a[m*lda + k], or a[k*lda + m]
// when trans_a; op_b(b)[k,n] is b[k*ldb + n], or b[n*ldb + k] when trans_b.
// c is contiguous [M,N]; scratch is an fp32 [M,N] buffer, used only by the
// weight-stationary order with bf16/fp16 (may be null otherwise).
// dtype: 0 fp32, 1 bf16, 2 fp16. stationary: 0 output, 1 weight.
// Returns the cudaError_t of the launches (0 on success); never synchronises.
extern "C" int hetero_matmul(const void* a, const void* b, void* c,
                             void* scratch, int M, int N, int K, long long lda,
                             long long ldb, int trans_a, int trans_b, int dtype,
                             int stationary, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % BM || N % BN || K % WS_BK ||
      (stationary != 0 && stationary != 1))
    return (int)cudaErrorInvalidValue;
  const bool a_kc = !trans_a, b_kc = trans_b != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(a, b, c, scratch, M, N, K, lda, ldb, a_kc, b_kc, stationary, s);
    case 1: return launch<__nv_bfloat16>(a, b, c, scratch, M, N, K, lda, ldb, a_kc, b_kc, stationary, s);
    case 2: return launch<__half>(a, b, c, scratch, M, N, K, lda, ldb, a_kc, b_kc, stationary, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
