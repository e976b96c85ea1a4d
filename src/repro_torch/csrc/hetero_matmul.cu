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
// chunk, 128..512 rows, against a 4096 x n weight block) the work is bound
// by the weight stream (w_gate, M = 256, n = 7168: 64.5 MB in 19.2 us at
// 3.35 TB/s, 15 GFLOP in 15.2 us at the bf16 tensor-core rate).
//
// bf16 / fp16, output-stationary (the order HeteroCtx._mxu launches): the
// tensor cores, fed by TMA. One block per 128 x BN output tile (BN 64 or
// 128) and per split of K: two consumer warpgroups, 64 rows each, run
// wgmma.mma_async m64nBNk16 on 128-byte-swizzled shared tiles (BK = 64, so
// a tile row is 128 bytes) into fp32 register accumulators, while one
// producer warp keeps a ring of 3-4 stages of TMA loads in flight, each
// stage with a full and an empty mbarrier. Both operand forms of the path
// reach wgmma through its transpose bits: x (K-major) by w[:, a:b]
// (MN-major) directly, and w.T (MN-major) by x.T (K-major) after the order
// exchange; an MN-major tile is loaded as 64-wide TMA boxes (the swizzle's
// 128-byte limit). TMA needs 16-byte-aligned bases and leading dimensions,
// which the wrapper checks. At thin M the 128 x BN tiles are too few for
// 132 SMs (llama3's wk at a 44-token chunk is one tile), so the wrapper's
// plan (ops.gemm_plan) also splits K: each split writes an fp32 partial
// [split, M, N] and a second pass sums the partials in split order and
// casts, so two runs give the same bits (no float atomics). The partials
// add 8 * split * M * N bytes (written once, read once) to the weight's
// 2 * K * N; the plan takes the smallest split that fills the card, and a
// split only where the tiles alone do not.
//
// fp32 keeps true fp32 products (no TF32), which the reference's fp32
// tolerance (2e-6) needs: CUDA-core FMA, one block per 128 x 128 output
// tile, the k loop inside the block in slices of 16 staged through shared
// memory as fp32, an 8 x 8 register accumulator per thread. The
// weight-stationary order (every dtype): one block per 128 x 128 weight
// tile (the reference's bk x bn), resident in shared memory while the block
// sweeps every m tile; fp32 partial products go into an fp32 buffer by
// atomicAdd (blocks run in no order, so the revisit-and-accumulate of the
// TPU grid becomes an unordered sum), then a cast pass writes the output
// type.

#include "common.cuh"
#include "hopper.cuh"

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

// fp32 only: bf16 / fp16 take the tensor cores (gemm_tc below).
__global__ void __launch_bounds__(THREADS)
mm_output_stationary(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ c, int N, int K, long long lda,
                     long long ldb, bool a_kc, bool b_kc) {
  __shared__ float As[BK * (BM + PAD)];
  __shared__ float Bs[BK * (BN + PAD)];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;
  float acc[TM][TN] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    stage<float, BK, BM, BM + PAD>(As, a, lda, a_kc, m0, k0);
    stage<float, BK, BN, BN + PAD>(Bs, b, ldb, b_kc, n0, k0);
    __syncthreads();
    fma_slice<BK>(acc, As, Bs, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      c[(m0 + ty + 16 * i) * N + n0 + tx + 16 * j] = acc[i][j];
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

// The FMA orders: fp32 output-stationary, and weight-stationary in every
// dtype.
template <typename T>
int launch_fma(const void* a, const void* b, void* c, void* scratch, int M,
               int N, int K, long long lda, long long ldb, bool a_kc,
               bool b_kc, int stationary, cudaStream_t s) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  if (stationary == 0) {
    if constexpr (!std::is_same<T, float>::value) {
      return (int)cudaErrorInvalidValue;   // bf16 / fp16: gemm_tc
    } else {
      dim3 grid(N / BN, M / BM);
      mm_output_stationary<<<grid, THREADS, 0, s>>>(A, B, static_cast<float*>(c),
                                                    N, K, lda, ldb, a_kc, b_kc);
      return (int)cudaGetLastError();
    }
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

// ------------------------------------------- bf16 / fp16 tensor-core GEMM --

namespace tc {

constexpr int BM = 128;                   // output tile rows
constexpr int BK = 64;                    // k per stage: 128-byte tile rows
constexpr int CONSUMERS = 2;              // warpgroups, 64 rows each
constexpr int PRODUCER_WARP = CONSUMERS * 4;
constexpr int THREADS = CONSUMERS * 128 + 32;
constexpr int RING_BYTES = 96 * 1024;     // two blocks fit on an SM
constexpr int BOX = SW128_BOX;            // a 64-row 128-byte-swizzled box
static_assert(BK == 64, "slice_desc's tiles are 64 deep");

template <int BN>
struct Ring {
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE;     // 4 (BN 64), 3 (128)
  // + 1024 to align the ring, + the full and empty barriers
  static constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8;
  static_assert(STAGES >= 3, "a ring of at least three stages");
};

// c (or the split's fp32 partial) = A[m0:m0+128, ks] @ B[ks, n0:n0+BN] over
// this block's `steps` k-steps. TA / TB: 1 where A / B is MN-major.
template <typename T, int BN, int TA, int TB>
__global__ void __launch_bounds__(THREADS, 2)
gemm_tc(const __grid_constant__ CUtensorMap map_a,
        const __grid_constant__ CUtensorMap map_b, T* __restrict__ c,
        float* __restrict__ part, int M, int N, int steps) {
  using R = Ring<BN>;
  constexpr bool HALF = std::is_same<T, __half>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int first = blockIdx.z * steps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      for (int it = 0; it < steps; ++it) {
        const int s = it % R::STAGES;
        if (it >= R::STAGES) mbar_wait(&empty[s], (it / R::STAGES - 1) & 1);
        uint8_t* sa = ring + s * R::STAGE;
        uint8_t* sb = sa + R::A_BYTES;
        const int k0 = (first + it) * BK;
        mbar_arrive_expect_tx(&full[s], R::STAGE);
        if (TA) {
          tma_load_2d(sa, &map_a, &full[s], m0, k0);
          tma_load_2d(sa + BOX, &map_a, &full[s], m0 + 64, k0);
        } else {
          tma_load_2d(sa, &map_a, &full[s], k0, m0);
        }
        if (TB) {
#pragma unroll
          for (int i = 0; i < BN / 64; ++i)
            tma_load_2d(sb + i * BOX, &map_b, &full[s], n0 + 64 * i, k0);
        } else {
          tma_load_2d(sb, &map_b, &full[s], k0, n0);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows m0 + 64 wg .. + 63, which sit BOX bytes
  // into the A tile in either layout
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < steps; ++it) {
    const int s = it % R::STAGES;
    mbar_wait(&full[s], (it / R::STAGES) & 1);
    const uint8_t* sa = ring + s * R::STAGE + wg * BOX;
    const uint8_t* sb = ring + s * R::STAGE + R::A_BYTES;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) {
      const uint64_t da = slice_desc<TA>(sa, k), db = slice_desc<TB>(sb, k);
      if constexpr (BN == 128) wgmma_m64n128k16<HALF, TA, TB>(acc, da, db);
      else wgmma_m64n64k16<HALF, TA, TB>(acc, da, db);
    }
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
    wgmma_wait<1>();        // the previous stage's products are done:
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % R::STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);

  // accumulator fragment: warp w of the warpgroup holds rows 16 w + lane / 4
  // and + 8; acc[4 j + {0, 1}] columns 8 j + 2 (lane % 4) + {0, 1}, and
  // acc[4 j + {2, 3}] the same columns 8 rows down
  const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col = n0 + 2 * (lane % 4);
  if (part != nullptr) {
    float* p = part + (size_t)blockIdx.z * M * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(&p[(size_t)row * N + col + 8 * j]) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(&p[(size_t)(row + 8) * N + col + 8 * j]) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      store2(&c[(size_t)row * N + col + 8 * j], acc[4 * j], acc[4 * j + 1]);
      store2(&c[(size_t)(row + 8) * N + col + 8 * j], acc[4 * j + 2],
             acc[4 * j + 3]);
    }
  }
}

// c = sum over s of part[s] in split order (fp32), cast to T.
template <typename T>
__global__ void splitk_reduce(const float* __restrict__ part, T* __restrict__ c,
                              long long mn, int split) {
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < mn; i += (long long)gridDim.x * blockDim.x * 4) {
    float4 acc = *reinterpret_cast<const float4*>(&part[i]);
    for (int s = 1; s < split; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(&part[s * mn + i]);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    c[i] = from_f32<T>(acc.x);
    c[i + 1] = from_f32<T>(acc.y);
    c[i + 2] = from_f32<T>(acc.z);
    c[i + 3] = from_f32<T>(acc.w);
  }
}

template <typename T, int BN, int TA, int TB>
int launch_t(const CUtensorMap& ma, const CUtensorMap& mb, T* c, float* part,
             int M, int N, int steps, int split, cudaStream_t s) {
  auto kernel = gemm_tc<T, BN, TA, TB>;
  static bool sized = false;   // the attribute once per instantiation
  cudaError_t e;
  if (!sized) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Ring<BN>::SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  dim3 grid(M / BM, N / BN, split);
  kernel<<<grid, THREADS, Ring<BN>::SMEM, s>>>(ma, mb, c, part, M, N, steps);
  e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return (int)e;
  const long long mn = (long long)M * N;
  const long long blocks = (mn / 4 + 255) / 256;
  splitk_reduce<T><<<(int)(blocks < 2048 ? blocks : 2048), 256, 0, s>>>(
      part, c, mn, split);
  return (int)cudaGetLastError();
}

template <typename T, int BN>
int launch_bn(const CUtensorMap& ma, const CUtensorMap& mb, T* c, float* part,
              int M, int N, int steps, int split, int ta, int tb,
              cudaStream_t s) {
  if (ta && tb) return launch_t<T, BN, 1, 1>(ma, mb, c, part, M, N, steps, split, s);
  if (ta) return launch_t<T, BN, 1, 0>(ma, mb, c, part, M, N, steps, split, s);
  if (tb) return launch_t<T, BN, 0, 1>(ma, mb, c, part, M, N, steps, split, s);
  return launch_t<T, BN, 0, 0>(ma, mb, c, part, M, N, steps, split, s);
}

// The bf16 / fp16 output-stationary GEMM; a_mn / b_mn: the operand is
// MN-major. Validates the plan and the TMA operand rules.
int launch(const void* a, const void* b, void* c, void* scratch, int M, int N,
           int K, long long lda, long long ldb, int a_mn, int b_mn, bool half,
           int block_n, int split, cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0 || (block_n != 64 && block_n != 128) || M % BM || N % block_n || K % BK ||
      split < 1 || (K / BK) % split || (split > 1 && scratch == nullptr) ||
      M / BM > 65535 || split > 65535 ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16 ||
      lda % 8 || ldb % 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  int e = a_mn ? encode_map_2d(&ma, a, half, M, K, lda, 64, 64)
               : encode_map_2d(&ma, a, half, K, M, lda, 64, BM);
  if (e) return e;
  e = b_mn ? encode_map_2d(&mb, b, half, N, K, ldb, 64, 64)
           : encode_map_2d(&mb, b, half, K, N, ldb, 64, block_n);
  if (e) return e;
  float* part = split > 1 ? static_cast<float*>(scratch) : nullptr;
  const int steps = K / BK / split;
  if (half) {
    __half* C = static_cast<__half*>(c);
    return block_n == 128
               ? launch_bn<__half, 128>(ma, mb, C, part, M, N, steps, split, a_mn, b_mn, s)
               : launch_bn<__half, 64>(ma, mb, C, part, M, N, steps, split, a_mn, b_mn, s);
  }
  __nv_bfloat16* C = static_cast<__nv_bfloat16*>(c);
  return block_n == 128
             ? launch_bn<__nv_bfloat16, 128>(ma, mb, C, part, M, N, steps, split, a_mn, b_mn, s)
             : launch_bn<__nv_bfloat16, 64>(ma, mb, C, part, M, N, steps, split, a_mn, b_mn, s);
}

}  // namespace tc

// y[M,N] = op_a(a) @ op_b(b). op_a(a)[m,k] is a[m*lda + k], or a[k*lda + m]
// when trans_a; op_b(b)[k,n] is b[k*ldb + n], or b[n*ldb + k] when trans_b.
// c is contiguous [M,N]. dtype: 0 fp32, 1 bf16, 2 fp16. stationary: 0
// output, 1 weight. bf16 / fp16 output-stationary runs the tensor-core
// GEMM on the plan (block_n 64 or 128, split dividing K / 64) and needs
// 16-byte-aligned a and b with lda and ldb multiples of 8; scratch is then
// an fp32 [split, M, N] buffer (null for split 1). The other cases run the
// FMA bodies (block_n and split unused); scratch is an fp32 [M,N] buffer
// for weight-stationary bf16/fp16, else null. Returns the cudaError_t of
// the launches (0 on success); never synchronises.
extern "C" int hetero_matmul(const void* a, const void* b, void* c,
                             void* scratch, int M, int N, int K, long long lda,
                             long long ldb, int trans_a, int trans_b, int dtype,
                             int stationary, int block_n, int split,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype == 1 || dtype == 2) && stationary == 0)
    return tc::launch(a, b, c, scratch, M, N, K, lda, ldb, trans_a != 0,
                      trans_b == 0, dtype == 2, block_n, split, s);
  if (M <= 0 || N <= 0 || K <= 0 || M % BM || N % BN || K % WS_BK ||
      (stationary != 0 && stationary != 1))
    return (int)cudaErrorInvalidValue;
  const bool a_kc = !trans_a, b_kc = trans_b != 0;
  switch (dtype) {
    case 0: return launch_fma<float>(a, b, c, scratch, M, N, K, lda, ldb, a_kc, b_kc, stationary, s);
    case 1: return launch_fma<__nv_bfloat16>(a, b, c, scratch, M, N, K, lda, ldb, a_kc, b_kc, stationary, s);
    case 2: return launch_fma<__half>(a, b, c, scratch, M, N, K, lda, ldb, a_kc, b_kc, stationary, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
