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
// with int8 codes, 25 MB in 7.5 us with int4).
//
// int8 and int4 codes, bf16 / fp16 x: the tensor cores (qgemm_tc below).
// Codes in [-127, 127] (int8) and [-8, 7] (int4) are exact in bf16 and
// fp16, so the kernel converts the codes, not the weights: wgmma multiplies
// x by the converted codes into fp32 accumulators, and the per-column scale
// is applied once, in the epilogue, after the K sum. No weight is ever
// rounded, which keeps the product closer to the reference's fp32
// x . (code . s) than bf16 dequantized weights would. The dataflow is the fp
// GEMM's (hetero_matmul.cu, gemm_tc): one block per 128 x BN output tile
// and split of K, one producer warp keeping a ring of TMA loads in flight
// (the x tile with 128-byte swizzle, the codes as a plain BN-byte-wide box:
// 64 int8 rows, or the 32 packed rows that hold the same 64 K rows in
// int4), two consumer warpgroups running wgmma.mma_async m64nBNk16. Each
// k-step adds a converter step: the consumers turn the box into 16-bit
// codes (a byte permute into an fp32 2^23 + offset + code, one
// subtraction, a paired round-exact convert; an int4 byte first splits
// into its two nibbles with a mask and a shift, so one packed row gives
// two K rows) and store them in the MN-major 128-byte-swizzled layout TMA
// would have produced (16-byte chunk c of row r at chunk c ^ (r mod 8)),
// fence the stores for the async proxy and meet at a named barrier before
// the wgmma. The converted tiles rotate through three buffers outside the
// ring, so the ring keeps as many stages of loads in flight as shared
// memory holds: int8 7 (BN 128) or 4 (BN 64, two blocks an SM), int4,
// whose stages are 4 KB (BN 128) or 2 KB (BN 64) smaller, 8 or 4 (a fifth
// would not leave room for two blocks an SM). A buffer is rewritten only
// three steps later, when both warpgroups' products on it are done. The
// plan (ops.gemm_plan) splits K at thin M; each split writes unscaled fp32
// partials and a second pass sums them in split order, then scales and
// casts, so runs repeat bit for bit. A block keeps its SM's shared memory
// busy (the conversion's stores beside wgmma's operand reads), so a grid
// just over 132 blocks (w_gate's 140 at M = 256) takes two blocks' time
// whether the extra blocks wait for a wave or share an SM: spreading the
// k-steps evenly over the SMs (stream-K) is the next step.
//
// fp32 x, int8 or int4 codes: CUDA-core FMA (true fp32 products, no TF32,
// which the reference's fp32 tolerance of 2e-6 needs), output-stationary,
// the reference's only order for these kernels: one block per 128 x 128
// output tile, the k loop inside the block in slices of 16 (even, so a
// slice never starts mid-byte of the packed codes). Each slice stages x as
// fp32 and the weight dequantized once, float(code) * scale[n], into shared
// memory; every thread then accumulates an 8 x 8 register tile and the
// block stores once.

#include "common.cuh"
#include "hopper.cuh"

#include <cstdint>
#include <type_traits>

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

template <bool Q4>
__global__ void __launch_bounds__(THREADS)
quant_mm(const float* __restrict__ x, const int8_t* __restrict__ wq,
         const float* __restrict__ scale, float* __restrict__ y, int N, int K,
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
      Xs[kk * (BM + PAD) + m] = x[(m0 + m) * ldx + k0 + kk];
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
      y[(m0 + ty + 16 * i) * N + n0 + tx + 16 * j] = acc[i][j];
}

template <bool Q4>
int launch_fma(const void* x, const void* wq, const float* scale, void* y,
               int M, int N, int K, long long ldx, long long ldw,
               cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0 || M % BM || N % BN || K % BM)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, M / BM);
  quant_mm<Q4><<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(wq), scale,
      static_cast<float*>(y), N, K, ldx, ldw);
  return (int)cudaGetLastError();
}

}  // namespace

// --------------------------------- int8 codes x bf16 / fp16: tensor cores --

namespace tc8 {

constexpr int BM = 128;                   // output tile rows
constexpr int BK = 64;                    // k per stage: 128-byte x rows
constexpr int CONSUMERS = 2;              // warpgroups, 64 rows each
constexpr int CONSUMER_THREADS = CONSUMERS * 128;
constexpr int PRODUCER_WARP = CONSUMERS * 4;
constexpr int THREADS = CONSUMER_THREADS + 32;
constexpr int A_BYTES = BM * BK * 2;      // x tile, 128-byte swizzled
constexpr int CONVERTED = 3;              // 16-bit code tiles in rotation
static_assert(BK == 64, "slice_desc's tiles are 64 deep");

// The ring's stages hold what TMA loads: the x tile and the code box (BK
// int8 rows, or BK / 2 packed int4 rows, of BN bytes). The codes converted
// to 16 bits (MN-major, 128-byte swizzled, 64-wide boxes SW128_BOX apart)
// rotate through CONVERTED tiles of their own, so a deep ring of loads
// stays in flight: as many stages as fit one block an SM at BN 128 (int8
// 7, int4 8) and two blocks an SM at BN 64 (4 either way). Every part is
// 1024-aligned.
template <int BN, bool Q4>
struct Ring {
  static constexpr int Q_ROWS = Q4 ? BK / 2 : BK;
  static constexpr int Q_BYTES = BN * Q_ROWS;
  static constexpr int STAGE = A_BYTES + Q_BYTES;
  static constexpr int STAGES = BN == 128 ? (Q4 ? 8 : 7) : 4;
  static constexpr int B_BYTES = BN * BK * 2;
  // + 1024 to align the ring, + the full and empty barriers
  static constexpr int SMEM =
      STAGES * STAGE + CONVERTED * B_BYTES + 1024 + 2 * STAGES * 8;
  static_assert(STAGE % 1024 == 0 && B_BYTES % 1024 == 0, "1024-aligned");
  // a block's 227 KB; at BN 64 two blocks (and their 1 KB reserves) an SM
  static_assert(SMEM <= 232448 && (BN == 128 || 2 * (SMEM + 1024) <= 233472),
                "the ring does not fit");
};

template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four codes of a word of offset codes as exact floats: each byte u_i =
// code_i + BIAS (non-negative) becomes the low mantissa bits of 2^23
// (0x4B000000), and 2^23 + BIAS is subtracted.
template <int BIAS>
__device__ __forceinline__ void codes4(uint32_t u, float (&f)[4]) {
  constexpr float base = 8388608.f + BIAS;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - base;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - base;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - base;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - base;
}

// 16 codes of a uint4 of offset codes (BIAS as codes4) as 8 words of
// paired T.
template <typename T, int BIAS>
__device__ __forceinline__ void codes16(const uint32_t (&u)[4],
                                        uint32_t (&out)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    codes4<BIAS>(u[i], f);
    out[2 * i] = pack2<T>(f[0], f[1]);
    out[2 * i + 1] = pack2<T>(f[2], f[3]);
  }
}

// Columns n .. n + 15 of K row r of the converted tile: box n / 64,
// 16-byte chunks ch and ch + 1 of the row, swizzled. `odd` picks which of
// the two a thread stores first, so that each 8-thread phase of a 16-byte
// store meets 8 distinct bank groups.
__device__ __forceinline__ void store_row16(uint8_t* b, int r, int n,
                                            int odd, const uint32_t (&out)[8]) {
  const int ch = (n % 64) / 8, sw = r & 7;
  uint8_t* row = b + (n / 64) * SW128_BOX + r * 128;
  const uint4 lo = make_uint4(out[0], out[1], out[2], out[3]);
  const uint4 hi = make_uint4(out[4], out[5], out[6], out[7]);
  *reinterpret_cast<uint4*>(row + (((ch + odd) ^ sw) << 4)) = odd ? hi : lo;
  *reinterpret_cast<uint4*>(row + (((ch + 1 - odd) ^ sw) << 4)) = odd ? lo : hi;
}

// The stage's code box q into b as T, laid out as TMA's 128-byte swizzle
// lays out a row-major [K, N] tile of T in 64-wide boxes. int8: BK rows of
// BN codes; thread t of the consumers converts 16-code chunks t, t + 256,
// ... An 8-thread phase holds one row of 128 codes (two boxes a multiple
// of 128 bytes apart: the second box's threads store their odd chunk
// first) or two rows of 64 (their swizzles differ in the lowest bit).
// int4: BK / 2 packed rows of BN bytes; a 16-byte chunk of packed row r
// gives 16 codes of K row 2r (the low nibbles: (w & 0x0F) ^ 8 = code + 8)
// and 16 of K row 2r + 1 (the high nibbles, shifted down first). Here a
// phase holds one packed row (BN 128) or two (BN 64, whose K rows' swizzles
// differ by 2), so the first chunk alternates with the box and the row.
template <typename T, int BN, bool Q4>
__device__ __forceinline__ void convert_codes(const uint8_t* q, uint8_t* b,
                                              int t) {
  constexpr int PER_ROW = BN / 16;
#pragma unroll
  for (int c = t; c < Ring<BN, Q4>::Q_ROWS * PER_ROW; c += CONSUMER_THREADS) {
    const int r = c / PER_ROW, n = (c % PER_ROW) * 16;
    const uint4 w = *reinterpret_cast<const uint4*>(q + r * BN + n);
    uint32_t out[8];
    if constexpr (Q4) {
      const uint32_t lo[4] = {(w.x & 0x0F0F0F0Fu) ^ 0x08080808u,
                              (w.y & 0x0F0F0F0Fu) ^ 0x08080808u,
                              (w.z & 0x0F0F0F0Fu) ^ 0x08080808u,
                              (w.w & 0x0F0F0F0Fu) ^ 0x08080808u};
      const uint32_t hi[4] = {((w.x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                              ((w.y >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                              ((w.z >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                              ((w.w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u};
      const int odd = (n / 64 + r) & 1;
      codes16<T, 8>(lo, out);
      store_row16(b, 2 * r, n, odd, out);
      codes16<T, 8>(hi, out);
      store_row16(b, 2 * r + 1, n, odd, out);
    } else {
      const uint32_t u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                             w.z ^ 0x80808080u, w.w ^ 0x80808080u};
      codes16<T, 128>(u, out);
      store_row16(b, r, n, (n / 64) & 1, out);
    }
  }
}

// c (or the split's unscaled fp32 partial) = x[m0:m0+128, ks] @
// code[ks, n0:n0+BN] (* scale[n] where unsplit) over this block's `steps`
// k-steps; Q4: the codes packed two to a byte along K.
template <typename T, int BN, bool Q4>
__global__ void __launch_bounds__(THREADS, BN == 64 ? 2 : 1)
qgemm_tc(const __grid_constant__ CUtensorMap map_x,
         const __grid_constant__ CUtensorMap map_q,
         const float* __restrict__ scale, T* __restrict__ c,
         float* __restrict__ part, int M, int N, int steps) {
  using R = Ring<BN, Q4>;
  constexpr int STAGES = R::STAGES;
  constexpr bool HALF = std::is_same<T, __half>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* converted = ring + STAGES * R::STAGE;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(converted + CONVERTED * R::B_BYTES);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int first = blockIdx.z * steps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      for (int it = 0; it < steps; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
        uint8_t* sa = ring + s * R::STAGE;
        const int k0 = (first + it) * BK;
        mbar_arrive_expect_tx(&full[s], R::STAGE);
        tma_load_2d(sa, &map_x, &full[s], k0, m0);
        tma_load_2d(sa + A_BYTES, &map_q, &full[s], n0, Q4 ? k0 / 2 : k0);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows m0 + 64 wg .. + 63, SW128_BOX bytes into
  // the x tile
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < steps; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    // converted tile it % 3 was last read by the products of step it - 3,
    // done in this warpgroup (wait<1> of step it - 2) and in the other
    // (it passed step it - 1's barrier after its wait<1> of step it - 2)
    const uint8_t* sa = ring + s * R::STAGE;
    uint8_t* sb = converted + (it % CONVERTED) * R::B_BYTES;
    convert_codes<T, BN, Q4>(sa + A_BYTES, sb, threadIdx.x);
    fence_proxy_async_smem();
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) {
      const uint64_t da = slice_desc<0>(sa + wg * SW128_BOX, k);
      const uint64_t db = slice_desc<1>(sb, k);
      if constexpr (BN == 128) wgmma_m64n128k16<HALF, 0, 1>(acc, da, db);
      else wgmma_m64n64k16<HALF, 0, 1>(acc, da, db);
    }
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
    wgmma_wait<1>();        // the previous stage's products are done:
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
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
      const float s0 = __ldg(scale + col + 8 * j);
      const float s1 = __ldg(scale + col + 8 * j + 1);
      store2(&c[(size_t)row * N + col + 8 * j], acc[4 * j] * s0,
             acc[4 * j + 1] * s1);
      store2(&c[(size_t)(row + 8) * N + col + 8 * j], acc[4 * j + 2] * s0,
             acc[4 * j + 3] * s1);
    }
  }
}

// c = (sum over s of part[s] in split order) * scale[n], cast to T.
template <typename T>
__global__ void splitk_reduce_scaled(const float* __restrict__ part,
                                     const float* __restrict__ scale,
                                     T* __restrict__ c, long long mn, int N,
                                     int split) {
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < mn; i += (long long)gridDim.x * blockDim.x * 4) {
    float4 acc = *reinterpret_cast<const float4*>(&part[i]);
    for (int s = 1; s < split; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(&part[s * mn + i]);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    const float* sc = scale + i % N;      // N % 4 == 0: one row
    store2(&c[i], acc.x * sc[0], acc.y * sc[1]);
    store2(&c[i + 2], acc.z * sc[2], acc.w * sc[3]);
  }
}

template <typename T, int BN, bool Q4>
int launch_t(const CUtensorMap& mx, const CUtensorMap& mq, const float* scale,
             T* c, float* part, int M, int N, int steps, int split,
             cudaStream_t s) {
  using R = Ring<BN, Q4>;
  auto kernel = qgemm_tc<T, BN, Q4>;
  static bool sized = false;   // the attribute once per instantiation
  cudaError_t e;
  if (!sized) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             R::SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  dim3 grid(M / BM, N / BN, split);
  kernel<<<grid, THREADS, R::SMEM, s>>>(mx, mq, scale, c, part, M, N, steps);
  e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return (int)e;
  const long long mn = (long long)M * N;
  const long long blocks = (mn / 4 + 255) / 256;
  splitk_reduce_scaled<T><<<(int)(blocks < 2048 ? blocks : 2048), 256, 0, s>>>(
      part, scale, c, mn, N, split);
  return (int)cudaGetLastError();
}

// Validates the plan and the TMA operand rules (16-byte-aligned bases, x's
// leading dimension a multiple of 8 elements, the codes' of 16 bytes). Q4:
// wq holds K / 2 packed rows.
template <bool Q4>
int launch(const void* x, const void* wq, const float* scale, void* y,
           void* scratch, int M, int N, int K, long long ldx, long long ldw,
           bool half, int block_n, int split, cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0 || (block_n != 64 && block_n != 128) ||
      M % BM || N % block_n || K % BK || split < 1 || (K / BK) % split ||
      (split > 1 && scratch == nullptr) || M / BM > 65535 || split > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wq) % 16 ||
      ldx % 8 || ldw % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mq;
  int e = encode_map_2d(&mx, x, half, K, M, ldx, 64, BM);
  if (e) return e;
  e = encode_map_2d_u8(&mq, wq, N, Q4 ? K / 2 : K, ldw, block_n,
                       Ring<128, Q4>::Q_ROWS);
  if (e) return e;
  float* part = split > 1 ? static_cast<float*>(scratch) : nullptr;
  const int steps = K / BK / split;
  if (half) {
    __half* C = static_cast<__half*>(y);
    return block_n == 128
               ? launch_t<__half, 128, Q4>(mx, mq, scale, C, part, M, N, steps, split, s)
               : launch_t<__half, 64, Q4>(mx, mq, scale, C, part, M, N, steps, split, s);
  }
  __nv_bfloat16* C = static_cast<__nv_bfloat16*>(y);
  return block_n == 128
             ? launch_t<__nv_bfloat16, 128, Q4>(mx, mq, scale, C, part, M, N, steps, split, s)
             : launch_t<__nv_bfloat16, 64, Q4>(mx, mq, scale, C, part, M, N, steps, split, s);
}

}  // namespace tc8

// y[M,N] = x[M,K] @ (wq[K,N] * scale[N]). x[m,k] is x[m*ldx + k];
// wq[k,n] is wq[k*ldw + n] (int8); scale is fp32 with unit stride; y is
// contiguous [M,N] in x's type. dtype: 0 fp32, 1 bf16, 2 fp16. bf16 / fp16
// run the tensor-core kernel on the plan (block_n 64 or 128, split dividing
// K / 64), with 16-byte-aligned x and wq, ldx a multiple of 8 and ldw of
// 16; scratch is then an fp32 [split, M, N] buffer (null for split 1).
// fp32 runs the FMA body (block_n, split and scratch unused). Returns the
// cudaError_t of the launches (0 on success); never synchronises.
extern "C" int quant_matmul_int8(const void* x, const void* wq,
                                 const float* scale, void* y, void* scratch,
                                 int M, int N, int K, long long ldx,
                                 long long ldw, int dtype, int block_n,
                                 int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_fma<false>(x, wq, scale, y, M, N, K, ldx, ldw, s);
    case 1: return tc8::launch<false>(x, wq, scale, y, scratch, M, N, K, ldx, ldw, false, block_n, split, s);
    case 2: return tc8::launch<false>(x, wq, scale, y, scratch, M, N, K, ldx, ldw, true, block_n, split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same with packed int4 codes: wq4 is [K/2, N] int8 with row stride
// ldw, packed row r holding K rows 2r (low nibble) and 2r+1 (high nibble).
// bf16 / fp16 run the tensor-core kernel on the plan, under the same
// operand rules as quant_matmul_int8 (wq4 16-byte aligned, ldw a multiple
// of 16); fp32 runs the FMA body.
extern "C" int quant_matmul_q4(const void* x, const void* wq4,
                               const float* scale, void* y, void* scratch,
                               int M, int N, int K, long long ldx,
                               long long ldw, int dtype, int block_n,
                               int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_fma<true>(x, wq4, scale, y, M, N, K, ldx, ldw, s);
    case 1: return tc8::launch<true>(x, wq4, scale, y, scratch, M, N, K, ldx, ldw, false, block_n, split, s);
    case 2: return tc8::launch<true>(x, wq4, scale, y, scratch, M, N, K, ldx, ldw, true, block_n, split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
