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
// Two kernels after the pre-pass, one for dk and dv, one for dq. Tiles
// wholly in the causal future are never visited. Rows past the end, keys
// past Sk and the padding of D are staged as zeros; P is masked to 0 there.
//
// What bounds it on the H100: at the training shape (qwen3-1.7b: B 2,
// S 4096, 16 / 8 heads of 128, causal) the five products over the visible
// pairs are 0.34 TFLOP a call against 202 MB of q, k, v, o, dO, lse and
// gradients: 0.35 ms at the bf16 tensor-core rate against 0.06 ms of bytes,
// so it is bound by operations. This design computes S and dP twice (in
// both kernels): seven products where five would do, 0.49 ms at that rate.
// The separate dq kernel is what keeps every sum in one fixed order without
// a semaphore between blocks; its cost is those two products.
//
// bf16 / fp16: warpgroup MMA (wgmma) fed by TMA, warp-specialised. A block
// is three warpgroups: two consumers (64 keys or positions each) and a
// producer whose first warp keeps the loads in flight (setmaxnreg gives the
// consumers 232 registers, the producer 40). Every 64-row tile of q, k, v or
// dO arrives as 64 x 64 boxes of a 4-D tensor map ([B, S, H, D]: the rows
// of one head), 128-byte swizzled, with zeros past S and D (an operand
// whose rows or base are not 16-byte aligned is copied into the same
// swizzled layout by the producer warp's lanes instead). D is taken at 64,
// 80 (zamba2's own width) or 128.
//   dk/dv: one block per (batch * kv head, 128 keys). K and V of the keys
//     are loaded once; a ring of 3 stages (4 at D <= 64), each with a full
//     and an empty mbarrier, brings (query head, 64-position) tiles of Q,
//     dO and the rows' lse and delta, from the first tile that can see the
//     block's first key, over all G query heads of the kv head, so the GQA
//     sum is taken in the accumulators. Each consumer: S^T = K Q^T and
//     dP^T = V dO^T as wgmma with both operands in shared memory (K-major),
//     P^T and dS^T formed in registers (exp2 of the scaled score minus lse,
//     the causal select, rounding to the input type), then dV += P^T dO and
//     dK += dS^T Q as wgmma with A from registers and B the same Q / dO tile
//     read MN-major through wgmma's transpose bit: no second copy of Q or
//     dO. dK and dV stay in fp32 registers until the end.
//   dq: one block per (batch * query head, 128 positions), last positions
//     (the longest) first; Q and dO resident, a ring of 2 stages (4 at
//     D <= 64) of 64-key K and V tiles up to the last key any row sees
//     (dk/dv gains from a third stage, dq does not); S = Q K^T and dP = dO V^T
//     from shared memory, dS in registers, dQ += dS K with A from
//     registers and K read MN-major.
// A consumer skips a tile wholly in its rows' causal future; the ring still
// walks it (a key or position tile that some other warpgroup of the block
// needs). In dk/dv the two consumers take turns to issue their products
// (named barriers), so one's softmax runs under the other's products; the
// dq kernel ran slower that way on the H100 and issues freely. Neither
// kernel has atomics: a gradient is bitwise the same run to run.
//
// What holds it back (H100, qwen3's shape): dk/dv runs its four products at
// ~475 TFLOP/s, dq its three at ~540. S^T and dP^T read both operands from
// shared memory; at m64n64k16 that is 128 bytes a clock a warpgroup, the
// SM's whole shared-memory rate, so two consumers' score products together
// run at most at half the tensor rate. At zamba2's D = 80 the products are
// shorter against the same softmax and barriers (~310 and ~385 TFLOP/s).
//
// fp32 keeps true fp32 operands, no TF32 (the reference's 2e-6): one block
// per (batch * kv head, 64 keys) for dk/dv and per 64 packed rows for dq,
// on the CUDA cores, 256 threads as 16 x 16, tiles staged in shared
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

// ---------------------------------- bf16 / fp16: wgmma, fed by TMA --

constexpr int TR = 64;                  // rows (keys or positions) a tile
constexpr int CWG = 2;                  // consumer warpgroups a block
constexpr int WG_THREADS = (CWG + 1) * 128;
constexpr int BOX = SW128_BOX;          // one 64 x 64 16-bit swizzled box
constexpr int PRODUCER_REGS = 40;       // setmaxnreg: 128 * 40 + 256 * 232
constexpr int CONSUMER_REGS = 232;      //   <= 65,536

// The shared-memory plan of a kernel for D taken as DN (64, 80 or 128): a
// 64-row tile of one operand is ND boxes of 64 D-values; resident, two
// operands for each consumer warpgroup's 64 rows (K and V of the dk/dv
// block, Q and dO of the dq block); a ring of STAGES stages, each two
// operand tiles (Q and dO, or K and V) and, for dk/dv, the tile's 64 rows'
// lse * log2(e) and delta. Four stages at D <= 64; above, dk/dv takes
// three and dq two, the fastest of two to four on the H100.
template <int DN, bool DKDV>
struct Plan {
  static constexpr int ND = (DN + 63) / 64;
  static constexpr int KS = DN / 16;    // k-steps of S and dP over D
  static constexpr int TILE = ND * BOX;
  static constexpr int STAGES = ND == 1 ? 4 : DKDV ? 3 : 2;
  static constexpr int RESIDENT = 2 * CWG * TILE;
  static constexpr int RING = STAGES * 2 * TILE;
  static constexpr int STATS = STAGES * 2 * TR * 4;
  static constexpr int BARS = (2 * STAGES + 1) * 8;
  static constexpr int SMEM = 1024 + RESIDENT + RING + STATS + BARS;
  static_assert(SMEM <= 232448, "one block an SM");
};

struct WgArgs {
  const void *q, *k, *v, *dout;         // the untiled path's sources
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int Sq, Sk, Hkv, G, D, causal, tma;
  float scale;
};

// A 64-row tile of a [B, S, H, D] operand (rows s0 .. s0 + 63 of head h)
// into ND swizzled boxes at dst, as TMA lays it out (zeros past S and D),
// by the producer warp's 32 lanes: where TMA cannot take the operand (D * 2
// or a base not a multiple of 16 bytes). The writes are fenced for wgmma's
// async proxy.
template <typename T, int ND>
__device__ void copy_tile(uint8_t* dst, const T* src, int b, int s0, int S,
                          int H, int h, int D) {
  const int lane = threadIdx.x % 32;
  for (int idx = lane; idx < TR * ND * 64; idx += 32) {
    const int r = idx / (ND * 64), d = idx % (ND * 64), s = s0 + r, c = d % 64;
    T val = from_f32<T>(0.f);
    if (s < S && d < D) val = src[(((long long)b * S + s) * H + h) * D + d];
    *reinterpret_cast<T*>(dst + (d / 64) * BOX + r * 128 +
                          (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2) = val;
  }
  fence_proxy_async_smem();
}

// One 64-row tile into dst: TMA boxes counted on `bar` (lane 0), or the
// lanes' copies.
template <typename T, int ND>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, const WgArgs& a,
                                          const void* src, int b, int s0,
                                          int S, int H, int h) {
  if (a.tma) {
    if (threadIdx.x % 32 == 0)
#pragma unroll
      for (int i = 0; i < ND; ++i)
        tma_load_4d(dst + i * BOX, map, bar, 64 * i, h, s0, b);
  } else {
    copy_tile<T, ND>(dst, static_cast<const T*>(src), b, s0, S, H, h, a.D);
  }
}

// wgmma descriptors of k-step ks of a 64-row tile: K-major (the tile's rows
// are the product's M or N, D its depth: S = Q K^T and the like), or
// MN-major (the tile's 64 rows are the depth, D the N: dV += P^T dO), read
// through wgmma's transpose bit from the same boxes.
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int ks) {
  return sw128_desc(tile + (ks / 4) * BOX + (ks % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile, int ks) {
  return sw128_desc(tile + ks * 2048, BOX, 1024);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16*, float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(__half*, float a, float b) {
  __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Columns 16 kk .. 16 kk + 15 of a 64 x 64 wgmma accumulator as the A
// fragment of the next product (k-step kk), rounded to T.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[32],
                                         int kk) {
  a[0] = pack2((T*)nullptr, c[8 * kk], c[8 * kk + 1]);
  a[1] = pack2((T*)nullptr, c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack2((T*)nullptr, c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack2((T*)nullptr, c[8 * kk + 6], c[8 * kk + 7]);
}

// The consumer warpgroups take turns to issue their products: warpgroup w
// waits at named barrier 1 + w for its turn and, its products issued,
// hands the turn over at 2 - w, so that one warpgroup's softmax overlaps
// the other's products.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(d[i]);
}

// S = A_s B_s^T (64 x 64, depth KS k-steps) into d; A and B K-major tiles.
template <bool HALF, int KS>
__device__ __forceinline__ void scores(float (&d)[32], const uint8_t* A,
                                       const uint8_t* Bt) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_m64n64k16<HALF, 0, 0>(d, kmajor(A, ks), kmajor(Bt, ks));
}

// A warpgroup's 64 x DN accumulator (warp w: rows 16 w + lane / 4 and + 8,
// columns 8 j + 2 (lane % 4) + {0, 1}) times `mul` into a [B, S, H, D]
// output at rows s0 .., head h; rows past S and columns past D dropped.
template <typename T, int DN>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[DN / 2],
                                           float mul, int b, int s0, int S,
                                           int H, int h, int D) {
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = s0 + 16 * w + lane / 4 + 8 * i;
    if (s >= S) continue;
    T* row = out + (((long long)b * S + s) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      const int d = 8 * j + 2 * (lane % 4);
      const float x = acc[4 * j + 2 * i] * mul, y = acc[4 * j + 2 * i + 1] * mul;
      if (d + 1 < D && D % 2 == 0) {
        store2(row + d, x, y);
      } else {
        if (d < D) row[d] = from_f32<T>(x);
        if (d + 1 < D) row[d + 1] = from_f32<T>(y);
      }
    }
  }
}

// dK and dV of 128 keys: one block per (batch * kv head, 128 keys), each
// consumer warpgroup 64 keys. The ring walks the (query head g, 64-position
// tile) pairs of the kv head from the first tile any of the block's keys
// can see; a warpgroup skips a tile wholly in its keys' causal future.
template <typename T, int DN>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkdv_wg(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mo,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv, const WgArgs a) {
  using P = Plan<DN, true>;
  constexpr bool HALF = std::is_same<T, __half>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Vs = Ks + CWG * P::TILE;
  uint8_t* ring = Vs + CWG * P::TILE;       // [STAGES][Q, dO]
  float* stats = reinterpret_cast<float*>(ring + P::RING);   // [STAGES][2][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(stats) + P::STATS);
  uint64_t* empty = full + P::STAGES;
  uint64_t* kv_bar = empty + P::STAGES;

  const int b = blockIdx.x / a.Hkv, h = blockIdx.x % a.Hkv;
  const int k0 = blockIdx.y * CWG * TR;
  const int Sq = a.Sq, Sk = a.Sk, G = a.G, Hq = a.Hkv * G;
  const int shift = Sk - Sq;
  const int pt0 = a.causal ? max(0, k0 - shift) / TR : 0;
  const int per_g = max(0, (Sq + TR - 1) / TR - pt0);
  const int n_tiles = G * per_g;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 32);              // the producer warp's lanes
      mbar_init(&empty[s], CWG * 4);        // one arrival a consumer warp
    }
    mbar_init(kv_bar, 32);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CWG) {                          // the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x % 128 >= 32) return;
    const int lane = threadIdx.x % 32;
    if (a.tma && lane == 0) mbar_expect_tx(kv_bar, 2 * CWG * P::TILE);
#pragma unroll
    for (int i = 0; i < CWG; ++i) {
      load_tile<T, P::ND>(Ks + i * P::TILE, &mk, kv_bar, a, a.k, b,
                          k0 + TR * i, Sk, a.Hkv, h);
      load_tile<T, P::ND>(Vs + i * P::TILE, &mv, kv_bar, a, a.v, b,
                          k0 + TR * i, Sk, a.Hkv, h);
    }
    mbar_arrive(kv_bar);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % P::STAGES;
      if (it >= P::STAGES) mbar_wait(&empty[s], (it / P::STAGES - 1) & 1);
      const int hq = h * G + it / per_g, p0 = (pt0 + it % per_g) * TR;
      uint8_t* qt = ring + s * 2 * P::TILE;
      if (a.tma && lane == 0) mbar_expect_tx(&full[s], 2 * P::TILE);
      load_tile<T, P::ND>(qt, &mq, &full[s], a, a.q, b, p0, Sq, Hq, hq);
      load_tile<T, P::ND>(qt + P::TILE, &mo, &full[s], a, a.dout, b, p0, Sq,
                          Hq, hq);
      float* st = stats + s * 2 * TR;
      for (int r = lane; r < TR; r += 32) {
        const int p = p0 + r;
        const long long at = ((long long)b * Hq + hq) * Sq + p;
        st[r] = p < Sq ? a.lse[at] * LOG2E : 0.f;
        st[TR + r] = p < Sq ? a.delta[at] : 0.f;
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int kw = k0 + TR * wg;              // the warpgroup's first key
  const float scale_log2 = a.scale * LOG2E;
  const uint8_t* Kw = Ks + wg * P::TILE;
  const uint8_t* Vw = Vs + wg * P::TILE;
  float dk[DN / 2], dv[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_bar, 0);
  if (wg == 1) turn_pass(wg);   // warpgroup 0 issues first

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % P::STAGES;
    const int p0 = (pt0 + it % per_g) * TR;
    mbar_wait(&full[s], (it / P::STAGES) & 1);
    // the tile's last position sees the warpgroup's first key
    if (kw >= Sk || (a.causal && kw > min(p0 + TR, Sq) - 1 + shift)) {
      turn_wait(wg);            // two turns, nothing issued
      turn_pass(wg);
      turn_wait(wg);
      turn_pass(wg);
    } else {
      const uint8_t* Qt = ring + s * 2 * P::TILE;
      const uint8_t* Ot = Qt + P::TILE;
      const float* L2 = stats + s * 2 * TR;
      const float* Dl = L2 + TR;
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 positions
      float st[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dp[i] = 0.f;
      fence_acc(st);
      fence_acc(dp);
      turn_wait(wg);
      wgmma_fence();
      scores<HALF, P::KS>(st, Kw, Qt);
      scores<HALF, P::KS>(dp, Vw, Ot);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      fence_acc(st);
      fence_acc(dp);
      // P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta), masked
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + 16 * w + lane / 4 + 8 * (e >> 1);
          const int r = 8 * j + 2 * (lane % 4) + (e & 1), p = p0 + r;
          const bool ok = p < Sq && key < Sk && (!a.causal || key <= p + shift);
          const float pv = ok ? exp2f(st[4 * j + e] * scale_log2 - L2[r]) : 0.f;
          st[4 * j + e] = pv;
          dp[4 * j + e] = pv * (dp[4 * j + e] - Dl[r]);
        }
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a<T>(pa[kk], st, kk);
        acc_to_a<T>(da[kk], dp, kk);
      }
      // dV += P^T dO and dK += dS^T Q over the tile's 64 positions
      fence_acc(dv);
      fence_acc(dk);
      turn_wait(wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_mn<HALF, DN>(dv, pa[kk], mnmajor(Ot, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_mn<HALF, DN>(dk, da[kk], mnmajor(Qt, kk));
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      fence_acc(dv);
      fence_acc(dk);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  store_rows<T, DN>(static_cast<T*>(a.dk), dk, a.scale, b, kw, Sk, a.Hkv, h,
                    a.D);
  store_rows<T, DN>(static_cast<T*>(a.dv), dv, 1.f, b, kw, Sk, a.Hkv, h, a.D);
}

// dQ of 128 positions of one query head: one block per (batch * query head,
// 128 positions), each consumer warpgroup 64 positions; the ring walks the
// 64-key tiles up to the last one any of the block's rows sees, and a
// warpgroup skips a tile wholly in its rows' causal future. Blocks of the
// last positions (the longest) launch first.
template <typename T, int DN>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_wg(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mo,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, const WgArgs a) {
  using P = Plan<DN, false>;
  constexpr bool HALF = std::is_same<T, __half>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Os = Qs + CWG * P::TILE;
  uint8_t* ring = Os + CWG * P::TILE;       // [STAGES][K, V]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + P::RING + P::STATS);
  uint64_t* empty = full + P::STAGES;
  uint64_t* q_bar = empty + P::STAGES;

  const int Sq = a.Sq, Sk = a.Sk, G = a.G, Hq = a.Hkv * G;
  const int b = blockIdx.x / Hq, hq = blockIdx.x % Hq, h = hq / G;
  const int p0 = (gridDim.y - 1 - blockIdx.y) * CWG * TR;
  const int shift = Sk - Sq;
  const int last = min(p0 + CWG * TR, Sq) - 1;
  const int kv_end = a.causal ? min(Sk, last + shift + 1) : Sk;
  const int n_tiles = (kv_end + TR - 1) / TR;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], CWG * 4);
    }
    mbar_init(q_bar, 32);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CWG) {                          // the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x % 128 >= 32) return;
    const int lane = threadIdx.x % 32;
    if (a.tma && lane == 0) mbar_expect_tx(q_bar, 2 * CWG * P::TILE);
#pragma unroll
    for (int i = 0; i < CWG; ++i) {
      load_tile<T, P::ND>(Qs + i * P::TILE, &mq, q_bar, a, a.q, b,
                          p0 + TR * i, Sq, Hq, hq);
      load_tile<T, P::ND>(Os + i * P::TILE, &mo, q_bar, a, a.dout, b,
                          p0 + TR * i, Sq, Hq, hq);
    }
    mbar_arrive(q_bar);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % P::STAGES;
      if (it >= P::STAGES) mbar_wait(&empty[s], (it / P::STAGES - 1) & 1);
      uint8_t* kt = ring + s * 2 * P::TILE;
      if (a.tma && lane == 0) mbar_expect_tx(&full[s], 2 * P::TILE);
      load_tile<T, P::ND>(kt, &mk, &full[s], a, a.k, b, it * TR, Sk, a.Hkv,
                          h);
      load_tile<T, P::ND>(kt + P::TILE, &mv, &full[s], a, a.v, b, it * TR,
                          Sk, a.Hkv, h);
      mbar_arrive(&full[s]);
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int pw = p0 + TR * wg;              // the warpgroup's first position
  const float scale_log2 = a.scale * LOG2E;
  const uint8_t* Qw = Qs + wg * P::TILE;
  const uint8_t* Ow = Os + wg * P::TILE;
  // this thread's two rows: lim, the last key each sees (-1: none)
  int lim[2];
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = pw + 16 * w + lane / 4 + 8 * i;
    lim[i] = p >= Sq ? -1 : (a.causal ? min(p + shift, Sk - 1) : Sk - 1);
    const long long at = ((long long)b * Hq + hq) * Sq + p;
    l2[i] = p < Sq ? a.lse[at] * LOG2E : 0.f;
    dl[i] = p < Sq ? a.delta[at] : 0.f;
  }
  // the end of the keys that any of the warpgroup's rows sees
  const int w_end = pw >= Sq ? 0
                  : a.causal ? min(Sk, min(pw + TR, Sq) + shift) : Sk;
  float dq[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) dq[i] = 0.f;
  mbar_wait(q_bar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % P::STAGES, c0 = it * TR;
    mbar_wait(&full[s], (it / P::STAGES) & 1);
    if (c0 < w_end) {
      const uint8_t* Kt = ring + s * 2 * P::TILE;
      const uint8_t* Vt = Kt + P::TILE;
      // S = Q K^T and dP = dO V^T: 64 positions x 64 keys
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      fence_acc(sc);
      fence_acc(dp);
      wgmma_fence();
      scores<HALF, P::KS>(sc, Qw, Kt);
      scores<HALF, P::KS>(dp, Ow, Vt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      // dS = P (dP - delta), P = exp(S scale - lse), masked
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, key = c0 + 8 * j + 2 * (lane % 4) + (e & 1);
          const float pv =
              key <= lim[i] ? exp2f(sc[4 * j + e] * scale_log2 - l2[i]) : 0.f;
          dp[4 * j + e] = pv * (dp[4 * j + e] - dl[i]);
        }
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a<T>(da[kk], dp, kk);
      // dQ += dS K over the tile's 64 keys
      fence_acc(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_mn<HALF, DN>(dq, da[kk], mnmajor(Kt, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dq);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  store_rows<T, DN>(static_cast<T*>(a.dq), dq, a.scale, b, pw, Sq, Hq, hq,
                    a.D);
}

// ------------------------------------------------------------ launches --

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, Hkv, G, D, causal;
  int vec;     // TMA takes q, k, v, dO (D * 2, bases: multiples of 16 B)
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

// What a call launches, as its entry decides it and the launch uses it:
// the path (0 fp32 on the CUDA cores, 1 wgmma), D as the kernels take it,
// threads a block, the grids of the dk/dv and dq kernels, their ring stages
// (0 on the fp32 path) and dynamic shared memory, and whether TMA loads the
// operands (1) or the producer warp copies them (0).
struct Launch {
  int wgmma, dn, threads, tma;
  int dkdv_grid[2], dq_grid[2], stages[2], smem[2];
};

template <int DMAX>
Launch fma_launch(const Args& a) {
  const int smem = (int)fma_smem_bytes<DMAX>();
  return {0, DMAX, F_THREADS, 0,
          {a.B * a.Hkv, (a.Sk + FR - 1) / FR},
          {a.B * a.Hkv, (a.Sq * a.G + FR - 1) / FR}, {0, 0}, {smem, smem}};
}

template <int DN>
Launch wg_launch(const Args& a) {
  using PK = Plan<DN, true>;
  using PQ = Plan<DN, false>;
  constexpr int ROWS = CWG * TR;
  return {1, DN, WG_THREADS, a.vec,
          {a.B * a.Hkv, (a.Sk + ROWS - 1) / ROWS},
          {a.B * a.Hkv * a.G, (a.Sq + ROWS - 1) / ROWS},
          {PK::STAGES, PQ::STAGES}, {PK::SMEM, PQ::SMEM}};
}

// fp32: D taken as 32, 64 or 128; bf16 / fp16: at its own width where it is
// zamba2's 80, else 64 or 128 (the pad is zero-filled by the loads)
Launch plan(const Args& a, int dtype) {
  if (dtype == 0)
    return a.D <= 32 ? fma_launch<32>(a)
         : a.D <= 64 ? fma_launch<64>(a) : fma_launch<128>(a);
  return a.D <= 64 ? wg_launch<64>(a)
       : a.D <= 80 ? wg_launch<80>(a) : wg_launch<128>(a);
}

template <int DMAX>
int launch_fma(const Args& a, const Launch& p, cudaStream_t s) {
  static bool sized = false;   // the attributes once per instantiation
  cudaError_t e;
  if (!sized) {
    if ((e = set_smem(flash_bwd_dkdv_fma<DMAX>, p.smem[0])) != cudaSuccess ||
        (e = set_smem(flash_bwd_dq_fma<DMAX>, p.smem[1])) != cudaSuccess)
      return (int)e;
    sized = true;
  }
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v),
              *dout = static_cast<const float*>(a.dout);
  flash_bwd_dkdv_fma<DMAX><<<dim3(p.dkdv_grid[0], p.dkdv_grid[1]),
                              p.threads, p.smem[0], s>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.Sq, a.Sk, a.Hkv, a.G, a.D, a.causal,
      a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_dq_fma<DMAX><<<dim3(p.dq_grid[0], p.dq_grid[1]), p.threads,
                            p.smem[1], s>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq), a.Sq, a.Sk,
      a.Hkv, a.G, a.D, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int DN>
int launch_wg(const Args& a, const Launch& p, cudaStream_t s) {
  static bool sized = false;   // the attributes once per instantiation
  cudaError_t e;
  if (!sized) {
    if ((e = set_smem(flash_bwd_dkdv_wg<T, DN>, p.smem[0])) != cudaSuccess ||
        (e = set_smem(flash_bwd_dq_wg<T, DN>, p.smem[1])) != cudaSuccess)
      return (int)e;
    sized = true;
  }
  constexpr bool HALF = std::is_same<T, __half>::value;
  const int Hq = a.Hkv * a.G;
  CUtensorMap mq{}, mo{}, mk{}, mv{};
  if (p.tma) {
    int r;
    if ((r = encode_map_bshd(&mq, a.q, HALF, a.B, a.Sq, Hq, a.D)) != 0 ||
        (r = encode_map_bshd(&mo, a.dout, HALF, a.B, a.Sq, Hq, a.D)) != 0 ||
        (r = encode_map_bshd(&mk, a.k, HALF, a.B, a.Sk, a.Hkv, a.D)) != 0 ||
        (r = encode_map_bshd(&mv, a.v, HALF, a.B, a.Sk, a.Hkv, a.D)) != 0)
      return r;
  }
  const WgArgs w{a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.dk, a.dv,
                 a.Sq, a.Sk, a.Hkv, a.G, a.D, a.causal, p.tma, a.scale};
  flash_bwd_dkdv_wg<T, DN><<<dim3(p.dkdv_grid[0], p.dkdv_grid[1]),
                             p.threads, p.smem[0], s>>>(mq, mo, mk, mv, w);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_dq_wg<T, DN><<<dim3(p.dq_grid[0], p.dq_grid[1]), p.threads,
                           p.smem[1], s>>>(mq, mo, mk, mv, w);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_wg(const Args& a, const Launch& p, cudaStream_t s) {
  int e = launch_delta<T>(a, s);
  if (e != 0) return e;
  switch (p.dn) {
    case 64: return launch_wg<T, 64>(a, p, s);
    case 80: return launch_wg<T, 80>(a, p, s);
    default: return launch_wg<T, 128>(a, p, s);
  }
}

int dispatch_fma(const Args& a, const Launch& p, cudaStream_t s) {
  int e = launch_delta<float>(a, s);
  if (e != 0) return e;
  switch (p.dn) {
    case 32: return launch_fma<32>(a, p, s);
    case 64: return launch_fma<64>(a, p, s);
    default: return launch_fma<128>(a, p, s);
  }
}

// The entry's checks and arguments, shared by the launch and its plan;
// false where the entry refuses the shapes.
bool make_args(Args* a, const void* q, const void* k, const void* v,
               const void* o, const void* dout, const void* lse, void* delta,
               void* dq, void* dk, void* dv, int B, int Sq, int Sk, int Hkv,
               int G, int D, int causal, int dtype) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || G <= 0 || D <= 0 ||
      D > 128 || (causal && Sq > Sk) || (long long)Sq * G > 65535LL * FR ||
      Sk > 65535LL * FR || dtype < 0 || dtype > 2)
    return false;
  const bool vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dout) % 16 == 0;
  *a = Args{q, k, v, o, dout, static_cast<const float*>(lse),
            static_cast<float*>(delta), dq, dk, dv, B, Sq, Sk, Hkv, G, D,
            causal, (int)vec, 1.0f / sqrtf((float)D)};
  return true;
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
  Args a;
  if (!make_args(&a, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hkv,
                 G, D, causal, dtype))
    return (int)cudaErrorInvalidValue;
  const Launch p = plan(a, dtype);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_fma(a, p, s);
    case 1: return dispatch_wg<__nv_bfloat16>(a, p, s);
    default: return dispatch_wg<__half>(a, p, s);
  }
}

// What flash_attention_bwd launches for these operands (q, k, v and dout as
// it would take them; nothing is read through them), into out[12]: path,
// D as taken, threads, tma, the dk/dv grid (2), the dq grid (2), stages
// (dk/dv, dq), dynamic shared memory (dk/dv, dq), as Launch holds them.
// Returns cudaErrorInvalidValue where the entry would refuse the shapes.
extern "C" int flash_attention_bwd_plan(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        int B, int Sq, int Sk, int Hkv, int G,
                                        int D, int causal, int dtype,
                                        int* out) {
  Args a;
  if (!make_args(&a, q, k, v, nullptr, dout, nullptr, nullptr, nullptr,
                 nullptr, nullptr, B, Sq, Sk, Hkv, G, D, causal, dtype))
    return (int)cudaErrorInvalidValue;
  const Launch p = plan(a, dtype);
  const int v12[12] = {p.wgmma, p.dn, p.threads, p.tma,
                       p.dkdv_grid[0], p.dkdv_grid[1], p.dq_grid[0],
                       p.dq_grid[1], p.stages[0], p.stages[1], p.smem[0],
                       p.smem[1]};
  for (int i = 0; i < 12; ++i) out[i] = v12[i];
  return 0;
}
