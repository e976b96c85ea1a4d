// One Mamba2 SSD chunk step for Hopper (sm_90a): the hybrid's prefill scan.
//
// Replaces src/repro/kernels/ssm_scan/kernel.py::ssd_chunk_pallas (body
// _chunk_kernel). For each (batch b, head h), with xb [L,hd], B and C [L,N]
// (shared by the heads), seg [L] (the inclusive cumsum of the log decay)
// and S_prev [hd,N]:
//   y[i]  = sum_{j<=i} (C_i . B_j) exp(seg_i - seg_j) xb[j]
//           + exp(seg_i) (C_i . S_prev^T)
//   S_new = exp(seg_{L-1}) S_prev + sum_j exp(seg_{L-1} - seg_j) xb[j]^T B_j
// all in fp32 (the contract: fp32 operands and results, 1e-4). The upper
// triangle (j > i) is removed by a select, never multiplied: exp(seg_i -
// seg_j) may be inf there.
//
// What bounds it on the H100. At the zamba2-2.7b path shape (L = 256,
// nh = 80, hd = N = 64, B = 1) the function moves 13.3 MB (xb and y
// 5.24 MB each, S_prev and S_new 1.31 MB each), 4.0 us at 3.35 TB/s, and
// does 0.68 GFLOP over the causal pairs (C.B^T counted once per batch):
// 10.1 us at the 67 TFLOP/s of fp32 outside the tensor cores, or 4.1 us as
// three TF32 products each (below) at 495 TFLOP/s. One TF32 product keeps
// 11 bits of each operand and misses the 1e-4 (a numpy emulation reads
// 4e-4 to 6e-4 at L = 88 to 256); split fp32 reads 1e-7 to 2e-7.
//
// Design: split fp32 on the tensor cores, C.B^T once per batch.
//  - Every product runs on mma.sync m16n8k8 TF32 with each fp32 operand
//    split as a = hi + lo (hi = tf32(a), lo = tf32(a - hi), rounded to
//    nearest by two integer instructions) and summed as lo.hi + hi.lo +
//    hi.hi into fp32 accumulators (CUTLASS's "fast fp32" split); lo.lo,
//    below 2^-22 of the product, is left out.
//  - C.B^T is shared by the heads, so a first kernel (ssd_cb_tc, one block
//    per causal 64 x 64 tile and batch) writes it once per batch into an
//    fp32 scratch [B, Lp, Lp] (Lp = L rounded up to 64; 256 KB at L = 256,
//    which stays in L2) that the wrapper allocates; only the tiles on and
//    below the diagonal are written or read.
//  - The second kernel (ssd_chunk_tc, eight warps, two blocks an SM) takes
//    grid (nh, T + 1, B), T = ceil(L / 64): one block per row tile, and one
//    for S_new = (xb . w)^T B over the key tiles, w = exp(seg_{L-1} -
//    seg_j), ordered longest first (row tile T - 1, S_new, T - 2, .., 0).
//    A row tile t is a run of t + 2 stages, each a 64-deep product: the
//    inter-chunk term C . S_prev^T (then scaled by exp(seg_i)), then for
//    each key tile u <= t att . xb, att = C.B^T (from the scratch) *
//    exp(seg_i - seg_j) formed in the A fragments' registers. Key tiles
//    past the row tile are never visited; in the diagonal tile a warp
//    stops at its last row's key and the mask is a select; off the
//    diagonal there is no mask. Warps w and w + 4 share 16 rows and take
//    the even and the odd k-slices, and add up through shared memory at
//    the end.
//  - Data movement: a stage's tiles arrive by cp.async (16-byte copies
//    where the operands allow, zero-filled past L, hd or N) two stages
//    ahead, into three buffers; each warp splits the operands of its own
//    fragments into hi and lo as it reads them (no block-wide split, no
//    barrier for it). Tiles sit with row strides of 4 mod 32 words (read
//    as A, or as B from an [n][k] tile) or 8 mod 32 (as B from a [k][n]
//    tile), so each fragment load meets 32 banks.
//  - What holds it back: a block's stages run one after another (wait,
//    products). Alone on the card a row-tile-3 block takes ~15 us at
//    L = 256, several times the tensor cores' time for its products; at
//    nh = 80 two blocks share each SM and the grid takes ~31 us: the chain
//    of dependent steps in a stage, not bandwidth or the tensor pipe, sets
//    the pace (PERF.md, the SSD kernel's findings).
//  - hd and N are taken at run time up to the DMAX template (16, 32 or 64:
//    the smoke model's 16 and zamba2's 64 alike); ragged rows, keys, hd and
//    N are zero-filled, rows past L get seg = -inf (so exp gives 0, never
//    inf * 0).

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int R = 64;            // rows of y per tile, and keys per key tile
constexpr int CB_THREADS = 128;  // C.B^T: four warps of 16 rows
constexpr int THREADS = 256;     // the chunk step: two warps for 16 rows
constexpr int SR = R + 4;        // row stride of the C.B^T tile (A side)

struct Args {
  const float* xb;               // [B, L, nh, hd], rows strided
  const float* b;                // [B, L, N], rows strided
  const float* c;                // [B, L, N], rows strided
  const float* seg;              // [B, L, nh], rows strided
  const float* s_prev;           // [B, nh, hd, N], contiguous
  float* y;                      // [B, L, nh, hd], contiguous
  float* s_new;                  // [B, nh, hd, N], contiguous
  float* cb;                     // [B, Lp, Lp] scratch: C.B^T
  int L, Lp, nh, hd, N;
  long long xb_b, xb_s, b_b, b_s, c_b, c_s, seg_b, seg_s;
  bool vec;                      // xb, B, C and S_prev take 16-byte copies
};

// acc[NT][4] += A . B for one k-slice of 8 in split fp32, from the
// fragments' hi and lo parts; the small terms go first, each pass over the
// NT independent accumulators. Fragments as PTX lays out m16n8k8: lane =
// 4 g + t holds A at rows g, g + 8 and k t, t + 4 (a0 .. a3 in that order:
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)); B at k t, t + 4 and
// column g; C at rows g, g + 8 and columns 2t, 2t + 1.
template <int NT>
__device__ __forceinline__ void mma3_frag(float (&acc)[NT][4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&bh)[NT][2],
                                          const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_1688_tf32(acc[j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_1688_tf32(acc[j], ah, bl[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_1688_tf32(acc[j], ah, bh[j]);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// 4 bytes from global src to shared dst, asynchronously (cp.async); where
// !valid, nothing is read and dst is zero-filled.
__device__ __forceinline__ void cp_async_4z(void* dst, const float* src,
                                            bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// The same for 16 bytes (4 floats, 16-byte aligned at both ends).
__device__ __forceinline__ void cp_async_16z(void* dst, const float* src,
                                             bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Starts copying rows [row0, row0 + NR) x columns [0, D) of a row-strided
// fp32 matrix (row stride ld; rows past `rows` and columns past `cols` as 0)
// into shared memory with row stride S. Every thread issues its copies
// before any lands: one load latency a tile, not one a row. vec: 16-byte
// copies (src 16-byte aligned, ld and cols multiples of 4).
template <int D, int S, int NR = R>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ld, int row0, int rows,
                                          int cols, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < NR * D / 4; e += blockDim.x) {
      const int r = e / (D / 4), k = e % (D / 4) * 4, i = row0 + r;
      const bool ok = i < rows && k < cols;
      cp_async_16z(&dst[r * S + k], ok ? src + i * ld + k : src, ok);
    }
    return;
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < NR * D; e += blockDim.x) {
    const int r = e / D, k = e % D, i = row0 + r;
    const bool ok = i < rows && k < cols;
    cp_async_4z(&dst[r * S + k], ok ? src + i * ld + k : src, ok);
  }
}

// Starts copying 64 strided values (seg of one head at rows row0 ..; 0 past
// `rows`) into dst.
__device__ __forceinline__ void load_seg(float* dst, const float* seg,
                                         long long ld, int row0, int rows) {
  if (threadIdx.x < R) {
    const int i = row0 + threadIdx.x;
    cp_async_4z(&dst[threadIdx.x], i < rows ? seg + i * ld : seg, i < rows);
  }
}

template <int D>
constexpr int cb_smem() {
  return (int)sizeof(float) * 2 * R * (D + 4);
}

// One causal 64 x 64 tile (row tile t, key tile u <= t) of C.B^T for one
// batch: blockIdx.x enumerates the tiles row-major, blockIdx.y the batch.
template <int D>
__global__ void __launch_bounds__(CB_THREADS) ssd_cb_tc(Args a) {
  constexpr int S = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;              // Cs[r * S + n] = C[i0 + r, n]
  float* Bs = Cs + R * S;        // Bs[c * S + n] = B[k0 + c, n]
  int t = 0, u = blockIdx.x;
  while (u > t) u -= ++t;
  const int bb = blockIdx.y, i0 = t * R, k0 = u * R;
  load_tile<D, S>(Cs, a.c + bb * a.c_b, a.c_s, i0, a.L, a.N, a.vec);
  load_tile<D, S>(Bs, a.b + bb * a.b_b, a.b_s, k0, a.L, a.N, a.vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // C . B^T: the warp's 16 rows of C as A, B's rows as the columns of B^T,
  // both split on the fly (each value is read by one lane of one warp for
  // A, by every warp for B)
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  const float* ca = Cs + (16 * w + lane / 4) * S + lane % 4;
  const float* bt = Bs + (lane / 4) * S + lane % 4;
  float acc[8][4];
  zero(acc);
#pragma unroll
  for (int k = 0; k < D; k += 8) {
    uint32_t ah[4], al[4], bh[8][2], bl[8][2];
    split_tf32(ca[k], ah[0], al[0]);
    split_tf32(ca[8 * S + k], ah[1], al[1]);
    split_tf32(ca[k + 4], ah[2], al[2]);
    split_tf32(ca[8 * S + k + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      split_tf32(bt[8 * j * S + k], bh[j][0], bl[j][0]);
      split_tf32(bt[8 * j * S + k + 4], bh[j][1], bl[j][1]);
    }
    mma3_frag<8>(acc, ah, al, bh, bl);
  }

  const int row = i0 + 16 * w + lane / 4, col = k0 + 2 * (lane % 4);
  float* out = a.cb + (size_t)bb * a.Lp * a.Lp;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(&out[(size_t)row * a.Lp + col + 8 * j]) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(&out[(size_t)(row + 8) * a.Lp + col + 8 * j]) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// The chunk kernel's shared memory, in floats: NBUF buffers of a stage,
// so that two stages are in flight while one multiplies. tile_rows: the A
// tile [R][SR] (the C rows, or C.B^T of a key tile), the raw B tile
// [R][D+8] (S_prev [D][D+4], or xb of the keys) and seg of the keys [R];
// seg of the rows [R]. new_state: raw xb and B tiles [R][D+8] and seg of
// the keys [R].
constexpr int NBUF = 3;
template <int D>
struct ChunkSmem {
  static constexpr int Y_BUF = R * SR + R * (D + 8) + R;
  static constexpr int Y_B = R * SR;
  static constexpr int Y_SEG = Y_B + R * (D + 8);
  static constexpr int SEG_R = NBUF * Y_BUF;
  static constexpr int Y_END = SEG_R + R;
  static constexpr int S_BUF = 2 * R * (D + 8) + R;
  static constexpr int S_B = R * (D + 8);
  static constexpr int S_SEG = 2 * R * (D + 8);
  static constexpr int S_END = NBUF * S_BUF;
  static constexpr int BYTES =
      (int)sizeof(float) * (Y_END > S_END ? Y_END : S_END);
  static_assert(Y_BUF % 4 == 0 && Y_B % 4 == 0 && S_BUF % 4 == 0 &&
                S_B % 4 == 0, "16-byte aligned buffers");
  // two blocks an SM (each with its 1 KB reserve)
  static_assert(2 * (BYTES + 1024) <= 233472, "two blocks an SM");
};

// The lane's B fragments of slice s, every column tile, split on the fly
// from a raw tile: b(k, n) = src[k * LD + n] (TRANS: src[n * LD + k]).
// With LD = 8 mod 32 (and TRANS with 4 mod 32) each load meets 32 banks.
template <int D, int LD, bool TRANS>
__device__ __forceinline__ void b_frags(const float* src, int s,
                                        uint32_t (&bh)[D / 8][2],
                                        uint32_t (&bl)[D / 8][2]) {
  const int lane = threadIdx.x & 31, g = lane / 4, t = lane % 4;
  const float* at = TRANS ? src + g * LD + t + 8 * s : src + (8 * s + t) * LD + g;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    split_tf32(TRANS ? at[8 * j * LD] : at[8 * j], bh[j][0], bl[j][0]);
    split_tf32(TRANS ? at[8 * j * LD + 4] : at[4 * LD + 8 * j], bh[j][1],
               bl[j][1]);
  }
}

// The products of one stage for the warp's 16 rows, over the k-slices kh,
// kh + 2, ... (the other warp of the rows takes the rest), B split on the
// fly from the raw tile b_s. The A fragments (the lane's entries at rows
// g, g + 8 and k t, t + 4 of each slice) are formed in registers from the
// tile a_s:
//  INTER: a_s holds the C rows, A = C (D / 8 slices); b_s holds S_prev
//         [p][n], read transposed: C . S_prev^T;
//  OFF:   a_s holds C.B^T of a key tile below the diagonal, A = att =
//         C.B^T * exp(seg_i - seg_j); b_s holds xb: att . xb;
//  DIAG:  the same on the diagonal tile: keys past the row are a select to
//         0, and slices from k_end on (past the warp's last row, or L) are
//         skipped.
enum { INTER, OFF, DIAG };
template <int D, int MODE>
__device__ __forceinline__ void stage_product(float (&acc)[D / 8][4],
                                              const float* a_s,
                                              const float* b_s,
                                              const float* segk, float sr0,
                                              float sr1, int w, int kh,
                                              int k_end) {
  constexpr int KS = MODE == INTER ? D / 8 : 8;
  const int lane = threadIdx.x & 31, g = lane / 4, t = lane % 4;
  const float* al_ = a_s + (16 * w + g) * SR + t + 8 * kh;
  const float* skl = segk + t + 8 * kh;
  const int row = 16 * w + g;
#pragma unroll
  for (int s2 = 0; s2 < KS; s2 += 2) {
    const int s = s2 + kh;       // the slice; al_ and skl are at kh already
    if (s >= KS || (MODE == DIAG && 8 * s >= k_end)) break;
    float v[4] = {al_[8 * s2], al_[8 * SR + 8 * s2], al_[8 * s2 + 4],
                  al_[8 * SR + 8 * s2 + 4]};
    if (MODE != INTER) {
      const float e0 = skl[8 * s2], e1 = skl[8 * s2 + 4];
      v[0] *= expf(sr0 - e0);
      v[1] *= expf(sr1 - e0);
      v[2] *= expf(sr0 - e1);
      v[3] *= expf(sr1 - e1);
    }
    if (MODE == DIAG) {
      const int key = 8 * s + t;
      if (key > row) v[0] = 0.f;
      if (key > row + 8) v[1] = 0.f;
      if (key + 4 > row) v[2] = 0.f;
      if (key + 4 > row + 8) v[3] = 0.f;
    }
    uint32_t ah[4], al[4], bh[D / 8][2], bl[D / 8][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(v[i], ah[i], al[i]);
    if (MODE == INTER)
      b_frags<D, D + 4, true>(b_s, s, bh, bl);
    else
      b_frags<D, D + 8, false>(b_s, s, bh, bl);
    mma3_frag<D / 8>(acc, ah, al, bh, bl);
  }
}

// Warps w + 4 (kh 1) hand their partial sums to warps w (kh 0), which add
// them: through red ([64][D + 4] floats of shared memory that no warp reads
// any more once the block meets here).
template <int D>
__device__ __forceinline__ void exchange(float (&acc)[D / 8][4], float* red,
                                         int w, int kh, bool live) {
  constexpr int RS = D + 4;
  const int lane = threadIdx.x & 31;
  float* at = red + (16 * w + lane / 4) * RS + 2 * (lane % 4);
  __syncthreads();
  if (live && kh) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(at + 8 * j) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(at + 8 * RS + 8 * j) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();
  if (live && !kh) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 u = *reinterpret_cast<const float2*>(at + 8 * j);
      const float2 v = *reinterpret_cast<const float2*>(at + 8 * RS + 8 * j);
      acc[j][0] += u.x; acc[j][1] += u.y; acc[j][2] += v.x; acc[j][3] += v.y;
    }
  }
}

// Rows [i0, i0 + 64) of y for one (b, h), as a run of stages: the
// inter-chunk term C . S_prev^T (then scaled by exp(seg_i)), then key tiles
// 0 .. tile. Warps w and w + 4 share rows 16 w .. 16 w + 15, taking the
// even and the odd k-slices of every product; their partial sums meet in
// shared memory at the end. Each stage is copied in two stages ahead.
template <int D>
__device__ __forceinline__ void tile_rows(const Args& a, int bb, int h,
                                          int tile, float* smem) {
  using SM = ChunkSmem<D>;
  constexpr int SA = D + 4, SB = D + 8, NT = D / 8;
  float* seg_r = smem + SM::SEG_R;   // seg of the rows (0 past L)
  const int tid = threadIdx.x, lane = tid & 31;
  const int w = (tid / 32) & 3, kh = tid / 128;
  const int L = a.L, hd = a.hd, i0 = tile * R, last = tile + 1;
  const float* xb = a.xb + bb * a.xb_b + (long long)h * hd;
  const float* seg = a.seg + bb * a.seg_b + h;
  const float* cb = a.cb + (size_t)bb * a.Lp * a.Lp;
  const float* sp = a.s_prev + ((long long)bb * a.nh + h) * hd * a.N;

  // stage u + 1 multiplies key tile u; stage 0 the inter-chunk term
  const auto load = [&](int i) {
    float* buf = smem + (i % NBUF) * SM::Y_BUF;
    if (i == 0) {                // C rows of the tile, S_prev, seg of the rows
      load_tile<D, SR>(buf, a.c + bb * a.c_b, a.c_s, i0, L, a.N, a.vec);
      load_tile<D, SA, D>(buf + SM::Y_B, sp, a.N, 0, hd, a.N, a.vec);
      load_seg(seg_r, seg, a.seg_s, i0, L);
    } else {                     // C.B^T of (tile, u), xb and seg of the keys
      const int k0 = (i - 1) * R;
      for (int e = tid; e < R * R / 4; e += blockDim.x) {
        const int r = e / (R / 4), c = (e % (R / 4)) * 4;
        cp_async_16(&buf[r * SR + c], &cb[(size_t)(i0 + r) * a.Lp + k0 + c]);
      }
      load_tile<D, SB>(buf + SM::Y_B, xb, a.xb_s, k0, L, hd, a.vec);
      load_seg(buf + SM::Y_SEG, seg, a.seg_s, k0, L);
    }
  };

#pragma unroll
  for (int i = 0; i < NBUF - 1; ++i) {
    if (i <= last) load(i);
    cp_async_commit();
  }
  const bool live = i0 + 16 * w < L;
  float acc[NT][4];
  zero(acc);
  float sr0 = 0.f, sr1 = 0.f;
  for (int i = 0; i <= last; ++i) {
    cp_async_wait<NBUF - 2>();   // stage i's copies (later ones may fly)
    __syncthreads();             // ... everyone's; stage i - 1 is done
    if (i + NBUF - 1 <= last) load(i + NBUF - 1);
    cp_async_commit();
    if (!live) continue;
    const float* buf = smem + (i % NBUF) * SM::Y_BUF;
    if (i == 0) {
      const int r0 = 16 * w + lane / 4;
      // rows past L: seg = -inf, so their exp terms are 0, never inf * 0
      sr0 = i0 + r0 < L ? seg_r[r0] : __int_as_float(0xff800000);
      sr1 = i0 + r0 + 8 < L ? seg_r[r0 + 8] : __int_as_float(0xff800000);
      stage_product<D, INTER>(acc, buf, buf + SM::Y_B, seg_r, 0.f, 0.f, w,
                              kh, 0);
      const float e0 = expf(sr0), e1 = expf(sr1);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] *= e0; acc[j][1] *= e0; acc[j][2] *= e1; acc[j][3] *= e1;
      }
    } else if (i < last) {
      stage_product<D, OFF>(acc, buf, buf + SM::Y_B, buf + SM::Y_SEG, sr0,
                            sr1, w, kh, R);
    } else {
      stage_product<D, DIAG>(acc, buf, buf + SM::Y_B, buf + SM::Y_SEG, sr0,
                             sr1, w, kh, min(16 * w + 16, L - i0));
    }
  }

  // the odd slices' sums join the even ones' (in the last stage's A
  // tile, free once every warp is here), and warps w store y
  exchange<D>(acc, smem + (last % NBUF) * SM::Y_BUF, w, kh, live);
  if (!live || kh) return;
  const int g = lane / 4, p0 = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = i0 + 16 * w + g + 8 * half;
    if (row >= L) continue;
    float* yrow = a.y + (((long long)bb * L + row) * a.nh + h) * hd;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int p = 8 * j + p0;
      if (p < hd) yrow[p] = acc[j][2 * half];
      if (p + 1 < hd) yrow[p + 1] = acc[j][2 * half + 1];
    }
  }
}

// S_new for one (b, h): exp(tot) S_prev + (xb . w)^T B, w_j = exp(tot -
// seg_j); warps w and w + 4 own state rows p in [16 w, 16 w + 16), taking
// the even and the odd k-slices, both operands split on the fly. Each key
// tile is copied in two tiles ahead.
template <int D>
__device__ __forceinline__ void new_state(const Args& a, int bb, int h,
                                          float* smem) {
  using SM = ChunkSmem<D>;
  constexpr int SB = D + 8, NT = D / 8;
  const int tid = threadIdx.x, lane = tid & 31;
  const int w = (tid / 32) & 3, kh = tid / 128;
  const int L = a.L, hd = a.hd, N = a.N;
  const float* xb = a.xb + bb * a.xb_b + (long long)h * hd;
  const float* B = a.b + bb * a.b_b;
  const float* seg = a.seg + bb * a.seg_b + h;
  const float tot = seg[(L - 1) * a.seg_s];
  const bool live = 16 * w < hd;
  const int tiles = (L + R - 1) / R;

  const auto load = [&](int u) {
    float* buf = smem + (u % NBUF) * SM::S_BUF;
    load_tile<D, SB>(buf, xb, a.xb_s, u * R, L, hd, a.vec);
    load_tile<D, SB>(buf + SM::S_B, B, a.b_s, u * R, L, N, a.vec);
    load_seg(buf + SM::S_SEG, seg, a.seg_s, u * R, L);
  };
#pragma unroll
  for (int u = 0; u < NBUF - 1; ++u) {
    if (u < tiles) load(u);
    cp_async_commit();
  }

  float acc[NT][4];
  zero(acc);
  const int g = lane / 4, t = lane % 4;
  for (int u = 0; u < tiles; ++u) {
    cp_async_wait<NBUF - 2>();   // key tile u
    __syncthreads();             // ... everyone's; tile u - 1 is done
    if (u + NBUF - 1 < tiles) load(u + NBUF - 1);
    cp_async_commit();
    if (!live) continue;
    const float* buf = smem + (u % NBUF) * SM::S_BUF;
    // A[p][j] = xb[j, p] * w_j, the product rounded in fp32 as the plain
    // version forms it (keys past L are 0 in xb)
    const float* xa = buf + (t + 8 * kh) * SB + 16 * w + g;
    const float* sk = buf + SM::S_SEG + t + 8 * kh;
    const int k_end = min(R, L - u * R);
#pragma unroll
    for (int s2 = 0; s2 < 8; s2 += 2) {
      const int s = s2 + kh;
      if (8 * s >= k_end) break;
      const float w0 = expf(tot - sk[8 * s2]), w1 = expf(tot - sk[8 * s2 + 4]);
      const float v[4] = {xa[8 * s2 * SB] * w0, xa[8 * s2 * SB + 8] * w0,
                          xa[(8 * s2 + 4) * SB] * w1,
                          xa[(8 * s2 + 4) * SB + 8] * w1};
      uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], ah[i], al[i]);
      b_frags<D, SB, false>(buf + SM::S_B, s, bh, bl);
      mma3_frag<NT>(acc, ah, al, bh, bl);
    }
  }
  // the odd slices' sums join the even ones' (in the last tile's buffer)
  exchange<D>(acc, smem + ((tiles - 1) % NBUF) * SM::S_BUF, w, kh, live);
  if (!live || kh) return;

  const float decay = expf(tot);
  const long long base = ((long long)bb * a.nh + h) * hd * N;
  const int n0 = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = 16 * w + g + 8 * half;
    if (p >= hd) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + n0 + e;
        if (n < N) {
          const long long at = base + (long long)p * N + n;
          a.s_new[at] = decay * a.s_prev[at] + acc[j][2 * half + e];
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2) ssd_chunk_tc(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, job = blockIdx.y, bb = blockIdx.z;
  const int T = (a.L + R - 1) / R;
  // the longest first: row tile T - 1, S_new, then row tiles T - 2 .. 0
  if (job != 1)
    tile_rows<D>(a, bb, h, job == 0 ? T - 1 : T - job, smem);
  else
    new_state<D>(a, bb, h, smem);
}

template <int D>
int launch(const Args& a, int Bb, cudaStream_t s) {
  static bool sized = false;     // the attribute once per instantiation
  cudaError_t e;
  if (!sized) {
    e = cudaFuncSetAttribute(ssd_chunk_tc<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ChunkSmem<D>::BYTES);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int T = (a.L + R - 1) / R;
  ssd_cb_tc<D><<<dim3(T * (T + 1) / 2, Bb), CB_THREADS, cb_smem<D>(), s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_tc<D><<<dim3(a.nh, T + 1, Bb), THREADS, ChunkSmem<D>::BYTES,
                    s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// (y [B,L,nh,hd], S_new [B,nh,hd,N]) = one SSD chunk step of xb [B,L,nh,hd],
// B_/C_ [B,L,N], seg [B,L,nh] and S_prev [B,nh,hd,N], all fp32. xb, B_, C_
// and seg have packed trailing dims (unit stride last, xb's heads hd
// apart); *_bs and *_ss are their batch and row strides in elements. S_prev,
// y and S_new are contiguous. cb is an fp32 scratch [B, Lp, Lp], Lp = L
// rounded up to a multiple of 64, 16-byte aligned. hd, N <= 64. Two
// launches (C.B^T, then the chunk step); returns the cudaError_t of the
// launches (0 on success); never synchronises.
extern "C" int ssd_chunk_fwd(const void* xb, const void* b, const void* c,
                             const void* seg, const void* s_prev, void* y,
                             void* s_new, void* cb, int B, int L, int nh,
                             int hd, int N, long long xb_bs, long long xb_ss,
                             long long b_bs, long long b_ss, long long c_bs,
                             long long c_ss, long long seg_bs,
                             long long seg_ss, void* stream) {
  const int T = (L + R - 1) / R;
  if (B <= 0 || L <= 0 || nh <= 0 || hd <= 0 || N <= 0 || hd > 64 || N > 64 ||
      B > 65535 || T + 1 > 65535 ||
      reinterpret_cast<uintptr_t>(cb) % 16)
    return (int)cudaErrorInvalidValue;
  const bool vec =
      hd % 4 == 0 && N % 4 == 0 && (xb_bs | xb_ss | b_bs | b_ss | c_bs | c_ss) % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(xb) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(s_prev)) % 16 == 0;
  const Args a{static_cast<const float*>(xb), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<const float*>(seg),
               static_cast<const float*>(s_prev), static_cast<float*>(y),
               static_cast<float*>(s_new), static_cast<float*>(cb),
               L, T * R, nh, hd, N,
               xb_bs, xb_ss, b_bs, b_ss, c_bs, c_ss, seg_bs, seg_ss, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = hd > N ? hd : N;
  if (d <= 16) return launch<16>(a, B, s);
  if (d <= 32) return launch<32>(a, B, s);
  return launch<64>(a, B, s);
}
