// One Mamba2 SSD chunk step for Hopper (sm_90a): the hybrid's prefill scan,
// and (at the end of the file) its gradient, training's backward.
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

// ------------------------------------------------------------- backward --
//
// The gradient of one chunk step (ssd_chunk_bwd). Not a TPU kernel: the
// reference's training differentiates the plain ssd_chunked
// (src/repro/models/mamba2.py:66) with JAX autodiff; the port's forward is
// this file's kernel, which autograd cannot see through. For each (b, h),
// with M = C.B^T * dec (dec = exp(min(seg_i - seg_j, 0)) on j <= i, else
// 0), G = dy, dS = dS_new, w_j = exp(seg_{L-1} - seg_j):
//   dM = G X^T (on j <= i), dA = dM * dec, dMM = dA * C.B^T = dM * M
//   dX = M^T G + w * (B dS^T)
//   dC_h = dA B + exp(seg_i) * (G S_prev),  dB_h = dA^T C + w * (X dS)
//   dS_prev = exp(seg_{L-1}) dS + (exp(seg) * G)^T C
//   dseg = rowsum(dMM) - colsum(dMM) + exp(seg_i) sum_p G (C S_prev^T)
//          - w_j dw_j,  dw_j = sum_p X[j,p] (B dS^T)[j,p];  and at L - 1
//          + sum_j w_j dw_j + exp(seg_{L-1}) sum S_prev * dS
// (the diagonal's row and column terms cancel, and so do key L - 1's two
// w dw terms: each pair is left out)
// dB and dC are sums over the heads (B and C are shared by them). The
// masked triangle is skipped (dec = 0 there, never exp of a positive
// exponent), so it contributes exactly zero.
//
// What bounds it on the H100. At the zamba2-2.7b training shape (B = 2,
// L = 256, nh = 80, hd = N = 64) the products over the causal tile pairs
// are ~5.9 GFLOP a call as this kernel runs them (the diagonal tiles
// whole, dM formed twice): ~88 us at the 67 TFLOP/s of fp32 outside the
// tensor cores, ~36 us as three TF32 products each at 495 TFLOP/s; the
// bytes (the inputs read once, the outputs written once) take ~13 us.
// chip_smoke.py computes the exact bounds of the call.
//
// Design: split fp32 on the tensor cores, as the forward. No atomics, every
// sum in a fixed order (a gradient repeats bitwise). C.B^T comes from
// ssd_cb_tc into the forward's scratch. ssd_bwd_tc takes grid (nh, 2T + 1,
// B), T = ceil(L / 64), eight warps and two blocks an SM; the jobs of a
// (b, h), longest first:
//  - key tile u (T of them): dX and dB_h of its 64 keys, over the row
//    tiles t >= u (dM recomputed, M and dA through shared memory), the
//    column sums of dMM and the key-side state terms;
//  - row tile t (T of them): dC_h of its rows over the key tiles u <= t,
//    the row sums of dMM and the row-side state terms;
//  - the state: dS_prev, and exp(seg_{L-1}) sum S_prev * dS.
// Every 64 x 64 product (dM = G X^T, M^T G, dA^T C, dA B, B dS^T, X dS,
// C S_prev^T, G S_prev, (e^seg G)^T C) runs on mma.sync m16n8k8 TF32, each
// fp32 operand split as it is read into hi = tf32(x) and lo = tf32(x - hi)
// and summed as lo.hi + hi.lo + hi.hi into fp32 (one pass of TF32 misses
// the 1e-4); warp w owns a 16 x 32 slab of the output (rows 16 (w % 4),
// columns 32 (w / 4)). The decay is formed where the masked entries are
// (a select above the diagonal, never exp of a positive exponent), and the
// diagonal tile's masked entries are zeros, never multiplied by inf. Tiles
// arrive by cp.async (16-byte copies where the operands allow), two stages
// of the streamed operand (G in a key job, X and B in a row job) so the
// next pair's copies run under this pair's products; they sit with a row
// stride of 68 words and are zero past L, hd and N. Row and column sums
// reduce by shuffles, then over the warps in order; results leave two
// adjacent columns a store.
// Per-head dB_h and dC_h, dseg's row and column parts and the partials of
// d seg_{L-1} go to scratch the wrapper allocates; ssd_bwd_reduce sums dB_h
// and dC_h over the heads with eight warps each summing a run of heads for
// 32 consecutive elements (contiguous reads, many in flight) and warp 0
// adding the eight runs in order.
// What holds it back (H100, the training shape): the jobs take ~0.19 ms
// where the split products would take ~0.04 ms at mma.sync's TF32 rate
// (315-323 TFLOP/s, scripts/mma_rate_probe.py): the pairs run one after
// another within a block, each a chain of dependent products, a select and
// barriers, and two blocks an SM do not hide it. Two things this design
// does not do: it forms the decay from dM's accumulators but passes M and
// dA to the next products through shared tiles (they take them transposed,
// or across both warps of a row, and m16n8k8's A layout is not its
// accumulator's); and a diagonal pair's products run whole over the upper
// triangle's zeros (a warp's slab is fixed and a pair ends at a barrier, so
// the warps above the diagonal would idle, not shorten it).

namespace {

constexpr int BT = 256;          // threads: 8 warps, a 16 x 32 slab each
constexpr int TS = R + 4;        // the tiles' row stride (68 words)
constexpr int TILE = R * TS;
constexpr int RED = 4 * R;       // a reduction scratch: 4 partials a row
// six tiles (the key job: X_u, two G, C_t, M, dA), three runs of seg, two
// reduction scratches
constexpr int BWD_SMEM = (int)sizeof(float) * (6 * TILE + 3 * R + 2 * RED);
static_assert(2 * (BWD_SMEM + 1024) <= 233472, "two blocks an SM");

struct BwdArgs {
  const float* xb;               // [B, L, nh, hd], rows strided
  const float* b;                // [B, L, N], rows strided
  const float* c;                // [B, L, N], rows strided
  const float* seg;              // [B, L, nh], rows strided
  const float* s_prev;           // [B, nh, hd, N], contiguous
  const float* dy;               // [B, L, nh, hd], rows strided
  const float* ds;               // [B, nh, hd, N], contiguous
  const float* cb;               // [B, Lp, Lp]: C.B^T (ssd_cb_tc)
  float* dxb;                    // [B, L, nh, hd], contiguous
  float* db;                     // [B, L, N], contiguous
  float* dc;                     // [B, L, N], contiguous
  float* dseg;                   // [B, L, nh], contiguous
  float* dsp;                    // [B, nh, hd, N], contiguous
  float* dbh;                    // [B, nh, L, N] scratch: dB_h
  float* dch;                    // [B, nh, L, N] scratch: dC_h
  float* dsr;                    // [B, nh, L] scratch: dseg's row part
  float* dsc;                    // [B, nh, L] scratch: dseg's column part
  float* dtot;                   // [B, nh, T + 1] scratch: d seg_{L-1}
  int L, Lp, nh, hd, N, T;
  long long xb_b, xb_s, b_b, b_s, c_b, c_s, seg_b, seg_s, dy_b, dy_s;
  bool vec;                      // 16-byte copies of xb, B, C, dy, S_prev, dS
};

// A thread's place in a 64 x 64 product: warp w owns rows rw .. rw + 15
// (rw = 16 (w % 4)) and columns cw .. cw + 31 (cw = 32 (w / 4)); as PTX lays
// out m16n8k8, lane 4 g + t holds acc[j][e] at row rw + g + 8 (e >> 1) and
// column cw + 8 j + 2 t + (e & 1).
struct Frag {
  int rw, cw, g, t;
  __device__ Frag() {
    const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
    rw = 16 * (w % 4);
    cw = 32 * (w / 4);
    g = lane / 4;
    t = lane % 4;
  }
  __device__ int row(int e) const { return rw + g + 8 * (e >> 1); }
  __device__ int col(int j, int e) const { return cw + 8 * j + 2 * t + (e & 1); }
};

// acc += a(m, k) b(k, n) over k < K (rounded up to 8: the tiles are 0
// past their extent) in split fp32 on the tensor cores, from [64][TS]
// tiles: a(m, k) = AT ? A[k][m] : A[m][k], b(k, n) = BTR ? Bm[n][k] :
// Bm[k][n]; each operand split into hi and lo as it is read, the slices in
// ascending k.
template <bool AT, bool BTR>
__device__ __forceinline__ void mm(float (&acc)[4][4], const float* A,
                                   const float* Bm, int K) {
  const Frag f;
  const int m0 = f.rw + f.g;
  for (int k = 0; k < K; k += 8) {
    const int k0 = k + f.t;
    const float av[4] = {
        AT ? A[k0 * TS + m0] : A[m0 * TS + k0],
        AT ? A[k0 * TS + m0 + 8] : A[(m0 + 8) * TS + k0],
        AT ? A[(k0 + 4) * TS + m0] : A[m0 * TS + k0 + 4],
        AT ? A[(k0 + 4) * TS + m0 + 8] : A[(m0 + 8) * TS + k0 + 4]};
    uint32_t ah[4], al[4], bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = f.cw + 8 * j + f.g;
      split_tf32(BTR ? Bm[n * TS + k0] : Bm[k0 * TS + n], bh[j][0], bl[j][0]);
      split_tf32(BTR ? Bm[n * TS + k0 + 4] : Bm[(k0 + 4) * TS + n], bh[j][1],
                 bl[j][1]);
    }
    mma3_frag<4>(acc, ah, al, bh, bl);
  }
}

// Rows [row0, row0 + 64) x columns [0, cols) of a row-strided fp32 matrix
// into a [64][TS] tile, 0 past `rows` and `cols`: cp.async copies, started
// (the caller commits and waits).
__device__ __forceinline__ void load_t(float* dst, const float* src,
                                       long long ld, int row0, int rows,
                                       int cols, bool vec) {
  load_tile<R, TS>(dst, src, ld, row0, rows, cols, vec);
}

// The sums over each row's 64 columns of the threads' partials part[i]
// (row rw + g + 8 i, over the thread's columns), in a fixed order: the
// quad's four lanes by shuffles, then the two column halves. Row m's sum is
// returned in thread m (m < 64), 0 elsewhere. Callers meet at a barrier
// first if red is reused.
__device__ __forceinline__ float row_sum(float (&part)[2], float* red) {
  const Frag f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 1);
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 2);
    if (f.t == 0) red[(f.cw / 32) * R + f.rw + f.g + 8 * i] = part[i];
  }
  __syncthreads();
  return threadIdx.x < R ? red[threadIdx.x] + red[R + threadIdx.x] : 0.f;
}

// The sums over each column's 64 rows of the threads' partials part[j][c]
// (column cw + 8 j + 2 t + c, over the thread's two rows): the eight g by
// shuffles, then the four row slabs in order; column n's in thread n.
__device__ __forceinline__ float col_sum(float (&part)[4][2], float* red) {
  const Frag f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float v = part[j][c];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (f.g == 0) red[(f.rw / 16) * R + f.cw + 8 * j + 2 * f.t + c] = v;
    }
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < R)
    for (int q = 0; q < 4; ++q) s += red[q * R + threadIdx.x];
  return s;
}

__device__ __forceinline__ void zero4(float (&acc)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// A 64 x 64 tile of the C.B^T scratch (rows i0 .., columns j0 ..) into a
// [64][TS] tile: cp.async copies, started.
__device__ __forceinline__ void load_cb(float* dst, const float* cb, int Lp,
                                        int i0, int j0) {
  for (int e = threadIdx.x; e < R * R / 4; e += BT) {
    const int r = e / (R / 4), c = (e % (R / 4)) * 4;
    cp_async_16(&dst[r * TS + c], &cb[(size_t)(i0 + r) * Lp + j0 + c]);
  }
}

// A 64 x 64 result (the thread's acc[j][e] at row row0 + f.row(e), column
// f.col(j, e)) into out[row * ld + col] for rows < rows and columns <
// cols, two adjacent columns a store where the row and column allow it.
__device__ __forceinline__ void store_tile(float* out, long long ld,
                                           const float (&acc)[4][4], int row0,
                                           int rows, int cols) {
  const Frag f;
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int row = row0 + f.row(e);
    if (row >= rows) continue;
    float* o = out + row * ld;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = f.col(j, e);
      if (c + 1 < cols && ld % 2 == 0 && reinterpret_cast<uintptr_t>(o) % 8 == 0) {
        *reinterpret_cast<float2*>(o + c) = make_float2(acc[j][e], acc[j][e + 1]);
      } else {
        if (c < cols) o[c] = acc[j][e];
        if (c + 1 < cols) o[c + 1] = acc[j][e + 1];
      }
    }
  }
}

// The thread's entries of a [64][TS] tile, in acc's layout.
__device__ __forceinline__ void read_frag(float (&v)[4][4], const float* t) {
  const Frag f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[j][e] = t[f.row(e) * TS + f.col(j, e)];
}

// One (row tile, key tile) pair's masked entries from dM and C.B^T (cbv,
// the thread's entries): dA = dM * dec (into dA_s), M = C.B^T * dec (into
// M_s unless null); the thread's entries of dMM below the diagonal go into
// rowp (by row) and colp (by column): a diagonal entry's row and column
// terms cancel, so it is left out of both. dec is a select above the
// diagonal, never exp of a positive exponent.
__device__ __forceinline__ void pair_entries(const BwdArgs& a, int i0, int j0,
                                             const float* sr, const float* sk,
                                             const float (&dM)[4][4],
                                             const float (&cbv)[4][4],
                                             float* M_s, float* dA_s,
                                             float (&rowp)[2],
                                             float (&colp)[4][2]) {
  const Frag f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = f.row(e), n = f.col(j, e), i = i0 + m, jj = j0 + n;
      float mv = 0.f, da = 0.f;
      if (i < a.L && jj <= i) {
        const float dec = expf(fminf(sr[m] - sk[n], 0.f));
        mv = cbv[j][e] * dec;
        da = dM[j][e] * dec;
        if (jj < i) {
          rowp[e >> 1] += da * cbv[j][e];
          colp[j][e & 1] += da * cbv[j][e];
        }
      }
      if (M_s) M_s[m * TS + n] = mv;
      dA_s[m * TS + n] = da;
    }
}

// Key tile u of (b, h): dX and dB_h of keys j in [64 u, 64 u + 64), dseg's
// column part there, and d seg_{L-1}'s partial sum_j w_j dw_j. The row
// tiles t = u .. T - 1 stream through two G buffers: G of tile t + 1 is
// copied in while tile t's products run, C and C.B^T of t + 1 as soon as
// the dB product has read tile t's (C.B^T lands in the dA tile, which the
// entries overwrite in place), during the dX product; the last pair brings
// B_u and dS for the state terms the same way.
__device__ void bwd_keys(const BwdArgs& a, int bb, int h, int u, float* sm) {
  float* Xu = sm;
  float* Gb = Xu + TILE;         // two G buffers
  float* Ct = Gb + 2 * TILE;
  float* Ms = Ct + TILE;
  float* As = Ms + TILE;         // C.B^T of the pair as it lands, then dA
  float* sk = As + TILE;
  float* srb = sk + R;           // seg of the rows, two buffers
  float* red = srb + 2 * R;
  const Frag f;
  const int L = a.L, hd = a.hd, N = a.N, j0 = u * R;
  const float* xb = a.xb + bb * a.xb_b + (long long)h * hd;
  const float* dy = a.dy + bb * a.dy_b + (long long)h * hd;
  const float* B = a.b + bb * a.b_b;
  const float* C = a.c + bb * a.c_b;
  const float* seg = a.seg + bb * a.seg_b + h;
  const float* cb = a.cb + (size_t)bb * a.Lp * a.Lp;
  const long long bh = (long long)bb * a.nh + h;
  const auto load_g = [&](int t) {
    load_t(Gb + (t & 1) * TILE, dy, a.dy_s, t * R, L, hd, a.vec);
    load_seg(srb + (t & 1) * R, seg, a.seg_s, t * R, L);
  };
  const auto load_c = [&](int t) {
    load_t(Ct, C, a.c_s, t * R, L, N, a.vec);
    load_cb(As, cb, a.Lp, t * R, j0);
  };

  load_t(Xu, xb, a.xb_s, j0, L, hd, a.vec);
  load_seg(sk, seg, a.seg_s, j0, L);
  load_g(u);
  load_c(u);
  cp_async_commit();
  float dX[4][4], dB[4][4], rowp[2] = {0.f, 0.f}, colp[4][2] = {};
  zero4(dX);
  zero4(dB);
  for (int t = u; t < a.T; ++t) {
    const int i0 = t * R, K = min(R, L - i0);
    const float* Gt = Gb + (t & 1) * TILE;
    cp_async_wait<0>();
    __syncthreads();             // pair t is in; pair t - 1's reads are done
    if (t + 1 < a.T) load_g(t + 1);
    else load_t(Gb + ((t + 1) & 1) * TILE, B, a.b_s, j0, L, N, a.vec);
    cp_async_commit();
    float dM[4][4], cbv[4][4];
    zero4(dM);
    mm<false, true>(dM, Gt, Xu, hd);          // dM(i, j) = G_i . X_j
    read_frag(cbv, As);
    pair_entries(a, i0, j0, srb + (t & 1) * R, sk, dM, cbv, Ms, As, rowp,
                 colp);
    __syncthreads();
    mm<true, false>(dB, As, Ct, K);           // dB(j, n) += dA(i, j) C(i, n)
    __syncthreads();             // C and dA are read: the next pair's land
    if (t + 1 < a.T) load_c(t + 1);
    else load_t(Ct, a.ds + bh * hd * N, N, 0, hd, N, a.vec);
    cp_async_commit();
    mm<true, false>(dX, Ms, Gt, K);           // dX(j, p) += M(i, j) G(i, p)
  }

  // the state's terms: B_u in the free G buffer, dS [hd][N] in C's tile
  cp_async_wait<0>();
  __syncthreads();
  const float* Bu = Gb + (a.T & 1) * TILE;
  const float* Ds = Ct;
  float bd[4][4], xds[4][4];
  zero4(bd);
  zero4(xds);
  mm<false, true>(bd, Bu, Ds, N);             // (B dS^T)(j, p)
  mm<false, false>(xds, Xu, Ds, hd);          // (X dS)(j, n)
  const float tot = seg[(L - 1) * a.seg_s];
  float dwp[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int m = f.row(e);
    const float wr = j0 + m < L ? expf(tot - sk[m]) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        dwp[e >> 1] += Xu[m * TS + f.col(j, e + c)] * bd[j][e + c];
        dX[j][e + c] += wr * bd[j][e + c];
        dB[j][e + c] += wr * xds[j][e + c];
      }
  }
  const float dw = row_sum(dwp, red);
  const float cs = col_sum(colp, red + RED);
  __syncthreads();               // red is free again below
  // key L - 1 (w = 1) would add -dw to dseg_{L-1} here and +dw through
  // d seg_{L-1}: it is left out of both, so the two cancel exactly
  float wdw = 0.f;
  if (threadIdx.x < R) {
    const int j = j0 + threadIdx.x;
    if (j < L) {
      if (j < L - 1) wdw = expf(tot - sk[threadIdx.x]) * dw;
      a.dsc[bh * L + j] = -cs - wdw;
    }
    red[threadIdx.x] = wdw;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int q = 0; q < R; ++q) s += red[q];
    a.dtot[bh * (a.T + 1) + u] = s;
  }

  // dX into dxb; dB_h into its scratch
  store_tile(a.dxb + ((long long)bb * L * a.nh + h) * hd, (long long)a.nh * hd,
             dX, j0, L, hd);
  store_tile(a.dbh + bh * L * N, N, dB, j0, L, N);
}

// Row tile t of (b, h): dC_h of rows i in [64 t, 64 t + 64) and dseg's row
// part there. The key tiles u = 0 .. t stream through two X and two B
// buffers (tile u + 1 copied in while tile u's products run; the pair's
// C.B^T read into registers before the tiles land); the last pair brings
// S_prev and C_t for the state terms the same way.
__device__ void bwd_rows(const BwdArgs& a, int bb, int h, int t, float* sm) {
  float* Gt = sm;
  float* Xb = Gt + TILE;         // two X buffers
  float* Bb = Xb + 2 * TILE;     // two B buffers
  float* As = Bb + 2 * TILE;
  float* sr = sm + 6 * TILE;
  float* skb = sr + R;           // seg of the keys, two buffers
  float* red = skb + 2 * R;
  const Frag f;
  const int L = a.L, hd = a.hd, N = a.N, i0 = t * R;
  const float* xb = a.xb + bb * a.xb_b + (long long)h * hd;
  const float* dy = a.dy + bb * a.dy_b + (long long)h * hd;
  const float* B = a.b + bb * a.b_b;
  const float* C = a.c + bb * a.c_b;
  const float* seg = a.seg + bb * a.seg_b + h;
  const float* cb = a.cb + (size_t)bb * a.Lp * a.Lp;
  const long long bh = (long long)bb * a.nh + h;
  const auto load_k = [&](int u) {
    load_t(Xb + (u & 1) * TILE, xb, a.xb_s, u * R, L, hd, a.vec);
    load_t(Bb + (u & 1) * TILE, B, a.b_s, u * R, L, N, a.vec);
    load_seg(skb + (u & 1) * R, seg, a.seg_s, u * R, L);
  };

  load_t(Gt, dy, a.dy_s, i0, L, hd, a.vec);
  load_seg(sr, seg, a.seg_s, i0, L);
  load_k(0);
  cp_async_commit();
  float dC[4][4], rowp[2] = {0.f, 0.f}, colp[4][2] = {};
  zero4(dC);
  for (int u = 0; u <= t; ++u) {
    const int j0 = u * R;
    float cbv[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cbv[j][e] = cb[(size_t)(i0 + f.row(e)) * a.Lp + j0 + f.col(j, e)];
    cp_async_wait<0>();
    __syncthreads();             // pair u is in; pair u - 1's reads are done
    if (u < t) {
      load_k(u + 1);
    } else {
      load_t(Xb + ((u + 1) & 1) * TILE, a.s_prev + bh * hd * N, N, 0, hd, N,
             a.vec);
      load_t(Bb + ((u + 1) & 1) * TILE, C, a.c_s, i0, L, N, a.vec);
    }
    cp_async_commit();
    float dM[4][4];
    zero4(dM);
    mm<false, true>(dM, Gt, Xb + (u & 1) * TILE, hd);
    pair_entries(a, i0, j0, sr, skb + (u & 1) * R, dM, cbv, nullptr, As,
                 rowp, colp);
    __syncthreads();
    // dC(i, n) += dA(i, j) B(j, n)
    mm<false, false>(dC, As, Bb + (u & 1) * TILE, min(R, L - j0));
  }

  // the state's terms: S_prev [hd][N] and C_t in the free buffers
  cp_async_wait<0>();
  __syncthreads();
  const float* Ps = Xb + ((t + 1) & 1) * TILE;
  const float* Ct = Bb + ((t + 1) & 1) * TILE;
  float y0[4][4], gp[4][4];
  zero4(y0);
  zero4(gp);
  mm<false, true>(y0, Ct, Ps, N);             // (C S_prev^T)(i, p)
  mm<false, false>(gp, Gt, Ps, hd);           // (G S_prev)(i, n)
  float yp[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int m = f.row(e);
    const float es = i0 + m < L ? expf(sr[m]) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        yp[e >> 1] += Gt[m * TS + f.col(j, e + c)] * y0[j][e + c];
        dC[j][e + c] += es * gp[j][e + c];
      }
  }
  const float rs = row_sum(rowp, red);
  const float gy = row_sum(yp, red + RED);
  if (threadIdx.x < R && i0 + threadIdx.x < L)
    a.dsr[bh * L + i0 + threadIdx.x] = rs + expf(sr[threadIdx.x]) * gy;
  store_tile(a.dch + bh * L * N, N, dC, i0, L, N);
}

// The state of (b, h): dS_prev = exp(tot) dS + (exp(seg) G)^T C, and
// d seg_{L-1}'s partial exp(tot) sum S_prev * dS. The row tiles stream
// through two G and two C buffers.
__device__ void bwd_state(const BwdArgs& a, int bb, int h, float* sm) {
  float* Gb = sm;                // two G buffers (scaled in place)
  float* Cb = sm + 2 * TILE;     // two C buffers
  float* srb = sm + 6 * TILE;    // seg of the rows, two buffers
  float* red = srb + 3 * R;
  const Frag f;
  const int L = a.L, hd = a.hd, N = a.N;
  const float* dy = a.dy + bb * a.dy_b + (long long)h * hd;
  const float* C = a.c + bb * a.c_b;
  const float* seg = a.seg + bb * a.seg_b + h;
  const long long bh = (long long)bb * a.nh + h;
  const auto load_r = [&](int t) {
    load_t(Gb + (t & 1) * TILE, dy, a.dy_s, t * R, L, hd, a.vec);
    load_t(Cb + (t & 1) * TILE, C, a.c_s, t * R, L, N, a.vec);
    load_seg(srb + (t & 1) * R, seg, a.seg_s, t * R, L);
  };
  load_r(0);
  cp_async_commit();
  float acc[4][4];
  zero4(acc);
  for (int t = 0; t < a.T; ++t) {
    const int i0 = t * R;
    float* Ge = Gb + (t & 1) * TILE;
    const float* sr = srb + (t & 1) * R;
    cp_async_wait<0>();
    __syncthreads();             // tile t is in; tile t - 1's reads are done
    if (t + 1 < a.T) load_r(t + 1);
    cp_async_commit();
    for (int e = threadIdx.x; e < R * R; e += BT) {   // exp(seg_i) G_i
      const int r = e / R, k = e % R;
      if (i0 + r < L) Ge[r * TS + k] *= expf(sr[r]);
    }
    __syncthreads();
    // (p, n) += Ge(i, p) C(i, n)
    mm<true, false>(acc, Ge, Cb + (t & 1) * TILE, min(R, L - i0));
  }
  const float e_tot = expf(seg[(L - 1) * a.seg_s]);
  const float* ds = a.ds + bh * hd * N;
  const float* sp = a.s_prev + bh * hd * N;
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int p = f.row(e);
    if (p >= hd) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = f.col(j, e);
      if (n >= N) continue;
      const long long at = (long long)p * N + n;
      acc[j][e] += e_tot * ds[at];
      part[e >> 1] += sp[at] * ds[at];
    }
  }
  store_tile(a.dsp + bh * hd * N, N, acc, 0, hd, N);
  const float s = row_sum(part, red);
  __syncthreads();
  if (threadIdx.x < R) red[RED + threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.f;
    for (int q = 0; q < R; ++q) v += red[RED + q];
    a.dtot[bh * (a.T + 1) + a.T] = e_tot * v;
  }
}

__global__ void __launch_bounds__(BT, 2) ssd_bwd_tc(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, job = blockIdx.y, bb = blockIdx.z;
  // the longest first: key tiles 0 .. T - 1, row tiles T - 1 .. 0, state
  if (job < a.T)
    bwd_keys(a, bb, h, job, smem);
  else if (job < 2 * a.T)
    bwd_rows(a, bb, h, 2 * a.T - 1 - job, smem);
  else
    bwd_state(a, bb, h, smem);
}

// The sums over the heads, each in a fixed order. Blocks x < red_blocks:
// dB and dC at 32 consecutive elements of batch blockIdx.y, the eight warps
// summing eight runs of heads, then warp 0 the eight partials in order;
// the rest: dseg = row part + column part (+ the partials of d seg_{L-1}
// at L - 1), an element a thread.
constexpr int RED_HEADS = BT / 32;
__global__ void __launch_bounds__(BT) ssd_bwd_reduce(BwdArgs a, int red_blocks) {
  __shared__ float part[2][RED_HEADS][32];
  const int bb = blockIdx.y, L = a.L, N = a.N, nh = a.nh;
  if ((int)blockIdx.x < red_blocks) {
    const int lane = threadIdx.x % 32, run = threadIdx.x / 32;
    const long long e = (long long)blockIdx.x * 32 + lane, LN = (long long)L * N;
    const int per = (nh + RED_HEADS - 1) / RED_HEADS;
    const int h0 = run * per, h1 = min(nh, h0 + per);
    float sb = 0.f, sc = 0.f;
    if (e < LN) {
      const long long at = (long long)bb * nh * LN + e;
#pragma unroll 8
      for (int h = h0; h < h1; ++h) {
        sb += a.dbh[at + h * LN];
        sc += a.dch[at + h * LN];
      }
    }
    part[0][run][lane] = sb;
    part[1][run][lane] = sc;
    __syncthreads();
    if (run == 0 && e < LN) {
      float tb = 0.f, tc = 0.f;
#pragma unroll
      for (int q = 0; q < RED_HEADS; ++q) {
        tb += part[0][q][lane];
        tc += part[1][q][lane];
      }
      a.db[(long long)bb * LN + e] = tb;
      a.dc[(long long)bb * LN + e] = tc;
    }
    return;
  }
  const long long e = (long long)(blockIdx.x - red_blocks) * BT + threadIdx.x;
  if (e < (long long)L * nh) {
    const long long i = e / nh, h = e % nh, bh = (long long)bb * nh + h;
    float v = a.dsr[bh * L + i] + a.dsc[bh * L + i];
    if (i == L - 1) {
      float d = 0.f;
      for (int k = 0; k <= a.T; ++k) d += a.dtot[bh * (a.T + 1) + k];
      v += d;
    }
    a.dseg[((long long)bb * L + i) * nh + h] = v;
  }
}

// What ssd_chunk_bwd launches at these sizes, as its entry uses it: the
// grids of C.B^T, the jobs and the sums over heads; threads a block of each;
// C.B^T's K (N taken as 16, 32 or 64) and its shared memory; the jobs'
// dynamic shared memory; and the reduce's blocks of dB / dC (the rest sum
// dseg). ok is false where the entry refuses the sizes.
struct BwdLaunch {
  int ok, cb_grid[2], jobs_grid[3], reduce_grid[2];
  int cb_threads, jobs_threads, reduce_threads, cb_k, cb_bytes, jobs_smem,
      red_blocks;
};

BwdLaunch bwd_launch(int B, int L, int nh, int hd, int N) {
  BwdLaunch p{};
  const int T = (L + R - 1) / R;
  if (B <= 0 || L <= 0 || nh <= 0 || hd <= 0 || N <= 0 || hd > 64 || N > 64 ||
      B > 65535 || 2 * T + 1 > 65535)
    return p;
  const int red_blocks = (int)(((long long)L * N + 31) / 32);
  const int seg_blocks = (int)(((long long)L * nh + BT - 1) / BT);
  const int cb_k = N <= 16 ? 16 : N <= 32 ? 32 : 64;
  const int cb_bytes =
      cb_k == 16 ? cb_smem<16>() : cb_k == 32 ? cb_smem<32>() : cb_smem<64>();
  return {1, {T * (T + 1) / 2, B}, {nh, 2 * T + 1, B},
          {red_blocks + seg_blocks, B}, CB_THREADS, BT, BT, cb_k, cb_bytes,
          BWD_SMEM, red_blocks};
}

}  // namespace

// (dxb, dB_, dC_, dseg, dS_prev) of one SSD chunk step given its inputs
// (as ssd_chunk_fwd takes them), dy [B,L,nh,hd] (rows strided, heads packed)
// and dS_new [B,nh,hd,N] (contiguous); all fp32, outputs contiguous. cb is
// an fp32 scratch [B, Lp, Lp] (Lp = L rounded up to 64, 16-byte aligned);
// dbh and dch [B, nh, L, N], dsr and dsc [B, nh, L] and dtot [B, nh, T + 1]
// (T = Lp / 64) are fp32 scratch. hd, N <= 64. Three launches (C.B^T, the
// jobs, the sums over heads); returns the cudaError_t of the launches (0 on
// success); never synchronises.
extern "C" int ssd_chunk_bwd(const void* xb, const void* b, const void* c,
                             const void* seg, const void* s_prev,
                             const void* dy, const void* ds, void* dxb,
                             void* db, void* dc, void* dseg, void* dsp,
                             void* cb, void* dbh, void* dch, void* dsr,
                             void* dsc, void* dtot, int B, int L, int nh,
                             int hd, int N, long long xb_bs, long long xb_ss,
                             long long b_bs, long long b_ss, long long c_bs,
                             long long c_ss, long long seg_bs,
                             long long seg_ss, long long dy_bs,
                             long long dy_ss, void* stream) {
  const BwdLaunch p = bwd_launch(B, L, nh, hd, N);
  if (!p.ok || reinterpret_cast<uintptr_t>(cb) % 16)
    return (int)cudaErrorInvalidValue;
  const int T = (L + R - 1) / R;
  const bool vec =
      N % 4 == 0 && (b_bs | b_ss | c_bs | c_ss) % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(c)) % 16 == 0;
  const bool vec_all =
      vec && hd % 4 == 0 && (xb_bs | xb_ss | dy_bs | dy_ss) % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(xb) | reinterpret_cast<uintptr_t>(dy) |
       reinterpret_cast<uintptr_t>(s_prev) | reinterpret_cast<uintptr_t>(ds)) %
              16 == 0;
  // C.B^T as the forward forms it (ssd_cb_tc reads only b, c and cb)
  const Args f{static_cast<const float*>(xb), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<const float*>(seg),
               static_cast<const float*>(s_prev), nullptr, nullptr,
               static_cast<float*>(cb), L, T * R, nh, hd, N,
               xb_bs, xb_ss, b_bs, b_ss, c_bs, c_ss, seg_bs, seg_ss, vec};
  const BwdArgs a{static_cast<const float*>(xb), static_cast<const float*>(b),
                  static_cast<const float*>(c), static_cast<const float*>(seg),
                  static_cast<const float*>(s_prev),
                  static_cast<const float*>(dy), static_cast<const float*>(ds),
                  static_cast<const float*>(cb), static_cast<float*>(dxb),
                  static_cast<float*>(db), static_cast<float*>(dc),
                  static_cast<float*>(dseg), static_cast<float*>(dsp),
                  static_cast<float*>(dbh), static_cast<float*>(dch),
                  static_cast<float*>(dsr), static_cast<float*>(dsc),
                  static_cast<float*>(dtot), L, T * R, nh, hd, N, T,
                  xb_bs, xb_ss, b_bs, b_ss, c_bs, c_ss, seg_bs, seg_ss,
                  dy_bs, dy_ss, vec_all};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool sized = false;     // the attribute once
  cudaError_t e;
  if (!sized) {
    e = cudaFuncSetAttribute(ssd_bwd_tc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.jobs_smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 cb_grid(p.cb_grid[0], p.cb_grid[1]);
  if (p.cb_k == 16)
    ssd_cb_tc<16><<<cb_grid, p.cb_threads, p.cb_bytes, s>>>(f);
  else if (p.cb_k == 32)
    ssd_cb_tc<32><<<cb_grid, p.cb_threads, p.cb_bytes, s>>>(f);
  else
    ssd_cb_tc<64><<<cb_grid, p.cb_threads, p.cb_bytes, s>>>(f);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_tc<<<dim3(p.jobs_grid[0], p.jobs_grid[1], p.jobs_grid[2]),
               p.jobs_threads, p.jobs_smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_reduce<<<dim3(p.reduce_grid[0], p.reduce_grid[1]),
                   p.reduce_threads, 0, s>>>(a, p.red_blocks);
  return (int)cudaGetLastError();
}

// What ssd_chunk_bwd launches at these sizes, into out[14]: the C.B^T grid
// (2), the jobs' grid (3), the reduce's grid (2), threads of the three, C.B^T's
// K and shared memory, the jobs' dynamic shared memory and the reduce's
// blocks of dB / dC, as BwdLaunch holds them. Returns cudaErrorInvalidValue
// where the entry would refuse the sizes.
extern "C" int ssd_chunk_bwd_plan(int B, int L, int nh, int hd, int N,
                                  int* out) {
  const BwdLaunch p = bwd_launch(B, L, nh, hd, N);
  if (!p.ok) return (int)cudaErrorInvalidValue;
  const int v14[14] = {p.cb_grid[0], p.cb_grid[1], p.jobs_grid[0],
                       p.jobs_grid[1], p.jobs_grid[2], p.reduce_grid[0],
                       p.reduce_grid[1], p.cb_threads, p.jobs_threads,
                       p.reduce_threads, p.cb_k, p.cb_bytes, p.jobs_smem,
                       p.red_blocks};
  for (int i = 0; i < 14; ++i) out[i] = v14[i];
  return 0;
}
