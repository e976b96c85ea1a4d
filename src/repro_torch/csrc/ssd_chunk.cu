// One Mamba2 SSD chunk step for Hopper (sm_90a): the hybrid's prefill scan.
//
// Replaces src/repro/kernels/ssm_scan/kernel.py::ssd_chunk_pallas (body
// _chunk_kernel). For each (batch b, head h), with xb [L,hd], B and C [L,N]
// (shared by the heads), seg [L] (the inclusive cumsum of the log decay)
// and S_prev [hd,N]:
//   y[i]  = sum_{j<=i} (C_i . B_j) exp(seg_i - seg_j) xb[j]
//           + exp(seg_i) (C_i . S_prev^T)
//   S_new = exp(seg_{L-1}) S_prev + sum_j exp(seg_{L-1} - seg_j) xb[j]^T B_j
// all in fp32 (the contract: fp32 operands and results). The upper triangle
// (j > i) is skipped by a select, never multiplied: exp(seg_i - seg_j) may
// be inf there.
//
// What bounds it on the H100. At the zamba2-2.7b path shape (L = 256,
// nh = 80, hd = N = 64, B = 1) the function moves 13.3 MB (xb and y
// 5.24 MB each, S_prev and S_new 1.31 MB each), 4.0 us at 3.35 TB/s, and
// does 0.68 GFLOP over the causal pairs (C.B^T counted once per batch),
// 10.1 us at the 67 TFLOP/s of fp32 outside the tensor cores: it is bound
// by its operations. The kernel keeps true fp32 (no TF32: the contract's
// 1e-4 tolerance would not hold) and multiplies on the CUDA cores with FMA
// from shared memory; it also recomputes C.B^T once per head, nh times the
// function's count. Tensor cores on split-fp32 operands and sharing C.B^T
// across heads are later work.
//
// Design. The TPU kernel keeps a whole chunk in VMEM (~1.2 MB a cell, the
// [L,L] C.B^T tile alone 256 KB), more than a block's 227 KB of shared
// memory. Here the rows of y are tiled: grid (ceil(L/64) + 1, nh, B). A
// block with x < ceil(L/64) owns 64 rows of y for one (b, h): it first
// computes the inter-chunk term from C and S_prev, then loops over 64-key
// tiles j <= its last row (the flash kernel's kv loop) with C.B^T for the
// tile as a 4 x 4 register tile per thread, the masked decay applied, the
// result staged in shared memory and multiplied into xb. The last block in
// x computes S_new, a reduction over all L rows into [hd, N], in its own
// loop over 64-row tiles. Operands in shared memory are stored transposed
// or padded so that a warp reads one broadcast address and 16 consecutive
// ones, and writes to distinct banks. hd and N are taken at run time up to
// the DMAX template (16, 32 or 64); ragged rows and keys are zero-filled.

#include "common.cuh"

namespace {

constexpr int R = 64;          // rows of y per block, and keys per tile
constexpr int RP = R + 1;      // padded row stride of transposed tiles
constexpr int THREADS = 256;   // 16 row groups x 16 lanes
constexpr int RI = R / 16;     // rows (or keys) per thread

struct Args {
  const float* xb;             // [B, L, nh, hd], rows strided
  const float* b;              // [B, L, N], rows strided
  const float* c;              // [B, L, N], rows strided
  const float* seg;            // [B, L, nh], rows strided
  const float* s_prev;         // [B, nh, hd, N], contiguous
  float* y;                    // [B, L, nh, hd], contiguous
  float* s_new;                // [B, nh, hd, N], contiguous
  int L, nh, hd, N;
  long long xb_b, xb_s, b_b, b_s, c_b, c_s, seg_b, seg_s;
};

template <int DMAX>
constexpr size_t smem_bytes() {
  // Ct, Bt [DMAX][RP]; Xs [R][DMAX]; Pt [R][RP]; St [DMAX][DMAX + 1]; seg
  // of the rows and of the keys [R] each
  return sizeof(float) *
         (2 * (size_t)DMAX * RP + (size_t)R * DMAX + (size_t)R * RP +
          (size_t)DMAX * (DMAX + 1) + 2 * (size_t)R);
}

// 64 rows [i0, i0 + 64) of y for one (b, h).
template <int DMAX>
__device__ void rows_of_y(const Args& a, int bb, int h, int i0, float* smem) {
  constexpr int CJ = DMAX / 16;      // columns p of y per thread
  constexpr int SP = DMAX + 1;
  float* Ct = smem;                  // Ct[n * RP + r] = C[i0 + r, n]
  float* Bt = Ct + DMAX * RP;        // Bt[n * RP + c] = B[k0 + c, n]
  float* Xs = Bt + DMAX * RP;        // Xs[c * DMAX + p] = xb[k0 + c, p]
  float* Pt = Xs + R * DMAX;         // Pt[c * RP + r] = att[i0 + r, k0 + c]
  float* St = Pt + R * RP;           // St[n * SP + p] = S_prev[p, n]
  float* seg_r = St + DMAX * SP;
  float* seg_k = seg_r + R;

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int L = a.L, hd = a.hd, N = a.N;
  const float* xb = a.xb + bb * a.xb_b + (long long)h * hd;
  const float* B = a.b + bb * a.b_b;
  const float* C = a.c + bb * a.c_b;
  const float* seg = a.seg + bb * a.seg_b + h;
  const float* sp = a.s_prev + ((long long)bb * a.nh + h) * hd * N;

  for (int idx = tid; idx < R * DMAX; idx += THREADS) {
    const int r = idx / DMAX, n = idx % DMAX, i = i0 + r;
    Ct[n * RP + r] = (i < L && n < N) ? C[i * a.c_s + n] : 0.f;
  }
  for (int idx = tid; idx < DMAX * DMAX; idx += THREADS) {
    const int p = idx / DMAX, n = idx % DMAX;
    St[n * SP + p] = (p < hd && n < N) ? sp[p * N + n] : 0.f;
  }
  if (tid < R) seg_r[tid] = i0 + tid < L ? seg[(i0 + tid) * a.seg_s] : 0.f;
  __syncthreads();

  // inter-chunk term: acc[i][p] = exp(seg_i) * sum_n C[i, n] S_prev[p, n]
  float acc[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  for (int n = 0; n < N; ++n) {
    float cv[RI], sv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) cv[i] = Ct[n * RP + rg + 16 * i];
#pragma unroll
    for (int j = 0; j < CJ; ++j) sv[j] = St[n * SP + cg + 16 * j];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const float e = expf(seg_r[rg + 16 * i]);
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] *= e;
  }

  // intra-chunk term over the key tiles that any row of the block sees
  const int row_end = min(i0 + R, L);
  for (int k0 = 0; k0 < row_end; k0 += R) {
    __syncthreads();   // the previous tile's reads are done
    for (int idx = tid; idx < R * DMAX; idx += THREADS) {
      const int c = idx / DMAX, d = idx % DMAX, j = k0 + c;
      Bt[d * RP + c] = (j < L && d < N) ? B[j * a.b_s + d] : 0.f;
      Xs[c * DMAX + d] = (j < L && d < hd) ? xb[j * a.xb_s + d] : 0.f;
    }
    if (tid < R) seg_k[tid] = k0 + tid < L ? seg[(k0 + tid) * a.seg_s] : 0.f;
    __syncthreads();

    float s[RI][RI];   // rows rg + 16 i, keys cg + 16 j
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[RI], bv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) cv[i] = Ct[n * RP + rg + 16 * i];
#pragma unroll
      for (int j = 0; j < RI; ++j) bv[j] = Bt[n * RP + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = rg + 16 * i, row = i0 + r;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = cg + 16 * j, key = k0 + c;
        // key <= row < L: visible; otherwise selected away, exp not taken
        Pt[c * RP + r] = (key <= row && row < L)
                             ? s[i][j] * expf(seg_r[r] - seg_k[c])
                             : 0.f;
      }
    }
    __syncthreads();

    const int n_keys = min(R, row_end - k0);
    for (int c = 0; c < n_keys; ++c) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Pt[c * RP + rg + 16 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float xv = Xs[c * DMAX + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(pv[i], xv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = i0 + rg + 16 * i;
    if (row >= L) continue;
    float* yrow = a.y + (((long long)bb * L + row) * a.nh + h) * hd;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int p = cg + 16 * j;
      if (p < hd) yrow[p] = acc[i][j];
    }
  }
}

// S_new for one (b, h): exp(tot) S_prev + sum_j exp(tot - seg_j) xb[j]^T B_j
template <int DMAX>
__device__ void new_state(const Args& a, int bb, int h, float* smem) {
  constexpr int CJ = DMAX / 16;      // columns n of S_new per thread
  float* Xw = smem;                  // Xw[c * DMAX + p] = w_j xb[j, p]
  float* Bs = Xw + R * DMAX;         // Bs[c * DMAX + n] = B[j, n]
  float* w = Bs + R * DMAX;          // w[c] = exp(tot - seg_j)

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int L = a.L, hd = a.hd, N = a.N;
  const float* xb = a.xb + bb * a.xb_b + (long long)h * hd;
  const float* B = a.b + bb * a.b_b;
  const float* seg = a.seg + bb * a.seg_b + h;
  const float tot = seg[(L - 1) * a.seg_s];

  float acc[RI][CJ];   // state rows p = rg + 16 i, columns n = cg + 16 j
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < L; k0 += R) {
    __syncthreads();   // the previous tile's reads are done
    if (tid < R) w[tid] = k0 + tid < L ? expf(tot - seg[(k0 + tid) * a.seg_s]) : 0.f;
    __syncthreads();
    for (int idx = tid; idx < R * DMAX; idx += THREADS) {
      const int c = idx / DMAX, d = idx % DMAX, j = k0 + c;
      Xw[idx] = (j < L && d < hd) ? xb[j * a.xb_s + d] * w[c] : 0.f;
      Bs[idx] = (j < L && d < N) ? B[j * a.b_s + d] : 0.f;
    }
    __syncthreads();
    const int n_keys = min(R, L - k0);
    for (int c = 0; c < n_keys; ++c) {
      float xv[RI], bv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) xv[i] = Xw[c * DMAX + rg + 16 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) bv[j] = Bs[c * DMAX + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
    }
  }

  const float decay = expf(tot);
  const long long base = ((long long)bb * a.nh + h) * hd * N;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int p = rg + 16 * i;
    if (p >= hd) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int n = cg + 16 * j;
      if (n < N) {
        const long long at = base + (long long)p * N + n;
        a.s_new[at] = decay * a.s_prev[at] + acc[i][j];
      }
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS) ssd_chunk_kernel(Args a) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  if (tile * R < a.L)
    rows_of_y<DMAX>(a, bb, h, tile * R, smem);
  else
    new_state<DMAX>(a, bb, h, smem);
}

template <int DMAX>
int launch(const Args& a, int Bb, cudaStream_t s) {
  const size_t smem = smem_bytes<DMAX>();
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.L + R - 1) / R + 1, a.nh, Bb);
  ssd_chunk_kernel<DMAX><<<grid, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// (y [B,L,nh,hd], S_new [B,nh,hd,N]) = one SSD chunk step of xb [B,L,nh,hd],
// B_/C_ [B,L,N], seg [B,L,nh] and S_prev [B,nh,hd,N], all fp32. xb, B_, C_
// and seg have packed trailing dims (unit stride last, xb's heads hd
// apart); *_bs and *_ss are their batch and row strides in elements. S_prev,
// y and S_new are contiguous. hd, N <= 64. Returns the cudaError_t of the
// launch (0 on success); never synchronises.
extern "C" int ssd_chunk_fwd(const void* xb, const void* b, const void* c,
                             const void* seg, const void* s_prev, void* y,
                             void* s_new, int B, int L, int nh, int hd, int N,
                             long long xb_bs, long long xb_ss, long long b_bs,
                             long long b_ss, long long c_bs, long long c_ss,
                             long long seg_bs, long long seg_ss,
                             void* stream) {
  if (B <= 0 || L <= 0 || nh <= 0 || hd <= 0 || N <= 0 || hd > 64 || N > 64 ||
      nh > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(xb), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<const float*>(seg),
               static_cast<const float*>(s_prev), static_cast<float*>(y),
               static_cast<float*>(s_new), L, nh, hd, N,
               xb_bs, xb_ss, b_bs, b_ss, c_bs, c_ss, seg_bs, seg_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = hd > N ? hd : N;
  if (d <= 16) return launch<16>(a, B, s);
  if (d <= 32) return launch<32>(a, B, s);
  return launch<64>(a, B, s);
}
