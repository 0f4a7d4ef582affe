// GEMM O = D @ W with the ABFT checks in its epilogue: two C entry points
// over one mainloop.
//
// Replaces: src/repro/kernels/abft_matmul.py::_kernel (the Pallas TPU GEMM
// whose epilogue reduces each output tile to colsum / rowsum / sumsq) and
// src/repro/kernels/abft_matmul.py::_detect_kernel (the same GEMM whose
// epilogue runs the CoC-D compare and emits one flag and score per chunk).
//
// Bound on an H100: at the shapes the port gives it - the CNN's fc, (8 x
// 512) @ (512 x 1000), and the transformer's sites at decode, (8 x 960) @
// (960 x {320, 960, 2560, 49152}) in bf16 - it moves the weight once and
// does 2 flops per weight element per row, so it is bound by bytes (and,
// below ~1 MB, by the launch itself). At prefill (128 rows) it does 256
// flops per bf16 weight element, which the fp32 FMA units (67 TFLOP/s)
// bound before the memory does. The detection thresholds
// (core/thresholds.py) price IEEE fp32 accumulation, so this kernel uses
// fp32 FMA only: no TF32, no tensor cores. wgmma on bf16 operands, TMA and
// a pipelined mainloop are later work.
//
// Design: operands are float or bf16 (products of bf16 values are exact in
// fp32; every sum is an fp32 FMA), W is read either as (K, M) row-major or
// as (M, K) row-major - the tied LM head's weight is the transposed view of
// the embedding table, read in place. Two tilings of one computation, picked
// per launch from N alone, so both entry points round O identically:
// * general: a shared-memory tiled SGEMM. A block of 256 threads owns a
//   64 x 64 output tile and walks K in steps of 16 inside the block (this
//   loop takes the place of the TPU kernel's sequential k grid axis and its
//   VMEM accumulator); each thread holds a 4 x 4 micro-tile of accumulators
//   at rows ty + 16*i and columns tx + 16*j, so a warp's stores coalesce.
// * skinny, for N <= 16 (decode, the CNN's fc): a 64-row tile would leave
//   most of its rows empty, so a block owns a 16 x 32 tile and its 8 warps
//   split K between them. A K chunk of D and of W is staged in shared
//   memory with loads that coalesce for either W layout; lane l of every
//   warp owns column l and keeps 16 row accumulators; the warps' partial
//   tiles are summed in a fixed order.
// Out-of-range rows, columns and K-slices read as zeros, so operands are
// never padded in device memory. The finished fp32 tile is staged in shared
// memory; O is stored in D's type (one rounding) and the epilogue reads the
// fp32 values:
// * partials (repro_abft_matmul): a fixed-order reduction to colsum per
//   (row tile, column), rowsum per (row, column tile) and sumsq per (row
//   tile, column tile) at granularity (pbm, pbn), powers of two dividing the
//   tile.
// * detect (repro_abft_matmul_detect): on the TPU the detection chunk
//   (rb x cb, up to 1024 x 1024) is the Pallas tile; here a block tile is
//   far smaller, so each block reduces every row of its tile, in column
//   segments of P (a power of two dividing both the tile and cb, so a
//   segment never straddles two chunks), to s5, the chunk-local
//   column-weighted s7 and the sum of squares. A second kernel, launched by
//   the same entry point, sums each chunk's segments in a fixed order (row
//   weights give s6), runs the compare and writes the chunk's flag and
//   score. No float atomics: the flags cannot change from run to run.
// Bias stays outside.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// W[kk][c] of W (k, m): row-major (k, m), or the transposed view of an
// (m, k) row-major tensor
template <typename T, bool kWT>
__device__ __forceinline__ float load_w(const T* __restrict__ W, int gk,
                                        int gc, int k, int m) {
  return kWT ? to_f(W[(size_t)gc * k + gk]) : to_f(W[(size_t)gk * m + gc]);
}

// ---------------------------------------------------------------- epilogues

// The partial sums of one finished TM x TN tile held in Cs (elements
// outside O are zero). Rq is TM x (TN/pbn) scratch for per-row sums of
// squares.
struct PartialsArgs {
  int pbm, pbn;
  float* colsum;
  float* rowsum;
  float* sumsq;
  int rs_cols, ss_cols;
};

template <int TM, int TN>
__device__ void partials_epilogue(float (*Cs)[TN + 1], float (*Rq)[TN + 1],
                                  int row0, int col0, int n, int m,
                                  const PartialsArgs& a) {
  const int tid = threadIdx.x;
  const int pbm = a.pbm, pbn = a.pbn;
  const int nrt = TM / pbm, nct = TN / pbn;   // partial tiles in this tile
  // colsum: one sum over pbm rows per (row tile, column)
  for (int idx = tid; idx < nrt * TN; idx += kThreads) {
    const int t = idx / TN, c = idx % TN;
    const int gc = col0 + c, rs = t * pbm;
    if (gc < m && row0 + rs < n) {
      float s = 0.f;
      for (int r = rs; r < rs + pbm; ++r) s += Cs[r][c];
      a.colsum[(size_t)(row0 / pbm + t) * m + gc] = s;
    }
  }
  // rowsum (and the per-row sums of squares): one sum over pbn columns per
  // (row, column tile)
  for (int idx = tid; idx < TM * nct; idx += kThreads) {
    const int r = idx / nct, t = idx % nct;
    const int gr = row0 + r, cs = t * pbn;
    float s = 0.f, q = 0.f;
    for (int c = cs; c < cs + pbn; ++c) {
      const float v = Cs[r][c];
      s += v;
      q += v * v;
    }
    Rq[r][t] = q;
    if (gr < n && col0 + cs < m)
      a.rowsum[(size_t)gr * a.rs_cols + col0 / pbn + t] = s;
  }
  __syncthreads();
  // sumsq: the row sums of squares of each (row tile, column tile)
  for (int idx = tid; idx < nrt * nct; idx += kThreads) {
    const int tr = idx / nct, tcol = idx % nct;
    const int rs = tr * pbm;
    if (row0 + rs < n && col0 + tcol * pbn < m) {
      float s = 0.f;
      for (int r = rs; r < rs + pbm; ++r) s += Rq[r][tcol];
      a.sumsq[(size_t)(row0 / pbm + tr) * a.ss_cols + col0 / pbn + tcol] = s;
    }
  }
}

// Per-row segment sums for the detect pass: part is (3, n, m / seg):
// [0] sum of O, [1] sum of (column index within its chunk) * O, [2] sum of
// O^2 over the seg columns of each segment. Segments past the edge of O are
// not written.
struct DetectArgs {
  int cb, seg;
  float* part;
};

template <int TM, int TN>
__device__ void detect_epilogue(float (*Cs)[TN + 1], float (*)[TN + 1],
                                int row0, int col0, int n, int m,
                                const DetectArgs& a) {
  const int seg = a.seg, nseg = TN / seg;
  const int segs_total = m / seg;
  const size_t plane = (size_t)n * segs_total;
  for (int idx = threadIdx.x; idx < TM * nseg; idx += kThreads) {
    const int r = idx / nseg, t = idx % nseg;
    const int gr = row0 + r, c0 = t * seg, gc0 = col0 + c0;
    if (gr >= n || gc0 >= m) continue;
    const float w0 = (float)(gc0 % a.cb);   // local index of the first column
    float s = 0.f, s7 = 0.f, q = 0.f;
    for (int c = 0; c < seg; ++c) {
      const float v = Cs[r][c0 + c];
      s += v;
      s7 = fmaf(w0 + (float)c, v, s7);
      q = fmaf(v, v, q);
    }
    const size_t at = (size_t)gr * segs_total + gc0 / seg;
    a.part[at] = s;
    a.part[plane + at] = s7;
    a.part[2 * plane + at] = q;
  }
}

template <int TM, int TN, typename Args>
__device__ __forceinline__ void run_epilogue(float (*Cs)[TN + 1],
                                             float (*Rq)[TN + 1], int row0,
                                             int col0, int n, int m,
                                             const Args& a);
template <>
__device__ __forceinline__ void run_epilogue<64, 64, PartialsArgs>(
    float (*Cs)[65], float (*Rq)[65], int row0, int col0, int n, int m,
    const PartialsArgs& a) {
  partials_epilogue<64, 64>(Cs, Rq, row0, col0, n, m, a);
}
template <>
__device__ __forceinline__ void run_epilogue<16, 32, PartialsArgs>(
    float (*Cs)[33], float (*Rq)[33], int row0, int col0, int n, int m,
    const PartialsArgs& a) {
  partials_epilogue<16, 32>(Cs, Rq, row0, col0, n, m, a);
}
template <>
__device__ __forceinline__ void run_epilogue<64, 64, DetectArgs>(
    float (*Cs)[65], float (*Rq)[65], int row0, int col0, int n, int m,
    const DetectArgs& a) {
  detect_epilogue<64, 64>(Cs, Rq, row0, col0, n, m, a);
}
template <>
__device__ __forceinline__ void run_epilogue<16, 32, DetectArgs>(
    float (*Cs)[33], float (*Rq)[33], int row0, int col0, int n, int m,
    const DetectArgs& a) {
  detect_epilogue<16, 32>(Cs, Rq, row0, col0, n, m, a);
}

// ---------------------------------------------------------------- mainloops

constexpr int BM = 64, BN = 64, BK = 16;

template <typename T, bool kWT, typename Args>
__global__ void __launch_bounds__(kThreads)
gemm_general_kernel(const T* __restrict__ D, const T* __restrict__ W,
                    T* __restrict__ O, int n, int k, int m, Args args) {
  __shared__ float As[BK][BM + 4];   // D tile, transposed: As[kk][row]
  __shared__ float Bs[BK][BN + 1];   // W tile: Bs[kk][col]
  __shared__ float Cs[BM][BN + 1];   // the finished output tile
  __shared__ float Rq[BM][BN + 1];   // per (row, column tile) sums of squares

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += kThreads) {
      const int r = idx / BK, kk = idx % BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < n && gk < k) ? to_f(D[(size_t)gr * k + gk]) : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += kThreads) {
      // consecutive threads walk the contiguous axis of W's layout
      const int kk = kWT ? idx % BK : idx / BN;
      const int c = kWT ? idx / BK : idx % BN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < k && gc < m) ? load_w<T, kWT>(W, gk, gc, k, m) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // store O and stage the tile; masked elements are exact zeros, so every
  // sum takes only elements of O
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const int gr = row0 + r, gc = col0 + c;
      const bool valid = gr < n && gc < m;
      Cs[r][c] = valid ? acc[i][j] : 0.f;
      if (valid) O[(size_t)gr * m + gc] = from_f<T>(acc[i][j]);
    }
  }
  __syncthreads();
  run_epilogue<BM, BN, Args>(Cs, Rq, row0, col0, n, m, args);
}

constexpr int SM = 16, SN = 32, SKC = 128;   // skinny tile and K chunk
constexpr int kWarps = kThreads / 32;

template <typename T, bool kWT, typename Args>
__global__ void __launch_bounds__(kThreads)
gemm_skinny_kernel(const T* __restrict__ D, const T* __restrict__ W,
                   T* __restrict__ O, int n, int k, int m, Args args) {
  __shared__ __align__(16) float Ds[SM][SKC];   // a K chunk of all of D
  __shared__ float Ws[SKC][SN + 1];             // a K chunk of W's columns
  __shared__ float Ps[kWarps][SM][SN + 1];      // each warp's partial tile
  __shared__ float Cs[SM][SN + 1];
  __shared__ float Rq[SM][SN + 1];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * SN;

  float acc[SM];
#pragma unroll
  for (int r = 0; r < SM; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < k; k0 += SKC) {
    const int kc = min(SKC, k - k0);
    for (int idx = tid; idx < SM * SKC; idx += kThreads) {
      const int r = idx / SKC, kk = idx % SKC;
      Ds[r][kk] = (r < n && kk < kc) ? to_f(D[(size_t)r * k + k0 + kk]) : 0.f;
    }
    for (int idx = tid; idx < SKC * SN; idx += kThreads) {
      const int kk = kWT ? idx % SKC : idx / SN;
      const int c = kWT ? idx / SKC : idx % SN;
      const int gc = col0 + c;
      Ws[kk][c] = (kk < kc && gc < m) ? load_w<T, kWT>(W, k0 + kk, gc, k, m)
                                      : 0.f;
    }
    __syncthreads();
    // warp w takes the groups of 4 consecutive k at 4w, 4w + 32, ...
#pragma unroll 2
    for (int kk = 4 * warp; kk < kc; kk += 4 * kWarps) {
      float wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[q] = Ws[kk + q][lane];
#pragma unroll
      for (int r = 0; r < SM; ++r) {
        const float4 d = *reinterpret_cast<const float4*>(&Ds[r][kk]);
        acc[r] = fmaf(d.x, wv[0], acc[r]);
        acc[r] = fmaf(d.y, wv[1], acc[r]);
        acc[r] = fmaf(d.z, wv[2], acc[r]);
        acc[r] = fmaf(d.w, wv[3], acc[r]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < SM; ++r) Ps[warp][r][lane] = acc[r];
  __syncthreads();
  // sum the warps' partial tiles in warp order; store O and stage the tile
  for (int idx = tid; idx < SM * SN; idx += kThreads) {
    const int r = idx / SN, cc = idx % SN;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += Ps[w][r][cc];
    const bool valid = r < n && col0 + cc < m;
    Cs[r][cc] = valid ? s : 0.f;
    if (valid) O[(size_t)r * m + col0 + cc] = from_f<T>(s);
  }
  __syncthreads();
  run_epilogue<SM, SN, Args>(Cs, Rq, 0, col0, n, m, args);
}

// The block tile of an n-row product. The tiling is chosen from n alone, so
// both entry points (and every partial granularity) accumulate each element
// of O in the same order. This is the rule's one home: the wrappers read it
// through repro_abft_tiling.
constexpr int tile_m(int n) { return n <= SM ? SM : BM; }
constexpr int tile_n(int n) { return n <= SM ? SN : BN; }

// The column segment the detect pass's blocks sum rows over: the largest
// power of two dividing both cb and the tile's width, so no segment
// straddles two chunks.
int detect_seg(int n, int cb) {
  int seg = tile_n(n);
  while (cb % seg) seg /= 2;
  return seg;
}

template <typename T, bool kWT, typename Args>
void launch_gemm(const void* d, const void* w, void* o, int n, int k, int m,
                 const Args& args, cudaStream_t s) {
  const T* D = static_cast<const T*>(d);
  const T* W = static_cast<const T*>(w);
  T* O = static_cast<T*>(o);
  if (tile_m(n) == SM) {
    gemm_skinny_kernel<T, kWT, Args>
        <<<(m + SN - 1) / SN, kThreads, 0, s>>>(D, W, O, n, k, m, args);
  } else {
    dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
    gemm_general_kernel<T, kWT, Args>
        <<<grid, kThreads, 0, s>>>(D, W, O, n, k, m, args);
  }
}

template <typename Args>
int dispatch(int dtype, int w_layout, const void* d, const void* w, void* o,
             int n, int k, int m, const Args& args, cudaStream_t s) {
  if (dtype == 0 && w_layout == 0)
    launch_gemm<float, false>(d, w, o, n, k, m, args, s);
  else if (dtype == 0 && w_layout == 1)
    launch_gemm<float, true>(d, w, o, n, k, m, args, s);
  else if (dtype == 1 && w_layout == 0)
    launch_gemm<__nv_bfloat16, false>(d, w, o, n, k, m, args, s);
  else if (dtype == 1 && w_layout == 1)
    launch_gemm<__nv_bfloat16, true>(d, w, o, n, k, m, args, s);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

// One block per detection chunk: the chunk's row segments summed in a fixed
// order (each thread a fixed strided subset, then a fixed tree), then the
// CoC-D compare of _detect_kernel:
//   tau5 = tau_a * sqrt(sumsq) + tau_b * absdot + 1e-30,
// s6 / s7 against tau5 * (rb - 1) / tau5 * (cb - 1) when weighted, NaN or
// Inf on either side flags the chunk with score inf.
__global__ void __launch_bounds__(kThreads)
detect_compare_kernel(const float* __restrict__ part, int n, int m, int rb,
                      int cb, int seg, const float* __restrict__ c5,
                      const float* __restrict__ c6,
                      const float* __restrict__ c7,
                      const float* __restrict__ absdot, float tau_a,
                      float tau_b, int weighted, int* __restrict__ flag,
                      float* __restrict__ score) {
  __shared__ float red[4][kThreads];
  const int a = blockIdx.y, b = blockIdx.x, mb = m / cb;
  const int segs_total = m / seg, spc = cb / seg;   // segments per chunk row
  const size_t plane = (size_t)n * segs_total;
  float s5 = 0.f, s6 = 0.f, s7 = 0.f, sq = 0.f;
  for (int i = threadIdx.x; i < rb * spc; i += kThreads) {
    const int r = i / spc, j = i % spc;
    const size_t at = (size_t)(a * rb + r) * segs_total + b * spc + j;
    const float v = part[at];
    s5 += v;
    s6 = fmaf((float)r, v, s6);
    s7 += part[plane + at];
    sq += part[2 * plane + at];
  }
  red[0][threadIdx.x] = s5;
  red[1][threadIdx.x] = s6;
  red[2][threadIdx.x] = s7;
  red[3][threadIdx.x] = sq;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h /= 2) {
    if (threadIdx.x < h)
      for (int q = 0; q < 4; ++q)
        red[q][threadIdx.x] += red[q][threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const int at = a * mb + b;
  const float tau5 = tau_a * sqrtf(fmaxf(red[3][0], 0.f))
                     + tau_b * absdot[at] + 1e-30f;
  const float cs[3] = {c5[at], c6[at], c7[at]};
  const float ts[3] = {tau5, tau5 * (float)max(rb - 1, 1),
                       tau5 * (float)max(cb - 1, 1)};
  bool f = false;
  float sc = 0.f;
  for (int q = 0; q < (weighted ? 3 : 1); ++q) {
    const float c = cs[q], s = red[q][0], t = ts[q];
    const bool bad = !(isfinite(c) && isfinite(s));
    const float diff = fabsf(c - s);
    f = f || bad || diff > t;
    sc = fmaxf(sc, bad ? __int_as_float(0x7f800000) : diff / t);
  }
  flag[at] = f ? 1 : 0;
  score[at] = sc;
}

}  // namespace

// The tiling an n-row product launches with: the block tile (tm x tn) and,
// for a detection chunk width cb > 0, the detect pass's row segment (seg;
// repro_abft_matmul_detect's part then holds 3 * n * (m / seg) floats;
// 0 when cb is 0). The wrappers size their buffers from it.
extern "C" int repro_abft_tiling(int n, int cb, int* tm, int* tn, int* seg) {
  if (n < 1 || cb < 0) return (int)cudaErrorInvalidValue;
  *tm = tile_m(n);
  *tn = tile_n(n);
  *seg = cb > 0 ? detect_seg(n, cb) : 0;
  return 0;
}

// D (n, k), W (k, m) with w_layout 0 (row-major) or the transposed view of
// an (m, k) row-major tensor (w_layout 1), O (n, m) row-major; dtype 0 is
// float32, 1 is bfloat16 (all three tensors). colsum has m columns, rowsum
// rs_cols and sumsq ss_cols; rows of colsum/sumsq are partial row tiles of
// pbm rows, columns of rowsum/sumsq partial column tiles of pbn columns,
// pbm and pbn powers of two dividing the block tile (repro_abft_tiling).
// Only the tiles that hold elements of O are written. Returns
// cudaGetLastError().
extern "C" int repro_abft_matmul(const void* d, const void* w, void* o,
                                 int dtype, int w_layout, int n, int k, int m,
                                 int pbm, int pbn, float* colsum,
                                 float* rowsum, float* sumsq, int rs_cols,
                                 int ss_cols, void* stream) {
  const int tm = tile_m(n), tn = tile_n(n);
  if (pbm < 1 || pbm > tm || tm % pbm || pbn < 1 || pbn > tn || tn % pbn)
    return (int)cudaErrorInvalidValue;
  const PartialsArgs args{pbm, pbn, colsum, rowsum, sumsq, rs_cols, ss_cols};
  const int err = dispatch(dtype, w_layout, d, w, o, n, k, m, args,
                           (cudaStream_t)stream);
  return err ? err : (int)cudaGetLastError();
}

// O = D @ W as above plus the CoC-D compare per (rb x cb) chunk: c5, c6,
// c7 and absdot are float32 (n / rb, m / cb); flag (int32) and score
// (float32) likewise. part is float32 scratch of 3 * n * (m / seg)
// elements, seg as repro_abft_tiling gives it. rb must divide n and cb must
// divide m. Returns the first error of the two launches, or
// cudaGetLastError().
extern "C" int repro_abft_matmul_detect(
    const void* d, const void* w, void* o, int dtype, int w_layout, int n,
    int k, int m, int rb, int cb, const float* c5, const float* c6,
    const float* c7, const float* absdot, float tau_a, float tau_b,
    int weighted, float* part, int* flag, float* score, void* stream) {
  if (rb < 1 || cb < 1 || n % rb || m % cb)
    return (int)cudaErrorInvalidValue;
  const int seg = detect_seg(n, cb);
  cudaStream_t s = (cudaStream_t)stream;
  const DetectArgs args{cb, seg, part};
  int err = dispatch(dtype, w_layout, d, w, o, n, k, m, args, s);
  if (err) return err;
  err = (int)cudaGetLastError();
  if (err) return err;
  detect_compare_kernel<<<dim3(m / cb, n / rb), kThreads, 0, s>>>(
      part, n, m, rb, cb, seg, c5, c6, c7, absdot, tau_a, tau_b, weighted,
      flag, score);
  return (int)cudaGetLastError();
}
