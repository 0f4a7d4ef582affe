// GEMM O = D @ W with the ABFT output summations in its epilogue.
//
// Replaces: src/repro/kernels/abft_matmul.py::_kernel (the Pallas TPU GEMM
// whose epilogue reduces each output tile to colsum / rowsum / sumsq).
//
// Bound on an H100: at the shape the protected CNN gives it - the fc layer,
// (8 x 512) @ (512 x 1000) - it moves ~2.1 MB and does 8.2 MFLOP, so it is
// bound by bytes and, below that, by the launch itself. At large shapes it
// would be bound by fp32 FMA throughput (67 TFLOP/s without tensor cores).
// The detection thresholds (core/thresholds.py) price IEEE fp32
// accumulation, so this kernel uses fp32 FMA only: no TF32, no tensor
// cores. wgmma, TMA and a pipelined mainloop are later work.
//
// Design: two tilings of one computation, picked per launch from the shape.
// * general: a shared-memory tiled SGEMM. A block of 256 threads owns a
//   64 x 64 output tile and walks K in steps of 16 inside the block (this
//   loop takes the place of the TPU kernel's sequential k grid axis and its
//   VMEM accumulator); each thread holds a 4 x 4 micro-tile of accumulators
//   at rows ty + 16*i and columns tx + 16*j, so a warp's stores coalesce.
// * skinny, for N <= 16 (the fc at batch 8): a 64-row tile would leave
//   most of its rows empty and the grid at 16 blocks, so a block owns a
//   16 x 32 tile instead and its 8 warps split K between them: lane l of
//   every warp owns column l, reads W rows coalesced, and keeps 16 row
//   accumulators; the warps' partial tiles are summed in a fixed order.
// Out-of-range rows, columns and K-slices read as zeros, so the operands
// are never padded in device memory. Both tilings finish in the same
// epilogue: the finished tile is staged in shared memory and reduced, in a
// fixed order, to the partial sums at granularity (pbm, pbn), powers of two
// dividing the tile: colsum per (row tile, column), rowsum per (row, column
// tile), and sumsq per (row tile, column tile). Bias stays outside.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The partial sums of one finished TM x TN tile held in Cs (elements
// outside O are zero). Rq is TM x (TN/pbn) scratch for per-row sums of
// squares.
template <int TM, int TN>
__device__ void epilogue(float (*Cs)[TN + 1], float (*Rq)[TN + 1],
                         int row0, int col0, int n, int m, int pbm, int pbn,
                         float* __restrict__ colsum, float* __restrict__ rowsum,
                         float* __restrict__ sumsq, int rs_cols, int ss_cols) {
  const int tid = threadIdx.x;
  const int nrt = TM / pbm, nct = TN / pbn;   // partial tiles in this tile
  // colsum: one sum over pbm rows per (row tile, column)
  for (int idx = tid; idx < nrt * TN; idx += kThreads) {
    const int t = idx / TN, c = idx % TN;
    const int gc = col0 + c, rs = t * pbm;
    if (gc < m && row0 + rs < n) {
      float s = 0.f;
      for (int r = rs; r < rs + pbm; ++r) s += Cs[r][c];
      colsum[(size_t)(row0 / pbm + t) * m + gc] = s;
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
      rowsum[(size_t)gr * rs_cols + col0 / pbn + t] = s;
  }
  __syncthreads();
  // sumsq: the row sums of squares of each (row tile, column tile)
  for (int idx = tid; idx < nrt * nct; idx += kThreads) {
    const int tr = idx / nct, tcol = idx % nct;
    const int rs = tr * pbm;
    if (row0 + rs < n && col0 + tcol * pbn < m) {
      float s = 0.f;
      for (int r = rs; r < rs + pbm; ++r) s += Rq[r][tcol];
      sumsq[(size_t)(row0 / pbm + tr) * ss_cols + col0 / pbn + tcol] = s;
    }
  }
}

constexpr int BM = 64, BN = 64, BK = 16;

__global__ void __launch_bounds__(kThreads)
abft_matmul_kernel(const float* __restrict__ D, const float* __restrict__ W,
                   float* __restrict__ O, int n, int k, int m, int pbm, int pbn,
                   float* __restrict__ colsum, float* __restrict__ rowsum,
                   float* __restrict__ sumsq, int rs_cols, int ss_cols) {
  __shared__ float As[BK][BM + 4];   // D tile, transposed: As[kk][row]
  __shared__ float Bs[BK][BN];       // W tile: Bs[kk][col]
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
      As[kk][r] = (gr < n && gk < k) ? D[(size_t)gr * k + gk] : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += kThreads) {
      const int kk = idx / BN, c = idx % BN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < k && gc < m) ? W[(size_t)gk * m + gc] : 0.f;
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
  // partial sums only elements of O
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const int gr = row0 + r, gc = col0 + c;
      const bool valid = gr < n && gc < m;
      Cs[r][c] = valid ? acc[i][j] : 0.f;
      if (valid) O[(size_t)gr * m + gc] = acc[i][j];
    }
  }
  __syncthreads();
  epilogue<BM, BN>(Cs, Rq, row0, col0, n, m, pbm, pbn, colsum, rowsum, sumsq,
                   rs_cols, ss_cols);
}

constexpr int SM = 16, SN = 32, SKC = 256;   // skinny tile and K chunk
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
abft_matmul_skinny_kernel(const float* __restrict__ D,
                          const float* __restrict__ W, float* __restrict__ O,
                          int n, int k, int m, int pbm, int pbn,
                          float* __restrict__ colsum,
                          float* __restrict__ rowsum, float* __restrict__ sumsq,
                          int rs_cols, int ss_cols) {
  __shared__ __align__(16) float Ds[SM][SKC];   // a K chunk of all of D
  __shared__ float Ps[kWarps][SM][SN + 1];      // each warp's partial tile
  __shared__ float Cs[SM][SN + 1];
  __shared__ float Rq[SM][SN + 1];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * SN, c = col0 + lane;
  const bool cvalid = c < m;

  float acc[SM];
#pragma unroll
  for (int r = 0; r < SM; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < k; k0 += SKC) {
    const int kc = min(SKC, k - k0);
    for (int idx = tid; idx < SM * SKC; idx += kThreads) {
      const int r = idx / SKC, kk = idx % SKC;
      Ds[r][kk] = (r < n && kk < kc) ? D[(size_t)r * k + k0 + kk] : 0.f;
    }
    __syncthreads();
    // warp w takes the groups of 4 consecutive k at 4w, 4w + 32, ...
#pragma unroll 2
    for (int kk = 4 * warp; kk < kc; kk += 4 * kWarps) {
      float wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wv[q] = (cvalid && kk + q < kc) ? W[(size_t)(k0 + kk + q) * m + c]
                                        : 0.f;
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
    if (valid) O[(size_t)r * m + col0 + cc] = s;
  }
  __syncthreads();
  epilogue<SM, SN>(Cs, Rq, 0, col0, n, m, pbm, pbn, colsum, rowsum, sumsq,
                   rs_cols, ss_cols);
}

}  // namespace

// D (n, k), W (k, m), O (n, m), all fp32 and row-major. colsum has m
// columns, rowsum rs_cols and sumsq ss_cols; rows of colsum/sumsq are
// partial row tiles of pbm rows, columns of rowsum/sumsq partial column
// tiles of pbn columns, pbm and pbn powers of two up to 64. Only the tiles
// that hold elements of O are written. Returns cudaGetLastError().
extern "C" int repro_abft_matmul_f32(const float* d, const float* w, float* o,
                                     int n, int k, int m, int pbm, int pbn,
                                     float* colsum, float* rowsum, float* sumsq,
                                     int rs_cols, int ss_cols, void* stream) {
  if (pbm < 1 || pbm > BM || BM % pbm || pbn < 1 || pbn > BN || BN % pbn)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= SM && pbm <= SM && pbn <= SN) {
    abft_matmul_skinny_kernel<<<(m + SN - 1) / SN, kThreads, 0, s>>>(
        d, w, o, n, k, m, pbm, pbn, colsum, rowsum, sumsq, rs_cols, ss_cols);
  } else {
    dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
    abft_matmul_kernel<<<grid, kThreads, 0, s>>>(
        d, w, o, n, k, m, pbm, pbn, colsum, rowsum, sumsq, rs_cols, ss_cols);
  }
  return (int)cudaGetLastError();
}
