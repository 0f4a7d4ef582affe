// GEMM O = D @ W with the ABFT checks in its epilogue: two C entry points
// over one mainloop per operand type.
//
// Replaces: src/repro/kernels/abft_matmul.py::_kernel (the Pallas TPU GEMM
// whose epilogue reduces each output tile to colsum / rowsum / sumsq) and
// src/repro/kernels/abft_matmul.py::_detect_kernel (the same GEMM whose
// epilogue runs the CoC-D compare and emits one flag and score per chunk).
//
// Bound on an H100, by regime:
// * bf16 at decode (the transformer's sites at 8 rows: (8 x 960) @ (960 x
//   {320, 960, 2560, 49152}), (8 x 2560) @ (2560 x 960)): 2 flops per
//   weight element per row, far below the card's ~295 flops per byte, so
//   the weight's bytes bound it: 0.6 us for a 960 x 960 site at 3.35 TB/s,
//   28 us for the tied head's 94 MB. Below ~2 MB the launch and the
//   latency of the first loads dominate, so the kernel must put its loads
//   in flight on most of the 132 SMs at once.
// * bf16 at prefill (16-128 rows): up to 256 flops per weight element,
//   near the ridge; the bf16 tensor-core rate (989 TFLOP/s) and how many
//   SMs hold work bound it. The thresholds (core/thresholds.py) price a
//   bf16 O by its rounding, 2^-7, ~10^5 above any fp32 accumulation
//   error, and products of bf16 values are exact in fp32, so the tensor
//   cores (fp32 accumulators) lose nothing the checks can see.
// * f32 (the CNN's fc, (8 x 512) @ (512 x 1000)): the thresholds price
//   IEEE fp32 accumulation, which the tensor cores do not give, so it
//   keeps fp32 FMA on the CUDA cores (the SIMT mainloops below).
//
// The bf16 design (gemm_wgmma_kernel): one warpgroup per block runs
// wgmma.mma_async on bf16 operands in shared memory, fp32 accumulators in
// registers. The product is computed transposed, O^T = W^T D^T: wgmma's
// 64-row M runs over 64 output columns and its N over the block's O rows
// (8, 16, 32, 64 or 128, the smallest that holds n), so a decode step's 8
// rows are not padded up to 64. W^T is K-major when W is the transposed
// view of an (M, K) table (the tied head, read in place) and M-major when
// W is (K, M) row-major (wgmma's transpose bit); D^T is K-major. K is
// walked in stages of 64 through a ring of 4 shared-memory stages filled
// by 16-byte cp.async copies (zero-filled past the edges of D and W), so
// three stages' loads are in flight while wgmma runs on the one that
// arrived; a shape whose rows are not 16-byte aligned (K or M not a
// multiple of 8) fills the same stages with masked 2-byte loads instead,
// which changes no sum. wgmma's accumulators truncate toward zero: summed
// over all of K they drift below IEEE fp32 accumulation, which the
// thresholds price, so each stage's 64 products are summed by wgmma alone
// and added to a second set of fp32 registers with round-to-nearest.
// When the output tiles cannot fill the card, K is split over up to 8
// blocks of one cluster (splits chosen so that tiles x splits reaches
// ~132). Through distributed shared memory, rank 0 gets every split's
// fp32 tile and their sum in rank order - the ranks store their tiles into
// its shared memory and leave (decode's short tiles), or each rank sums a
// share of the elements over all ranks (taller tiles, whose splits would
// not fit one block's shared memory) - no float atomics, so O, flags and
// scores are the same from run to run - and rank 0 runs the epilogue on
// the fp32 total. The detect
// entry point is one launch: after its segments, the last tile of each
// detection chunk to finish (an integer counter per chunk, reset by that
// block) runs the chunk's compare.
//
// The tiling (tile, orientation, split count) is chosen here alone, from
// (n, k, m, dtype), so both entry points accumulate each element of O in
// the same order and round O identically; the wrappers read it through
// repro_abft_tiling and size their buffers from it.
//
// The f32 design: two SIMT tilings of one computation, picked per launch
// from N alone. W is read either as (K, M) row-major or as (M, K)
// row-major, as above.
// * general: a shared-memory tiled SGEMM. A block of 256 threads owns a
//   64 x 64 output tile and walks K in steps of 16 inside the block (this
//   loop takes the place of the TPU kernel's sequential k grid axis and its
//   VMEM accumulator); each thread holds a 4 x 4 micro-tile of accumulators
//   at rows ty + 16*i and columns tx + 16*j, so a warp's stores coalesce.
// * skinny, for N <= 16 (the CNN's fc): a 64-row tile would leave most of
//   its rows empty, so a block owns a 16 x 32 tile and its 8 warps split K
//   between them. A K chunk of D and of W is staged in shared memory with
//   loads that coalesce for either W layout; lane l of every warp owns
//   column l and keeps 16 row accumulators; the warps' partial tiles are
//   summed in a fixed order.
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
//   column-weighted s7 and the sum of squares. compare_chunk sums each
//   chunk's segments in a fixed order (row weights give s6), runs the
//   compare and writes the chunk's flag and score: in a second kernel of
//   the same entry point on f32, inside the GEMM's launch on bf16. No
//   float atomics: the flags cannot change from run to run.
// Bias stays outside.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// W[kk][c] of W (k, m): row-major (k, m), or the transposed view of an
// (m, k) row-major tensor
template <typename T, bool kWT>
__device__ __forceinline__ float load_w(const T* __restrict__ W, int gk,
                                        int gc, int k, int m) {
  return kWT ? to_f(W[(size_t)gc * k + gk]) : to_f(W[(size_t)gk * m + gc]);
}

// ---------------------------------------------------------------- epilogues

// A row's sum over a segment or a partial column tile can be split over p
// lanes of one warp and finished by a fixed butterfly (kLanes): p is the
// most lanes, up to 32, that keep `tasks` sums within NT threads, so a
// decode tile's few rows do not run serially. Without kLanes p is 1 and
// each thread sums its own.
template <bool kLanes, int NT>
__device__ __forceinline__ int lanes_per_task(int tasks) {
  int p = kLanes ? 32 : 1;
  while (p > 1 && tasks * p > NT) p /= 2;
  return p;
}

// the butterfly over p lanes, on several sums at once
template <int N>
__device__ __forceinline__ void lanes_sum(float (&v)[N], int p) {
  for (int off = p / 2; off > 0; off /= 2) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  }
}

// The partial sums of one finished TM x TN tile held in Cs (elements
// outside O are zero), by a block of NT threads. Rq is TM x (TN/pbn)
// scratch for per-row sums of squares.
struct PartialsArgs {
  int pbm, pbn;
  float* colsum;
  float* rowsum;
  float* sumsq;
  int rs_cols, ss_cols;
};

template <int TM, int TN, int NT, bool kLanes>
__device__ void tile_epilogue(float (*Cs)[TN + 1], float (*Rq)[TN + 1],
                              int row0, int col0, int n, int m,
                              const PartialsArgs& a) {
  const int tid = threadIdx.x;
  const int pbm = a.pbm, pbn = a.pbn;
  const int nrt = TM / pbm, nct = TN / pbn;   // partial tiles in this tile
  // colsum: one sum over pbm rows per (row tile, column)
  for (int idx = tid; idx < nrt * TN; idx += NT) {
    const int t = idx / TN, c = idx % TN;
    const int gc = col0 + c, rs = t * pbm;
    if (gc < m && row0 + rs < n) {
      float s = 0.f;
      for (int r = rs; r < rs + pbm; ++r) s += Cs[r][c];
      a.colsum[(size_t)(row0 / pbm + t) * m + gc] = s;
    }
  }
  // rowsum (and the per-row sums of squares): one sum over pbn columns per
  // (row, column tile), on p lanes
  const int tasks = TM * nct, p = lanes_per_task<kLanes, NT>(tasks);
  const int lane = tid % p;
  for (int base = 0; base < tasks; base += NT / p) {
    const int idx = base + tid / p;
    const int r = idx / nct, t = idx % nct;
    const int gr = row0 + r, cs = t * pbn;
    float sq[2] = {0.f, 0.f};   // the sum and the sum of squares
    if (idx < tasks) {
      for (int c = cs + lane; c < cs + pbn; c += p) {
        const float v = Cs[r][c];
        sq[0] += v;
        sq[1] += v * v;
      }
    }
    lanes_sum(sq, p);
    if (idx < tasks && lane == 0) {
      Rq[r][t] = sq[1];
      if (gr < n && col0 + cs < m)
        a.rowsum[(size_t)gr * a.rs_cols + col0 / pbn + t] = sq[0];
    }
  }
  __syncthreads();
  // sumsq: the row sums of squares of each (row tile, column tile)
  for (int idx = tid; idx < nrt * nct; idx += NT) {
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
  int rb, cb, seg;
  float* part;
  const float* c5;
  const float* c6;
  const float* c7;
  const float* absdot;
  float tau_a, tau_b;
  int weighted;
  int* flag;
  float* score;
  int* chunk_counters;   // bf16 route: one per chunk, zero on entry and exit
};

template <int TM, int TN, int NT, bool kLanes>
__device__ void tile_epilogue(float (*Cs)[TN + 1], float (*)[TN + 1],
                              int row0, int col0, int n, int m,
                              const DetectArgs& a) {
  const int seg = a.seg, nseg = TN / seg;
  const int segs_total = m / seg;
  const size_t plane = (size_t)n * segs_total;
  const int tasks = TM * nseg, p = lanes_per_task<kLanes, NT>(tasks);
  const int lane = threadIdx.x % p;
  for (int base = 0; base < tasks; base += NT / p) {
    const int idx = base + threadIdx.x / p;
    const int r = idx / nseg, t = idx % nseg;
    const int gr = row0 + r, c0 = t * seg, gc0 = col0 + c0;
    const bool live = idx < tasks && gr < n && gc0 < m;
    float sums[3] = {0.f, 0.f, 0.f};   // s, s7, the sum of squares
    if (live) {
      const float w0 = (float)(gc0 % a.cb);  // local index of the first column
      for (int c = lane; c < seg; c += p) {
        const float v = Cs[r][c0 + c];
        sums[0] += v;
        sums[1] = fmaf(w0 + (float)c, v, sums[1]);
        sums[2] = fmaf(v, v, sums[2]);
      }
    }
    lanes_sum(sums, p);
    if (live && lane == 0) {
      const size_t at = (size_t)gr * segs_total + gc0 / seg;
      a.part[at] = sums[0];
      a.part[plane + at] = sums[1];
      a.part[2 * plane + at] = sums[2];
    }
  }
}

// The compare of chunk (a, b) by a block of NT threads: the chunk's row
// segments summed in a fixed order (each thread a fixed strided subset,
// then a fixed tree in red), then the CoC-D compare of _detect_kernel:
//   tau5 = tau_a * sqrt(sumsq) + tau_b * absdot + 1e-30,
// s6 / s7 against tau5 * (rb - 1) / tau5 * (cb - 1) when weighted, NaN or
// Inf on either side flags the chunk with score inf.
template <int NT>
__device__ void compare_chunk(const DetectArgs& d, int n, int m, int a,
                              int b, float (*red)[NT]) {
  const int tid = threadIdx.x, mb = m / d.cb;
  const int segs_total = m / d.seg, spc = d.cb / d.seg;  // per chunk row
  const size_t plane = (size_t)n * segs_total;
  float s5 = 0.f, s6 = 0.f, s7 = 0.f, sq = 0.f;
  for (int i = tid; i < d.rb * spc; i += NT) {
    const int r = i / spc, j = i % spc;
    const size_t at = (size_t)(a * d.rb + r) * segs_total + b * spc + j;
    const float v = __ldcg(d.part + at);
    s5 += v;
    s6 = fmaf((float)r, v, s6);
    s7 += __ldcg(d.part + plane + at);
    sq += __ldcg(d.part + 2 * plane + at);
  }
  red[0][tid] = s5;
  red[1][tid] = s6;
  red[2][tid] = s7;
  red[3][tid] = sq;
  __syncthreads();
  for (int h = NT / 2; h > 0; h /= 2) {
    if (tid < h)
      for (int q = 0; q < 4; ++q) red[q][tid] += red[q][tid + h];
    __syncthreads();
  }
  if (tid == 0) {
    const int at = a * mb + b;
    const float tau5 = d.tau_a * sqrtf(fmaxf(red[3][0], 0.f))
                       + d.tau_b * d.absdot[at] + 1e-30f;
    const float cs[3] = {d.c5[at], d.c6[at], d.c7[at]};
    const float ts[3] = {tau5, tau5 * (float)max(d.rb - 1, 1),
                         tau5 * (float)max(d.cb - 1, 1)};
    bool f = false;
    float sc = 0.f;
    for (int q = 0; q < (d.weighted ? 3 : 1); ++q) {
      const float c = cs[q], s = red[q][0], t = ts[q];
      const bool bad = !(isfinite(c) && isfinite(s));
      const float diff = fabsf(c - s);
      f = f || bad || diff > t;
      sc = fmaxf(sc, bad ? __int_as_float(0x7f800000) : diff / t);
    }
    d.flag[at] = f ? 1 : 0;
    d.score[at] = sc;
  }
  __syncthreads();   // red is free again
}

template <int TM, int TN, typename Args, int NT = kThreads,
          bool kLanes = false>
__device__ __forceinline__ void run_epilogue(float (*Cs)[TN + 1],
                                             float (*Rq)[TN + 1], int row0,
                                             int col0, int n, int m,
                                             const Args& a) {
  tile_epilogue<TM, TN, NT, kLanes>(Cs, Rq, row0, col0, n, m, a);
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

// The f32 block tile of an n-row product: 16 x 32 for N <= 16, else 64 x
// 64.
constexpr int tile_m(int n) { return n <= SM ? SM : BM; }
constexpr int tile_n(int n) { return n <= SM ? SN : BN; }

// ------------------------------------------------ the bf16 wgmma mainloop

constexpr int kWgThreads = 128;   // one warpgroup
constexpr int WM = 64;            // output columns per block: wgmma's M
constexpr int WK = 64;            // K per pipeline stage
constexpr int kChunks = WK / 8;   // 16-byte chunks of a K-major row's stage
constexpr int kRowGroup = 128 * kChunks;   // bytes of 8 K-major rows
constexpr int kStages = 4;        // the shared-memory ring
constexpr int kMaxRows = 128;     // the tallest row tile: wgmma's N
constexpr int kSMs = 132;         // the H100 SXM's SMs: the split-K target
constexpr int kMaxSplits = 8;     // a split tile is one cluster: portable size
constexpr int kPushRows = 128;    // splits x rows up to which ranks push
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int wg_stage_bytes(int rows) {
  return (WM + rows) * WK * 2;
}
// after the mainloop: a split's tile, the fp32 tile, the epilogue's
// scratch and the chunk compare's (red, done)
__host__ __device__ constexpr int wg_tail_bytes(int rows) {
  return (rows * (3 * WM + 2) + 5 * kWgThreads) * 4;
}
// the ring, reused after the mainloop for the tail
__host__ __device__ constexpr int wg_smem_bytes(int rows) {
  return kStages * wg_stage_bytes(rows) > wg_tail_bytes(rows)
             ? kStages * wg_stage_bytes(rows)
             : wg_tail_bytes(rows);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor without swizzling: operands are laid
// out as 8 x 16-byte core matrices (128 contiguous bytes); lbo is the byte
// step between core matrices along K, sbo along M or N.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF)
         | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
         | (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}

// D[64 x N] = A[64 x 16] B[16 x N] (+ D when scale_d is 1) for one
// warpgroup, bf16 operands from shared memory, fp32 accumulators; kTA = 1
// reads A M-major. d[v] holds row 16 warp + lane/4 + 8 ((v/2) % 2), column
// 2 (lane % 4) + v % 2 + 8 (v / 4).
template <int kTA>
__device__ __forceinline__ void wgmma_bf16(float (&d)[4], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, %7, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA));
}

template <int kTA>
__device__ __forceinline__ void wgmma_bf16(float (&d)[8], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA));
}

template <int kTA>
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA));
}

template <int kTA>
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA));
}

template <int kTA>
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 16-byte chunk of shared memory from the 8 bf16 at src + off, of
// which `avail` exist (ok false: none): zeros past them. vec: a cp.async
// of 16 aligned bytes that exist entirely or not at all; otherwise masked
// 2-byte loads and one shared store.
__device__ __forceinline__ void copy_chunk(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           bool ok, size_t off, int avail,
                                           bool vec) {
  ok = ok && avail > 0;
  if (vec) {
    const void* p = ok ? (const void*)(src + off) : (const void*)src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(p), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t lo = ok && 2 * e < avail ? s[off + 2 * e] : 0u;
      const uint32_t hi = ok && 2 * e + 1 < avail ? s[off + 2 * e + 1] : 0u;
      v[e] = lo | hi << 16;
    }
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                 : "memory");
  }
}

// Stage the K slice [k0, k0 + WK) of the block's operands at sa: W^T's 64
// columns (A, 8 KB), then D's rows (B). Chunk q lands at sa + 16 q, so
// consecutive threads fill consecutive bytes:
// * K-major (W^T of the tied head, and D): q = (8-row group, K chunk of
//   8, row in group); core matrices step 128 bytes along K, kRowGroup
//   bytes along the rows.
// * M-major (W (K, M) row-major): q = (8-k group, 8-column group, k in
//   group); core matrices step 128 bytes along the columns, 1024 (8
//   groups of 8 columns) along K.
template <int ROWS, bool kWT>
__device__ __forceinline__ void load_stage(const __nv_bfloat16* D,
                                           const __nv_bfloat16* W, int n,
                                           int k, int m, int row0, int col0,
                                           int k0, uint32_t sa, bool vec) {
  for (int q = threadIdx.x; q < WM * WK / 8; q += kWgThreads) {
    if (kWT) {
      const int c = q / (8 * kChunks) * 8 + q % 8;
      const int gk = k0 + q / 8 % kChunks * 8;
      copy_chunk(sa + 16 * q, W, col0 + c < m, (size_t)(col0 + c) * k + gk,
                 k - gk, vec);
    } else {
      const int gk = k0 + q / 64 * 8 + q % 8, gc = col0 + q / 8 % 8 * 8;
      copy_chunk(sa + 16 * q, W, gk < k, (size_t)gk * m + gc, m - gc, vec);
    }
  }
  const uint32_t sb = sa + WM * WK * 2;
  for (int q = threadIdx.x; q < ROWS * WK / 8; q += kWgThreads) {
    const int r = q / (8 * kChunks) * 8 + q % 8;
    const int gk = k0 + q / 8 % kChunks * 8;
    copy_chunk(sb + 16 * q, D, row0 + r < n, (size_t)(row0 + r) * k + gk,
               k - gk, vec);
  }
}

// After a tile's epilogue: nothing more for the partials.
template <int ROWS>
__device__ __forceinline__ void finish_chunks(const PartialsArgs&, int, int,
                                              int, int, float*) {}

// After a tile's detect segments: the block counts itself into every
// detection chunk its tile overlaps, and the last tile of a chunk to get
// there runs that chunk's compare (so the detect entry point is one launch
// on the bf16 route). A chunk's tiles: the row tiles its rows meet times
// the column tiles its columns meet.
template <int ROWS>
__device__ void finish_chunks(const DetectArgs& d, int row0, int col0, int n,
                              int m, float* scratch) {
  float (*red)[kWgThreads] = reinterpret_cast<float (*)[kWgThreads]>(scratch);
  int* done = reinterpret_cast<int*>(scratch + 4 * kWgThreads);
  const int tid = threadIdx.x, mb = m / d.cb;
  const int a0 = row0 / d.rb, a1 = (min(n, row0 + ROWS) - 1) / d.rb;
  const int b0 = col0 / d.cb, b1 = (min(m, col0 + WM) - 1) / d.cb;
  const int nb = b1 - b0 + 1, count = (a1 - a0 + 1) * nb;
  // the block's segments are written before a counter counts it (release),
  // and the last block reads the others' after it (acquire)
  __syncthreads();
  for (int base = 0; base < count; base += kWgThreads) {
    const int i = base + tid;
    int id = -1;
    if (i < count) {
      const int a = a0 + i / nb, b = b0 + i % nb;
      const int tr = (a * d.rb + d.rb - 1) / ROWS - a * d.rb / ROWS + 1;
      const int tc = (b * d.cb + d.cb - 1) / WM - b * d.cb / WM + 1;
      int seen;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(seen)
                   : "l"(d.chunk_counters + a * mb + b)
                   : "memory");
      if (seen == tr * tc - 1) id = a * mb + b;
    }
    done[tid] = id;
    __syncthreads();
    for (int j = 0; j < min(kWgThreads, count - base); ++j) {
      const int at = done[j];
      if (at < 0) continue;
      compare_chunk<kWgThreads>(d, n, m, at / mb, at % mb, red);
      if (tid == 0) d.chunk_counters[at] = 0;
    }
    __syncthreads();
  }
}

// Block (x, y, z): output columns [64 x, 64 x + 64), rows [ROWS y, ROWS y +
// ROWS), K tiles [per z, per z + per) of WK. With splits > 1 the launch
// makes the `splits` blocks of a tile one cluster (rank z): each leaves its
// fp32 tile in its shared memory, every rank sums a share of the elements
// over all ranks in rank order into rank 0's tile (distributed shared
// memory), and rank 0 runs the epilogue.
template <int ROWS, bool kWT, typename Args>
__global__ void __launch_bounds__(kWgThreads)
gemm_wgmma_kernel(const __nv_bfloat16* __restrict__ D,
                  const __nv_bfloat16* __restrict__ W,
                  __nv_bfloat16* __restrict__ O, int n, int k, int m,
                  int per, int splits, int vec, Args args) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kStage = wg_stage_bytes(ROWS);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * WM, row0 = blockIdx.y * ROWS;
  const int z = blockIdx.z, kt0 = z * per;
  const int nkt = min(per, (k > WK ? (k + WK - 1) / WK : 1) - kt0);
  const uint32_t ring = smem_addr(smem);
  // a pushing split stores into rank 0's shared memory, so every block of
  // the cluster must have started: the barrier's first phase, waited for
  // after the mainloop
  const bool push = splits > 1 && splits * ROWS <= kPushRows;
  if (push) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // part: one K stage's sum, in wgmma's accumulators; acc: the running
  // sum, by fp32 adds (round to nearest)
  float acc[ROWS / 2], part[ROWS / 2];
#pragma unroll
  for (int i = 0; i < ROWS / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkt)
      load_stage<ROWS, kWT>(D, W, n, k, m, row0, col0, (kt0 + s) * WK,
                            ring + s * kStage, vec);
    cp_async_commit();
  }
  for (int i = 0; i < nkt; ++i) {
    // stage i has landed for every thread, and every warp is done with the
    // stage the next load overwrites (its wgmma were waited for)
    cp_async_wait<kStages - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int j = i + kStages - 1;
    if (j < nkt)
      load_stage<ROWS, kWT>(D, W, n, k, m, row0, col0, (kt0 + j) * WK,
                            ring + j % kStages * kStage, vec);
    cp_async_commit();
    const uint32_t sa = ring + i % kStages * kStage, sb = sa + WM * WK * 2;
    pin(part);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < WK / 16; ++s) {
      const uint64_t da = kWT ? gmma_desc(sa + 256 * s, 128, kRowGroup)
                              : gmma_desc(sa + 2048 * s, 1024, 128);
      wgmma_bf16<kWT ? 0 : 1>(part, da,
                              gmma_desc(sb + 256 * s, 128, kRowGroup),
                              s > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(part);
#pragma unroll
    for (int v = 0; v < ROWS / 2; ++v) acc[v] += part[v];
  }
  cp_async_wait<0>();
  __syncthreads();

  // the ring becomes this split's tile Ps[row][column], then the fp32 tile
  // Cs (elements outside O are zero), the epilogue's scratch Rq and the
  // chunk compare's
  float* Ps = reinterpret_cast<float*>(smem);
  float (*Cs)[WM + 1] = reinterpret_cast<float (*)[WM + 1]>(Ps + ROWS * WM);
  float (*Rq)[WM + 1] = Cs + ROWS;
  if (splits == 1) {
#pragma unroll
    for (int v = 0; v < ROWS / 2; ++v) {
      const int c = 16 * warp + lane / 4 + 8 * (v / 2 % 2);
      const int r = 2 * (lane % 4) + v % 2 + 8 * (v / 4);
      Cs[r][c] = row0 + r < n && col0 + c < m ? acc[v] : 0.f;
    }
  } else if (push) {
    // every rank stores its tile into rank 0's receiving area (past the
    // ring and the tail) and leaves; rank 0 sums them in rank order
    float* recv = reinterpret_cast<float*>(smem + wg_smem_bytes(ROWS));
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    float* to = cg::this_cluster().map_shared_rank(recv, 0) + z * ROWS * WM;
#pragma unroll
    for (int v = 0; v < ROWS / 2; ++v) {
      const int c = 16 * warp + lane / 4 + 8 * (v / 2 % 2);
      const int r = 2 * (lane % 4) + v % 2 + 8 * (v / 4);
      to[r * WM + c] = acc[v];
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    if (z != 0) return;
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    for (int idx = tid; idx < ROWS * WM; idx += kWgThreads) {
      const int r = idx / WM, c = idx % WM;
      float v[kMaxSplits];
#pragma unroll
      for (int q = 0; q < kMaxSplits; ++q)
        v[q] = q < splits ? recv[q * ROWS * WM + idx] : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxSplits; ++q)
        if (q < splits) sum += v[q];
      Cs[r][c] = row0 + r < n && col0 + c < m ? sum : 0.f;
    }
  } else {
    // taller tiles: each rank leaves its tile in its own ring, every rank
    // sums a share of the elements over all ranks in rank order into rank
    // 0's tile
#pragma unroll
    for (int v = 0; v < ROWS / 2; ++v) {
      const int c = 16 * warp + lane / 4 + 8 * (v / 2 % 2);
      const int r = 2 * (lane % 4) + v % 2 + 8 * (v / 4);
      Ps[r * WM + c] = acc[v];
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const float* peer[kMaxSplits];
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      peer[q] = cluster.map_shared_rank(Ps, q < splits ? q : 0);
    float* cs0 = cluster.map_shared_rank(&Cs[0][0], 0);
    for (int g = z; g < ROWS * WM / kWgThreads; g += splits) {
      const int idx = g * kWgThreads + tid, r = idx / WM, c = idx % WM;
      float v[kMaxSplits];
#pragma unroll
      for (int q = 0; q < kMaxSplits; ++q) v[q] = q < splits ? peer[q][idx] : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxSplits; ++q)
        if (q < splits) sum += v[q];
      cs0[r * (WM + 1) + c] = row0 + r < n && col0 + c < m ? sum : 0.f;
    }
    // rank 0's tile is complete, and no rank's Ps is read any more
    cluster.sync();
    if (z != 0) return;
  }
  __syncthreads();
  // O rounded once to bf16: 8 columns (16 bytes) a thread where the tile's
  // rows lie whole and aligned in O, else element by element
  if (col0 + WM <= m && m % 8 == 0
      && reinterpret_cast<uintptr_t>(O) % 16 == 0) {
    for (int i8 = tid; i8 < ROWS * WM / 8; i8 += kWgThreads) {
      const int r = i8 / (WM / 8), c = i8 % (WM / 8) * 8;
      if (row0 + r >= n) continue;
      uint32_t u[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h =
            __floats2bfloat162_rn(Cs[r][c + 2 * e], Cs[r][c + 2 * e + 1]);
        u[e] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(O + (size_t)(row0 + r) * m + col0 + c) =
          make_uint4(u[0], u[1], u[2], u[3]);
    }
  } else {
    for (int idx = tid; idx < ROWS * WM; idx += kWgThreads) {
      const int r = idx / WM, c = idx % WM;
      if (row0 + r < n && col0 + c < m)
        O[(size_t)(row0 + r) * m + col0 + c] = __float2bfloat16_rn(Cs[r][c]);
    }
  }
  run_epilogue<ROWS, WM, Args, kWgThreads, true>(Cs, Rq, row0, col0, n, m,
                                                 args);
  finish_chunks<ROWS>(args, row0, col0, n, m, &Rq[ROWS][0]);
}

// ------------------------------------------------------------ the tiling

// How an n-row product of dtype (0 f32, 1 bf16) is launched: block tile
// tm x tn, K split over `splits` blocks of `per` WK-tiles each (bf16),
// swapped when O^T = W^T D^T is what the blocks compute. This is the
// rule's one home: both entry points launch from it, so each accumulates
// every element of O in the same order, and the wrappers read it through
// repro_abft_tiling.
struct Tiling {
  int tm, tn, splits, per, swapped;
};

Tiling choose_tiling(int n, int k, int m, int dtype) {
  if (dtype != 1) return {tile_m(n), tile_n(n), 1, 0, 0};
  int tm = 8;
  while (tm < n && tm < kMaxRows) tm *= 2;
  const int tiles = (m + WM - 1) / WM * ((n + tm - 1) / tm);
  const int kt = k > WK ? (k + WK - 1) / WK : 1;
  const int want = tiles >= kSMs ? 1 : min(kMaxSplits, (kSMs + tiles - 1) / tiles);
  const int per = (kt + want - 1) / want;
  return {tm, WM, (kt + per - 1) / per, per, 1};
}

// The column segment the detect pass's blocks sum rows over: the largest
// power of two dividing both cb and the tile's width, so no segment
// straddles two chunks.
int detect_seg(int tn, int cb) {
  int seg = tn;
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

template <int ROWS, bool kWT, typename Args>
int launch_wgmma(const void* d, const void* w, void* o, int n, int k, int m,
                 const Tiling& t, const Args& args, cudaStream_t s) {
  // the ring and tail, and rank 0's receiving area when the splits push
  constexpr int most = wg_smem_bytes(ROWS) + kPushRows * WM * 4;
  const int bytes = wg_smem_bytes(ROWS)
                    + (t.splits > 1 && t.splits * ROWS <= kPushRows
                           ? t.splits * ROWS * WM * 4 : 0);
  // more than 48 KB of shared memory only once asked for, on each device
  static bool sized[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(gemm_wgmma_kernel<ROWS, kWT, Args>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
    if (e != cudaSuccess) return (int)e;
    sized[dev] = true;
  }
  const bool vec = k % 8 == 0 && (kWT || m % 8 == 0)
                   && reinterpret_cast<uintptr_t>(d) % 16 == 0
                   && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((m + WM - 1) / WM, (n + ROWS - 1) / ROWS, t.splits);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = t.splits;
  cfg.attrs = cluster;
  cfg.numAttrs = t.splits > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(
      &cfg, gemm_wgmma_kernel<ROWS, kWT, Args>,
      static_cast<const __nv_bfloat16*>(d),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(o),
      n, k, m, t.per, t.splits, vec ? 1 : 0, args);
}

template <bool kWT, typename Args>
int dispatch_bf16(const void* d, const void* w, void* o, int n, int k, int m,
                  const Tiling& t, const Args& args, cudaStream_t s) {
  switch (t.tm) {
    case 8: return launch_wgmma<8, kWT>(d, w, o, n, k, m, t, args, s);
    case 16: return launch_wgmma<16, kWT>(d, w, o, n, k, m, t, args, s);
    case 32: return launch_wgmma<32, kWT>(d, w, o, n, k, m, t, args, s);
    case 64: return launch_wgmma<64, kWT>(d, w, o, n, k, m, t, args, s);
    case 128: return launch_wgmma<128, kWT>(d, w, o, n, k, m, t, args, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename Args>
int dispatch(int dtype, int w_layout, const void* d, const void* w, void* o,
             int n, int k, int m, const Tiling& t, const Args& args,
             cudaStream_t s) {
  if (dtype == 0 && w_layout == 0)
    launch_gemm<float, false>(d, w, o, n, k, m, args, s);
  else if (dtype == 0 && w_layout == 1)
    launch_gemm<float, true>(d, w, o, n, k, m, args, s);
  else if (dtype == 1 && w_layout == 0)
    return dispatch_bf16<false>(d, w, o, n, k, m, t, args, s);
  else if (dtype == 1 && w_layout == 1)
    return dispatch_bf16<true>(d, w, o, n, k, m, t, args, s);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The f32 route's second launch: one block per detection chunk runs
// compare_chunk on the segments the GEMM's blocks wrote.
__global__ void __launch_bounds__(kThreads)
detect_compare_kernel(int n, int m, DetectArgs d) {
  __shared__ float red[4][kThreads];
  compare_chunk<kThreads>(d, n, m, blockIdx.y, blockIdx.x, red);
}

}  // namespace

// The tiling an n-row product of dtype (0 float32, 1 bfloat16) with K = k
// and M = m launches with: the block tile (tm rows x tn columns of O), the
// K split (splits blocks per tile, one cluster; > 1 only for bf16 when the
// tiles cannot fill the card), swapped (1: the blocks compute O^T = W^T
// D^T) and, for a detection chunk width cb > 0, the detect pass's row
// segment (seg; repro_abft_matmul_detect's part then holds 3 * n * (m /
// seg) floats; 0 when cb is 0). The wrappers size their buffers from it.
extern "C" int repro_abft_tiling(int n, int k, int m, int dtype, int cb,
                                 int* tm, int* tn, int* seg, int* splits,
                                 int* swapped) {
  if (n < 1 || k < 0 || m < 1 || cb < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Tiling t = choose_tiling(n, k, m, dtype);
  *tm = t.tm;
  *tn = t.tn;
  *seg = cb > 0 ? detect_seg(t.tn, cb) : 0;
  *splits = t.splits;
  *swapped = t.swapped;
  return 0;
}

// D (n, k), W (k, m) with w_layout 0 (row-major) or the transposed view of
// an (m, k) row-major tensor (w_layout 1), O (n, m) row-major; dtype 0 is
// float32, 1 is bfloat16 (all three tensors). colsum has m columns, rowsum
// rs_cols and sumsq ss_cols; rows of colsum/sumsq are partial row tiles of
// pbm rows, columns of rowsum/sumsq partial column tiles of pbn columns,
// pbm and pbn powers of two dividing the block tile (repro_abft_tiling).
// Only the tiles that hold elements of O are written. Returns the launch's
// error, or cudaGetLastError().
extern "C" int repro_abft_matmul(const void* d, const void* w, void* o,
                                 int dtype, int w_layout, int n, int k, int m,
                                 int pbm, int pbn, float* colsum,
                                 float* rowsum, float* sumsq, int rs_cols,
                                 int ss_cols, void* stream) {
  if (n < 1 || k < 0 || m < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Tiling t = choose_tiling(n, k, m, dtype);
  if (pbm < 1 || pbm > t.tm || t.tm % pbm || pbn < 1 || pbn > t.tn
      || t.tn % pbn)
    return (int)cudaErrorInvalidValue;
  const PartialsArgs args{pbm, pbn, colsum, rowsum, sumsq, rs_cols, ss_cols};
  const int err = dispatch(dtype, w_layout, d, w, o, n, k, m, t, args,
                           (cudaStream_t)stream);
  return err ? err : (int)cudaGetLastError();
}

// O = D @ W as above plus the CoC-D compare per (rb x cb) chunk: c5, c6,
// c7 and absdot are float32 (n / rb, m / cb); flag (int32) and score
// (float32) likewise. part is float32 scratch of 3 * n * (m / seg)
// elements, seg as repro_abft_tiling gives it. bfloat16 runs the compare in
// the GEMM's own launch and takes counters, (n / rb) * (m / cb) int32 that
// are zero and that no other launch uses until this one has ended (the
// kernel leaves them zero); float32 launches a second kernel for the
// compare and takes no counters. rb must divide n and cb must
// divide m. Returns the first error of the launches, or
// cudaGetLastError().
extern "C" int repro_abft_matmul_detect(
    const void* d, const void* w, void* o, int dtype, int w_layout, int n,
    int k, int m, int rb, int cb, const float* c5, const float* c6,
    const float* c7, const float* absdot, float tau_a, float tau_b,
    int weighted, float* part, int* counters, int* flag, float* score,
    void* stream) {
  if (n < 1 || k < 0 || m < 1 || (dtype != 0 && dtype != 1) || rb < 1
      || cb < 1 || n % rb || m % cb)
    return (int)cudaErrorInvalidValue;
  const Tiling t = choose_tiling(n, k, m, dtype);
  cudaStream_t s = (cudaStream_t)stream;
  const DetectArgs args{rb,     cb,    detect_seg(t.tn, cb), part, c5, c6,
                        c7,     absdot, tau_a, tau_b, weighted, flag, score,
                        counters};
  int err = dispatch(dtype, w_layout, d, w, o, n, k, m, t, args, s);
  if (err) return err;
  err = (int)cudaGetLastError();
  if (err || dtype == 1) return err;
  detect_compare_kernel<<<dim3(m / cb, n / rb), kThreads, 0, s>>>(n, m,
                                                                    args);
  return (int)cudaGetLastError();
}

// Whether `stream` is capturing a CUDA graph, and the capture's id (unique
// in the process) when it is: the detect wrapper gives each capture chunk
// counters of its own.
extern "C" int repro_capture_id(void* stream, int* capturing,
                                unsigned long long* id) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  *id = 0;
  const cudaError_t e =
      cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, id);
  *capturing = status == cudaStreamCaptureStatusActive;
  return (int)e;
}
