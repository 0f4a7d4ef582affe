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
// * f32 (the CNN's fc, (8 x 512) @ (512 x 1000), 0.6 us of bytes): launch
//   and the first loads' latency set the time; the thresholds price IEEE
//   fp32 accumulation, which the tensor cores do not give (ROADMAP 3.3),
//   so the product runs as fp32 FMA on the CUDA cores.
//
// One kernel skeleton for both types (gemm_kernel): one warpgroup (128
// threads) per block computes an output tile transposed, O^T = W^T D^T: 64
// output columns by the block's O rows (8, 16, 32, 64 or 128, the smallest
// that holds n), so a decode step's or the fc's 8 rows are not padded up
// to 64. K is walked in stages of 128 bytes of each operand row (64 bf16,
// 32 f32) through a ring of 4 shared-memory stages filled by 16-byte
// cp.async copies (zero-filled past the edges of D and W), so three
// stages' loads are in flight while the block computes on the one that
// arrived; a shape whose rows are not 16-byte aligned fills the same
// stages with masked element loads instead, which changes no sum. W is
// read in place as (K, M) row-major or as the transposed view of an (M,
// K) table (the tied head). The mainloop is the type's own:
// * bf16: wgmma.mma_async on the stage in shared memory (no-swizzle core
//   matrices; W^T K-major for the tied head, M-major through wgmma's
//   transpose bit for row-major W; D^T K-major). wgmma's accumulators
//   truncate toward zero: summed over all of K they drift below IEEE fp32
//   accumulation, which the thresholds price, so each stage's 64 products
//   are summed by wgmma alone and added to a second set of fp32 registers
//   with round-to-nearest.
// * f32: each thread owns 4 columns (16 apart) by ROWS / 8 rows (8 apart);
//   each stage's 32 products of an element are summed by fmaf in K order
//   in fresh registers and added into a second set (IEEE fp32 all along;
//   blocked as cuBLAS sums, so the error stays as small as its): 16-byte
//   shared loads of D's rows and of W^T's, 4-byte ones of row-major W, no
//   bank conflicts.
// When the output tiles cannot fill the card, K is split over up to 8
// blocks of one cluster (splits chosen so that tiles x splits reaches
// ~132; the fc: 16 tiles x 8 splits). Through distributed shared memory,
// rank 0 gets every split's fp32 tile and their sum in rank order - the
// ranks store their tiles into its shared memory and leave (short tiles),
// or each rank sums a share of the elements over all ranks (taller tiles,
// whose splits would not fit one block's shared memory) - no float
// atomics, so O, flags and scores are the same from run to run - and rank
// 0 stores O, rounded once to its type, and runs the epilogue on the fp32
// tile:
// * partials (repro_abft_matmul): a fixed-order reduction to colsum per
//   (row tile, column), rowsum per (row, column tile) and sumsq per (row
//   tile, column tile) at granularity (pbm, pbn), powers of two dividing the
//   tile.
// * detect (repro_abft_matmul_detect): on the TPU the detection chunk
//   (rb x cb, up to 1024 x 1024) is the Pallas tile; here a block tile is
//   far smaller, so each block reduces every row of its tile, in column
//   segments of P (a power of two dividing both the tile's width and cb, so
//   a segment never straddles two chunks), to s5, the chunk-local
//   column-weighted s7 and the sum of squares. Then the last tile of each
//   detection chunk to finish (an integer counter per chunk, reset by that
//   block) sums the chunk's segments in a fixed order (row weights give
//   s6), runs the compare and writes the chunk's flag and score, so the
//   entry point is one launch.
// Bias stays outside.
//
// The tiling (tile, split count) is chosen here alone, from (n, k, m,
// dtype), so both entry points accumulate each element of O in the same
// order and round O identically; the wrappers read it through
// repro_abft_tiling and size their buffers from it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

constexpr int kWgThreads = 128;   // one warpgroup: a block
constexpr int WM = 64;            // output columns per block: wgmma's M

// ---------------------------------------------------------------- epilogues

// A row's sum over a segment or a partial column tile is split over p
// lanes of one warp and finished by a fixed butterfly: p is the most lanes,
// up to 32, that keep `tasks` sums within the block's threads, so a decode
// tile's few rows do not run serially.
__device__ __forceinline__ int lanes_per_task(int tasks) {
  int p = 32;
  while (p > 1 && tasks * p > kWgThreads) p /= 2;
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
// outside O are zero), by the block. Rq is TM x (TN/pbn)
// scratch for per-row sums of squares.
struct PartialsArgs {
  int pbm, pbn;
  float* colsum;
  float* rowsum;
  float* sumsq;
  int rs_cols, ss_cols;
  long long g_col, g_row, g_sq;   // elements from one group's sums to the next

  // group g's sums
  __device__ PartialsArgs at(int g) const {
    PartialsArgs a = *this;
    a.colsum += g * g_col;
    a.rowsum += g * g_row;
    a.sumsq += g * g_sq;
    return a;
  }
};

template <int TM, int TN>
__device__ void tile_epilogue(float (*Cs)[TN + 1], float (*Rq)[TN + 1],
                              int row0, int col0, int n, int m,
                              const PartialsArgs& a) {
  constexpr int NT = kWgThreads;
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
  const int tasks = TM * nct, p = lanes_per_task(tasks);
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
  int* chunk_counters;   // one per chunk, zero on entry and exit
  long long g_part;      // floats of part per group
  long long g_chunks;    // chunks per group: c5..absdot, flag, score, counters

  // group g's checksums, verdicts, scratch and counters
  __device__ DetectArgs at(int g) const {
    DetectArgs a = *this;
    a.part += g * g_part;
    a.c5 += g * g_chunks;
    a.c6 += g * g_chunks;
    a.c7 += g * g_chunks;
    a.absdot += g * g_chunks;
    a.flag += g * g_chunks;
    a.score += g * g_chunks;
    a.chunk_counters += g * g_chunks;
    return a;
  }
};

template <int TM, int TN>
__device__ void tile_epilogue(float (*Cs)[TN + 1], float (*)[TN + 1],
                              int row0, int col0, int n, int m,
                              const DetectArgs& a) {
  constexpr int NT = kWgThreads;
  const int seg = a.seg, nseg = TN / seg;
  const int segs_total = m / seg;
  const size_t plane = (size_t)n * segs_total;
  const int tasks = TM * nseg, p = lanes_per_task(tasks);
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

// The compare of chunk (a, b) by the block: the chunk's row
// segments summed in a fixed order (each thread a fixed strided subset,
// then a fixed tree in red), then the CoC-D compare of _detect_kernel:
//   tau5 = tau_a * sqrt(sumsq) + tau_b * absdot + 1e-30,
// s6 / s7 against tau5 * (rb - 1) / tau5 * (cb - 1) when weighted, NaN or
// Inf on either side flags the chunk with score inf.
__device__ void compare_chunk(const DetectArgs& d, int n, int m, int a,
                              int b, float (*red)[kWgThreads]) {
  constexpr int NT = kWgThreads;
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

// ---------------------------------------------------------------- mainloops

constexpr int WK = 64;            // bf16 K per pipeline stage (128 bytes)
constexpr int WKF = 32;           // f32 K per pipeline stage (128 bytes)
constexpr int kPitch = WKF + 4;   // f32 floats per staged K-major row
constexpr int kChunks = WK / 8;   // 16-byte chunks of a K-major row's stage
constexpr int kRowGroup = 128 * kChunks;   // bytes of 8 K-major rows
constexpr int kStages = 4;        // the shared-memory ring
constexpr int kMaxRows = 128;     // the tallest row tile: wgmma's N
constexpr int kSMs = 132;         // the H100 SXM's SMs: the split-K target
constexpr int kMaxSplits = 8;     // a split tile is one cluster: portable size
constexpr int kPushRows = 128;    // splits x rows up to which ranks push
constexpr int kMaxDevices = 64;

// K per stage: 128 bytes of an operand row
template <typename T> __host__ __device__ constexpr int k_step() {
  return 128 / (int)sizeof(T);
}
// one ring stage: W^T's 64 columns, then D's rows (f32: rows of kPitch)
template <typename T> __host__ __device__ constexpr int stage_bytes(int rows) {
  return sizeof(T) == 2 ? (WM + rows) * WK * 2 : (WM + rows) * kPitch * 4;
}
// after the mainloop: a split's tile, the fp32 tile, the epilogue's
// scratch and the chunk compare's (red, done)
__host__ __device__ constexpr int tail_bytes(int rows) {
  return (rows * (3 * WM + 2) + 5 * kWgThreads) * 4;
}
// the ring, reused after the mainloop for the tail
template <typename T> __host__ __device__ constexpr int smem_bytes(int rows) {
  return kStages * stage_bytes<T>(rows) > tail_bytes(rows)
             ? kStages * stage_bytes<T>(rows)
             : tail_bytes(rows);
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

// One 16-byte chunk of shared memory from the 4 floats at src + off, of
// which `avail` exist (ok false: none): zeros past them. vec: a cp.async
// of 16 aligned bytes that exist entirely or not at all; otherwise masked
// 4-byte loads and one shared store.
__device__ __forceinline__ void copy_chunk(uint32_t dst, const float* src,
                                           bool ok, size_t off, int avail,
                                           bool vec) {
  ok = ok && avail > 0;
  if (vec) {
    const void* p = ok ? (const void*)(src + off) : (const void*)src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(p), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = ok && e < avail ? src[off + e] : 0.f;
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
                 : "memory");
  }
}

// Stage the K slice [k0, k0 + WKF) of the block's f32 operands at sa: W,
// then D's rows (rows of kPitch floats, 16-byte aligned, at sa + 4 WM
// kPitch). W^T of the tied head lands K-major like D (a row per column);
// row-major W lands as Ws[k][64 columns]. Consecutive threads copy
// consecutive 16 bytes of a row.
template <int ROWS, bool kWT>
__device__ __forceinline__ void load_stage(const float* D, const float* W,
                                           int n, int k, int m, int row0,
                                           int col0, int k0, uint32_t sa,
                                           bool vec) {
  constexpr int kRowChunks = WKF / 4;
  if (kWT) {
    for (int q = threadIdx.x; q < WM * kRowChunks; q += kWgThreads) {
      const int c = q / kRowChunks, kk = q % kRowChunks * 4, gk = k0 + kk;
      copy_chunk(sa + 4 * (c * kPitch + kk), W, col0 + c < m,
                 (size_t)(col0 + c) * k + gk, k - gk, vec);
    }
  } else {
    for (int q = threadIdx.x; q < WKF * (WM / 4); q += kWgThreads) {
      const int kk = q / (WM / 4), c = q % (WM / 4) * 4;
      const int gk = k0 + kk, gc = col0 + c;
      copy_chunk(sa + 4 * (kk * WM + c), W, gk < k, (size_t)gk * m + gc,
                 m - gc, vec);
    }
  }
  const uint32_t sb = sa + 4 * WM * kPitch;
  for (int q = threadIdx.x; q < ROWS * kRowChunks; q += kWgThreads) {
    const int r = q / kRowChunks, kk = q % kRowChunks * 4, gk = k0 + kk;
    copy_chunk(sb + 4 * (r * kPitch + kk), D, row0 + r < n,
               (size_t)(row0 + r) * k + gk, k - gk, vec);
  }
}

// One f32 stage's sums into `part`: columns tx + 16 j (j < 4) by rows
// ty + 8 i (i < ROWS / 8), part[4 i + j], each over the stage's 32 K in
// order by fmaf. ws/ds: the stage's W and D as load_stage lays them out.
template <int ROWS, bool kWT>
__device__ __forceinline__ void fma_stage(const float* ws, const float* ds,
                                          int tx, int ty,
                                          float (&part)[ROWS / 2]) {
#pragma unroll
  for (int k4 = 0; k4 < WKF; k4 += 4) {
    float w[4][4];   // w[k][j]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (kWT) {
        const float4 x = *reinterpret_cast<const float4*>(
            ws + (tx + 16 * j) * kPitch + k4);
        w[0][j] = x.x;
        w[1][j] = x.y;
        w[2][j] = x.z;
        w[3][j] = x.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q][j] = ws[(k4 + q) * WM + tx + 16 * j];
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS / 8; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(ds + (ty + 8 * i) * kPitch + k4);
      const float d[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          part[4 * i + j] = fmaf(d[q], w[q][j], part[4 * i + j]);
    }
  }
}

// The bf16 mainloop: the K tiles [kt0, kt0 + nkt) through the ring, each
// stage's sum by wgmma, added into acc in fp32. The caller waits for the
// last copies.
template <int ROWS, bool kWT>
__device__ __forceinline__ void mainloop(const __nv_bfloat16* D,
                                         const __nv_bfloat16* W, int n,
                                         int k, int m, int row0, int col0,
                                         int kt0, int nkt, bool vec,
                                         unsigned char* smem,
                                         float (&acc)[ROWS / 2]) {
  constexpr int kStage = stage_bytes<__nv_bfloat16>(ROWS);
  const uint32_t ring = smem_addr(smem);
  // part: one K stage's sum, in wgmma's accumulators; acc: the running
  // sum, by fp32 adds (round to nearest)
  float part[ROWS / 2];
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
}

// The f32 mainloop: the same ring of K tiles; each stage's 32 products are
// summed by fma_stage in fresh registers and added into acc, so an element
// of O is a sum of stage sums (IEEE fp32 throughout): its rounding error
// grows with sqrt(K / 32) + sqrt(32) terms, not sqrt(K), as blocked sums
// in cuBLAS do.
template <int ROWS, bool kWT>
__device__ __forceinline__ void mainloop(const float* D, const float* W,
                                         int n, int k, int m, int row0,
                                         int col0, int kt0, int nkt, bool vec,
                                         unsigned char* smem,
                                         float (&acc)[ROWS / 2]) {
  constexpr int kStage = stage_bytes<float>(ROWS);
  const uint32_t ring = smem_addr(smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float part[ROWS / 2];
#pragma unroll
  for (int i = 0; i < ROWS / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkt)
      load_stage<ROWS, kWT>(D, W, n, k, m, row0, col0, (kt0 + s) * WKF,
                            ring + s * kStage, vec);
    cp_async_commit();
  }
  for (int i = 0; i < nkt; ++i) {
    // stage i has landed for every thread, and every thread is done with
    // the stage the next load overwrites
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int j = i + kStages - 1;
    if (j < nkt)
      load_stage<ROWS, kWT>(D, W, n, k, m, row0, col0, (kt0 + j) * WKF,
                            ring + j % kStages * kStage, vec);
    cp_async_commit();
    const float* ws =
        reinterpret_cast<const float*>(smem + i % kStages * kStage);
#pragma unroll
    for (int v = 0; v < ROWS / 2; ++v) part[v] = 0.f;
    fma_stage<ROWS, kWT>(ws, ws + WM * kPitch, tx, ty, part);
#pragma unroll
    for (int v = 0; v < ROWS / 2; ++v) acc[v] += part[v];
  }
}

// The tile element (r, c) that accumulator v of thread tid holds: wgmma's
// fragment (bf16), fma_stage's (f32)
__device__ __forceinline__ void frag_rc(const __nv_bfloat16*, int v, int tid,
                                        int& r, int& c) {
  const int warp = tid / 32, lane = tid % 32;
  c = 16 * warp + lane / 4 + 8 * (v / 2 % 2);
  r = 2 * (lane % 4) + v % 2 + 8 * (v / 4);
}
__device__ __forceinline__ void frag_rc(const float*, int v, int tid, int& r,
                                        int& c) {
  r = tid / 16 + 8 * (v / 4);
  c = tid % 16 + 16 * (v % 4);
}

// 8 bf16 or 4 floats of O (16 bytes), rounded once from the fp32 tile
__device__ __forceinline__ void store16(__nv_bfloat16* o, const float* x) {
  uint32_t u[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
    u[e] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(o) = make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ void store16(float* o, const float* x) {
  *reinterpret_cast<float4*>(o) = make_float4(x[0], x[1], x[2], x[3]);
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
      compare_chunk(d, n, m, at / mb, at % mb, red);
      if (tid == 0) d.chunk_counters[at] = 0;
    }
    __syncthreads();
  }
}

// Block (x, y, z): output columns [64 x, 64 x + 64) of group y / rtiles,
// rows [ROWS (y % rtiles), + ROWS), K tiles [per z, per z + per) of
// k_step<T>(). Group g's D, W and O start gd, gw and go elements past
// group 0's (64-bit: an expert stack passes 2^31 elements) and its sums
// where Args::at(g) puts them; every group is tiled as a product of its
// own shape would be, so its O is bitwise what a launch of that group
// alone gives. With splits > 1 the
// launch makes the `splits` blocks of a tile one cluster (rank z): each
// leaves its fp32 tile in its shared memory, every rank sums a share of the
// elements over all ranks in rank order into rank 0's tile (distributed
// shared memory), and rank 0 runs the epilogue.
template <typename T, int ROWS, bool kWT, typename Args>
__global__ void __launch_bounds__(kWgThreads)
gemm_kernel(const T* __restrict__ D, const T* __restrict__ W,
            T* __restrict__ O, int n, int k, int m, int per, int splits,
            int vec, int rtiles, long long gd, long long gw, long long go,
            Args args0) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kStep = k_step<T>();
  const int tid = threadIdx.x;
  const int g = blockIdx.y / rtiles;
  const int col0 = blockIdx.x * WM, row0 = blockIdx.y % rtiles * ROWS;
  D += g * gd;
  W += g * gw;
  O += g * go;
  const Args args = args0.at(g);
  const int z = blockIdx.z, kt0 = z * per;
  const int nkt = min(per, (k > kStep ? (k + kStep - 1) / kStep : 1) - kt0);
  // a pushing split stores into rank 0's shared memory, so every block of
  // the cluster must have started: the barrier's first phase, waited for
  // after the mainloop
  const bool push = splits > 1 && splits * ROWS <= kPushRows;
  if (push) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float acc[ROWS / 2];
  mainloop<ROWS, kWT>(D, W, n, k, m, row0, col0, kt0, nkt, vec != 0, smem,
                      acc);
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
      int r, c;
      frag_rc(D, v, tid, r, c);
      Cs[r][c] = row0 + r < n && col0 + c < m ? acc[v] : 0.f;
    }
  } else if (push) {
    // every rank stores its tile into rank 0's receiving area (past the
    // ring and the tail) and leaves; rank 0 sums them in rank order
    float* recv = reinterpret_cast<float*>(smem + smem_bytes<T>(ROWS));
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    float* to = cg::this_cluster().map_shared_rank(recv, 0) + z * ROWS * WM;
#pragma unroll
    for (int v = 0; v < ROWS / 2; ++v) {
      int r, c;
      frag_rc(D, v, tid, r, c);
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
      int r, c;
      frag_rc(D, v, tid, r, c);
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
  // O rounded once to its type: 16 bytes a thread where the tile's rows
  // lie whole and aligned in O, else element by element
  constexpr int kV = 16 / (int)sizeof(T);
  if (col0 + WM <= m && m % kV == 0
      && reinterpret_cast<uintptr_t>(O) % 16 == 0) {
    for (int iv = tid; iv < ROWS * WM / kV; iv += kWgThreads) {
      const int r = iv / (WM / kV), c = iv % (WM / kV) * kV;
      if (row0 + r < n)
        store16(O + (size_t)(row0 + r) * m + col0 + c, &Cs[r][c]);
    }
  } else {
    for (int idx = tid; idx < ROWS * WM; idx += kWgThreads) {
      const int r = idx / WM, c = idx % WM;
      if (row0 + r < n && col0 + c < m)
        O[(size_t)(row0 + r) * m + col0 + c] = from_f<T>(Cs[r][c]);
    }
  }
  tile_epilogue<ROWS, WM>(Cs, Rq, row0, col0, n, m, args);
  finish_chunks<ROWS>(args, row0, col0, n, m, &Rq[ROWS][0]);
}

// ------------------------------------------------------------ the tiling

// How an n-row product of dtype (0 f32, 1 bf16) is launched: block tile
// tm x tn of O (computed as O^T), K split over `splits` blocks of `per`
// K tiles each. This is the rule's one home: both entry points launch from
// it, so each accumulates every element of O in the same order, and the
// wrappers read it through repro_abft_tiling.
struct Tiling {
  int tm, tn, splits, per;
};

Tiling choose_tiling(int n, int k, int m, int dtype) {
  int tm = 8;
  while (tm < n && tm < kMaxRows) tm *= 2;
  const int tiles = (m + WM - 1) / WM * ((n + tm - 1) / tm);
  const int wk = dtype == 1 ? WK : WKF;
  const int kt = k > wk ? (k + wk - 1) / wk : 1;
  const int want = tiles >= kSMs ? 1 : min(kMaxSplits, (kSMs + tiles - 1) / tiles);
  const int per = (kt + want - 1) / want;
  return {tm, WM, (kt + per - 1) / per, per};
}

// The column segment the detect pass's blocks sum rows over: the largest
// power of two dividing both cb and the tile's width, so no segment
// straddles two chunks.
int detect_seg(int tn, int cb) {
  int seg = tn;
  while (cb % seg) seg /= 2;
  return seg;
}

// G products of one shape: group g's operands gd, gw and go elements past
// group 0's
struct Groups {
  int count;
  long long d, w, o;
};

template <typename T, int ROWS, bool kWT, typename Args>
int launch_gemm(const void* d, const void* w, void* o, int n, int k, int m,
                const Tiling& t, const Groups& gr, const Args& args,
                cudaStream_t s) {
  // the ring and tail, and rank 0's receiving area when the splits push
  constexpr int most = smem_bytes<T>(ROWS) + kPushRows * WM * 4;
  const int bytes = smem_bytes<T>(ROWS)
                    + (t.splits > 1 && t.splits * ROWS <= kPushRows
                           ? t.splits * ROWS * WM * 4 : 0);
  // more than 48 KB of shared memory only once asked for, on each device
  static bool sized[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(gemm_kernel<T, ROWS, kWT, Args>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
    if (e != cudaSuccess) return (int)e;
    sized[dev] = true;
  }
  constexpr int kV = 16 / (int)sizeof(T);   // elements per 16-byte copy
  const bool vec = k % kV == 0 && (kWT || m % kV == 0)
                   && reinterpret_cast<uintptr_t>(d) % 16 == 0
                   && reinterpret_cast<uintptr_t>(w) % 16 == 0
                   && gr.d % kV == 0 && gr.w % kV == 0;
  const int rtiles = (n + ROWS - 1) / ROWS;
  if (gr.count < 1 || (long long)rtiles * gr.count > 65535)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((m + WM - 1) / WM, rtiles * gr.count, t.splits);
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
      &cfg, gemm_kernel<T, ROWS, kWT, Args>, static_cast<const T*>(d),
      static_cast<const T*>(w), static_cast<T*>(o), n, k, m, t.per, t.splits,
      vec ? 1 : 0, rtiles, gr.d, gr.w, gr.o, args);
}

template <typename T, bool kWT, typename Args>
int dispatch_rows(const void* d, const void* w, void* o, int n, int k, int m,
                  const Tiling& t, const Groups& g, const Args& args,
                  cudaStream_t s) {
  switch (t.tm) {
    case 8: return launch_gemm<T, 8, kWT>(d, w, o, n, k, m, t, g, args, s);
    case 16: return launch_gemm<T, 16, kWT>(d, w, o, n, k, m, t, g, args, s);
    case 32: return launch_gemm<T, 32, kWT>(d, w, o, n, k, m, t, g, args, s);
    case 64: return launch_gemm<T, 64, kWT>(d, w, o, n, k, m, t, g, args, s);
    case 128: return launch_gemm<T, 128, kWT>(d, w, o, n, k, m, t, g, args, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename Args>
int dispatch(int dtype, int w_layout, const void* d, const void* w, void* o,
             int n, int k, int m, const Tiling& t, const Groups& g,
             const Args& args, cudaStream_t s) {
  if (dtype == 0 && w_layout == 0)
    return dispatch_rows<float, false>(d, w, o, n, k, m, t, g, args, s);
  if (dtype == 0 && w_layout == 1)
    return dispatch_rows<float, true>(d, w, o, n, k, m, t, g, args, s);
  if (dtype == 1 && w_layout == 0)
    return dispatch_rows<__nv_bfloat16, false>(d, w, o, n, k, m, t, g, args, s);
  if (dtype == 1 && w_layout == 1)
    return dispatch_rows<__nv_bfloat16, true>(d, w, o, n, k, m, t, g, args, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The tiling an n-row product of dtype (0 float32, 1 bfloat16) with K = k
// and M = m launches with: the block tile (tm rows x tn columns of O), the
// K split (splits blocks per tile, one cluster, > 1 when the tiles cannot
// fill the card) and, for a detection chunk width cb > 0, the detect
// pass's row segment (seg; repro_abft_matmul_detect's part then holds 3 *
// n * (m / seg) floats; 0 when cb is 0). The wrappers size their buffers
// from it.
extern "C" int repro_abft_tiling(int n, int k, int m, int dtype, int cb,
                                 int* tm, int* tn, int* seg, int* splits) {
  if (n < 1 || k < 0 || m < 1 || cb < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Tiling t = choose_tiling(n, k, m, dtype);
  *tm = t.tm;
  *tn = t.tn;
  *seg = cb > 0 ? detect_seg(t.tn, cb) : 0;
  *splits = t.splits;
  return 0;
}

// G products O_g = D_g @ W_g of one shape in one launch (the group axis:
// the counterpart of the Pallas kernel under jax.vmap; one product is G =
// 1). D_g (n, k), W_g (k, m) with w_layout 0 (row-major) or the transposed
// view of an (m, k) row-major tensor (w_layout 1), O_g (n, m) row-major,
// group g's at gd, gw and go elements past group 0's; dtype 0 is float32, 1 is bfloat16 (all
// three tensors). colsum has m columns, rowsum rs_cols and sumsq ss_cols;
// rows of colsum/sumsq are partial row tiles of pbm rows, columns of
// rowsum/sumsq partial column tiles of pbn columns, pbm and pbn powers of
// two dividing the block tile (repro_abft_tiling); group g's sums lie
// g_col, g_row and g_sq floats past group 0's. Only the tiles that hold
// elements of O are written. Returns the launch's error, or
// cudaGetLastError().
extern "C" int repro_abft_matmul(
    const void* d, const void* w, void* o, int dtype, int w_layout,
    int groups, long long gd, long long gw, long long go, int n, int k, int m,
    int pbm, int pbn, float* colsum, float* rowsum, float* sumsq, int rs_cols,
    int ss_cols, long long g_col, long long g_row, long long g_sq,
    void* stream) {
  if (n < 1 || k < 0 || m < 1 || (dtype != 0 && dtype != 1) || groups < 1)
    return (int)cudaErrorInvalidValue;
  const Tiling t = choose_tiling(n, k, m, dtype);
  if (pbm < 1 || pbm > t.tm || t.tm % pbm || pbn < 1 || pbn > t.tn
      || t.tn % pbn)
    return (int)cudaErrorInvalidValue;
  const PartialsArgs args{pbm,    pbn,     colsum, rowsum, sumsq,
                          rs_cols, ss_cols, g_col,  g_row,  g_sq};
  const int err = dispatch(dtype, w_layout, d, w, o, n, k, m, t,
                           Groups{groups, gd, gw, go}, args,
                           (cudaStream_t)stream);
  return err ? err : (int)cudaGetLastError();
}

// The G products as above plus the CoC-D compare per (rb x cb) chunk of
// each, in one launch: c5, c6, c7 and absdot are float32 (G, n / rb, m /
// cb); flag (int32) and score (float32) likewise. part is float32 scratch
// of G * 3 * n * (m / seg) elements, seg as repro_abft_tiling gives it;
// counters are G * (n / rb) * (m / cb) int32 that are zero and that no
// other launch uses until this one has ended (the kernel leaves them
// zero). rb must divide n and cb must divide m. Returns the launch's
// error, or cudaGetLastError().
extern "C" int repro_abft_matmul_detect(
    const void* d, const void* w, void* o, int dtype, int w_layout,
    int groups, long long gd, long long gw, long long go, int n, int k, int m,
    int rb, int cb, const float* c5, const float* c6, const float* c7,
    const float* absdot, float tau_a, float tau_b, int weighted, float* part,
    int* counters, int* flag, float* score, void* stream) {
  if (n < 1 || k < 0 || m < 1 || (dtype != 0 && dtype != 1) || rb < 1
      || cb < 1 || n % rb || m % cb || groups < 1)
    return (int)cudaErrorInvalidValue;
  const Tiling t = choose_tiling(n, k, m, dtype);
  const int seg = detect_seg(t.tn, cb);
  const DetectArgs args{rb,     cb,     seg,      part,     c5,
                        c6,     c7,     absdot,   tau_a,    tau_b,
                        weighted, flag, score,    counters,
                        3LL * n * (m / seg),
                        (long long)(n / rb) * (m / cb)};
  const int err = dispatch(dtype, w_layout, d, w, o, n, k, m, t,
                           Groups{groups, gd, gw, go}, args,
                           (cudaStream_t)stream);
  return err ? err : (int)cudaGetLastError();
}

// Whether `stream` is capturing a CUDA graph, and the capture's id (unique
// in the process) when it is: each capture gets counters of its own
// (kernels/_counters.py).
extern "C" int repro_capture_id(void* stream, int* capturing,
                                unsigned long long* id) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  *id = 0;
  const cudaError_t e =
      cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, id);
  *capturing = status == cudaStreamCaptureStatusActive;
  return (int)e;
}
