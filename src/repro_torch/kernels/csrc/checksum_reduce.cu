// Single-pass output-summation partials of an existing output O.
//
// Replaces: src/repro/kernels/checksum_reduce.py::_kernel (the Pallas TPU
// kernel behind repro.kernels.ops.checksum_reduce / conv_detect_sums).
//
// Bound on an H100: device-memory bandwidth. The kernel reads O once and
// writes partials that are 1/bm and 1/bn of its size; there are ~4 flops
// per element read, far below the card's ridge point. So O must be read
// exactly once, with coalesced loads, and never copied: the JAX wrapper
// zero-pads a ragged O with jnp.pad before the kernel, while this kernel
// masks the ragged edge of each tile itself.
//
// Design: one block of 256 threads per partial tile (bm rows x bn
// columns). Threads run along the columns (neighbouring threads read
// neighbouring addresses) and, when bn < 256, several row groups share a
// column. Each thread keeps its column's colsum and wcolsum (the column sum
// weighted by the row's index within the tile) in registers over its rows;
// the row groups combine through shared memory in a fixed order, and the
// tile's sum of squares is reduced by warp shuffles and shared memory.
// Every sum is taken in a fixed order, so the result is deterministic.
// rowsum (one sum per row across the tile's columns) is optional: the conv
// detection path discards it. When asked for, each warp re-reads the
// tile's rows, which are then in L2.
//
// The rows are laid out as `nseg` segments of `seg_rows` rows. A row tile
// never straddles two segments: the conv path views O[N, M, P] as
// N segments of M rows (the flattened (N*M, P) view), and its s6/s7
// reconstruction needs every tile inside one batch block, because wcolsum
// carries only local row weights. A segment whose length is not a multiple
// of bm ends in a ragged tile, masked like the ragged last column tile.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
checksum_reduce_kernel(const float* __restrict__ o, int seg_rows, int cols,
                       int bm, int bn, int mtiles, int ptiles,
                       float* __restrict__ colsum, float* __restrict__ rowsum,
                       float* __restrict__ sumsq, float* __restrict__ wcolsum) {
  __shared__ float part[2][kThreads];
  __shared__ float warp_sq[kThreads / 32];

  const int rt = blockIdx.x;                 // row tile, over all segments
  const int pt = blockIdx.y;                 // column tile
  const int seg = rt / mtiles;
  const int r0 = (rt % mtiles) * bm;         // first row inside the segment
  const int rows = min(bm, seg_rows - r0);
  const int c0 = pt * bn;
  const int ncols = min(bn, cols - c0);
  const float* base = o + ((size_t)seg * seg_rows + r0) * cols + c0;

  const int tc = bn < kThreads ? bn : kThreads;  // column lanes
  const int groups = kThreads / tc;              // row groups per column
  const int lane = threadIdx.x % tc;
  const int grp = threadIdx.x / tc;
  const bool active = grp < groups;              // tc need not divide 256

  float sq = 0.f;
  const int passes = (bn + tc - 1) / tc;
  for (int it = 0; it < passes; ++it) {
    const int c = it * tc + lane;
    float cs = 0.f, ws = 0.f;
    if (active && c < ncols) {
      const float* p = base + c;
      for (int r = grp; r < rows; r += groups) {
        const float v = p[(size_t)r * cols];
        cs += v;
        ws += (float)r * v;
        sq += v * v;
      }
    }
    part[0][threadIdx.x] = cs;
    part[1][threadIdx.x] = ws;
    __syncthreads();
    if (active && grp == 0 && c < ncols) {
      float a = 0.f, b = 0.f;
      for (int g = 0; g < groups; ++g) {
        a += part[0][g * tc + lane];
        b += part[1][g * tc + lane];
      }
      const size_t at = (size_t)rt * cols + c0 + c;
      colsum[at] = a;
      wcolsum[at] = b;
    }
    __syncthreads();
  }

  sq = warp_sum(sq);
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  if (wl == 0) warp_sq[warp] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) t += warp_sq[i];
    sumsq[(size_t)rt * ptiles + pt] = t;
  }

  if (rowsum != nullptr) {
    for (int r = warp; r < rows; r += kThreads / 32) {
      const float* p = base + (size_t)r * cols;
      float s = 0.f;
      for (int c = wl; c < ncols; c += 32) s += p[c];
      s = warp_sum(s);
      if (wl == 0) rowsum[((size_t)seg * seg_rows + r0 + r) * ptiles + pt] = s;
    }
  }
}

}  // namespace

// colsum/wcolsum: (nseg * ceil(seg_rows/bm), cols); sumsq: (nseg *
// ceil(seg_rows/bm), ceil(cols/bn)); rowsum: (nseg * seg_rows,
// ceil(cols/bn)) or null to skip it. Returns cudaGetLastError().
extern "C" int repro_checksum_reduce_f32(const float* o, int nseg, int seg_rows,
                                         int cols, int bm, int bn,
                                         float* colsum, float* rowsum,
                                         float* sumsq, float* wcolsum,
                                         void* stream) {
  const int mtiles = (seg_rows + bm - 1) / bm;
  const int ptiles = (cols + bn - 1) / bn;
  dim3 grid(nseg * mtiles, ptiles);
  checksum_reduce_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      o, seg_rows, cols, bm, bn, mtiles, ptiles, colsum, rowsum, sumsq, wcolsum);
  return (int)cudaGetLastError();
}
