// Output-summation sums of an existing output O, two C entry points.
//
// Replaces: src/repro/kernels/checksum_reduce.py::_kernel (the Pallas TPU
// kernel behind repro.kernels.ops.checksum_reduce / conv_detect_sums).
//
// Bound on an H100: device-memory bandwidth. Both entry points read O
// (float32 or bfloat16; every sum in fp32, as the TPU kernel casts its
// tile) once and write far less than they read; there are ~7 flops per
// element read, far below the card's ridge point. So O must be read exactly
// once, with coalesced loads, and never copied: the JAX wrapper zero-pads a
// ragged O with jnp.pad before the kernel, while these kernels mask ragged
// edges themselves.
//
// repro_conv_detect_sums_* (the conv detection path, 17 launches per
// ResNet-18 forward): what repro.kernels.ops.conv_detect_sums returns, in
// one launch. O[N, M, E, E] is read as its (N*M, P) row-major view, P =
// E*E; row nm weighs n = nm / M for s6 and m = nm % M for s7, so the sums
// need no tile-local weights. Per payload position p it gives s5[p] =
// sum O[nm, p], s6[p] = sum n O[nm, p], s7[p] = sum m O[nm, p], and the
// scalar sum of squares. The tiling is this card's, chosen here from (N*M,
// P) alone: a block owns 128 bytes of each row (a column tile) over a run
// of rows (a row group); its threads run 16-byte loads along the row where
// P and O's address allow (4-byte ones on short rows such as the 7x7 maps'
// P = 49) and walk the run's rows, up to 16 loads in flight each. Row
// groups are added until the blocks fill the card about twice, at most 32
// per column tile, so conv0's 25.7 MB view (392 column tiles) takes no row
// split and the 7x7 views take 32. A block combines its threads in a fixed
// order; with several row groups it writes its column sums to scratch and
// the last block of its column tile (an int32 counter) adds the row groups
// in order. Every block writes its sum of squares, and the last block of
// the launch (another counter) adds them in block order. Both counters are
// bumped at once and left at zero. No float atomics, so the sums repeat
// bitwise. Below a few MB the views are bound by latency, not bytes: the
// launch, one wave of loads, then the finishing handshake (fence, atomic,
// the last block's L2 reads).
//
// repro_checksum_reduce_* (what the TPU kernel computes, for
// ops.checksum_reduce and the parity checks): per (bm x bn) tile, colsum,
// rowsum, sumsq and wcolsum (the column sum weighted by the row's index
// within the tile). One block of 256 threads per tile; threads run along
// the columns (neighbouring threads read neighbouring addresses) and, when
// bn < 256, several row groups share a column. Each thread keeps its
// column's colsum and wcolsum in registers over its rows; the row groups
// combine through shared memory in a fixed order, and the tile's sum of
// squares is reduced by warp shuffles and shared memory. rowsum is
// optional; when asked for, each warp re-reads the tile's rows, which are
// then in L2. The rows are laid out as `nseg` segments of `seg_rows` rows
// and a row tile never straddles two segments (the (N*M, P) view as N
// segments of M rows: wcolsum carries only local row weights). A segment
// whose length is not a multiple of bm ends in a ragged tile, masked like
// the ragged last column tile.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
checksum_reduce_kernel(const T* __restrict__ o, int seg_rows, int cols,
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
  const T* base = o + ((size_t)seg * seg_rows + r0) * cols + c0;

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
      const T* p = base + c;
      for (int r = grp; r < rows; r += groups) {
        const float v = to_f(p[(size_t)r * cols]);
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
      const T* p = base + (size_t)r * cols;
      float s = 0.f;
      for (int c = wl; c < ncols; c += 32) s += to_f(p[c]);
      s = warp_sum(s);
      if (wl == 0) rowsum[((size_t)seg * seg_rows + r0 + r) * ptiles + pt] = s;
    }
  }
}

template <typename T>
int launch(const void* o, int nseg, int seg_rows, int cols, int bm, int bn,
           float* colsum, float* rowsum, float* sumsq, float* wcolsum,
           void* stream) {
  const int mtiles = (seg_rows + bm - 1) / bm;
  const int ptiles = (cols + bn - 1) / bn;
  dim3 grid(nseg * mtiles, ptiles);
  checksum_reduce_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(o), seg_rows, cols, bm, bn, mtiles, ptiles,
      colsum, rowsum, sumsq, wcolsum);
  return (int)cudaGetLastError();
}


// ------------------------------------------------- the conv detection sums

constexpr int kTileBytes = 128;      // a column tile: 128 bytes of each row
constexpr int kTargetBlocks = 2 * 132;   // about two blocks per SM
constexpr int kMaxRowGroups = 32;    // bounds the last block's adds per column

struct ConvTiling {
  int ctiles, rg, rpb;   // column tiles, row groups, rows per row group
};

ConvTiling conv_tiling(int rows, int p, int esize) {
  const int cols = kTileBytes / esize;
  const int ctiles = (p + cols - 1) / cols;
  int rg = min(kMaxRowGroups, (kTargetBlocks + ctiles - 1) / ctiles);
  rg = max(1, min(rg, rows));
  const int rpb = (rows + rg - 1) / rg;
  return {ctiles, (rows + rpb - 1) / rpb, rpb};
}

// floats of scratch after the 3p + 1 results: each row group's column
// sums (when there are several) and each block's sum of squares
long long conv_scratch(const ConvTiling& t, int p) {
  return (t.rg > 1 ? (long long)t.rg * 3 * p : 0) + (long long)t.ctiles * t.rg;
}

// VEC consecutive elements of O as floats, in one load
__device__ __forceinline__ void load_vec(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[1]) {
  v[0] = __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = bf16_lo(x.x);
  v[1] = bf16_hi(x.x);
  v[2] = bf16_lo(x.y);
  v[3] = bf16_hi(x.y);
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = bf16_lo(w[i]);
    v[2 * i + 1] = bf16_hi(w[i]);
  }
}

// Block (ct, g): columns [ct * kCols, ct * kCols + kCols) of rows [g * rpb,
// g * rpb + rpb). out: s5 (p), s6 (p), s7 (p), sumsq (1); scratch as
// conv_scratch counts it; counters: one per column tile, then one for the
// launch, zero on entry and on exit.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
conv_sums_kernel(const T* __restrict__ o, int rows, int m, int p, int rpb,
                 float* __restrict__ out, float* __restrict__ scratch,
                 int* __restrict__ counters) {
  constexpr int kCols = kTileBytes / (int)sizeof(T);
  constexpr int kLanes = kCols / VEC;             // threads along a row
  constexpr int kGroups = kThreads / kLanes;      // rows walked at once
  constexpr int kU = VEC * sizeof(T) >= 8 ? 8 : 16;   // loads in flight
  __shared__ float red[3][kGroups * kCols];
  __shared__ float warp_sq[kThreads / 32];
  __shared__ int last;

  const int ct = blockIdx.x, g = blockIdx.y;
  const int ctiles = gridDim.x, rg = gridDim.y;
  const int tid = threadIdx.x, lane = tid % kLanes, grp = tid / kLanes;
  const int c = ct * kCols + lane * VEC;
  const bool live = c < p;             // p % VEC == 0: all VEC or none
  const int r0 = g * rpb, r1 = min(rows, r0 + rpb);
  float* part = scratch;               // (rg, 3, p) when rg > 1
  float* sq_part = scratch + (rg > 1 ? (size_t)rg * 3 * p : 0);

  float s[3][VEC], sq = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[0][i] = s[1][i] = s[2][i] = 0.f;
  for (int rb = r0 + grp; rb < r1; rb += kU * kGroups) {
    float v[kU][VEC];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = rb + u * kGroups;
      if (live && r < r1) {
        load_vec(o + (size_t)r * p + c, v[u]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[u][i] = 0.f;
      }
    }
    // rows past the run read as zeros, which change no sum
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = rb + u * kGroups, nn = r / m;
      const float wn = (float)nn, wm = (float)(r - nn * m);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float x = v[u][i];
        s[0][i] += x;
        s[1][i] = fmaf(wn, x, s[1][i]);
        s[2][i] = fmaf(wm, x, s[2][i]);
        sq = fmaf(x, x, sq);
      }
    }
  }

  // the block's column sums over its rows, groups added in order
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[q][grp * kCols + lane * VEC + i] = s[q][i];
  sq = warp_sum(sq);
  if (tid % 32 == 0) warp_sq[tid / 32] = sq;
  __syncthreads();
  for (int t = tid; t < 3 * kCols; t += kThreads) {
    const int q = t / kCols, cc = t % kCols, gc = ct * kCols + cc;
    float a = 0.f;
    for (int gg = 0; gg < kGroups; ++gg) a += red[q][gg * kCols + cc];
    if (gc < p) {
      if (rg == 1)
        out[(size_t)q * p + gc] = a;
      else
        part[((size_t)g * 3 + q) * p + gc] = a;
    }
  }
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) t += warp_sq[w];
    sq_part[(size_t)g * ctiles + ct] = t;
  }

  // the block's writes are visible before its counters count it; both
  // counters are bumped at once (one atomic round trip, not two)
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int a = rg > 1 ? atomicAdd(counters + ct, 1) : -1;
    const int b = atomicAdd(counters + ctiles, 1);
    last = (a == rg - 1 ? 1 : 0) | (b == ctiles * rg - 1 ? 2 : 0);
  }
  __syncthreads();
  const int flags = last;
  if (flags == 0) return;
  // a last block: the others' writes, read from L2, every load issued
  // before the first add
  __threadfence();
  float sqa = 0.f;
  if (flags & 2)   // the launch's last block: the blocks' sums of squares
    for (int b = tid; b < ctiles * rg; b += kThreads) sqa += __ldcg(sq_part + b);
  if (flags & 1) {   // the tile's last row group: the row groups in order
    for (int t = tid; t < 3 * kCols; t += kThreads) {
      const int q = t / kCols, gc = ct * kCols + t % kCols;
      if (gc >= p) continue;
      float x[kMaxRowGroups];
#pragma unroll
      for (int gg = 0; gg < kMaxRowGroups; ++gg)
        x[gg] = gg < rg ? __ldcg(part + ((size_t)gg * 3 + q) * p + gc) : 0.f;
      float a = 0.f;
#pragma unroll
      for (int gg = 0; gg < kMaxRowGroups; ++gg)
        if (gg < rg) a += x[gg];
      out[(size_t)q * p + gc] = a;
    }
    if (tid == 0) counters[ct] = 0;
  }
  if (flags & 2) {
    sqa = warp_sum(sqa);
    if (tid % 32 == 0) warp_sq[tid / 32] = sqa;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) t += warp_sq[w];
      out[3 * (size_t)p] = t;
      counters[ctiles] = 0;
    }
  }
}

template <typename T, int VEC>
int launch_sums(const T* o, int rows, int m, int p, const ConvTiling& t,
                float* buf, int* counters, cudaStream_t s) {
  conv_sums_kernel<T, VEC><<<dim3(t.ctiles, t.rg), kThreads, 0, s>>>(
      o, rows, m, p, t.rpb, buf, buf + 3 * (size_t)p + 1, counters);
  return (int)cudaGetLastError();
}

// The widest load that every row start allows: 16 bytes, else 4 elements,
// else one.
template <typename T>
int conv_sums(const void* o, int n, int m, int p, float* buf, int* counters,
              void* stream) {
  if (n < 1 || m < 1 || p < 1) return (int)cudaErrorInvalidValue;
  const int rows = n * m;
  const ConvTiling t = conv_tiling(rows, p, (int)sizeof(T));
  const T* x = static_cast<const T*>(o);
  const uintptr_t at = reinterpret_cast<uintptr_t>(o);
  cudaStream_t s = (cudaStream_t)stream;
  constexpr int kWide = 16 / (int)sizeof(T);
  if (p % kWide == 0 && at % 16 == 0)
    return launch_sums<T, kWide>(x, rows, m, p, t, buf, counters, s);
  if (p % 4 == 0 && at % (4 * sizeof(T)) == 0)
    return launch_sums<T, 4>(x, rows, m, p, t, buf, counters, s);
  return launch_sums<T, 1>(x, rows, m, p, t, buf, counters, s);
}

}  // namespace

// O float32 (_f32) or bfloat16 (_bf16), row-major (nseg * seg_rows, cols).
// colsum/wcolsum: (nseg * ceil(seg_rows/bm), cols); sumsq: (nseg *
// ceil(seg_rows/bm), ceil(cols/bn)); rowsum: (nseg * seg_rows,
// ceil(cols/bn)) or null to skip it; all float32. Returns
// cudaGetLastError().
extern "C" int repro_checksum_reduce_f32(const float* o, int nseg, int seg_rows,
                                         int cols, int bm, int bn,
                                         float* colsum, float* rowsum,
                                         float* sumsq, float* wcolsum,
                                         void* stream) {
  return launch<float>(o, nseg, seg_rows, cols, bm, bn, colsum, rowsum,
                       sumsq, wcolsum, stream);
}

extern "C" int repro_checksum_reduce_bf16(const void* o, int nseg,
                                          int seg_rows, int cols, int bm,
                                          int bn, float* colsum,
                                          float* rowsum, float* sumsq,
                                          float* wcolsum, void* stream) {
  return launch<__nv_bfloat16>(o, nseg, seg_rows, cols, bm, bn, colsum,
                               rowsum, sumsq, wcolsum, stream);
}

// What a conv-sums launch over O[n, m, p] of dtype (0 float32, 1 bfloat16)
// needs, as this source tiles it: `floats`, the float32 buffer's length
// (the 3p + 1 results, then the scratch), and `counters`, the int32
// counters.
extern "C" int repro_conv_sums_layout(int n, int m, int p, int dtype,
                                      long long* floats, int* counters) {
  if (n < 1 || m < 1 || p < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const ConvTiling t = conv_tiling(n * m, p, dtype == 1 ? 2 : 4);
  *floats = 3LL * p + 1 + conv_scratch(t, p);
  *counters = t.ctiles + 1;
  return 0;
}

// O float32 (_f32) or bfloat16 (_bf16), row-major (n * m, p): s5, s6, s7
// (p floats each) and sumsq (1) at the start of buf, whose length
// repro_conv_sums_layout gives; counters: as many int32 as it gives, zero,
// and used by no other launch until this one has ended (the kernel leaves
// them zero). Returns cudaGetLastError().
extern "C" int repro_conv_detect_sums_f32(const float* o, int n, int m,
                                          int p, float* buf, int* counters,
                                          void* stream) {
  return conv_sums<float>(o, n, m, p, buf, counters, stream);
}

extern "C" int repro_conv_detect_sums_bf16(const void* o, int n, int m,
                                           int p, float* buf, int* counters,
                                           void* stream) {
  return conv_sums<__nv_bfloat16>(o, n, m, p, buf, counters, stream);
}
