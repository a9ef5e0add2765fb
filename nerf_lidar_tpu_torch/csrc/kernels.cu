// Hand-written Hopper (sm_90a) kernels of the LiDAR sweep render path.
//
// Built by nerf_lidar_tpu_torch/ops/_build.py with one nvcc call into a
// shared library with a plain C interface (no PyTorch headers), loaded with
// ctypes. Every launcher takes raw device pointers, sizes, the device index
// and the caller's cudaStream_t, launches on that stream without
// synchronising, allocates nothing, and returns cudaGetLastError().
//
// K1 composite: replaces the Pallas kernel
//   nerf_lidar_tpu/ops/render_pallas.py:_composite_kernel (fused_composite).
//   Per ray: delta = dt * |d| * sigma, alpha = 1 - exp(-delta) (alpha = 1 on
//   the last sample when the background is opaque), T = exp(-sum_{j<i}
//   delta_j), w = alpha * T, then acc / depth / rgb (+ background) /
//   semantic / intensity composites. Bound by device-memory reads of the
//   [R, S, C] features (about 50 MB per 16,384-ray chunk at S = 32, C = 22).
//   Design: one thread per ray with a sequential loop over the S samples,
//   which replaces the TPU's triangle-matmul cumsum with a running finite
//   sum (the opaque +inf never enters it). Features are read in the MLP's
//   natural [R, S, C] layout; the TPU's channel-major [C, R, S] stack was a
//   lane-padding workaround and is gone.
//
// H1 hash_encode_ms: replaces the XLA gathers of
//   nerf_lidar_tpu/ops/grid.py:_ms_encode_impl (hash_encode_multisample,
//   linear interpolation, no coarse cutoff). Bound by table reads: 8 corners
//   x n multisamples x L levels per sample, at random rows of tables up to
//   240 MB (larger than the 50 MB L2). Design, one thread per (sample,
//   level):
//   - corner-run merge: at the coarse levels the n multisamples of a sample
//     mostly share one cell, so while a point's integer cell equals the
//     previous in-range point's, its erf-weighted trilinear weights add into
//     8 per-corner sums, and each corner row is read once per run;
//   - a row is one float4 (C4) or float2 (C2) load through __ldg;
//   - a block takes one level and a tile of kThreads consecutive samples.
//     The caller picks the block order (ops/grid.py:level_major): a table
//     larger than the L2 runs level-major, so one level's slice at a time
//     takes the reads in L2, and its blocks stage their tile's x01 / stds
//     through shared memory in one coalesced copy (the tile comes from
//     device memory once per level); a smaller table runs a tile's levels
//     in neighbouring blocks, which find the tile in L2.
//   Measured and dropped: a shared-memory copy of the coarse levels' slices
//   in persistent blocks, slower than these reads on the render's and the
//   train step's points (PERF.md).
//
// K3 scatter_add_rows: replaces the Pallas kernel
//   experiments/scatter_variants.py:pallas_mxu_scatter (out[r] += sum of
//   vals[i] with idx[i] == r). The TPU kernel built a one-hot [block, rows]
//   matrix in VMEM and kept the [rows, C] sum there across a sequential
//   grid; Hopper's blocks run in no order, so the cross-block sum goes into
//   device memory with atomics. Bound by atomic throughput at the L2, and
//   by same-address serialisation when many indices share a row (the
//   hash-decay segment sum puts a whole level of up to 2^21 rows on one
//   output row). Design: a warp takes 32 * kScatterRun consecutive values
//   of the flattened [N, C] vals, lane j the values j, j + 32, ..., which
//   share one channel because C divides 32; a lane sums while the row stays
//   the same and adds one atomic when it changes, and a warp whose lanes
//   all end on one row sums each channel across lanes by shuffles and adds
//   C atomics. Sorted runs (the segment sum) thus cost one atomic per
//   channel per warp; random rows cost one per value, as a plain scatter.
//   Indices outside [0, rows) are dropped, as the one-hot drops them.
//
// H1 backward hash_encode_ms_bwd: the gradient of hash_encode_ms, which JAX
//   gets by autodiff through the gathers of _ms_encode_impl
//   (diff_inputs=True). d_table: every in-range corner adds
//   w_corner * erf_w / n * g_out[b, l] to its row. d_x01 / d_stds (only
//   when asked for): the derivative of the trilinear weights times scale_l,
//   and of the erf weight, each against <g_out, corner row>, per point,
//   summed over the levels with atomics. Bound by table atomics, and at the
//   coarse levels by same-row serialisation: training points cluster along
//   rays, so millions of updates land on a few thousand rows. Design, with
//   the forward's threads, block order and staging (level-major, a level's
//   d_table slice of up to 33.5 MB takes its atomics in L2):
//   - the corner-run merge: 8 row updates per run of same-cell points
//     instead of 8 per point (56 -> 8 at the coarse levels for n = 7);
//   - neighbouring lanes (neighbouring samples of a ray) whose runs end in
//     the same cell sum their updates with a segmented shuffle scan, and
//     the segment's last lane adds them through add_row, K3's row atomic.
//   Measured and dropped: summing the coarse levels in shared memory
//   (persistent blocks, one flush per block), slower than the merged device
//   atomics on the train step's points (PERF.md). Atomics make every sum
//   order change from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr float kEps = 1.1920929e-07f;  // float32 eps, as in the reference
constexpr unsigned kFullMask = 0xffffffffu;

// Samples (threads) of a block of H1 and its backward.
constexpr int kThreads = 128;
// Staged x01 / stds of a block's tile: at most the dynamic shared memory a
// block gets without opting in (16 * kThreads * n bytes; n <= 24).
constexpr int kStageBytes = 48 * 1024;

struct GridLevels {
  float scale[kMaxLevels];      // exp2(l * log2(per_level_scale)) * H - 1
  float grid_size[kMaxLevels];  // resolution, for the erf downweighting
  uint32_t res[kMaxLevels];     // tiled stride R_l
  uint32_t rows[kMaxLevels];    // rows of the level's table slice
  uint32_t offset[kMaxLevels];  // first row of the level in the table
  int tiled[kMaxLevels];        // 1: direct index, 0: XOR-prime hash
};

__global__ void composite_kernel(
    const float* __restrict__ density, const float* __restrict__ tdist,
    const float* __restrict__ dirs, const float* __restrict__ rgb,
    const float* __restrict__ sem, const float* __restrict__ inten,
    float* __restrict__ weights, float* __restrict__ rgb_out,
    float* __restrict__ sem_out, float* __restrict__ inten_out,
    float* __restrict__ depth_out, float* __restrict__ acc_out, int64_t R,
    int S, int K, int opaque, float bg) {
  const int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  const float* d_r = density + r * S;
  const float* t_r = tdist + r * (S + 1);
  float* w_r = weights + r * S;

  float csum = 0.f, acc = 0.f, dsum = 0.f, isum = 0.f;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
  for (int i = 0; i < S; ++i) {
    const float t0 = t_r[i], t1 = t_r[i + 1];
    const float dd = d_r[i] * ((t1 - t0) * dnorm);
    const float alpha = (opaque && i == S - 1) ? 1.f : 1.f - expf(-dd);
    const float w = alpha * expf(-csum);
    csum += dd;
    w_r[i] = w;
    acc += w;
    dsum += w * (0.5f * (t0 + t1));
    const float* c = rgb + (r * S + i) * 3;
    c0 += w * c[0];
    c1 += w * c[1];
    c2 += w * c[2];
    if (inten != nullptr) isum += w * inten[r * S + i];
  }
  const float bg_w = fmaxf(1.f - acc, 0.f);
  rgb_out[3 * r] = c0 + bg_w * bg;
  rgb_out[3 * r + 1] = c1 + bg_w * bg;
  rgb_out[3 * r + 2] = c2 + bg_w * bg;
  depth_out[r] = dsum / fmaxf(acc, kEps);
  acc_out[r] = acc;
  if (inten_out != nullptr) inten_out[r] = isum;
  // Semantic channels: a second pass over this ray's weights, which the
  // loop above just wrote (same thread, so they are visible).
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int i = 0; i < S; ++i) s += w_r[i] * sem[(r * S + i) * K + k];
    sem_out[r * K + k] = s;
  }
}

// One level's constants, as a thread uses them.
struct Level {
  float scale, g2;
  uint32_t res, rows;
  bool tiled;
};

__device__ __forceinline__ Level level_of(const GridLevels& lv, int l) {
  const float g = lv.grid_size[l];
  return Level{lv.scale[l], g * g, lv.res[l], lv.rows[l], lv.tiled[l] != 0};
}

// A point's cell at one level and its fractions within it.
struct Cell {
  int ix, iy, iz;
  float rx, ry, rz;
};

__device__ __forceinline__ bool in_unit_cube(float x, float y, float z) {
  return !(x < 0.f || x > 1.f || y < 0.f || y > 1.f || z < 0.f || z > 1.f);
}

__device__ __forceinline__ Cell cell_of(float x, float y, float z,
                                        float scale) {
  // pos = x * scale + 0.5, rounded after each operation (never an FMA),
  // so floor() picks the same cell as the reference.
  const float px = __fadd_rn(__fmul_rn(x, scale), 0.5f);
  const float py = __fadd_rn(__fmul_rn(y, scale), 0.5f);
  const float pz = __fadd_rn(__fmul_rn(z, scale), 0.5f);
  const float gx = floorf(px), gy = floorf(py), gz = floorf(pz);
  return Cell{(int)gx, (int)gy, (int)gz, px - gx, py - gy, pz - gz};
}

__device__ __forceinline__ bool same_cell(const Cell& p, int ix, int iy,
                                          int iz) {
  return p.ix == ix && p.iy == iy && p.iz == iz;
}

// Corner c = (c & 1, c >> 1 & 1, c >> 2 & 1) of the unit cell.
__device__ __forceinline__ float corner_weight(const Cell& p, int c) {
  return ((c & 1) ? p.rx : 1.f - p.rx) * ((c & 2) ? p.ry : 1.f - p.ry) *
         ((c & 4) ? p.rz : 1.f - p.rz);
}

// Row of corner c of cell (ix, iy, iz) within the level's slice: uint32
// arithmetic and `% rows`, as the reference.
__device__ __forceinline__ uint32_t corner_row(int ix, int iy, int iz, int c,
                                               const Level& v) {
  const uint32_t ux = (uint32_t)(ix + (c & 1));
  const uint32_t uy = (uint32_t)(iy + ((c >> 1) & 1));
  const uint32_t uz = (uint32_t)(iz + ((c >> 2) & 1));
  const uint32_t idx =
      v.tiled ? (ux + uy * v.res + uz * v.res * v.res)
              : ((ux * 1u) ^ (uy * 2654435761u) ^ (uz * 805459861u));
  return idx % v.rows;
}

// v[0..C) = p[0..C) through the read-only cache: one vector load for C = 2
// and 4 (p is 8- or 16-byte aligned: rows of a [rows, C] float tensor whose
// start the wrapper checks).
template <int C>
__device__ __forceinline__ void load_row(const float* p, float* v) {
  if constexpr (C == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (C == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int k = 0; k < C; ++k) v[k] = __ldg(p + k);
  }
}

template <int C>
__device__ __forceinline__ void store_row(float* p, const float* v) {
  if constexpr (C == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < C; ++k) p[k] = v[k];
  }
}

// A block's level and its tile's first sample. Level-major: the tiles of
// one level in consecutive blocks; else the L levels of one tile.
struct Work {
  int l;
  int64_t b0;
};

__device__ __forceinline__ Work work_of(int64_t tiles, int L,
                                        bool level_major) {
  const int64_t i = blockIdx.x;
  if (level_major) return Work{(int)(i / tiles), (i % tiles) * blockDim.x};
  return Work{(int)(i % L), (i / L) * blockDim.x};
}

// Samples in the tile that starts at b0: blockDim.x, or fewer at the end.
__device__ __forceinline__ int tile_count(int64_t B, int64_t b0) {
  const int64_t rem = B - b0;
  return rem < (int64_t)blockDim.x ? (int)rem : (int)blockDim.x;
}

// The tile of samples [b0, b0 + cnt): x01 [cnt, n, 3] into sx and stds
// [cnt, n] into ss, consecutive threads on consecutive words.
__device__ __forceinline__ void stage_tile(const float* __restrict__ x01,
                                           const float* __restrict__ stds,
                                           int64_t b0, int cnt, int n,
                                           float* sx, float* ss) {
  const float* gx = x01 + b0 * n * 3;
  const float* gs = stds + b0 * n;
  for (int i = threadIdx.x; i < cnt * n * 3; i += blockDim.x) sx[i] = gx[i];
  for (int i = threadIdx.x; i < cnt * n; i += blockDim.x) ss[i] = gs[i];
}

// This thread's points (3n floats) and stds (n floats) in a tile of cnt
// samples starting at b0: in the staged copy at `stage`, or in device
// memory when stage is nullptr.
struct Points {
  const float* x;
  const float* s;
};

__device__ __forceinline__ Points points_of(const float* x01,
                                            const float* stds, int64_t b0,
                                            int cnt, int n,
                                            const float* stage) {
  const int t = threadIdx.x;
  if (stage != nullptr)
    return Points{stage + t * n * 3, stage + cnt * n * 3 + t * n};
  return Points{x01 + (b0 + t) * n * 3, stds + (b0 + t) * n};
}

// Adds sum_c W[c] * row_c of cell (ix, iy, iz) into acc.
template <int C>
__device__ __forceinline__ void gather_run(const float* tbl, int ix, int iy,
                                           int iz, const float* W,
                                           const Level& v, float* acc) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float row[C];
    load_row<C>(tbl + (int64_t)corner_row(ix, iy, iz, c, v) * C, row);
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] += W[c] * row[k];
  }
}

// The encode of one sample at one level, before the division by n:
// acc[k] = sum over in-range points j of erf_w_j sum_c w_jc row_c[k], each
// corner row read once per run of same-cell points. tbl: the level's slice
// of the table.
template <int C>
__device__ __forceinline__ void encode_one(const float* tbl, Points pt, int n,
                                           const Level& v, float* acc) {
  float W[8];
  int cx = 0, cy = 0, cz = 0;
  bool have = false;
  for (int j = 0; j < n; ++j) {
    const float x = pt.x[3 * j], y = pt.x[3 * j + 1], z = pt.x[3 * j + 2];
    if (!in_unit_cube(x, y, z)) continue;  // encodes to 0, breaks no run
    const float s = pt.s[j];
    const float wl = erff(1.0f / sqrtf(fmaxf(8.0f * (s * s) * v.g2, 1e-10f)));
    const Cell p = cell_of(x, y, z, v.scale);
    if (have && !same_cell(p, cx, cy, cz)) {
      gather_run<C>(tbl, cx, cy, cz, W, v, acc);
      have = false;
    }
    if (!have) {
      cx = p.ix;
      cy = p.iy;
      cz = p.iz;
      have = true;
#pragma unroll
      for (int c = 0; c < 8; ++c) W[c] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) W[c] += wl * corner_weight(p, c);
  }
  if (have) gather_run<C>(tbl, cx, cy, cz, W, v, acc);
}

template <int C>
__global__ void hash_encode_ms_kernel(const float* __restrict__ table,
                                      const float* __restrict__ x01,
                                      const float* __restrict__ stds,
                                      float* __restrict__ out, int64_t B,
                                      int n, int L, int64_t tiles,
                                      int level_major, int stage,
                                      GridLevels lv) {
  extern __shared__ __align__(16) float smem[];
  const Work w = work_of(tiles, L, level_major != 0);
  const int cnt = tile_count(B, w.b0);
  const Level v = level_of(lv, w.l);
  if (stage) {
    stage_tile(x01, stds, w.b0, cnt, n, smem, smem + cnt * n * 3);
    __syncthreads();
  }
  if ((int)threadIdx.x >= cnt) return;
  float acc[C] = {};
  encode_one<C>(table + (int64_t)lv.offset[w.l] * C,
                points_of(x01, stds, w.b0, cnt, n, stage ? smem : nullptr), n,
                v, acc);
  const int64_t b = w.b0 + threadIdx.x;
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = acc[k] / (float)n;
  store_row<C>(out + (b * L + w.l) * C, acc);
}

// dst[0..C) += v[0..C) in device memory. sm_90 adds a 2- or 4-float row in
// one vector atomic (dst must then be 8- or 16-byte aligned, which rows of
// a contiguous [rows, C] float tensor are).
template <int C>
__device__ __forceinline__ void add_row(float* dst, const float* v) {
  if constexpr (C == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (C == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int k = 0; k < C; ++k) atomicAdd(dst + k, v[k]);
  }
}

constexpr int kScatterRun = 16;  // values per lane in scatter_add_rows

// C = 1 << log2c divides 32, so value e = base + 32 j + lane has channel
// lane % C for every j.
__global__ void scatter_add_rows_kernel(const int32_t* __restrict__ idx,
                                        const float* __restrict__ vals,
                                        float* __restrict__ out, int64_t N,
                                        int log2c, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t total = N << log2c;
  const int64_t base = warp * (32 * kScatterRun);
  if (base >= total) return;  // the whole warp: shuffles below need all 32
  const int C = 1 << log2c;
  const int c = lane & (C - 1);
  int32_t cur = -1;  // the row being summed; -1 is dropped like any other
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kScatterRun; ++j) {
    const int64_t e = base + 32 * j + lane;
    if (e >= total) break;
    const int32_t r = idx[e >> log2c];
    if (r != cur) {
      if (cur >= 0 && cur < rows)
        add_row<1>(out + (int64_t)cur * C + c, &acc);
      cur = r;
      acc = 0.f;
    }
    acc += vals[e];
  }
  const int32_t r0 = __shfl_sync(0xffffffffu, cur, 0);
  if (__all_sync(0xffffffffu, cur == r0)) {
    for (int off = 16; off >= C; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane < C && r0 >= 0 && r0 < rows)
      add_row<1>(out + (int64_t)r0 * C + lane, &acc);
  } else if (cur >= 0 && cur < rows) {
    add_row<1>(out + (int64_t)cur * C + c, &acc);
  }
}

// The row updates of a run that ends: corner c of cell (ix, iy, iz) gets
// W[c] * g, where `act` says this lane has a run. All 32 lanes call
// (warp-uniform): a lane whose run is in the same cell as its left
// neighbour's joins that lane's segment, a segmented scan sums each
// segment, and its last lane adds the sum.
template <int C>
__device__ __forceinline__ void add_runs(bool act, int ix, int iy, int iz,
                                         const float* W, const float* g,
                                         float* dst, const Level& v) {
  const int lane = threadIdx.x & 31;
  const int px = __shfl_up_sync(kFullMask, ix, 1);
  const int py = __shfl_up_sync(kFullMask, iy, 1);
  const int pz = __shfl_up_sync(kFullMask, iz, 1);
  const bool pact = __shfl_up_sync(kFullMask, (int)act, 1) != 0;
  const bool head =
      lane == 0 || !act || !pact || px != ix || py != iy || pz != iz;
  const unsigned heads = __ballot_sync(kFullMask, head);
  const int start = 31 - __clz(heads & (kFullMask >> (31 - lane)));
  const bool last = act && (lane == 31 || ((heads >> (lane + 1)) & 1u));
  const bool scan = heads != kFullMask;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float u[C];
#pragma unroll
    for (int k = 0; k < C; ++k) u[k] = W[c] * g[k];
    if (scan) {
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const float t = __shfl_up_sync(kFullMask, u[k], off);
          if (lane - off >= start) u[k] += t;
        }
      }
    }
    if (last)
      add_row<C>(dst + (int64_t)corner_row(ix, iy, iz, c, v) * C, u);
  }
}

// The backward of one sample at one level. Every lane of the warp calls
// (`active`: this lane holds a sample), because add_runs shuffles.
// gp: g_out[b, l]; tbl: the level's table slice; dst: its d_table slice,
// nullptr when d_table is not wanted; dx / ds: this sample's d_x01 /
// d_stds, nullptr when not wanted.
template <int C>
__device__ __forceinline__ void backward_one(bool active, Points pt,
                                             const float* gp,
                                             const float* tbl, float* dst,
                                             float* dx, float* ds, int n,
                                             const Level& v) {
  const float inv_n = 1.0f / (float)n;
  float g[C] = {};
  if (active) load_row<C>(gp, g);
  float W[8] = {};
  int cx = 0, cy = 0, cz = 0;
  bool have = false;
  for (int j = 0; j < n; ++j) {
    float x = 0.f, y = 0.f, z = 0.f, s = 0.f;
    if (active) {
      x = pt.x[3 * j];
      y = pt.x[3 * j + 1];
      z = pt.x[3 * j + 2];
      s = pt.s[j];
    }
    // Out-of-range points are encoded to 0 by a select: no gradient.
    const bool in = active && in_unit_cube(x, y, z);
    const float u = 8.0f * (s * s) * v.g2;
    const float vs = 1.0f / sqrtf(fmaxf(u, 1e-10f));
    const float coef = erff(vs) * inv_n;  // d out[b, l] / d feat of point j
    const Cell p = cell_of(x, y, z, v.scale);
    if (dst != nullptr) {
      const bool ends = in && have && !same_cell(p, cx, cy, cz);
      if (__any_sync(kFullMask, ends))
        add_runs<C>(ends, cx, cy, cz, W, g, dst, v);
      if (ends) have = false;
      if (in) {
        if (!have) {
          cx = p.ix;
          cy = p.iy;
          cz = p.iz;
          have = true;
#pragma unroll
          for (int c = 0; c < 8; ++c) W[c] = 0.f;
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) W[c] += coef * corner_weight(p, c);
      }
    }
    if ((dx != nullptr || ds != nullptr) && in) {
      float fdot = 0.f, dfx = 0.f, dfy = 0.f, dfz = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float wx = (c & 1) ? p.rx : 1.f - p.rx;
        const float wy = (c & 2) ? p.ry : 1.f - p.ry;
        const float wz = (c & 4) ? p.rz : 1.f - p.rz;
        float row[C];
        load_row<C>(tbl + (int64_t)corner_row(p.ix, p.iy, p.iz, c, v) * C,
                    row);
        float dot = 0.f;
#pragma unroll
        for (int k = 0; k < C; ++k) dot += g[k] * row[k];
        fdot += (wx * wy * wz) * dot;
        dfx += ((c & 1) ? 1.f : -1.f) * wy * wz * dot;
        dfy += wx * ((c & 2) ? 1.f : -1.f) * wz * dot;
        dfz += wx * wy * ((c & 4) ? 1.f : -1.f) * dot;
      }
      if (dx != nullptr) {
        const float k = coef * v.scale;  // d frac / d x = scale (floor: 0)
        atomicAdd(dx + 3 * j, k * dfx);
        atomicAdd(dx + 3 * j + 1, k * dfy);
        atomicAdd(dx + 3 * j + 2, k * dfz);
      }
      if (ds != nullptr && u > 1e-10f) {
        // d erf(v) / ds with v = u^-1/2, u = 8 s^2 g^2 (0 where u is
        // clamped).
        const float dwl = 1.1283791671f * expf(-vs * vs) * (-0.5f * vs / u) *
                          (16.0f * s * v.g2);
        atomicAdd(ds + j, inv_n * dwl * fdot);
      }
    }
  }
  if (dst != nullptr && __any_sync(kFullMask, have))
    add_runs<C>(have, cx, cy, cz, W, g, dst, v);
}

template <int C>
__global__ void hash_encode_ms_bwd_kernel(
    const float* __restrict__ table, const float* __restrict__ x01,
    const float* __restrict__ stds, const float* __restrict__ g_out,
    float* __restrict__ d_table, float* __restrict__ d_x01,
    float* __restrict__ d_stds, int64_t B, int n, int L, int64_t tiles,
    int level_major, int stage, GridLevels lv) {
  extern __shared__ __align__(16) float smem[];
  const Work w = work_of(tiles, L, level_major != 0);
  const int cnt = tile_count(B, w.b0);
  const Level v = level_of(lv, w.l);
  if (stage) {
    stage_tile(x01, stds, w.b0, cnt, n, smem, smem + cnt * n * 3);
    __syncthreads();
  }
  // No early return: the lanes past B join the warp's shuffles.
  const int64_t b = w.b0 + threadIdx.x;
  const int64_t off = (int64_t)lv.offset[w.l] * C;
  backward_one<C>(
      (int)threadIdx.x < cnt,
      points_of(x01, stds, w.b0, cnt, n, stage ? smem : nullptr),
      g_out + (b * L + w.l) * C, table + off,
      d_table != nullptr ? d_table + off : nullptr,
      d_x01 != nullptr ? d_x01 + b * n * 3 : nullptr,
      d_stds != nullptr ? d_stds + b * n : nullptr, n, v);
}

void fill_levels(GridLevels* lv, int L, const float* scale,
                 const float* grid_size, const unsigned int* res,
                 const unsigned int* rows, const unsigned int* offset,
                 const int* tiled) {
  *lv = {};
  for (int l = 0; l < L; ++l) {
    lv->scale[l] = scale[l];
    lv->grid_size[l] = grid_size[l];
    lv->res[l] = res[l];
    lv->rows[l] = rows[l];
    lv->offset[l] = offset[l];
    lv->tiled[l] = tiled[l];
  }
}

// The launch of B samples x L levels in blocks of kThreads samples: `tiles`
// per level, `blocks` in all, and the shared memory of a block's staged
// tile (0: not staged). Level-major blocks stage while the tile fits
// kStageBytes.
struct Launch {
  int64_t tiles;
  unsigned blocks;
  int smem;
};

cudaError_t launch_of(int64_t B, int n, int L, int level_major, Launch* g) {
  g->tiles = (B + kThreads - 1) / kThreads;
  if (g->tiles * L > 0x7fffffff) return cudaErrorInvalidValue;
  g->blocks = (unsigned)(g->tiles * L);
  const int64_t bytes = 16LL * kThreads * n;
  g->smem = level_major && bytes <= kStageBytes ? (int)bytes : 0;
  return cudaSuccess;
}

template <int C>
cudaError_t encode(const float* table, const float* x01, const float* stds,
                   float* out, int64_t B, int n, int L, const GridLevels& lv,
                   int level_major, cudaStream_t s) {
  Launch g;
  const cudaError_t err = launch_of(B, n, L, level_major, &g);
  if (err != cudaSuccess) return err;
  hash_encode_ms_kernel<C><<<g.blocks, kThreads, g.smem, s>>>(
      table, x01, stds, out, B, n, L, g.tiles, level_major, g.smem > 0, lv);
  return cudaGetLastError();
}

template <int C>
cudaError_t backward(const float* table, const float* x01, const float* stds,
                     const float* g_out, float* d_table, float* d_x01,
                     float* d_stds, int64_t B, int n, int L,
                     const GridLevels& lv, int level_major, cudaStream_t s) {
  Launch g;
  const cudaError_t err = launch_of(B, n, L, level_major, &g);
  if (err != cudaSuccess) return err;
  hash_encode_ms_bwd_kernel<C><<<g.blocks, kThreads, g.smem, s>>>(
      table, x01, stds, g_out, d_table, d_x01, d_stds, B, n, L, g.tiles,
      level_major, g.smem > 0, lv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int nl_composite(const float* density, const float* tdist, const float* dirs,
                 const float* rgb, const float* sem, const float* inten,
                 float* weights, float* rgb_out, float* sem_out,
                 float* inten_out, float* depth_out, float* acc_out,
                 long long R, int S, int K, int opaque, float bg, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (R == 0) return cudaSuccess;
  const int threads = 128;
  const unsigned int blocks = (unsigned int)((R + threads - 1) / threads);
  composite_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      density, tdist, dirs, rgb, sem, inten, weights, rgb_out, sem_out,
      inten_out, depth_out, acc_out, R, S, K, opaque, bg);
  return cudaGetLastError();
}

// level_major: the block order (ops/grid.py:level_major).
int nl_hash_encode_ms(const float* table, const float* x01, const float* stds,
                      float* out, long long B, int n, int L, int C,
                      const float* scale, const float* grid_size,
                      const unsigned int* res, const unsigned int* rows,
                      const unsigned int* offset, const int* tiled,
                      int level_major, int device, void* stream) {
  if (L <= 0 || L > kMaxLevels || n <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  GridLevels lv;
  fill_levels(&lv, L, scale, grid_size, res, rows, offset, tiled);
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      return encode<1>(table, x01, stds, out, B, n, L, lv, level_major, s);
    case 2:
      return encode<2>(table, x01, stds, out, B, n, L, lv, level_major, s);
    case 4:
      return encode<4>(table, x01, stds, out, B, n, L, lv, level_major, s);
    // The ported presets' grids: C = 1 (proposal), 4 (NeRF), 2 (tiny_debug).
    default:
      return cudaErrorInvalidValue;
  }
}

// d_table, d_x01, d_stds: zero-filled by the caller, each nullptr when not
// wanted. level_major: the block order, as the forward's.
int nl_hash_encode_ms_bwd(const float* table, const float* x01,
                          const float* stds, const float* g_out,
                          float* d_table, float* d_x01, float* d_stds,
                          long long B, int n, int L, int C, const float* scale,
                          const float* grid_size, const unsigned int* res,
                          const unsigned int* rows,
                          const unsigned int* offset, const int* tiled,
                          int level_major, int device, void* stream) {
  if (L <= 0 || L > kMaxLevels || n <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  GridLevels lv;
  fill_levels(&lv, L, scale, grid_size, res, rows, offset, tiled);
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      return backward<1>(table, x01, stds, g_out, d_table, d_x01, d_stds, B,
                         n, L, lv, level_major, s);
    case 2:
      return backward<2>(table, x01, stds, g_out, d_table, d_x01, d_stds, B,
                         n, L, lv, level_major, s);
    case 4:
      return backward<4>(table, x01, stds, g_out, d_table, d_x01, d_stds, B,
                         n, L, lv, level_major, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// out: [rows, C], zero-filled (or holding a sum to add to) by the caller.
// C must be a power of two up to 32.
int nl_scatter_add_rows(const int* idx, const float* vals, float* out,
                        long long N, int C, long long rows, int device,
                        void* stream) {
  int log2c = 0;
  while ((1 << log2c) < C && log2c < 5) ++log2c;
  if (C <= 0 || (1 << log2c) != C) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long total = N * C;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const long long per_block = (long long)threads * kScatterRun;
  const unsigned int blocks =
      (unsigned int)((total + per_block - 1) / per_block);
  scatter_add_rows_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      idx, vals, out, N, log2c, rows);
  return cudaGetLastError();
}

}  // extern "C"
