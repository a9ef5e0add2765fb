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
//   semantic / intensity composites. Bound by device-memory bytes: every
//   input read once and every output written once, 54 MB per 16,384-ray
//   chunk at S = 32, K = 19 (0.0162 ms at 3.35 TB/s), of which the [R, S, K]
//   semantic features are 39.8 MB. Design: one warp per ray, several rays
//   per block, so a render chunk fills the card with warps:
//   - lane i takes sample i of a 32-sample chunk (S > 32 loops over chunks,
//     carrying the prefix sum): coalesced loads of density and tdist;
//   - the exclusive cumsum of sigma * dt * |d| is a warp shuffle scan, which
//     replaces the TPU's triangle matmul (the opaque +inf never enters it);
//   - the weights stay in registers: written once, summed into acc / depth
//     and the rgb / intensity composites per lane, then warp reductions;
//   - the ray's contiguous [S, K] semantic block is read one row per load
//     instruction, lane k taking channel k (neighbouring lanes on
//     neighbouring floats, so a warp load covers the row's bytes, at any K
//     and any alignment), and multiplied by the sample's weight, broadcast
//     from its lane by a shuffle. A lane loads its whole column of the
//     chunk into registers, the first 32 channels' with the chunk's other
//     loads ahead of the scan, so a warp waits for device memory once per
//     chunk at K <= 32;
//   - the channel sums of a ray carry across its chunks in shared memory.
//   Measured and dropped (PERF.md; NVIDIA H100 80GB HBM3, 700 W): the
//   column loads after the scan, with the block's lines prefetched into L2
//   first (0.0415 ms against 0.0237 at a render chunk). 16-byte loads of
//   the block are not needed: the row loads of a warp already cover whole
//   sectors, and the kernel runs at 68% of its bound on that card. The
//   features are read in the MLP's natural [R, S, C] layout; the TPU's
//   channel-major [C, R, S] stack was a lane-padding workaround and is gone.
//
// H1 hash_encode_ms: replaces the XLA gathers of
//   nerf_lidar_tpu/ops/grid.py:_ms_encode_impl (hash_encode_multisample):
//   trilinear (8 corners) or tetrahedral (the 4 vertices of the point's
//   Kuhn simplex) interpolation, C = 1, 2, 4 or 16 channels, and levels at
//   or below the coarse cutoff that encode each sample's mean point once
//   with the mean erf weight (the presets'). Bound by table reads: up to 8
//   corners x n multisamples x L levels per sample, at random rows of
//   tables up to 240 MB (larger than the 50 MB L2). Design, one thread per
//   (sample, level):
//   - corner-run merge: at the coarse levels the n multisamples of a sample
//     mostly share one cell, so while a point's integer cell equals the
//     previous in-range point's, its erf-weighted trilinear weights add into
//     8 per-corner sums, and each corner row is read once per run;
//   - a row is one float4 (C4), float2 (C2) or four float4 (C16) loads
//     through __ldg; with tetra the run's weights W[8] stay per cube corner
//     (a corner is vertex popcount(c) of a simplex or no vertex), and only
//     the corners some point of the run weights are read;
//   - a mean-point level is one run of one point; cells, fractions, ranks
//     and means are rounded as the plain version rounds them (one FMA for
//     x * scale + 0.5, a mean as a sum times float(1 / n)), so both pick
//     the same corners;
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
//   device memory with atomics. Bound by bytes: idx and vals read once
//   (0.0895 ms for the NeRF grid's hash-decay level sums, 300 MB), as long
//   as the atomics stay off the critical path. Same-address atomics
//   serialise at the L2, and the hash-decay segment sum puts a whole level
//   of up to 2^21 sorted rows on one output row. Design:
//   - a grid of a few blocks per SM (as many as fit at once), each walking
//     one contiguous chunk of the flattened [N, C] vals, so a sorted
//     segment is split across few blocks;
//   - 16-byte loads: a float4 of vals is 4 channels of one row for C >= 4
//     (the C / 4 threads of a row read its index in one transaction of
//     their warp), or 2 / 4 whole rows for C = 2 / 1, whose indices come as
//     one int2 / int4; the N * C % 4 values past the last float4 take
//     scalar atomics;
//   - a thread sums in registers while its row stays the same, across
//     tiles, and adds a finished run with one vector atomic (add_row:
//     float4 / float2 on sm_90, scalar for C = 1);
//   - at the end of its chunk a block sums the runs still open on the
//     chunk's last row (warp shuffles, then shared memory) and adds them
//     once per channel group. A sorted segment thus costs O(blocks)
//     atomics; random rows cost one vector atomic per 16 bytes.
//   vals and idx must start on 16 bytes (the wrapper refuses others).
//   Indices outside [0, rows) are dropped, as the one-hot drops them.
//
// H1 backward hash_encode_ms_bwd: the gradient of hash_encode_ms, which JAX
//   gets by autodiff through the gathers of _ms_encode_impl
//   (diff_inputs=True) or from _ms_encode_nodiff_bwd (diff_inputs=False:
//   d_table alone). d_table: every in-range corner adds
//   w_corner * erf_w / n * g_out[b, l] to its row (a mean-point level:
//   w_corner * w_mean * g_out[b, l] at the mean point). d_x01 / d_stds
//   (only when asked for): the derivative of the trilinear or simplex
//   weights (the sorted fractions' gradients with JAX's rule at ties)
//   times scale_l, and of the erf weight, each against <g_out, corner
//   row>, per point (a mean-point level: 1 / n of the mean's to each
//   point), summed over the levels with atomics. Bound by table atomics, and at the
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
//
// Deterministic variants (torch.are_deterministic_algorithms_enabled(); the
//   JAX package's scatter-adds are XLA's, whose sums do not depend on the
//   run): hash_encode_ms_bwd_fixed (d_table), hash_encode_ms_pos_grads
//   (d_x01 / d_stds) and scatter_add_rows_fixed (K3), then fixed_to_float.
//   A float sum depends on its order; an integer sum does not. So every
//   term is rounded once to a fixed-point int64, u * 2^k[g, c] to the
//   nearest integer, and all sums after that are exact: the results are
//   the same bits whatever the order of the atomics, the block order or
//   the block size. The caller picks k[g, c] = 62 - ceil(log2 S[g, c])
//   from S = the sum of |g_out| (H1-bwd, per level g and channel c) or of
//   |vals| (K3, per channel) over the finite entries: each term of an
//   entry of group g is at most |that g_out| (the corner weights of a
//   point times its erf weight / n sum to at most 1), so the entries of a
//   group sum to at most S * 2^k <= 2^62 and no int64 overflows. A
//   non-finite term adds nothing and sets its entry's NaN / +inf / -inf
//   flag (an atomicOr, which no order changes); fixed_to_float then writes
//   NaN (NaN, or both infinities), +-inf, or the sum times 2^-k, which is
//   what a float sum of the same terms gives. Design:
//   - H1-bwd keeps its threads, block orders, corner-run merge and warp
//     aggregation: a thread rounds its own run's merged corner value once,
//     before any cross-lane sum (so no sum depends on which lanes share a
//     warp), then the segmented scan and the row atomics run on int64
//     (scalar atomics: C per row where the float path takes one vector);
//   - d_x01 / d_stds are a gather, not a scatter: one thread per sample
//     walks the levels in order, reads the corner rows as H1 does, and
//     sums its n points' gradients in shared-memory slots of its own,
//     written once; float sums in a fixed order, no atomics;
//   - K3 keeps its tiling, with each value rounded as it is loaded and the
//     runs summed in int64 registers, shuffles and shared memory.
//   Bound as the float kernels (table / output atomics), plus the int64
//   accumulator (8 bytes an entry) written and read once more by
//   fixed_to_float.

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
  int mean[kMaxLevels];         // 1: encode the multisample mean point
};

// Rays (warps) of a block of K1, as long as their channel sums fit.
constexpr int kCompositeWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// col[j] = channel k of row j of a chunk's semantic rows p ([n, K]), 0 past
// them.
__device__ __forceinline__ void load_column(float (&col)[32], const float* p,
                                            int K, int k, int n) {
#pragma unroll
  for (int j = 0; j < 32; ++j)
    col[j] = (k < K && j < n) ? p[(size_t)j * K + k] : 0.f;
}

// One warp per ray: blockDim.x / 32 rays a block. Shared memory: K floats a
// warp, the ray's semantic sums across its 32-sample chunks.
__global__ void composite_kernel(
    const float* __restrict__ density, const float* __restrict__ tdist,
    const float* __restrict__ dirs, const float* __restrict__ rgb,
    const float* __restrict__ sem, const float* __restrict__ inten,
    float* __restrict__ weights, float* __restrict__ rgb_out,
    float* __restrict__ sem_out, float* __restrict__ inten_out,
    float* __restrict__ depth_out, float* __restrict__ acc_out, int64_t R,
    int S, int K, int opaque, float bg) {
  extern __shared__ float s_sem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= R) return;  // the whole warp: r is the same on every lane
  float* sem_sum = s_sem + (size_t)warp * K;
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  const size_t ray = (size_t)r * S;
  const float* t_r = tdist + (size_t)r * (S + 1);

  float carry = 0.f, acc = 0.f, dsum = 0.f, isum = 0.f;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
  for (int base = 0; base < S; base += 32) {
    const int n = min(32, S - base);
    const int i = base + lane;
    const bool live = lane < n;
    const float* sem_c = sem + (ray + base) * K;
    // Every load of the chunk ahead of the scan: this lane's sample, and
    // channel `lane`'s column of the chunk's semantic rows.
    float col[32];
    load_column(col, sem_c, K, lane, n);
    float t0 = 0.f, t1 = 0.f, sigma = 0.f, f0 = 0.f, f1 = 0.f, f2 = 0.f;
    float fi = 0.f;
    if (live) {
      t0 = t_r[i];
      t1 = t_r[i + 1];
      sigma = density[ray + i];
      const float* c = rgb + 3 * (ray + i);
      f0 = c[0];
      f1 = c[1];
      f2 = c[2];
      if (inten != nullptr) fi = inten[ray + i];
    }
    const float dd = live ? sigma * ((t1 - t0) * dnorm) : 0.f;
    // Inclusive scan of dd over the lanes, then shifted by one lane.
    float inc = dd;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kFullMask, inc, o);
      if (lane >= o) inc += u;
    }
    float excl = __shfl_up_sync(kFullMask, inc, 1);
    if (lane == 0) excl = 0.f;
    const float csum = carry + excl;
    carry += __shfl_sync(kFullMask, inc, 31);

    float w = 0.f;
    if (live) {
      const float alpha = (opaque && i == S - 1) ? 1.f : 1.f - expf(-dd);
      w = alpha * expf(-csum);
      weights[ray + i] = w;
      acc += w;
      dsum += w * (0.5f * (t0 + t1));
      c0 += w * f0;
      c1 += w * f1;
      c2 += w * f2;
      isum += w * fi;
    }
    // Semantic rows: lane k takes channel k (k0 + lane for K > 32, whose
    // columns load after the scan).
    for (int k0 = 0; k0 < K; k0 += 32) {
      if (k0 > 0) load_column(col, sem_c, K, k0 + lane, n);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) s += __shfl_sync(kFullMask, w, j) * col[j];
      float* sum = sem_sum + k0 + lane;
      if (k0 + lane < K) *sum = base == 0 ? s : *sum + s;
    }
  }
  acc = warp_sum(acc);
  dsum = warp_sum(dsum);
  c0 = warp_sum(c0);
  c1 = warp_sum(c1);
  c2 = warp_sum(c2);
  if (inten_out != nullptr) isum = warp_sum(isum);
  if (lane == 0) {
    const float bg_w = fmaxf(1.f - acc, 0.f);
    rgb_out[3 * r] = c0 + bg_w * bg;
    rgb_out[3 * r + 1] = c1 + bg_w * bg;
    rgb_out[3 * r + 2] = c2 + bg_w * bg;
    depth_out[r] = dsum / fmaxf(acc, kEps);
    acc_out[r] = acc;
    if (inten_out != nullptr) inten_out[r] = isum;
  }
  // Each lane reads back only the sums it wrote.
  for (int k = lane; k < K; k += 32) sem_out[(size_t)r * K + k] = sem_sum[k];
}

// One level's constants, as a thread uses them.
struct Level {
  float scale, g2;
  uint32_t res, rows;
  bool tiled, mean;
};

__device__ __forceinline__ Level level_of(const GridLevels& lv, int l) {
  const float g = lv.grid_size[l];
  return Level{lv.scale[l], g * g,          lv.res[l],
               lv.rows[l],  lv.tiled[l] != 0, lv.mean[l] != 0};
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
  // pos = x * scale + 0.5 with one rounding (a fused multiply-add), as the
  // plain version (ops/grid.py:grid_pos) and XLA's CPU code take it, so
  // floor() picks the same cell and the fractions (and the tetrahedral
  // ranks) agree to the bit.
  const float px = __fmaf_rn(x, scale, 0.5f);
  const float py = __fmaf_rn(y, scale, 0.5f);
  const float pz = __fmaf_rn(z, scale, 0.5f);
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

// The Kuhn simplex of the cell that holds a point (tetrahedral
// interpolation, the JAX `_corner_list`): each axis' rank (0 = largest
// fraction, ties broken by axis order as the JAX code does) and the vertex
// weights 1 - s1, s1 - s2, s2 - s3, s3 of the sorted fractions, s2 summed
// in the JAX order.
struct Simplex {
  int r[3];
  float w[4];
};

__device__ __forceinline__ Simplex simplex_of(const Cell& p) {
  const float fx = p.rx, fy = p.ry, fz = p.rz;
  Simplex t;
  t.r[0] = (fy > fx) + (fz > fx);
  t.r[1] = (fx >= fy) + (fz > fy);
  t.r[2] = (fx >= fz) + (fy >= fz);
  const float s1 = fmaxf(fmaxf(fx, fy), fz);
  const float s3 = fminf(fminf(fx, fy), fz);
  const float s2 =
      __fsub_rn(__fsub_rn(__fadd_rn(__fadd_rn(fx, fy), fz), s1), s3);
  t.w[0] = 1.f - s1;
  t.w[1] = s1 - s2;
  t.w[2] = s2 - s3;
  t.w[3] = s3;
  return t;
}

// Vertex k of the simplex: the corner that steps along the axes ranked
// below k.
__device__ __forceinline__ int vertex_corner(const Simplex& t, int k) {
  return (t.r[0] < k) | ((t.r[1] < k) << 1) | ((t.r[2] < k) << 2);
}

// W[c] += a * (weight of corner c) for one point: the 8 trilinear weights,
// or the 4 simplex weights (corner c is vertex popcount(c) or none). c is
// a constant in each unrolled step, so W stays in registers.
template <bool kTetra>
__device__ __forceinline__ void add_weights(const Cell& p, float a,
                                            float* W) {
  if constexpr (kTetra) {
    const Simplex t = simplex_of(p);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int k = (c & 1) + ((c >> 1) & 1) + ((c >> 2) & 1);
      if (vertex_corner(t, k) == c) W[c] += a * t.w[k];
    }
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) W[c] += a * corner_weight(p, c);
  }
}

// d s / d (fx, fy, fz) for s = op(op(fx, fy), fz), op = max (kMax) or
// min, by the rule of JAX's (and torch's) max / min gradient: an input
// equal to the result takes 1, or 0.5 when the other input equals it too.
__device__ __forceinline__ float tie_share(float a, float b, float m) {
  return a == m ? (b == m ? 0.5f : 1.f) : 0.f;
}

template <bool kMax>
__device__ __forceinline__ void sorted_grad(const Cell& p, float* d) {
  const float m = kMax ? fmaxf(p.rx, p.ry) : fminf(p.rx, p.ry);
  const float s = kMax ? fmaxf(m, p.rz) : fminf(m, p.rz);
  const float dm = tie_share(m, p.rz, s);
  d[0] = tie_share(p.rx, p.ry, m) * dm;
  d[1] = tie_share(p.ry, p.rx, m) * dm;
  d[2] = tie_share(p.rz, m, s);
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
  } else if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) load_row<4>(p + 4 * q, v + 4 * q);
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
  } else if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) store_row<4>(p + 4 * q, v + 4 * q);
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

// Adds sum_c W[c] * row_c of cell (ix, iy, iz) into acc. With tetra only
// the corners of some point's simplex carry a weight: the others are not
// read.
template <int C, bool kTetra>
__device__ __forceinline__ void gather_run(const float* tbl, int ix, int iy,
                                           int iz, const float* W,
                                           const Level& v, float* acc) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (kTetra && W[c] == 0.f) continue;
    float row[C];
    load_row<C>(tbl + (int64_t)corner_row(ix, iy, iz, c, v) * C, row);
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] += W[c] * row[k];
  }
}

// The erf downweighting of a point with std s at one level.
__device__ __forceinline__ float erf_weight(float s, const Level& v) {
  return erff(1.0f / sqrtf(fmaxf(8.0f * (s * s) * v.g2, 1e-10f)));
}

// The encode of one sample at one level, before the division by n:
// acc[k] = sum over in-range points j of erf_w_j sum_c w_jc row_c[k], each
// corner row read once per run of same-cell points. tbl: the level's slice
// of the table.
template <int C, bool kTetra>
__device__ __forceinline__ void encode_one(const float* tbl, Points pt, int n,
                                           const Level& v, float* acc) {
  float W[8];
  int cx = 0, cy = 0, cz = 0;
  bool have = false;
  for (int j = 0; j < n; ++j) {
    const float x = pt.x[3 * j], y = pt.x[3 * j + 1], z = pt.x[3 * j + 2];
    if (!in_unit_cube(x, y, z)) continue;  // encodes to 0, breaks no run
    const float wl = erf_weight(pt.s[j], v);
    const Cell p = cell_of(x, y, z, v.scale);
    if (have && !same_cell(p, cx, cy, cz)) {
      gather_run<C, kTetra>(tbl, cx, cy, cz, W, v, acc);
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
    add_weights<kTetra>(p, wl, W);
  }
  if (have) gather_run<C, kTetra>(tbl, cx, cy, cz, W, v, acc);
}

// A sample's mean point (its n points, out-of-range ones included, summed
// in order and times float(1 / n), as the plain version takes it) and its
// mean erf weight at one level.
struct MeanPoint {
  float x, y, z, w;
};

__device__ __forceinline__ MeanPoint mean_of(Points pt, int n,
                                             const Level& v) {
  float x = 0.f, y = 0.f, z = 0.f, w = 0.f;
  for (int j = 0; j < n; ++j) {
    x = __fadd_rn(x, pt.x[3 * j]);
    y = __fadd_rn(y, pt.x[3 * j + 1]);
    z = __fadd_rn(z, pt.x[3 * j + 2]);
    w = __fadd_rn(w, erf_weight(pt.s[j], v));
  }
  const float r = __fdiv_rn(1.0f, (float)n);
  return MeanPoint{__fmul_rn(x, r), __fmul_rn(y, r), __fmul_rn(z, r),
                   __fmul_rn(w, r)};
}

// A mean-point level (resolution at or below the coarse cutoff): the mean
// point encoded once with the mean erf weight; 0 when it is out of range.
template <int C, bool kTetra>
__device__ __forceinline__ void encode_mean(const float* tbl, Points pt,
                                            int n, const Level& v,
                                            float* acc) {
  const MeanPoint m = mean_of(pt, n, v);
  if (!in_unit_cube(m.x, m.y, m.z)) return;
  const Cell p = cell_of(m.x, m.y, m.z, v.scale);
  float W[8] = {};
  add_weights<kTetra>(p, m.w, W);
  gather_run<C, kTetra>(tbl, p.ix, p.iy, p.iz, W, v, acc);
}

template <int C, bool kTetra>
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
  const float* tbl = table + (int64_t)lv.offset[w.l] * C;
  const Points pt = points_of(x01, stds, w.b0, cnt, n, stage ? smem : nullptr);
  if (v.mean) {
    encode_mean<C, kTetra>(tbl, pt, n, v, acc);
  } else {
    encode_one<C, kTetra>(tbl, pt, n, v, acc);
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] = acc[k] / (float)n;
  }
  const int64_t b = w.b0 + threadIdx.x;
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
  } else if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) add_row<4>(dst + 4 * q, v + 4 * q);
  } else if constexpr (C == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int k = 0; k < C; ++k) atomicAdd(dst + k, v[k]);
  }
}

// The non-finite flags of the deterministic kernels: 4 bits an entry of a
// [rows, C] output, 8 entries a word.
constexpr unsigned kFlagNaN = 1u, kFlagPosInf = 2u, kFlagNegInf = 4u;

__device__ __forceinline__ void mark_nonfinite(unsigned* flags, int64_t e,
                                               float u) {
  const unsigned f = isnan(u) ? kFlagNaN : (u > 0.f ? kFlagPosInf
                                                    : kFlagNegInf);
  atomicOr(flags + (e >> 3), f << (4 * (e & 7)));
}

// u * 2^k rounded to the nearest int64 (ties to even): one rounding, since
// scaling by a power of two is exact here (|u| * 2^k <= 2^62).
__device__ __forceinline__ long long to_fixed(float u, int k) {
  return __float2ll_rn(ldexpf(u, k));
}

// Where add_runs puts a segment's sum for one corner row: a float atomic on
// d_table (the default kernel), or exact int64 atomics on an accumulator of
// fixed-point terms (the deterministic one). term() is called by every lane
// of the warp; `act` says its run ends here.
template <int C>
struct FloatRows {
  using T = float;
  float* dst;  // the level's d_table slice; nullptr: d_table not wanted
  __device__ __forceinline__ bool on() const { return dst != nullptr; }
  template <class Row>
  __device__ __forceinline__ T term(float w, float g, bool, int,
                                    Row) const {
    return w * g;
  }
  __device__ __forceinline__ void add(uint32_t row, const T* u) const {
    add_row<C>(dst + (int64_t)row * C, u);
  }
};

template <int C, bool kTetra>
struct FixedRows {
  using T = long long;
  unsigned long long* acc;  // the level's slice of the [rows, C] sums
  unsigned* flags;          // the whole table's flags
  int64_t base;             // the level's first entry, offset * C
  int k[C];                 // the level's exponent per channel
  __device__ __forceinline__ bool on() const { return true; }
  // With tetra a weight of 0 is a corner that no point of the run reaches
  // (or a simplex vertex of weight 0): it adds nothing, also against a
  // non-finite g. Trilinear corners are all terms, as in JAX.
  template <class Row>
  __device__ __forceinline__ T term(float w, float g, bool act, int ch,
                                    Row row) const {
    if (kTetra && w == 0.f) return 0;
    const float u = w * g;
    if (isfinite(u)) return to_fixed(u, k[ch]);
    if (act) mark_nonfinite(flags, base + (int64_t)row() * C + ch, u);
    return 0;
  }
  __device__ __forceinline__ void add(uint32_t row, const T* q) const {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (q[c] != 0)
        atomicAdd(acc + (int64_t)row * C + c, (unsigned long long)q[c]);
  }
};

// K3's block, and the float4s of vals a thread loads before it sums them.
constexpr int kScatterThreads = 256;
constexpr int kScatterUnroll = 4;

// How K3 cuts the flattened [N, C] vals into float4s: for C >= 4 a float4
// is kW = 4 channels of one row and a row spans kG float4s; for C = 1 and 2
// it is kP = 4 / C whole rows of kW = C channels.
template <int C>
struct ScatterTile {
  static constexpr int kW = C < 4 ? C : 4;
  static constexpr int kP = 4 / kW;
  static constexpr int kG = C < 4 ? 1 : C / 4;
};

// r[0..kP): the rows of float4 v of vals. For C >= 4 the kG threads of a
// row read the same index, which their warp fetches once.
template <int C>
__device__ __forceinline__ void rows_of(const int32_t* idx, int64_t v,
                                        int* r) {
  if constexpr (C == 1) {
    const int4 t = __ldcs(reinterpret_cast<const int4*>(idx) + v);
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else if constexpr (C == 2) {
    const int2 t = __ldcs(reinterpret_cast<const int2*>(idx) + v);
    r[0] = t.x; r[1] = t.y;
  } else {
    r[0] = __ldcs(idx + v / ScatterTile<C>::kG);
  }
}

// How K3 sums: the values with float atomics (the default), or each value
// rounded to fixed point (channel c at 2^k[c]) and summed in int64 (the
// deterministic variant; a non-finite value adds nothing and flags its
// entry). term(v, row, channel) is a value's summand, add<W>(e, s) adds W
// channels of sums at entry e of the [rows, C] output.
template <int C>
struct FloatSums {
  using T = float;
  float* out;
  __device__ __forceinline__ T term(float v, int, int) const { return v; }
  template <int W>
  __device__ __forceinline__ void add(int64_t e, const T* s) const {
    add_row<W>(out + e, s);
  }
};

template <int C>
struct FixedSums {
  using T = long long;
  unsigned long long* out;
  unsigned* flags;
  const int* k;  // [C]
  int64_t rows;
  __device__ __forceinline__ T term(float v, int r, int ch) const {
    if (isfinite(v)) return to_fixed(v, __ldg(k + ch));
    if (r >= 0 && r < rows) mark_nonfinite(flags, (int64_t)r * C + ch, v);
    return 0;
  }
  template <int W>
  __device__ __forceinline__ void add(int64_t e, const T* s) const {
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (s[i] != 0) atomicAdd(out + e + i, (unsigned long long)s[i]);
  }
};

// Adds a run's sum v[0..kW) to channels [ch, ch + kW) of row r; rows
// outside [0, rows) are dropped.
template <int C, class Sums>
__device__ __forceinline__ void add_run(const Sums& out, int r, int64_t rows,
                                        int ch, const typename Sums::T* v) {
  if (r >= 0 && r < rows)
    out.template add<ScatterTile<C>::kW>((int64_t)r * C + ch, v);
}

// Block b sums float4s [b * chunk, min((b + 1) * chunk, V)) of vals, thread
// t the float4s t, t + kScatterThreads, ... of it. chunk is a multiple of
// kScatterThreads, so for C >= 4 a thread's float4s are all of channel
// group t % kG. The last block also adds the `tail` values past float4 V.
template <int C, class Sums>
__global__ void __launch_bounds__(kScatterThreads)
    scatter_add_rows_kernel(const int32_t* __restrict__ idx,
                            const float* __restrict__ vals, Sums out,
                            int64_t V, int64_t chunk, int tail,
                            int64_t rows) {
  using Tile = ScatterTile<C>;
  using T = typename Sums::T;
  constexpr int kW = Tile::kW, kP = Tile::kP, kG = Tile::kG;
  constexpr int kWarps = kScatterThreads / 32;
  __shared__ T part[kWarps][kG * kW];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (blockIdx.x == gridDim.x - 1 && t < tail) {
    const int64_t e = 4 * V + t;
    const int r = __ldg(idx + e / C);
    const T v = out.term(__ldg(vals + e), r, (int)(e % C));
    if (r >= 0 && r < rows) out.template add<1>((int64_t)r * C + e % C, &v);
  }
  const int64_t v0 = (int64_t)blockIdx.x * chunk;
  const int64_t v1 = v0 + chunk < V ? v0 + chunk : V;
  if (v1 <= v0) return;  // the whole block: no float4 in its chunk
  const float4* vals4 = reinterpret_cast<const float4*>(vals);
  const int ch = (t % kG) * kW;
  int cur = -1;  // the row being summed; -1 is dropped like any other
  T acc[kW] = {};
  for (int64_t base = v0 + t; base < v1;
       base += kScatterUnroll * kScatterThreads) {
    // All loads of the tile first, then the sums and atomics.
    float4 x[kScatterUnroll];
    int r[kScatterUnroll][kP];
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u) {
      const int64_t v = base + u * kScatterThreads;
      if (v < v1) {
        x[u] = __ldcs(vals4 + v);
        rows_of<C>(idx, v, r[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u) {
      if (base + u * kScatterThreads >= v1) continue;
      const float f[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        if (r[u][p] != cur) {
          add_run<C>(out, cur, rows, ch, acc);
          cur = r[u][p];
#pragma unroll
          for (int k = 0; k < kW; ++k) acc[k] = 0;
        }
#pragma unroll
        for (int k = 0; k < kW; ++k)
          acc[k] += out.term(f[p * kW + k], r[u][p], ch + k);
      }
    }
  }
  // The runs still open. Those on the chunk's last row (all of them, on
  // sorted rows) are summed per channel group: across the lanes of a group
  // (kG apart) by shuffles, then across warps in shared memory, and added
  // once. Any other adds its own.
  const int last = __ldg(idx + (4 * v1 - 1) / C);
  const bool mine = cur == last;
  if (!mine) add_run<C>(out, cur, rows, ch, acc);
  T s[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) s[k] = mine ? acc[k] : T(0);
#pragma unroll
  for (int off = 16; off >= kG; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kW; ++k) s[k] += __shfl_xor_sync(kFullMask, s[k], off);
  }
  if (lane < kG) {
#pragma unroll
    for (int k = 0; k < kW; ++k) part[warp][lane * kW + k] = s[k];
  }
  __syncthreads();
  if (t < kG) {
    T sum[kW] = {};
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int k = 0; k < kW; ++k) sum[k] += part[w][t * kW + k];
    }
    add_run<C>(out, last, rows, t * kW, sum);
  }
}

// The row updates of a run that ends: corner c of cell (ix, iy, iz) gets
// W[c] * g, where `act` says this lane has a run. All 32 lanes call
// (warp-uniform): a lane whose run is in the same cell as its left
// neighbour's joins that lane's segment, a segmented scan sums each
// segment (of Rows::T: float, or the int64 of each lane's fixed-point
// term), and its last lane adds the sum. With tetra a corner that no lane's
// run weights is skipped, and a segment whose sum is 0 adds nothing.
template <int C, bool kTetra, class Rows>
__device__ __forceinline__ void add_runs(bool act, int ix, int iy, int iz,
                                         const float* W, const float* g,
                                         const Rows& rows, const Level& v) {
  using T = typename Rows::T;
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
    if (kTetra && !__any_sync(kFullMask, act && W[c] != 0.f)) continue;
    const auto row = [&] { return corner_row(ix, iy, iz, c, v); };
    T u[C];
#pragma unroll
    for (int k = 0; k < C; ++k) u[k] = rows.term(W[c], g[k], act, k, row);
    if (scan) {
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const T t = __shfl_up_sync(kFullMask, u[k], off);
          if (lane - off >= start) u[k] += t;
        }
      }
    }
    bool add = last;
    if (kTetra && add) {
      add = false;
#pragma unroll
      for (int k = 0; k < C; ++k) add |= u[k] != T(0);
    }
    if (add) rows.add(row(), u);
  }
}

// <g, feature> (fdot) and <g, d feature / d frac> (df[3]) of a point in
// cell p, from the rows of its interpolation corners: the derivative of
// the trilinear weights, or of the simplex weights (the sorted fractions'
// gradients with JAX's rule at ties, as the plain version takes them).
template <int C, bool kTetra>
__device__ __forceinline__ void point_grads(const float* tbl, const Cell& p,
                                            const float* g, const Level& v,
                                            float& fdot, float* df) {
  fdot = 0.f;
  df[0] = df[1] = df[2] = 0.f;
  if constexpr (kTetra) {
    const Simplex t = simplex_of(p);
    float d1[3], d3[3];
    sorted_grad<true>(p, d1);
    sorted_grad<false>(p, d3);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float row[C];
      load_row<C>(tbl + (int64_t)corner_row(p.ix, p.iy, p.iz,
                                            vertex_corner(t, k), v) * C,
                  row);
      float dot = 0.f;
#pragma unroll
      for (int q = 0; q < C; ++q) dot += g[q] * row[q];
      fdot += t.w[k] * dot;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float d2 = 1.f - d1[d] - d3[d];
        const float dw = k == 0   ? -d1[d]
                         : k == 1 ? d1[d] - d2
                         : k == 2 ? d2 - d3[d]
                                  : d3[d];
        df[d] += dw * dot;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float wx = (c & 1) ? p.rx : 1.f - p.rx;
      const float wy = (c & 2) ? p.ry : 1.f - p.ry;
      const float wz = (c & 4) ? p.rz : 1.f - p.rz;
      float row[C];
      load_row<C>(tbl + (int64_t)corner_row(p.ix, p.iy, p.iz, c, v) * C, row);
      float dot = 0.f;
#pragma unroll
      for (int q = 0; q < C; ++q) dot += g[q] * row[q];
      fdot += (wx * wy * wz) * dot;
      df[0] += ((c & 1) ? 1.f : -1.f) * wy * wz * dot;
      df[1] += wx * ((c & 2) ? 1.f : -1.f) * wz * dot;
      df[2] += wx * wy * ((c & 4) ? 1.f : -1.f) * dot;
    }
  }
}

// d erf_weight / ds at std s (0 where the weight's argument is clamped).
__device__ __forceinline__ float erf_weight_grad(float s, const Level& v) {
  const float u = 8.0f * (s * s) * v.g2;
  if (!(u > 1e-10f)) return 0.f;
  // v = u^-1/2, u = 8 s^2 g^2.
  const float vs = 1.0f / sqrtf(u);
  return 1.1283791671f * expf(-vs * vs) * (-0.5f * vs / u) *
         (16.0f * s * v.g2);
}

// The backward of one sample at one level. Every lane of the warp calls
// (`active`: this lane holds a sample), because add_runs shuffles.
// g: g_out[b, l]; tbl: the level's table slice; rows: where its d_table
// updates go (rows.on() false when d_table is not wanted); dx / ds: this
// sample's d_x01 / d_stds, nullptr when not wanted.
template <int C, bool kTetra, class Rows>
__device__ __forceinline__ void backward_one(bool active, Points pt,
                                             const float* g,
                                             const float* tbl,
                                             const Rows& rows, float* dx,
                                             float* ds, int n,
                                             const Level& v) {
  const float inv_n = 1.0f / (float)n;
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
    const float coef = erf_weight(s, v) * inv_n;  // d out / d feat of j
    const Cell p = cell_of(x, y, z, v.scale);
    if (rows.on()) {
      const bool ends = in && have && !same_cell(p, cx, cy, cz);
      if (__any_sync(kFullMask, ends))
        add_runs<C, kTetra>(ends, cx, cy, cz, W, g, rows, v);
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
        add_weights<kTetra>(p, coef, W);
      }
    }
    if ((dx != nullptr || ds != nullptr) && in) {
      float fdot, df[3];
      point_grads<C, kTetra>(tbl, p, g, v, fdot, df);
      if (dx != nullptr) {
        const float k = coef * v.scale;  // d frac / d x = scale (floor: 0)
        atomicAdd(dx + 3 * j, k * df[0]);
        atomicAdd(dx + 3 * j + 1, k * df[1]);
        atomicAdd(dx + 3 * j + 2, k * df[2]);
      }
      if (ds != nullptr) atomicAdd(ds + j, inv_n * erf_weight_grad(s, v) * fdot);
    }
  }
  if (rows.on() && __any_sync(kFullMask, have))
    add_runs<C, kTetra>(have, cx, cy, cz, W, g, rows, v);
}

// The backward of a mean-point level: the mean point's corners get
// w_mean * weight * g (one run; neighbouring lanes in the same cell are
// merged by add_runs), and each of the n points 1/n of the mean's position
// and weight gradients. Warp-uniform, as backward_one.
template <int C, bool kTetra, class Rows>
__device__ __forceinline__ void backward_mean(bool active, Points pt,
                                              const float* g,
                                              const float* tbl,
                                              const Rows& rows, float* dx,
                                              float* ds, int n,
                                              const Level& v) {
  MeanPoint m{0.f, 0.f, 0.f, 0.f};
  if (active) m = mean_of(pt, n, v);
  const bool in = active && in_unit_cube(m.x, m.y, m.z);
  const Cell p = cell_of(m.x, m.y, m.z, v.scale);
  if (rows.on() && __any_sync(kFullMask, in)) {
    float W[8] = {};
    if (in) add_weights<kTetra>(p, m.w, W);
    add_runs<C, kTetra>(in, p.ix, p.iy, p.iz, W, g, rows, v);
  }
  if ((dx == nullptr && ds == nullptr) || !in) return;
  const float fn = (float)n;
  float fdot, df[3];
  point_grads<C, kTetra>(tbl, p, g, v, fdot, df);
  const float k = m.w / fn * v.scale;
  const float fd = fdot / fn;
  for (int j = 0; j < n; ++j) {
    if (dx != nullptr) {
      atomicAdd(dx + 3 * j, k * df[0]);
      atomicAdd(dx + 3 * j + 1, k * df[1]);
      atomicAdd(dx + 3 * j + 2, k * df[2]);
    }
    if (ds != nullptr) atomicAdd(ds + j, erf_weight_grad(pt.s[j], v) * fd);
  }
}

template <int C, bool kTetra>
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
  const bool active = (int)threadIdx.x < cnt;
  const int64_t b = w.b0 + threadIdx.x;
  const int64_t off = (int64_t)lv.offset[w.l] * C;
  float g[C] = {};
  if (active) load_row<C>(g_out + (b * L + w.l) * C, g);
  const Points pt = points_of(x01, stds, w.b0, cnt, n, stage ? smem : nullptr);
  const FloatRows<C> rows{d_table != nullptr ? d_table + off : nullptr};
  float* dx = d_x01 != nullptr ? d_x01 + b * n * 3 : nullptr;
  float* ds = d_stds != nullptr ? d_stds + b * n : nullptr;
  if (v.mean)
    backward_mean<C, kTetra>(active, pt, g, table + off, rows, dx, ds, n, v);
  else
    backward_one<C, kTetra>(active, pt, g, table + off, rows, dx, ds, n, v);
}

// The deterministic d_table: hash_encode_ms_bwd_kernel's threads, block
// order and run merge, with each lane's merged corner values rounded to
// fixed point (k: [L, C] exponents) and summed into acc ([rows, C] int64)
// and flags (the non-finite terms). d_x01 / d_stds: pos_grads_kernel.
template <int C, bool kTetra>
__global__ void hash_encode_ms_bwd_fixed_kernel(
    const float* __restrict__ x01, const float* __restrict__ stds,
    const float* __restrict__ g_out, const int* __restrict__ k,
    unsigned long long* __restrict__ acc, unsigned* __restrict__ flags,
    int64_t B, int n, int L, int64_t tiles, int level_major, int stage,
    GridLevels lv) {
  extern __shared__ __align__(16) float smem[];
  const Work w = work_of(tiles, L, level_major != 0);
  const int cnt = tile_count(B, w.b0);
  const Level v = level_of(lv, w.l);
  if (stage) {
    stage_tile(x01, stds, w.b0, cnt, n, smem, smem + cnt * n * 3);
    __syncthreads();
  }
  const bool active = (int)threadIdx.x < cnt;
  const int64_t b = w.b0 + threadIdx.x;
  const int64_t off = (int64_t)lv.offset[w.l] * C;
  float g[C] = {};
  if (active) load_row<C>(g_out + (b * L + w.l) * C, g);
  const Points pt = points_of(x01, stds, w.b0, cnt, n, stage ? smem : nullptr);
  FixedRows<C, kTetra> rows{acc + off, flags, off, {}};
#pragma unroll
  for (int c = 0; c < C; ++c) rows.k[c] = __ldg(k + w.l * C + c);
  if (v.mean)
    backward_mean<C, kTetra>(active, pt, g, nullptr, rows, nullptr, nullptr,
                             n, v);
  else
    backward_one<C, kTetra>(active, pt, g, nullptr, rows, nullptr, nullptr, n,
                            v);
}

// d_x01 / d_stds without atomics: one thread per sample walks the levels in
// order, reads its corner rows as H1 does, and sums each point's gradient
// (the terms of backward_one / backward_mean, the same float expressions)
// in shared-memory slots of its own, [4n][blockDim.x] (dx, dy, dz, ds of
// point j at (4j + q) * blockDim.x + t), written once. d_x01 / d_stds:
// nullptr when not wanted.
template <int C, bool kTetra>
__global__ void pos_grads_kernel(const float* __restrict__ table,
                                 const float* __restrict__ x01,
                                 const float* __restrict__ stds,
                                 const float* __restrict__ g_out,
                                 float* __restrict__ d_x01,
                                 float* __restrict__ d_stds, int64_t B, int n,
                                 int L, GridLevels lv) {
  extern __shared__ float slots[];
  const int t = threadIdx.x, nt = blockDim.x;
  const int64_t b = (int64_t)blockIdx.x * nt + t;
  if (b >= B) return;  // no shuffles below
  float* sum = slots + t;  // slot i of this thread: sum[i * nt]
  for (int i = 0; i < 4 * n; ++i) sum[i * nt] = 0.f;
  const Points pt{x01 + b * n * 3, stds + b * n};
  const float inv_n = 1.0f / (float)n;
  for (int l = 0; l < L; ++l) {
    const Level v = level_of(lv, l);
    const float* tbl = table + (int64_t)lv.offset[l] * C;
    float g[C];
    load_row<C>(g_out + (b * L + l) * C, g);
    if (v.mean) {
      const MeanPoint m = mean_of(pt, n, v);
      if (!in_unit_cube(m.x, m.y, m.z)) continue;
      const Cell p = cell_of(m.x, m.y, m.z, v.scale);
      float fdot, df[3];
      point_grads<C, kTetra>(tbl, p, g, v, fdot, df);
      const float k = m.w / (float)n * v.scale;
      const float fd = fdot / (float)n;
      for (int j = 0; j < n; ++j) {
#pragma unroll
        for (int d = 0; d < 3; ++d) sum[(4 * j + d) * nt] += k * df[d];
        sum[(4 * j + 3) * nt] += erf_weight_grad(pt.s[j], v) * fd;
      }
    } else {
      for (int j = 0; j < n; ++j) {
        const float x = pt.x[3 * j], y = pt.x[3 * j + 1], z = pt.x[3 * j + 2];
        if (!in_unit_cube(x, y, z)) continue;
        const float s = pt.s[j];
        const float coef = erf_weight(s, v) * inv_n;
        float fdot, df[3];
        point_grads<C, kTetra>(tbl, cell_of(x, y, z, v.scale), g, v, fdot,
                               df);
        const float k = coef * v.scale;
#pragma unroll
        for (int d = 0; d < 3; ++d) sum[(4 * j + d) * nt] += k * df[d];
        sum[(4 * j + 3) * nt] += inv_n * erf_weight_grad(s, v) * fdot;
      }
    }
  }
  for (int j = 0; j < n; ++j) {
    if (d_x01 != nullptr) {
#pragma unroll
      for (int d = 0; d < 3; ++d) d_x01[(b * n + j) * 3 + d] = sum[(4 * j + d) * nt];
    }
    if (d_stds != nullptr) d_stds[b * n + j] = sum[(4 * j + 3) * nt];
  }
}

void fill_levels(GridLevels* lv, int L, const float* scale,
                 const float* grid_size, const unsigned int* res,
                 const unsigned int* rows, const unsigned int* offset,
                 const int* tiled, const int* mean) {
  *lv = {};
  for (int l = 0; l < L; ++l) {
    lv->scale[l] = scale[l];
    lv->grid_size[l] = grid_size[l];
    lv->res[l] = res[l];
    lv->rows[l] = rows[l];
    lv->offset[l] = offset[l];
    lv->tiled[l] = tiled[l];
    lv->mean[l] = mean[l];
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

cudaError_t launch_of(int64_t B, int n, int L, int level_major, Launch* g,
                      int threads = kThreads) {
  g->tiles = (B + threads - 1) / threads;
  if (g->tiles * L > 0x7fffffff) return cudaErrorInvalidValue;
  g->blocks = (unsigned)(g->tiles * L);
  const int64_t bytes = 16LL * threads * n;
  g->smem = level_major && bytes <= kStageBytes ? (int)bytes : 0;
  return cudaSuccess;
}

template <int C>
cudaError_t encode(const float* table, const float* x01, const float* stds,
                   float* out, int64_t B, int n, int L, const GridLevels& lv,
                   int tetra, int level_major, cudaStream_t s) {
  Launch g;
  const cudaError_t err = launch_of(B, n, L, level_major, &g);
  if (err != cudaSuccess) return err;
  if (tetra)
    hash_encode_ms_kernel<C, true><<<g.blocks, kThreads, g.smem, s>>>(
        table, x01, stds, out, B, n, L, g.tiles, level_major, g.smem > 0, lv);
  else
    hash_encode_ms_kernel<C, false><<<g.blocks, kThreads, g.smem, s>>>(
        table, x01, stds, out, B, n, L, g.tiles, level_major, g.smem > 0, lv);
  return cudaGetLastError();
}

template <int C>
cudaError_t backward(const float* table, const float* x01, const float* stds,
                     const float* g_out, float* d_table, float* d_x01,
                     float* d_stds, int64_t B, int n, int L,
                     const GridLevels& lv, int tetra, int level_major,
                     cudaStream_t s) {
  Launch g;
  const cudaError_t err = launch_of(B, n, L, level_major, &g);
  if (err != cudaSuccess) return err;
  if (tetra)
    hash_encode_ms_bwd_kernel<C, true><<<g.blocks, kThreads, g.smem, s>>>(
        table, x01, stds, g_out, d_table, d_x01, d_stds, B, n, L, g.tiles,
        level_major, g.smem > 0, lv);
  else
    hash_encode_ms_bwd_kernel<C, false><<<g.blocks, kThreads, g.smem, s>>>(
        table, x01, stds, g_out, d_table, d_x01, d_stds, B, n, L, g.tiles,
        level_major, g.smem > 0, lv);
  return cudaGetLastError();
}

// The deterministic d_table in blocks of `threads` samples (a multiple of
// 32 up to 1024; kThreads on the path): the sums do not depend on it.
template <int C>
cudaError_t backward_fixed(const float* x01, const float* stds,
                           const float* g_out, const int* k,
                           unsigned long long* acc, unsigned* flags,
                           int64_t B, int n, int L, const GridLevels& lv,
                           int tetra, int level_major, int threads,
                           cudaStream_t s) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0)
    return cudaErrorInvalidValue;
  Launch g;
  const cudaError_t err = launch_of(B, n, L, level_major, &g, threads);
  if (err != cudaSuccess) return err;
  if (tetra)
    hash_encode_ms_bwd_fixed_kernel<C, true><<<g.blocks, threads, g.smem, s>>>(
        x01, stds, g_out, k, acc, flags, B, n, L, g.tiles, level_major,
        g.smem > 0, lv);
  else
    hash_encode_ms_bwd_fixed_kernel<C, false>
        <<<g.blocks, threads, g.smem, s>>>(x01, stds, g_out, k, acc, flags, B,
                                           n, L, g.tiles, level_major,
                                           g.smem > 0, lv);
  return cudaGetLastError();
}

// d_x01 / d_stds by pos_grads_kernel: the largest block (up to kThreads)
// whose slots, 16 n bytes a sample, fit kStageBytes.
template <int C>
cudaError_t pos_grads(const float* table, const float* x01, const float* stds,
                      const float* g_out, float* d_x01, float* d_stds,
                      int64_t B, int n, int L, const GridLevels& lv, int tetra,
                      cudaStream_t s) {
  int threads = kThreads;
  while (threads > 32 && 16LL * threads * n > kStageBytes) threads >>= 1;
  const int64_t smem = 16LL * threads * n;
  if (smem > kStageBytes) return cudaErrorInvalidValue;
  const int64_t blocks = (B + threads - 1) / threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  if (tetra)
    pos_grads_kernel<C, true><<<(unsigned)blocks, threads, smem, s>>>(
        table, x01, stds, g_out, d_x01, d_stds, B, n, L, lv);
  else
    pos_grads_kernel<C, false><<<(unsigned)blocks, threads, smem, s>>>(
        table, x01, stds, g_out, d_x01, d_stds, B, n, L, lv);
  return cudaGetLastError();
}

// K3 on N x C values: one chunk of whole tiles per block, with as many
// blocks as the card holds at once. Sums: FloatSums or FixedSums.
template <int C, class Sums>
cudaError_t scatter(const int32_t* idx, const float* vals, Sums out,
                    int64_t N, int64_t rows, int device, cudaStream_t s) {
  const int64_t V = N * C / 4;
  const int tail = (int)(N * C - 4 * V);
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, scatter_add_rows_kernel<C, Sums>, kScatterThreads, 0);
  if (err != cudaSuccess) return err;
  const int64_t most = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t per_block = (V + most - 1) / most;
  const int64_t tiles = (per_block + kScatterThreads - 1) / kScatterThreads;
  const int64_t chunk = (tiles > 0 ? tiles : 1) * kScatterThreads;
  const int64_t blocks = V > 0 ? (V + chunk - 1) / chunk : 1;
  scatter_add_rows_kernel<C, Sums>
      <<<(unsigned)blocks, kScatterThreads, 0, s>>>(idx, vals, out, V, chunk,
                                                    tail, rows);
  return cudaGetLastError();
}

// K3 at any C it takes, through `Sums` (FloatSums<C> or FixedSums<C>).
template <template <int> class Sums, class... A>
cudaError_t scatter_any(int C, const int32_t* idx, const float* vals,
                        int64_t N, int64_t rows, int device, cudaStream_t s,
                        A... a) {
  switch (C) {
    case 1: return scatter<1>(idx, vals, Sums<1>{a...}, N, rows, device, s);
    case 2: return scatter<2>(idx, vals, Sums<2>{a...}, N, rows, device, s);
    case 4: return scatter<4>(idx, vals, Sums<4>{a...}, N, rows, device, s);
    case 8: return scatter<8>(idx, vals, Sums<8>{a...}, N, rows, device, s);
    case 16: return scatter<16>(idx, vals, Sums<16>{a...}, N, rows, device, s);
    case 32: return scatter<32>(idx, vals, Sums<32>{a...}, N, rows, device, s);
    default: return cudaErrorInvalidValue;
  }
}

// The row ranges of fixed_to_float's exponent groups: H1-bwd's levels, or
// one group (K3).
struct Groups {
  int64_t start[kMaxLevels + 1];
  int count;
};

// out[e] = the deterministic kernels' sum of entry e of a [rows, C] output:
// NaN where a NaN term (or both infinities) was flagged, else +-inf where
// one was, else acc[e] * 2^-k[g, c] (g: the entry's group). Through
// float64, as the plain version takes it: the int64 rounded to double, an
// exact scaling, one rounding to float.
__global__ void fixed_to_float_kernel(const long long* __restrict__ acc,
                                      const unsigned* __restrict__ flags,
                                      const int* __restrict__ k,
                                      float* __restrict__ out, int64_t total,
                                      int C, Groups gr) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += step) {
    const int64_t r = e / C;
    const int c = (int)(e - r * C);
    int g = 0;
    while (g + 1 < gr.count && r >= gr.start[g + 1]) ++g;
    const unsigned f = (flags[e >> 3] >> (4 * (e & 7))) & 0xfu;
    const unsigned inf = kFlagPosInf | kFlagNegInf;
    float v;
    if ((f & kFlagNaN) || (f & inf) == inf)
      v = __int_as_float(0x7fc00000);
    else if (f & kFlagPosInf)
      v = __int_as_float(0x7f800000);
    else if (f & kFlagNegInf)
      v = __int_as_float((int)0xff800000u);
    else
      v = __double2float_rn(ldexp(__ll2double_rn(acc[e]), -k[g * C + c]));
    out[e] = v;
  }
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
  if (R < 0 || S <= 0 || K < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (R == 0) return cudaSuccess;
  // kCompositeWarps rays a block while their K channel sums fit the 48 KiB
  // a block gets without opting in; fewer for a larger K, and one ray with
  // up to the card's opt-in limit above that (K <= 58,112 on an H100).
  constexpr size_t kStatic = 48 * 1024;
  const size_t per_warp = (size_t)K * sizeof(float);
  int warps = kCompositeWarps;
  if (per_warp * warps > kStatic)
    warps = per_warp > kStatic ? 1 : (int)(kStatic / per_warp);
  const size_t smem = per_warp * warps;
  if (smem > kStatic) {
    err = cudaFuncSetAttribute(composite_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned int blocks = (unsigned int)((R + warps - 1) / warps);
  composite_kernel<<<blocks, 32 * warps, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      density, tdist, dirs, rgb, sem, inten, weights, rgb_out, sem_out,
      inten_out, depth_out, acc_out, R, S, K, opaque, bg);
  return cudaGetLastError();
}

// mean: per level, 1 where it encodes the multisample mean point (the
// coarse cutoff); tetra: tetrahedral interpolation (else trilinear);
// level_major: the block order (ops/grid.py:level_major).
int nl_hash_encode_ms(const float* table, const float* x01, const float* stds,
                      float* out, long long B, int n, int L, int C,
                      const float* scale, const float* grid_size,
                      const unsigned int* res, const unsigned int* rows,
                      const unsigned int* offset, const int* tiled,
                      const int* mean, int tetra, int level_major, int device,
                      void* stream) {
  if (L <= 0 || L > kMaxLevels || n <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  GridLevels lv;
  fill_levels(&lv, L, scale, grid_size, res, rows, offset, tiled, mean);
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The presets' grids: C = 1 and 4 (proposal), 4 and 16 (NeRF), 2
  // (objects, tiny_debug).
  switch (C) {
    case 1:
      return encode<1>(table, x01, stds, out, B, n, L, lv, tetra,
                       level_major, s);
    case 2:
      return encode<2>(table, x01, stds, out, B, n, L, lv, tetra,
                       level_major, s);
    case 4:
      return encode<4>(table, x01, stds, out, B, n, L, lv, tetra,
                       level_major, s);
    case 16:
      return encode<16>(table, x01, stds, out, B, n, L, lv, tetra,
                        level_major, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// d_table, d_x01, d_stds: zero-filled by the caller, each nullptr when not
// wanted. mean, tetra, level_major: as the forward's.
int nl_hash_encode_ms_bwd(const float* table, const float* x01,
                          const float* stds, const float* g_out,
                          float* d_table, float* d_x01, float* d_stds,
                          long long B, int n, int L, int C, const float* scale,
                          const float* grid_size, const unsigned int* res,
                          const unsigned int* rows,
                          const unsigned int* offset, const int* tiled,
                          const int* mean, int tetra, int level_major,
                          int device, void* stream) {
  if (L <= 0 || L > kMaxLevels || n <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  GridLevels lv;
  fill_levels(&lv, L, scale, grid_size, res, rows, offset, tiled, mean);
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      return backward<1>(table, x01, stds, g_out, d_table, d_x01, d_stds, B,
                         n, L, lv, tetra, level_major, s);
    case 2:
      return backward<2>(table, x01, stds, g_out, d_table, d_x01, d_stds, B,
                         n, L, lv, tetra, level_major, s);
    case 4:
      return backward<4>(table, x01, stds, g_out, d_table, d_x01, d_stds, B,
                         n, L, lv, tetra, level_major, s);
    case 16:
      return backward<16>(table, x01, stds, g_out, d_table, d_x01, d_stds, B,
                          n, L, lv, tetra, level_major, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// out: [rows, C], zero-filled (or holding a sum to add to) by the caller.
// C must be a power of two up to 32; idx and vals start on 16 bytes, out
// on 4 min(C, 4) bytes.
int nl_scatter_add_rows(const int* idx, const float* vals, float* out,
                        long long N, int C, long long rows, int device,
                        void* stream) {
  const uintptr_t row_bytes = 4 * (C < 4 ? C : 4);
  if (N < 0 || C <= 0 || ((uintptr_t)idx | (uintptr_t)vals) % 16 != 0 ||
      (uintptr_t)out % row_bytes != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N == 0) return cudaSuccess;
  return scatter_any<FloatSums>(C, idx, vals, N, rows, device,
                                static_cast<cudaStream_t>(stream), out);
}

// The deterministic K3: acc [rows, C] int64 and flags (4 bits an entry)
// zero-filled (or holding sums to add to) by the caller; k: [C] exponents
// on the device. Then nl_fixed_to_float. idx and vals start on 16 bytes.
int nl_scatter_add_rows_fixed(const int* idx, const float* vals, const int* k,
                              long long* acc, unsigned* flags, long long N,
                              int C, long long rows, int device,
                              void* stream) {
  if (N < 0 || C <= 0 || ((uintptr_t)idx | (uintptr_t)vals) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N == 0) return cudaSuccess;
  return scatter_any<FixedSums>(
      C, idx, vals, N, rows, device, static_cast<cudaStream_t>(stream),
      reinterpret_cast<unsigned long long*>(acc), flags, k, (int64_t)rows);
}

// The deterministic H1-bwd d_table: acc [rows, C] int64 and flags
// zero-filled by the caller, k: [L, C] exponents on the device; then
// nl_fixed_to_float. threads: the block size (a multiple of 32). The
// other arguments as nl_hash_encode_ms_bwd's.
int nl_hash_encode_ms_bwd_fixed(const float* x01, const float* stds,
                                const float* g_out, const int* k,
                                long long* acc, unsigned* flags, long long B,
                                int n, int L, int C, const float* scale,
                                const float* grid_size,
                                const unsigned int* res,
                                const unsigned int* rows,
                                const unsigned int* offset, const int* tiled,
                                const int* mean, int tetra, int level_major,
                                int threads, int device, void* stream) {
  if (L <= 0 || L > kMaxLevels || n <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  GridLevels lv;
  fill_levels(&lv, L, scale, grid_size, res, rows, offset, tiled, mean);
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* a = reinterpret_cast<unsigned long long*>(acc);
  switch (C) {
    case 1:
      return backward_fixed<1>(x01, stds, g_out, k, a, flags, B, n, L, lv,
                               tetra, level_major, threads, s);
    case 2:
      return backward_fixed<2>(x01, stds, g_out, k, a, flags, B, n, L, lv,
                               tetra, level_major, threads, s);
    case 4:
      return backward_fixed<4>(x01, stds, g_out, k, a, flags, B, n, L, lv,
                               tetra, level_major, threads, s);
    case 16:
      return backward_fixed<16>(x01, stds, g_out, k, a, flags, B, n, L, lv,
                                tetra, level_major, threads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// d_x01 / d_stds of hash_encode_ms without atomics (each nullptr when not
// wanted; written, not added to). Arguments as nl_hash_encode_ms_bwd's.
int nl_hash_encode_ms_pos_grads(const float* table, const float* x01,
                                const float* stds, const float* g_out,
                                float* d_x01, float* d_stds, long long B,
                                int n, int L, int C, const float* scale,
                                const float* grid_size,
                                const unsigned int* res,
                                const unsigned int* rows,
                                const unsigned int* offset, const int* tiled,
                                const int* mean, int tetra, int device,
                                void* stream) {
  if (L <= 0 || L > kMaxLevels || n <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  GridLevels lv;
  fill_levels(&lv, L, scale, grid_size, res, rows, offset, tiled, mean);
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      return pos_grads<1>(table, x01, stds, g_out, d_x01, d_stds, B, n, L, lv,
                          tetra, s);
    case 2:
      return pos_grads<2>(table, x01, stds, g_out, d_x01, d_stds, B, n, L, lv,
                          tetra, s);
    case 4:
      return pos_grads<4>(table, x01, stds, g_out, d_x01, d_stds, B, n, L, lv,
                          tetra, s);
    case 16:
      return pos_grads<16>(table, x01, stds, g_out, d_x01, d_stds, B, n, L,
                           lv, tetra, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// out [rows, C] float32 from the deterministic kernels' acc, flags and k
// ([G, C] on the device); starts: G + 1 row starts on the host (the
// groups' row ranges, starts[G] = rows).
int nl_fixed_to_float(const long long* acc, const unsigned* flags,
                      const int* k, const long long* starts, int G,
                      float* out, long long rows, int C, int device,
                      void* stream) {
  if (G <= 0 || G > kMaxLevels || C <= 0 || rows < 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Groups gr{};
  for (int g = 0; g <= G; ++g) gr.start[g] = starts[g];
  gr.count = G;
  const int64_t total = rows * C;
  if (total == 0) return cudaSuccess;
  constexpr int kBlock = 256;
  int64_t blocks = (total + kBlock - 1) / kBlock;
  if (blocks > 65535LL * 64) blocks = 65535LL * 64;
  fixed_to_float_kernel<<<(unsigned)blocks, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      acc, flags, k, out, total, C, gr);
  return cudaGetLastError();
}

}  // extern "C"
