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
//   linear interpolation, no coarse cutoff). Bound by random 4..64-byte
//   table reads: 8 corners x n multisamples x L levels per sample, from
//   tables up to 240 MB (larger than the 50 MB L2). Design: one thread per
//   (sample, level), level-major so that neighbouring threads read
//   neighbouring points; a loop over the n multisamples and the 8 corners
//   keeps the [B*n, C] per-corner gathers of the plain version out of
//   device memory. Out-of-range points contribute 0 and read no corner.
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
//   w_corner * erf_w / n * g_out[b, l] to its row through add_row, the
//   routine K3 uses. d_x01 / d_stds (only when asked for): the derivative
//   of the trilinear weights times scale_l, and of the erf weight, each
//   against <g_out, corner row>. Bound like K3 by table atomics: one row
//   update per corner (C4 rows of a 240 MB table for the NeRF grid), with
//   heavy contention at the coarse tiled levels, where millions of updates
//   land on a few thousand rows. Design: as the forward, one thread per
//   (sample, level), level-major; d_x01 / d_stds sum the levels of a point
//   with atomics. Atomics make every sum order change from run to run.
//
// Later PRs make these fast (warp per ray, shared-memory staging,
// vectorised loads, warp-aggregated or sorted scatters in the H1
// backward); this version is the simple correct one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr float kEps = 1.1920929e-07f;  // float32 eps, as in the reference

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

template <int C>
__global__ void hash_encode_ms_kernel(const float* __restrict__ table,
                                      const float* __restrict__ x01,
                                      const float* __restrict__ stds,
                                      float* __restrict__ out, int64_t B,
                                      int n, int L, GridLevels lv) {
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (tid >= B * L) return;
  const int l = (int)(tid / B);
  const int64_t b = tid - (int64_t)l * B;
  const float scale = lv.scale[l];
  const float g = lv.grid_size[l];
  const float g2 = g * g;
  const uint32_t res = lv.res[l];
  const uint32_t rows = lv.rows[l];
  const bool tiled = lv.tiled[l] != 0;
  const float* tbl = table + (int64_t)lv.offset[l] * C;

  float acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = 0.f;

  for (int j = 0; j < n; ++j) {
    const int64_t p = b * n + j;
    const float x = x01[3 * p], y = x01[3 * p + 1], z = x01[3 * p + 2];
    if (x < 0.f || x > 1.f || y < 0.f || y > 1.f || z < 0.f || z > 1.f)
      continue;
    const float s = stds[p];
    const float wl = erff(1.0f / sqrtf(fmaxf(8.0f * (s * s) * g2, 1e-10f)));
    // pos = x * scale + 0.5, rounded after each operation (never an FMA),
    // so floor() picks the same cell as the reference.
    const float px = __fadd_rn(__fmul_rn(x, scale), 0.5f);
    const float py = __fadd_rn(__fmul_rn(y, scale), 0.5f);
    const float pz = __fadd_rn(__fmul_rn(z, scale), 0.5f);
    const float gx = floorf(px), gy = floorf(py), gz = floorf(pz);
    const float rx = px - gx, ry = py - gy, rz = pz - gz;
    const int ix = (int)gx, iy = (int)gy, iz = (int)gz;

    float feat[C];
#pragma unroll
    for (int k = 0; k < C; ++k) feat[k] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int cx = c & 1, cy = (c >> 1) & 1, cz = (c >> 2) & 1;
      const float w = (cx ? rx : 1.f - rx) * (cy ? ry : 1.f - ry) *
                      (cz ? rz : 1.f - rz);
      const uint32_t ux = (uint32_t)(ix + cx);
      const uint32_t uy = (uint32_t)(iy + cy);
      const uint32_t uz = (uint32_t)(iz + cz);
      uint32_t idx = tiled ? (ux + uy * res + uz * res * res)
                           : ((ux * 1u) ^ (uy * 2654435761u) ^
                              (uz * 805459861u));
      idx %= rows;
      const float* row = tbl + (int64_t)idx * C;
#pragma unroll
      for (int k = 0; k < C; ++k) feat[k] += w * row[k];
    }
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] += feat[k] * wl;
  }
  float* o = out + b * (int64_t)(L * C) + (int64_t)l * C;
#pragma unroll
  for (int k = 0; k < C; ++k) o[k] = acc[k] / (float)n;
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

template <int C>
__global__ void hash_encode_ms_bwd_kernel(
    const float* __restrict__ table, const float* __restrict__ x01,
    const float* __restrict__ stds, const float* __restrict__ g_out,
    float* __restrict__ d_table, float* __restrict__ d_x01,
    float* __restrict__ d_stds, int64_t B, int n, int L, GridLevels lv) {
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (tid >= B * L) return;
  const int l = (int)(tid / B);
  const int64_t b = tid - (int64_t)l * B;
  const float scale = lv.scale[l];
  const float g = lv.grid_size[l];
  const float g2 = g * g;
  const uint32_t res = lv.res[l];
  const uint32_t rows = lv.rows[l];
  const bool tiled = lv.tiled[l] != 0;
  const int64_t row0 = (int64_t)lv.offset[l];
  const bool need_dot = d_x01 != nullptr || d_stds != nullptr;
  const float inv_n = 1.0f / (float)n;

  float gv[C];
  const float* gp = g_out + b * (int64_t)(L * C) + (int64_t)l * C;
#pragma unroll
  for (int k = 0; k < C; ++k) gv[k] = gp[k];

  for (int j = 0; j < n; ++j) {
    const int64_t p = b * n + j;
    const float x = x01[3 * p], y = x01[3 * p + 1], z = x01[3 * p + 2];
    if (x < 0.f || x > 1.f || y < 0.f || y > 1.f || z < 0.f || z > 1.f)
      continue;  // encoded to 0 by a select: no gradient anywhere
    const float s = stds[p];
    const float u = 8.0f * (s * s) * g2;
    const float v = 1.0f / sqrtf(fmaxf(u, 1e-10f));
    const float wl = erff(v);
    const float coef = wl * inv_n;  // d out[b, l] / d feat of point j
    const float px = __fadd_rn(__fmul_rn(x, scale), 0.5f);
    const float py = __fadd_rn(__fmul_rn(y, scale), 0.5f);
    const float pz = __fadd_rn(__fmul_rn(z, scale), 0.5f);
    const float gx = floorf(px), gy = floorf(py), gz = floorf(pz);
    const float rx = px - gx, ry = py - gy, rz = pz - gz;
    const int ix = (int)gx, iy = (int)gy, iz = (int)gz;

    float fdot = 0.f, dfx = 0.f, dfy = 0.f, dfz = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int cx = c & 1, cy = (c >> 1) & 1, cz = (c >> 2) & 1;
      const float wx = cx ? rx : 1.f - rx;
      const float wy = cy ? ry : 1.f - ry;
      const float wz = cz ? rz : 1.f - rz;
      const uint32_t ux = (uint32_t)(ix + cx);
      const uint32_t uy = (uint32_t)(iy + cy);
      const uint32_t uz = (uint32_t)(iz + cz);
      uint32_t idx = tiled ? (ux + uy * res + uz * res * res)
                           : ((ux * 1u) ^ (uy * 2654435761u) ^
                              (uz * 805459861u));
      idx %= rows;
      const int64_t row = (row0 + (int64_t)idx) * C;
      if (d_table != nullptr) {
        const float cw = coef * (wx * wy * wz);
        float add[C];
#pragma unroll
        for (int k = 0; k < C; ++k) add[k] = cw * gv[k];
        add_row<C>(d_table + row, add);
      }
      if (need_dot) {
        float dot = 0.f;
#pragma unroll
        for (int k = 0; k < C; ++k) dot += gv[k] * table[row + k];
        fdot += (wx * wy * wz) * dot;
        dfx += (cx ? 1.f : -1.f) * wy * wz * dot;
        dfy += wx * (cy ? 1.f : -1.f) * wz * dot;
        dfz += wx * wy * (cz ? 1.f : -1.f) * dot;
      }
    }
    if (d_x01 != nullptr) {
      const float k = coef * scale;  // d frac / d x = scale (floor: 0)
      atomicAdd(d_x01 + 3 * p, k * dfx);
      atomicAdd(d_x01 + 3 * p + 1, k * dfy);
      atomicAdd(d_x01 + 3 * p + 2, k * dfz);
    }
    if (d_stds != nullptr && u > 1e-10f) {
      // d erf(v) / ds with v = u^-1/2, u = 8 s^2 g^2 (0 where u is clamped).
      const float dwl = 1.1283791671f * expf(-v * v) * (-0.5f * v / u) *
                        (16.0f * s * g2);
      atomicAdd(d_stds + p, inv_n * dwl * fdot);
    }
  }
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

int nl_hash_encode_ms(const float* table, const float* x01, const float* stds,
                      float* out, long long B, int n, int L, int C,
                      const float* scale, const float* grid_size,
                      const unsigned int* res, const unsigned int* rows,
                      const unsigned int* offset, const int* tiled,
                      int device, void* stream) {
  if (L <= 0 || L > kMaxLevels || n <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  GridLevels lv;
  fill_levels(&lv, L, scale, grid_size, res, rows, offset, tiled);
  const long long total = B * L;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      hash_encode_ms_kernel<1><<<blocks, threads, 0, s>>>(table, x01, stds,
                                                          out, B, n, L, lv);
      break;
    case 2:
      hash_encode_ms_kernel<2><<<blocks, threads, 0, s>>>(table, x01, stds,
                                                          out, B, n, L, lv);
      break;
    case 4:
      hash_encode_ms_kernel<4><<<blocks, threads, 0, s>>>(table, x01, stds,
                                                          out, B, n, L, lv);
      break;
    // The ported presets' grids: C = 1 (proposal), 4 (NeRF), 2 (tiny_debug).
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// d_table, d_x01, d_stds: zero-filled by the caller, each nullptr when not
// wanted.
int nl_hash_encode_ms_bwd(const float* table, const float* x01,
                          const float* stds, const float* g_out,
                          float* d_table, float* d_x01, float* d_stds,
                          long long B, int n, int L, int C, const float* scale,
                          const float* grid_size, const unsigned int* res,
                          const unsigned int* rows,
                          const unsigned int* offset, const int* tiled,
                          int device, void* stream) {
  if (L <= 0 || L > kMaxLevels || n <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  GridLevels lv;
  fill_levels(&lv, L, scale, grid_size, res, rows, offset, tiled);
  const long long total = B * L;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      hash_encode_ms_bwd_kernel<1><<<blocks, threads, 0, s>>>(
          table, x01, stds, g_out, d_table, d_x01, d_stds, B, n, L, lv);
      break;
    case 2:
      hash_encode_ms_bwd_kernel<2><<<blocks, threads, 0, s>>>(
          table, x01, stds, g_out, d_table, d_x01, d_stds, B, n, L, lv);
      break;
    case 4:
      hash_encode_ms_bwd_kernel<4><<<blocks, threads, 0, s>>>(
          table, x01, stds, g_out, d_table, d_x01, d_stds, B, n, L, lv);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
