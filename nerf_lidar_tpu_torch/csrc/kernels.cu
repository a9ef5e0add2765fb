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
// Later PRs make these fast (warp per ray, shared-memory staging,
// vectorised loads); this version is the simple correct one.

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
  GridLevels lv = {};
  for (int l = 0; l < L; ++l) {
    lv.scale[l] = scale[l];
    lv.grid_size[l] = grid_size[l];
    lv.res[l] = res[l];
    lv.rows[l] = rows[l];
    lv.offset[l] = offset[l];
    lv.tiled[l] = tiled[l];
  }
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

}  // extern "C"
