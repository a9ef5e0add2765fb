// Hand-written Hopper (sm_90a) in-tile gathers: the port's counterparts of
// the Pallas gathers K2, K4 and K5.
//
// Built with kernels.cu by nerf_lidar_tpu_torch/ops/_build.py into one
// shared library with a plain C interface. Each launcher takes raw device
// pointers, sizes, the device index and the caller's cudaStream_t, launches
// on that stream without synchronising, allocates nothing, and returns
// cudaGetLastError().
//
// take_along_axis: replaces the Pallas kernels
//   nerf_lidar_tpu/ops/grid_pallas.py:_tile_gather_kernel (K2,
//   tile_lane_gather), the take_along_axis forms of
//   experiments/gather_bench.py:probe_mosaic_gather (K4) and the kernel of
//   experiments/gather_bench.py:bench_pallas_tile_gather (K5).
//   out[g, i, j] = tbl[i, idx[g, i, j]] (axis 1) or tbl[idx[g, i, j], j]
//   (axis 0) for a row-major table [A, B] shared by the G index tiles.
//   Bound by device-memory bytes: 4 bytes of index read and 4 of output
//   written per element, and the table entries the indices touch. Design:
//   one thread per output element (kPerThread of them a thread, a block's
//   threads on neighbouring elements); a table of up to 48 KiB (the 4 KiB
//   [8, 128] tile of K2 and K5) is staged in shared memory by every block,
//   so the random reads stay on the SM, and a larger one (K4's [8, 2^15]
//   form) is read through the read-only cache (__ldg).
//
// take_rows: replaces the row gather jnp.take(tbl, idx, axis=0) of
//   experiments/gather_bench.py:probe_mosaic_gather (K4, form 3).
//   out[n, c] = tbl[idx[n], c]. Bound by bytes like the above; at the
//   TPU kernel's own shape, (512, 128) <- 256, by the latency of one index
//   load and the row load it feeds. Design: a group of lanes per output
//   row (the least power of two that covers the row, at most a warp,
//   which then loops over it: 32 lanes a row for C >= 128, 4 for C = 16,
//   8 rows a warp). The group reads the row's index in one transaction of
//   its warp and wraps it once, then copies the row as float4s through
//   __ldg into float4 stores, or fills it with NaN. A row whose width is
//   not a multiple of 4, or a table or output that does not start on 16
//   bytes, takes the same loop over single floats. Index math is 32-bit
//   (the launcher refuses N * C or R * C above 2^31 - 1), so no thread
//   pays a 64-bit division ahead of its loads.
//
// Index rules (JAX's): an index k with -size <= k < 0 wraps once to
// k + size; any other index outside [0, size) gives NaN.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kGatherThreads = 256;
constexpr int kPerThread = 4;
constexpr long long kMaxSharedTable = 48 * 1024;  // bytes, static limit

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);
}

// k wrapped once when negative; -1 when it gives NaN.
__device__ __forceinline__ int wrap_index(int k, int size) {
  if (k < 0) k += size;
  return (k >= 0 && k < size) ? k : -1;
}

template <bool kShared>
__global__ void take_along_axis_kernel(const float* __restrict__ tbl,
                                       const int* __restrict__ idx,
                                       float* __restrict__ out, int A, int B,
                                       int I, int J, long long total,
                                       int axis) {
  extern __shared__ float s_tbl[];
  if constexpr (kShared) {
    const int n = A * B;
    for (int k = threadIdx.x; k < n; k += blockDim.x)
      s_tbl[k] = __ldg(tbl + k);
    __syncthreads();
  }
  const int size = axis ? B : A;
  const long long first =
      (long long)blockIdx.x * blockDim.x * kPerThread + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const long long o = first + (long long)r * blockDim.x;
    if (o >= total) return;
    const int j = (int)(o % J);
    const int i = (int)((o / J) % I);
    const int k = wrap_index(__ldg(idx + o), size);
    float v = quiet_nan();
    if (k >= 0) {
      const long long at = axis ? (long long)i * B + k : (long long)k * B + j;
      if constexpr (kShared) {
        v = s_tbl[at];
      } else {
        v = __ldg(tbl + at);
      }
    }
    out[o] = v;
  }
}

constexpr int kRowThreads = 128;

__device__ __forceinline__ float nan_of(float) { return quiet_nan(); }

__device__ __forceinline__ float4 nan_of(float4) {
  const float q = quiet_nan();
  return make_float4(q, q, q, q);
}

// Rows of `units` T (float4 or float) each; 1 << log2l lanes per row.
template <typename T>
__global__ void take_rows_kernel(const T* __restrict__ tbl,
                                 const int* __restrict__ idx,
                                 T* __restrict__ out, int R, int units,
                                 int log2l, unsigned N) {
  const unsigned g = blockIdx.x * (unsigned)blockDim.x + threadIdx.x;
  const unsigned n = g >> log2l;
  if (n >= N) return;
  const int lanes = 1 << log2l;
  const int k = wrap_index(__ldg(idx + n), R);
  T* dst = out + n * (unsigned)units;
  if (k < 0) {
    for (int u = g & (lanes - 1); u < units; u += lanes) dst[u] = nan_of(T());
    return;
  }
  const T* src = tbl + (unsigned)k * (unsigned)units;
  for (int u = g & (lanes - 1); u < units; u += lanes) dst[u] = __ldg(src + u);
}

}  // namespace

extern "C" {

// tbl [A, B], idx and out [G, I, J]; I == A for axis 1, J == B for axis 0.
int nl_take_along_axis(const float* tbl, const int* idx, float* out, int A,
                       int B, long long G, int I, int J, int axis, int device,
                       void* stream) {
  if (A <= 0 || B <= 0 || I <= 0 || J <= 0 || G < 0 ||
      (axis == 1 && I != A) || (axis == 0 && J != B) ||
      (axis != 0 && axis != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long total = G * I * J;
  if (total == 0) return cudaSuccess;
  const long long per_block = (long long)kGatherThreads * kPerThread;
  const unsigned int blocks =
      (unsigned int)((total + per_block - 1) / per_block);
  const long long table_bytes = (long long)A * B * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_bytes <= kMaxSharedTable) {
    take_along_axis_kernel<true><<<blocks, kGatherThreads, table_bytes, s>>>(
        tbl, idx, out, A, B, I, J, total, axis);
  } else {
    take_along_axis_kernel<false><<<blocks, kGatherThreads, 0, s>>>(
        tbl, idx, out, A, B, I, J, total, axis);
  }
  return cudaGetLastError();
}

// tbl [R, C], idx [N], out [N, C]; N * C and R * C at most 2^31 - 1.
int nl_take_rows(const float* tbl, const int* idx, float* out, int R, int C,
                 long long N, int device, void* stream) {
  if (R <= 0 || C <= 0 || N < 0 || N * C > INT_MAX ||
      (long long)R * C > INT_MAX)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N == 0) return cudaSuccess;
  // float4 copies when a row is whole float4s and both tables start on 16
  // bytes; single floats otherwise.
  const bool vec =
      C % 4 == 0 && ((uintptr_t)tbl | (uintptr_t)out) % 16 == 0;
  const int units = vec ? C / 4 : C;
  int log2l = 0;
  while (log2l < 5 && (1 << log2l) < units) ++log2l;
  const unsigned blocks =
      (unsigned)(((N << log2l) + kRowThreads - 1) / kRowThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    take_rows_kernel<float4><<<blocks, kRowThreads, 0, s>>>(
        reinterpret_cast<const float4*>(tbl), idx,
        reinterpret_cast<float4*>(out), R, units, log2l, (unsigned)N);
  } else {
    take_rows_kernel<float><<<blocks, kRowThreads, 0, s>>>(
        tbl, idx, out, R, units, log2l, (unsigned)N);
  }
  return cudaGetLastError();
}

}  // extern "C"
