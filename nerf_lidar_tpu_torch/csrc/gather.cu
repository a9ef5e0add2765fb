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
//   written per element, and the table entries the indices touch (8.4 MB
//   for K5's 2^20 elements: 2.5 us at 3.35 TB/s); at K2's single tile, by
//   the launch.
//   Design:
//   - a unit is 4 neighbouring outputs of one row (an int4 of indices in,
//     a float4 out) where J % 4 == 0 and idx and out start on 16 bytes, one
//     output otherwise; a thread takes kUnits units, a block's threads on
//     neighbouring units, so K5 runs 256 blocks (two per SM);
//   - a thread issues all its index loads first, then the block stages a
//     table of up to 48 KiB (the 4 KiB [8, 128] tile of K2 and K5) in
//     shared memory (float4 copies where it starts on 16 bytes), so the two
//     round trips overlap; a larger table (K4's [8, 2^15], [256, 128] and
//     [128, 128] forms) is read through the read-only cache (__ldg);
//   - 32-bit index math (the launcher refuses G * I * J or A * B above
//     2^31 - 1), one division per unit, so no thread pays the 64-bit
//     division routine ahead of its loads.
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
constexpr int kUnits = 4;
constexpr int kMaxSharedTable = 48 * 1024;  // bytes, static limit

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);
}

// k wrapped once when negative; -1 when it gives NaN.
__device__ __forceinline__ int wrap_index(int k, int size) {
  if (k < 0) k += size;
  return (k >= 0 && k < size) ? k : -1;
}

// A unit's indices and outputs: int4 / float4 (4 outputs) or int / float.
template <bool kVec>
struct Unit {
  using Idx = int4;
  using Val = float4;
  static constexpr int kWidth = 4;
};
template <>
struct Unit<false> {
  using Idx = int;
  using Val = float;
  static constexpr int kWidth = 1;
};

__device__ __forceinline__ int lane_of(int4 v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
__device__ __forceinline__ int lane_of(int v, int) { return v; }
__device__ __forceinline__ void set_lane(float4& v, int c, float x) {
  if (c == 0) v.x = x;
  else if (c == 1) v.y = x;
  else if (c == 2) v.z = x;
  else v.w = x;
}
__device__ __forceinline__ void set_lane(float& v, int, float x) { v = x; }

// out[o] for o = kWidth * u + c: tbl[i, idx[o]] (axis 1) or tbl[idx[o], j]
// (axis 0), i = (o / J) % I, j = o % J. `units` outputs / kWidth in all.
template <bool kShared, bool kVec>
__global__ void __launch_bounds__(kGatherThreads) take_along_axis_kernel(
    const float* __restrict__ tbl, const int* __restrict__ idx,
    float* __restrict__ out, int A, int B, unsigned I, unsigned J,
    unsigned units, int axis) {
  using U = Unit<kVec>;
  extern __shared__ float4 s_tbl4[];
  float* s_tbl = reinterpret_cast<float*>(s_tbl4);
  const auto* idx_u = reinterpret_cast<const typename U::Idx*>(idx);
  auto* out_u = reinterpret_cast<typename U::Val*>(out);
  // Unsigned: below 2^31 + kGatherThreads * kUnits, with no overflow.
  const unsigned first =
      blockIdx.x * (kGatherThreads * kUnits) + threadIdx.x;

  // The indices first: their loads are in flight while the table stages.
  typename U::Idx k[kUnits];
#pragma unroll
  for (int r = 0; r < kUnits; ++r) {
    const unsigned u = first + r * kGatherThreads;
    if (u < units) k[r] = __ldg(idx_u + u);
  }
  if constexpr (kShared) {
    const int n = A * B;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(tbl) & 15) == 0) {
      done = n & ~3;
      const float4* t4 = reinterpret_cast<const float4*>(tbl);
      for (int q = threadIdx.x; q < done / 4; q += kGatherThreads)
        s_tbl4[q] = __ldg(t4 + q);
    }
    for (int q = done + threadIdx.x; q < n; q += kGatherThreads)
      s_tbl[q] = __ldg(tbl + q);
    __syncthreads();
  }
  const int size = axis ? B : A;
#pragma unroll
  for (int r = 0; r < kUnits; ++r) {
    const unsigned u = first + r * kGatherThreads;
    if (u >= units) break;
    const unsigned o = u * U::kWidth;
    const unsigned row = o / J;
    const int j0 = (int)(o - row * J);
    const int i = (int)(row % I);
    typename U::Val v;
#pragma unroll
    for (int c = 0; c < U::kWidth; ++c) {
      const int kc = wrap_index(lane_of(k[r], c), size);
      float x = quiet_nan();
      if (kc >= 0) {
        const int at = axis ? i * B + kc : kc * B + j0 + c;
        if constexpr (kShared) {
          x = s_tbl[at];
        } else {
          x = __ldg(tbl + at);
        }
      }
      set_lane(v, c, x);
    }
    out_u[u] = v;
  }
}

template <bool kShared>
void launch_along_axis(bool vec, const float* tbl, const int* idx,
                       float* out, int A, int B, int I, int J, int total,
                       int axis, size_t smem, cudaStream_t s) {
  const unsigned units = vec ? total / 4 : total;
  const unsigned per_block = kGatherThreads * kUnits;
  const unsigned blocks = (units + per_block - 1) / per_block;
  if (vec) {
    take_along_axis_kernel<kShared, true>
        <<<blocks, kGatherThreads, smem, s>>>(tbl, idx, out, A, B, I, J,
                                              units, axis);
  } else {
    take_along_axis_kernel<kShared, false>
        <<<blocks, kGatherThreads, smem, s>>>(tbl, idx, out, A, B, I, J,
                                              units, axis);
  }
}

// An empty kernel: its device time is the card's launch floor.
__global__ void empty_kernel() {}

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

// tbl [A, B], idx and out [G, I, J]; I == A for axis 1, J == B for axis 0;
// G * I * J and A * B at most 2^31 - 1.
int nl_take_along_axis(const float* tbl, const int* idx, float* out, int A,
                       int B, long long G, int I, int J, int axis, int device,
                       void* stream) {
  if (A <= 0 || B <= 0 || I <= 0 || J <= 0 || G < 0 ||
      (axis == 1 && I != A) || (axis == 0 && J != B) ||
      (axis != 0 && axis != 1) || G * I * J > INT_MAX ||
      (long long)A * B > INT_MAX)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int total = (int)(G * I * J);
  if (total == 0) return cudaSuccess;
  const bool vec =
      J % 4 == 0 && ((uintptr_t)idx | (uintptr_t)out) % 16 == 0;
  const long long table_bytes = (long long)A * B * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_bytes <= kMaxSharedTable) {
    launch_along_axis<true>(vec, tbl, idx, out, A, B, I, J, total, axis,
                            (size_t)table_bytes, s);
  } else {
    launch_along_axis<false>(vec, tbl, idx, out, A, B, I, J, total, axis, 0,
                             s);
  }
  return cudaGetLastError();
}

// One launch of an empty kernel (1 block of 32 threads) on the stream.
int nl_empty_kernel(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
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
