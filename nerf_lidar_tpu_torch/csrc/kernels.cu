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
//   Kuhn simplex) interpolation, C = 1, 2, 4, 8 or 16 channels (any other
//   C: the general path below), and levels at or below the coarse cutoff
//   that encode each sample's mean point once with the mean erf weight (the
//   presets'). Bound by table reads: up to 8
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
//   - C >= 8 (the presets' C16 NeRF grids, and C8): lane = sample for the
//     cells, weights and runs as above, but the kG = C / 4 lanes of a group
//     read their samples' rows together (gather_wide): in round m lane p of
//     the group reads float4 p of the row of its m-th sample, so a warp
//     load covers 32 / kG whole rows in full 32-byte sectors, where a lane
//     a row spread each of its C / 4 loads over 32 rows and half of each
//     sector; a run's end becomes a warp-wide step, with tetra one step per
//     corner of non-zero weight of each lane (4 for a run of one point)
//     instead of 8; the same lanes store the output rows, contiguous;
//   - tetra: the 4 simplex corners placed by the axis ranks (no loop over
//     the 8), and a hashed level's row `& (rows - 1)` (the same value as
//     `% rows` for its power-of-two rows).
//   Measured and dropped: a shared-memory copy of the coarse levels' slices
//   in persistent blocks, slower than these reads on the render's and the
//   train step's points (PERF.md).
//   Residual mode (the forward of a grid whose x01 / stds take a gradient:
//   pose and track refinement): the position gradient is a contraction of
//   per-point terms with g_out, and the terms need the corner rows of the
//   point's cell, which this thread reads anyway. So a run reads its 8 rows
//   when it starts and keeps them in registers (its weighted sum is taken
//   from them when it ends: the features are the same bits as without the
//   mode), and every point writes, in its own step of the loop, its 4 rows
//   of C floats (rows 0-2: erf_w / n * scale * d f / d frac_d, row 3:
//   d erf_w / ds / n * f; a mean-point level: the mean point's terms with
//   w_mean / n, and each point's own d erf_w / ds), zeros out of range,
//   with streaming stores (evict-first: R should not push the level's rows
//   out of the L2). R is [L, n, 4, B, C]: the lanes of a warp, which step
//   through their points together, store a row of point j as 32 C
//   contiguous floats. Measured and dropped (PERF.md): R [L, B, n, 4, C]
//   written when a run ends, walking its points again (each lane's rows
//   448 bytes from its neighbour's, and the walks diverging): NeRF 5.07 ms
//   against H1's 2.07 on the refinement step. The backward then reads R
//   instead of the table: where the earlier position-gradient pass and every
//   redesign of it re-gathered the corner rows of every point and level
//   (PERF.md), this adds R's write to H1 and one read.
//   C >= 8 (no configuration asks it): each lane reads its point's corner
//   rows anew, float4 by float4, after the warp's encode.
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
//   - (C a power of two up to 32; any other C: the general path below)
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
// H1 backward hash_encode_ms_bwd: the d_table gradient of hash_encode_ms,
//   which JAX gets by autodiff through the gathers of _ms_encode_impl
//   (diff_inputs=True) or from _ms_encode_nodiff_bwd (diff_inputs=False).
//   Every in-range corner adds w_corner * erf_w / n * g_out[b, l] to its
//   row (a mean-point level: w_corner * w_mean * g_out[b, l] at the mean
//   point). d_x01 / d_stds come from H1's residuals (hash_encode_ms_pos_grads
//   below), in both modes. Bound by table atomics, and at the
//   coarse levels by same-row serialisation: training points cluster along
//   rays, so millions of updates land on a few thousand rows. Design, with
//   the forward's threads, block order and staging (level-major, a level's
//   d_table slice of up to 33.5 MB takes its atomics in L2):
//   - the corner-run merge: 8 row updates per run of same-cell points
//     instead of 8 per point (56 -> 8 at the coarse levels for n = 7);
//   - neighbouring lanes (neighbouring samples of a ray) whose runs end in
//     the same cell sum their updates with a segmented shuffle scan, and
//     the segment's last lane adds them through add_row, K3's row atomic;
//     in the preset modes (tetra, C >= 8) the scan stops below the longest
//     segment (one warp reduction) instead of always taking 5 steps;
//   - C >= 8: the segments' sums leave lane-transposed (WideRows): staged in
//     the warp's shared-memory slots, then lane p of a group adds float4 p
//     of its group's rows, so one float4 atomic instruction covers 32 / kG
//     whole rows in full sectors where a lane a row covered 32 rows, half of
//     each sector. The count of atomics, not their bytes, bounds these
//     levels: the host counts of the train step's updates (PERF.md) leave
//     <= 10% to a merge by row within a sample or a warp, so none is built;
//   - C >= 8 mean levels (add_mean_segments): every lane stages g and its
//     corner weights, and lane (corner, float4) of a segment sums its
//     members' products in one pass, in place of 8 segmented scans of C
//     values over a ray's long same-cell segments. What holds a mean level
//     near 0.12 ms against its 0.035 ms bound is open (PERF.md).
//   Measured and dropped: summing the coarse levels in shared memory
//   (persistent blocks, one flush per block), slower than the merged device
//   atomics on the train step's points (PERF.md). Atomics make every sum
//   order change from run to run.
//
// Deterministic variants (torch.are_deterministic_algorithms_enabled(); the
//   JAX package's scatter-adds are XLA's, whose sums do not depend on the
//   run): hash_encode_ms_bwd_fixed (d_table) and scatter_add_rows_fixed
//   (K3), with abs_bound before and fixed_to_float after. A float sum depends
//   on its order; an integer sum does not. So every term is rounded once, by
//   its own lane and before any cross-lane sum, to a fixed-point int64, u *
//   2^k[g, c] to the nearest integer, and all sums after that are exact: where
//   terms are merged (a thread's run, a warp's segmented scan, L2 atomics) and
//   in what order cannot move a bit, so neither can the block order, the block
//   size or the sinks' layout. k[g, c] = 62 - ceil(log2
//   S[g, c]), S = the sum of |g_out| (H1-bwd, per level g and channel c) or
//   of |vals| (K3, per channel) over the finite entries: each term of an
//   entry of group g is at most |that g_out| (the corner weights of a point
//   times its erf weight / n sum to at most 1), so the entries of a group
//   sum to at most S * 2^k <= 2^62 and no int64 overflows. A non-finite
//   term adds nothing and sets its entry's NaN / +inf / -inf flag (an
//   atomicOr, which no order changes); fixed_to_float then writes NaN (NaN,
//   or both infinities), +-inf, or the sum times 2^-k, which is what a
//   float sum of the same terms gives. Design:
//   - abs_bound: S as one kernel (one read of g_out or vals, 16-byte loads
//     where a row holds whole float4s, float64 sums in an order fixed by
//     the shape: block partials by a tree, then, in the block that
//     finishes last, 32 lanes a column over the blocks), and k from it, in
//     place of four torch passes;
//   - H1-bwd keeps its threads, block orders (picked for the int64 table's
//     size, ops/grid.py:fixed_level_major), corner-run merge and warp
//     aggregation on int64; its row sums leave by add_rows_transposed: the
//     warp compacts its segment ends by a ballot and lane j adds channel
//     j % C of the (j / C)-th, so one atomic instruction covers 32 / C
//     whole rows (C4: a 32-byte sector a row) where a lane a row spent C
//     scalar ones over 32 sectors (15.9 ms on the NeRF grid's train step
//     with a lane a row, 12.3 transposed; PERF.md). Measured and dropped
//     (PERF.md): a
//     block's shared-memory table keyed by row that merged its rows'
//     updates before device memory (slower at every level and size: its
//     64-bit shared atomics, fill and flush cost more than the device
//     atomics they saved), and cutting a hashed level's rows into passes so
//     each pass's 32 MB of sums stay in L2 (each pass walks every point
//     again: 1.8 ms a level against 1.3);
//   - K3 keeps its chunks and tiling, with each value rounded as it is
//     loaded, the runs summed in int64 registers, shuffles and shared
//     memory, and every finished run added by its warp lane-transposed;
//   - fixed_to_float reads each int64 sum once and leaves it and the flags
//     zero, so the wrappers keep one accumulator a shape (no zero fill a
//     call).
//   Bound as the float kernels (table / output atomics), plus the int64
//   accumulator (8 bytes an entry) read and cleared once by fixed_to_float;
//   on the card the sums are held back by the L2's int64 atomics, C a row
//   where the float kernels' vector atomic is one (PERF.md).
//
// hash_encode_ms_pos_grads: d_x01 / d_stds of hash_encode_ms in both modes,
//   from H1's residuals R [L, n, 4, B, C]: d_x01[b, j, d] = sum_l sum_c
//   R[l, j, d, b, c] g_out[b, l, c], d_stds[b, j] the same over row 3. It
//   replaces, with H1's residual mode, what JAX's autodiff of
//   nerf_lidar_tpu/ops/grid.py:_ms_encode_impl does with the intermediates
//   it saves (diff_inputs=True). Bound by bytes: R read once, g_out read
//   once, the outputs written once (3.11 GB, 0.93 ms at 3.35 TB/s, for the
//   refinement step's NeRF grid). Design: a thread a point, a warp 32
//   neighbouring samples' point j, so each of its loads of a row covers 32
//   C contiguous floats; sums in a fixed order (levels, then channels), each
//   output written once: no atomics, the same bits in every run and mode.
//
// The general path: every width C that the kernels above are not
// instantiated for (H1 and its backward: 1, 2, 4, 8, 16; K3: powers of two
// up to 32), so any level_dim the JAX package takes (C3, C5, C6, C12, C24,
// C32, ...). A row of C floats is S = C / V slices of V = gcd(C, 4) floats:
// one float, float2 or float4 load, the widest every row start allows (the
// wrappers check the tensors' start for that width). Bound as the tuned
// kernels (table reads; atomics), and held back where a sample's points
// are walked again for each part of its rows: each walk recomputes the
// cells, erf weights, corner weights, runs and warp merges, and fetches
// the corner rows' sectors again. Design (ops/grid.py:walk_plan picks the
// plan; its register counts and times: PERF.md):
//   - H1 (both modes): a sample takes as many neighbouring lanes as its
//     row needs at kLaneFloats = 4 floats a lane (C3: one lane, C6: two,
//     C12: three; 32 / lanes samples a warp), so a level is one walk of
//     its points for C <= 128 (blocks: levels x tiles); a lane computes
//     each point's cell, erf and corner weights once for its span, reads a
//     run's corner rows as its slices' loads (gather_span), the group's
//     lanes a row's neighbouring spans together; the residual mode keeps
//     the run's 8 corner spans in registers (32 floats, the tuned C4
//     residual kernel's) and the group stores R's neighbouring spans
//     together. (The tuned C >= 8 residual pass is slow for another
//     reason: each lane reads every point's corner rows anew, a float4
//     part at a time, after the warp's encode; here a run's rows are read
//     once, when it starts.) Measured and dropped (PERF.md): a lane a
//     sample with a 16-float span (72-90 registers), and with 4 slices
//     (C6 and C12 slower on the train calls);
//   - H1-bwd: a lane a sample (the warp's segment merge), holding g_out's
//     span of up to kSpanSlices = 4 slices (C3, C6, C12 in one walk a
//     level; ceil(S / 4) walks, a block a (level, walk) of a tile), the
//     segment ends adding the span at once (add_runs_span); its
//     deterministic variant takes 4 floats a walk at V = 1 (C3 one walk)
//     and one slice above (C6 and C12 three walks: wider int64 spans held
//     more registers and were slower there, PERF.md);
//   - each channel keeps the runs, weights, warp merges and order of sums
//     of a C-wide instantiation: the features and R are the tuned V-wide
//     kernels' bits on the same columns, the deterministic d_table the
//     plain twin's;
//   - the atomic backward adds a run's row as float4 atomics on 16-byte
//     rows: d_table itself where C % 4 == 0, else, on a call dense enough
//     (ops/grid.py:pad_rows), a zeroed scratch of rows padded to Cp = 4
//     ceil(C / 4) floats (C3: one `red` a row where a lane a slice issued
//     three scalar ones; the L2 takes atomics at a rate of operations, not
//     of bytes: PERF.md), whose sums unpad_rows_kernel then writes into
//     d_table (read once, Cp / C of d_table's bytes); a sparse call adds
//     V-float atomics a slice into d_table;
//   - the deterministic backward keeps the [rows, C] int64 sums (no 64-bit
//     vector atomic): a segment's span of w channels leaves by
//     add_span_transposed, lane j adding channel j % w of the (j / w)-th
//     row, so one instruction covers 32 / w whole rows; its exponents are
//     read from the L1 when a term is rounded, not held in registers;
//   - the contraction (pos_grads_slices_kernel) reads a row of R and g_out as
//     C / V slices, in the plain version's order of sums;
//   - K3 and its deterministic variant (scatter_add_slices_kernel) cut the
//     flattened values into slices, a block's working threads a multiple of
//     S, so every thread's run stays on one slice of one row (the hash decay's
//     level sums: a few atomics a block); the int64 sums leave by the warp's
//     transposed atomics on the [rows S, V] view;
//   - fixed_to_float_any_kernel finds each entry's row, channel and exponent
//     group on its own (groups may start on any entry).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxLevels = 32;
constexpr float kEps = 1.1920929e-07f;  // float32 eps, as in the reference
constexpr unsigned kFullMask = 0xffffffffu;

// Samples (threads) of a block of H1 and its backward.
constexpr int kThreads = 128;
// Threads of a block of hash_encode_ms_pos_grads, and the samples it takes
// (a warp's; its other threads take more points of them).
constexpr int kPosThreads = 256;
constexpr int kPosSamples = 32;
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

// One level's constants, as a thread uses them. mask: rows - 1 where rows
// is a power of two (every hashed level), else 0.
struct Level {
  float scale, g2;
  uint32_t res, rows, mask;
  bool tiled, mean;
};

__device__ __forceinline__ Level level_of(const GridLevels& lv, int l) {
  const float g = lv.grid_size[l];
  const uint32_t rows = lv.rows[l];
  return Level{lv.scale[l],       g * g,
               lv.res[l],         rows,
               (rows & (rows - 1u)) == 0u ? rows - 1u : 0u,
               lv.tiled[l] != 0,  lv.mean[l] != 0};
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
// or the 4 simplex weights. Simplex vertex k is corner vertex_corner(t, k):
// vertex 0 is corner 0 and vertex 3 corner 7; vertex 1 steps along the
// axis of rank 0 (corner 1, 2 or 4), vertex 2 along all but the axis of
// rank 2 (corner 6, 5 or 3). c is a constant in each branch, so W stays in
// registers.
template <bool kTetra>
__device__ __forceinline__ void add_weights(const Cell& p, float a,
                                            float* W) {
  if constexpr (kTetra) {
    const Simplex t = simplex_of(p);
    W[0] += a * t.w[0];
    if (t.r[0] == 0)
      W[1] += a * t.w[1];
    else if (t.r[1] == 0)
      W[2] += a * t.w[1];
    else
      W[4] += a * t.w[1];
    if (t.r[0] == 2)
      W[6] += a * t.w[2];
    else if (t.r[1] == 2)
      W[5] += a * t.w[2];
    else
      W[3] += a * t.w[2];
    W[7] += a * t.w[3];
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
// arithmetic and `% rows`, as the reference. kMask (the preset modes):
// `& (rows - 1)` where rows is a power of two, the same value without the
// division's instruction sequence.
template <bool kMask = false>
__device__ __forceinline__ uint32_t corner_row(int ix, int iy, int iz, int c,
                                               const Level& v) {
  const uint32_t ux = (uint32_t)(ix + (c & 1));
  const uint32_t uy = (uint32_t)(iy + ((c >> 1) & 1));
  const uint32_t uz = (uint32_t)(iz + ((c >> 2) & 1));
  const uint32_t idx =
      v.tiled ? (ux + uy * v.res + uz * v.res * v.res)
              : ((ux * 1u) ^ (uy * 2654435761u) ^ (uz * 805459861u));
  if (kMask && v.mask != 0u) return idx & v.mask;
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
    load_row<C>(tbl + (int64_t)corner_row<kTetra>(ix, iy, iz, c, v) * C, row);
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] += W[c] * row[k];
  }
}

// The kG = C / 4 lanes of a group (C >= 8): lanes base .. base + kG - 1 of
// a warp, base = lane - lane % kG. They read and write their samples' rows
// together, one float4 (part p = lane % kG) of a row each.
struct Group {
  int p, base;
};

template <int C>
__device__ __forceinline__ Group group_of() {
  constexpr int kG = C / 4;
  const int lane = threadIdx.x & 31;
  return Group{lane % kG, lane - lane % kG};
}

// One corner of every lane's run, read by the lanes of its group (C >= 8,
// warp-collective): on / row / w are this lane's (on: it reads a row of
// weight w); in round m lane base + p reads float4 p of the row of sample
// base + m and adds it into acc[m], float4 p of that sample's sum.
template <int C>
__device__ __forceinline__ void gather_corner(bool on, uint32_t row, float w,
                                              const float4* part,
                                              float4* acc) {
  constexpr int kG = C / 4;
  const Group gr = group_of<C>();
  const unsigned ons = __ballot_sync(kFullMask, on);
#pragma unroll
  for (int m = 0; m < kG; ++m) {
    const int src = gr.base + m;
    const uint32_t r = __shfl_sync(kFullMask, row, src);
    const float wm = __shfl_sync(kFullMask, w, src);
    if ((ons >> src) & 1u) {
      const float4 t = __ldg(part + (int64_t)r * kG);
      acc[m].x += wm * t.x;
      acc[m].y += wm * t.y;
      acc[m].z += wm * t.z;
      acc[m].w += wm * t.w;
    }
  }
}

// gather_run for C >= 8, warp-collective: every lane calls, `act` says
// that its run ends here. The lanes of a group read their runs' rows
// together (gather_corner), so one load instruction of the warp covers
// 32 / kG whole rows in full 32-byte sectors, where one lane a row reads
// C / 4 float4s, each instruction over 32 rows and half of each sector.
// With tetra the warp steps through each lane's corners of non-zero
// weight, the i-th of every lane at step i (a run of one point has 4 of
// the 8), instead of through the 8 corners. The corners, weights and order
// of adds are gather_run's, so the sums are its bits.
template <int C, bool kTetra>
__device__ __forceinline__ void gather_wide(bool act, int ix, int iy, int iz,
                                            const float* W, const Level& v,
                                            const float* tbl, float4* acc) {
  const float4* part =
      reinterpret_cast<const float4*>(tbl) + group_of<C>().p;
  if constexpr (kTetra) {
    unsigned left = 0u;  // this lane's corners still to read
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (act && W[c] != 0.f) left |= 1u << c;
    const int steps = (int)__reduce_max_sync(kFullMask, __popc(left));
    for (int i = 0; i < steps; ++i) {
      const bool on = left != 0u;
      const int c = on ? __ffs(left) - 1 : 0;
      left &= left - 1u;
      float w = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) w = c == k ? W[k] : w;
      gather_corner<C>(on, on ? corner_row<true>(ix, iy, iz, c, v) : 0u, w,
                       part, acc);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      gather_corner<C>(act, act ? corner_row<true>(ix, iy, iz, c, v) : 0u,
                       W[c], part, acc);
  }
}

// The erf downweighting of a point with std s at one level.
__device__ __forceinline__ float erf_weight(float s, const Level& v) {
  return erff(1.0f / sqrtf(fmaxf(8.0f * (s * s) * v.g2, 1e-10f)));
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

// H1's residual mode. R [L, n, 4, B, C] holds, per level, point j, row q
// and sample b, the C floats that d_x01 / d_stds contract with g_out
// (hash_encode_ms_pos_grads): rows 0-2 kx * d f / d frac_d, row 3 ks * f,
// with f the point's interpolated row, kx = erf_w / n * scale (a mean-point
// level: w_mean / n * scale, d frac / d x = scale) and ks = d erf_w / ds / n;
// zeros for a point out of range. Samples are the fastest axis after the
// channels, so the lanes of a warp (neighbouring samples) writing their
// point j store one contiguous run of 32 C floats a row.
struct ResOut {
  float* p;       // R[l, 0, 0, b]: this sample's rows at this level
  int64_t plane;  // B * C: from one (point, row) plane to the next
  __device__ __forceinline__ float* row(int j, int q) const {
    return p + (4 * j + q) * plane;
  }
};

// Bits of a corner's offsets: the simplex vertex it is, if any.
__host__ __device__ constexpr int corner_bits(int c) {
  return (c & 1) + ((c >> 1) & 1) + ((c >> 2) & 1);
}

// The corners of the point's simplex (tetra) or all 8, as a mask.
template <bool kTetra>
__device__ __forceinline__ unsigned reached_corners(const Cell& p) {
  if constexpr (kTetra) {
    const Simplex t = simplex_of(p);
    return 1u | (1u << vertex_corner(t, 1)) | (1u << vertex_corner(t, 2)) |
           0x80u;
  } else {
    return 0xffu;
  }
}

// f[k] = sum_c w_c row_c[k] and df[d][k] = sum_c (d w_c / d frac_d)
// row_c[k] of a point in cell p, from its corner rows[c] (the derivative of
// the trilinear weights, or of the simplex weights with the sorted
// fractions' gradients by JAX's rule at ties; corners off the simplex are
// not read). c is a constant in each unrolled step, so rows stay in
// registers.
template <int C, bool kTetra>
__device__ __forceinline__ void point_terms(const Cell& p,
                                            const float (*rows)[C],
                                            float* f, float (*df)[C]) {
#pragma unroll
  for (int k = 0; k < C; ++k) f[k] = df[0][k] = df[1][k] = df[2][k] = 0.f;
  if constexpr (kTetra) {
    const Simplex t = simplex_of(p);
    float d1[3], d3[3];
    sorted_grad<true>(p, d1);
    sorted_grad<false>(p, d3);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int k = corner_bits(c);
      if (vertex_corner(t, k) != c) continue;
      float dw[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float d2 = 1.f - d1[d] - d3[d];
        dw[d] = k == 0   ? -d1[d]
                : k == 1 ? d1[d] - d2
                : k == 2 ? d2 - d3[d]
                         : d3[d];
      }
#pragma unroll
      for (int q = 0; q < C; ++q) {
        f[q] += t.w[k] * rows[c][q];
#pragma unroll
        for (int d = 0; d < 3; ++d) df[d][q] += dw[d] * rows[c][q];
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float wx = (c & 1) ? p.rx : 1.f - p.rx;
      const float wy = (c & 2) ? p.ry : 1.f - p.ry;
      const float wz = (c & 4) ? p.rz : 1.f - p.rz;
      const float w = wx * wy * wz;
      const float dw[3] = {((c & 1) ? 1.f : -1.f) * wy * wz,
                           wx * ((c & 2) ? 1.f : -1.f) * wz,
                           wx * wy * ((c & 4) ? 1.f : -1.f)};
#pragma unroll
      for (int q = 0; q < C; ++q) {
        f[q] += w * rows[c][q];
#pragma unroll
        for (int d = 0; d < 3; ++d) df[d][q] += dw[d] * rows[c][q];
      }
    }
  }
}

// p[0..kW) = v[0..kW) with streaming stores (R is read once, by the
// backward, and should not push the level's table rows out of the L2); p
// is 4 min(kW, 4)-byte aligned (a row of R, C floats at a multiple of C).
template <int kW>
__device__ __forceinline__ void store_streaming(float* p, const float* v) {
  if constexpr (kW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kW / 4; ++i)
      __stcs(reinterpret_cast<float4*>(p) + i,
             make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]));
  } else if constexpr (kW == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int i = 0; i < kW; ++i) __stcs(p + i, v[i]);
  }
}

// Point j's residual rows, kW channels of each at `at` (the first channel
// of the part; C >= 8 writes its rows a float4 part at a time): kx * df[d]
// and ks * f.
template <int kW>
__device__ __forceinline__ void store_residual(const ResOut& r, int j,
                                               int at, float kx, float ks,
                                               const float* f,
                                               const float (*df)[kW]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float v[kW];
#pragma unroll
    for (int q = 0; q < kW; ++q) v[q] = kx * df[d][q];
    store_streaming<kW>(r.row(j, d) + at, v);
  }
  float v[kW];
#pragma unroll
  for (int q = 0; q < kW; ++q) v[q] = ks * f[q];
  store_streaming<kW>(r.row(j, 3) + at, v);
}

// Point j's zero residual rows.
template <int C>
__device__ __forceinline__ void store_zero_residual(const ResOut& r, int j) {
  const float z[C] = {};
#pragma unroll
  for (int q = 0; q < 4; ++q) store_streaming<C>(r.row(j, q), z);
}

// The corner rows of cell (ix, iy, iz) a mask `reach` names into rows[8][C]
// (the others are left as they are and not read).
template <int C, bool kTetra>
__device__ __forceinline__ void load_corners(const float* tbl, int ix, int iy,
                                             int iz, unsigned reach,
                                             const Level& v,
                                             float (*rows)[C]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (!((reach >> c) & 1u)) continue;
    load_row<C>(tbl + (int64_t)corner_row<kTetra>(ix, iy, iz, c, v) * C,
                rows[c]);
  }
}

// acc += sum_c W[c] rows[c], in gather_run's order and with its skips (so
// with the same bits).
template <int C, bool kTetra>
__device__ __forceinline__ void add_run(const float* W, const float (*rows)[C],
                                        float* acc) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (kTetra && W[c] == 0.f) continue;
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] += W[c] * rows[c][k];
  }
}

// The encode of one sample at one level, before the division by n:
// acc[k] = sum over in-range points j of erf_w_j sum_c w_jc row_c[k], each
// corner row read once per run of same-cell points. tbl: the level's slice
// of the table. kResid: also every point's residual, written in the
// point's own step (the lanes of a warp step through the points together,
// so their stores of point j are one contiguous run): a run's corner rows
// are read when it starts and kept in registers (with tetra all 8: which
// of them the run's points reach is not known yet), and its weighted sum
// is taken from them when it ends.
template <int C, bool kTetra, bool kResid>
__device__ __forceinline__ void encode_one(const float* tbl, Points pt, int n,
                                           const Level& v, float* acc,
                                           const ResOut& r) {
  float W[8];
  float rows[8][C];
  int cx = 0, cy = 0, cz = 0;
  bool have = false;
  const float inv_n = 1.0f / (float)n;
  for (int j = 0; j < n; ++j) {
    const float x = pt.x[3 * j], y = pt.x[3 * j + 1], z = pt.x[3 * j + 2];
    if (!in_unit_cube(x, y, z)) {  // encodes to 0, breaks no run
      if constexpr (kResid) store_zero_residual<C>(r, j);
      continue;
    }
    const float wl = erf_weight(pt.s[j], v);
    const Cell p = cell_of(x, y, z, v.scale);
    if (have && !same_cell(p, cx, cy, cz)) {
      if constexpr (kResid)
        add_run<C, kTetra>(W, rows, acc);
      else
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
      if constexpr (kResid)
        load_corners<C, kTetra>(tbl, cx, cy, cz, 0xffu, v, rows);
    }
    add_weights<kTetra>(p, wl, W);
    if constexpr (kResid) {
      float f[C], df[3][C];
      point_terms<C, kTetra>(p, rows, f, df);
      store_residual<C>(r, j, 0, wl * inv_n * v.scale,
                        inv_n * erf_weight_grad(pt.s[j], v), f, df);
    }
  }
  if (!have) return;
  if constexpr (kResid)
    add_run<C, kTetra>(W, rows, acc);
  else
    gather_run<C, kTetra>(tbl, cx, cy, cz, W, v, acc);
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
// kResid: each point j gets the mean point's terms, kx = w_mean / n *
// scale (x_mean = sum_j x_j / n) and ks = d erf_w(s_j) / ds / n (w_mean =
// sum_j erf_w_j / n).
template <int C, bool kTetra, bool kResid>
__device__ __forceinline__ void encode_mean(const float* tbl, Points pt,
                                            int n, const Level& v,
                                            float* acc, const ResOut& r) {
  const MeanPoint m = mean_of(pt, n, v);
  if (!in_unit_cube(m.x, m.y, m.z)) {
    if constexpr (kResid)
      for (int j = 0; j < n; ++j) store_zero_residual<C>(r, j);
    return;
  }
  const Cell p = cell_of(m.x, m.y, m.z, v.scale);
  float W[8] = {};
  add_weights<kTetra>(p, m.w, W);
  if constexpr (kResid) {
    float rows[8][C], f[C], df[3][C];
    load_corners<C, kTetra>(tbl, p.ix, p.iy, p.iz, reached_corners<kTetra>(p),
                            v, rows);
    add_run<C, kTetra>(W, rows, acc);
    point_terms<C, kTetra>(p, rows, f, df);
    const float inv_n = 1.0f / (float)n, kx = m.w / (float)n * v.scale;
    for (int j = 0; j < n; ++j)
      store_residual<C>(r, j, 0, kx, inv_n * erf_weight_grad(pt.s[j], v), f,
                        df);
  } else {
    gather_run<C, kTetra>(tbl, p.ix, p.iy, p.iz, W, v, acc);
  }
}

// The residuals of one sample at one level for C >= 8, by its own lane
// (after the warp's encode, which keeps no rows in registers): per float4
// part of the rows, each point's (or the mean point's) corner parts read
// anew and its residual's parts written. No configuration takes position
// gradients on a C >= 8 grid; this keeps the contract at those widths.
template <int C, bool kTetra>
__device__ __forceinline__ void residuals_wide(const float* tbl, Points pt,
                                               int n, const Level& v,
                                               const ResOut& r) {
  const float inv_n = 1.0f / (float)n;
  const auto one = [&](const Cell& p, int j, float kx, float ks) {
    const unsigned reach = reached_corners<kTetra>(p);
#pragma unroll 1
    for (int q = 0; q < C / 4; ++q) {
      float rows[8][4], f[4], df[3][4];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (!((reach >> c) & 1u)) continue;
        load_row<4>(tbl + (int64_t)corner_row<true>(p.ix, p.iy, p.iz, c, v) *
                              C + 4 * q,
                    rows[c]);
      }
      point_terms<4, kTetra>(p, rows, f, df);
      store_residual<4>(r, j, 4 * q, kx, ks, f, df);
    }
  };
  if (v.mean) {
    const MeanPoint m = mean_of(pt, n, v);
    const bool in = in_unit_cube(m.x, m.y, m.z);
    const Cell p = cell_of(m.x, m.y, m.z, v.scale);
    for (int j = 0; j < n; ++j) {
      if (in)
        one(p, j, m.w / (float)n * v.scale,
            inv_n * erf_weight_grad(pt.s[j], v));
      else
        store_zero_residual<C>(r, j);
    }
    return;
  }
  for (int j = 0; j < n; ++j) {
    const float x = pt.x[3 * j], y = pt.x[3 * j + 1], z = pt.x[3 * j + 2];
    if (!in_unit_cube(x, y, z)) {
      store_zero_residual<C>(r, j);
      continue;
    }
    const float s = pt.s[j];
    one(cell_of(x, y, z, v.scale), j, erf_weight(s, v) * inv_n * v.scale,
        inv_n * erf_weight_grad(s, v));
  }
}

// encode_one for C >= 8, warp-collective (active: this lane holds a
// sample): the runs of encode_one, each read by gather_wide when it ends.
template <int C, bool kTetra>
__device__ __forceinline__ void encode_one_wide(bool active, const float* tbl,
                                                Points pt, int n,
                                                const Level& v, float4* acc) {
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
    const bool in = active && in_unit_cube(x, y, z);
    const Cell p = cell_of(x, y, z, v.scale);
    const bool ends = in && have && !same_cell(p, cx, cy, cz);
    if (__any_sync(kFullMask, ends))
      gather_wide<C, kTetra>(ends, cx, cy, cz, W, v, tbl, acc);
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
      add_weights<kTetra>(p, erf_weight(s, v), W);
    }
  }
  if (__any_sync(kFullMask, have))
    gather_wide<C, kTetra>(have, cx, cy, cz, W, v, tbl, acc);
}

// encode_mean for C >= 8, warp-collective.
template <int C, bool kTetra>
__device__ __forceinline__ void encode_mean_wide(bool active,
                                                 const float* tbl, Points pt,
                                                 int n, const Level& v,
                                                 float4* acc) {
  MeanPoint m{0.f, 0.f, 0.f, 0.f};
  if (active) m = mean_of(pt, n, v);
  const bool in = active && in_unit_cube(m.x, m.y, m.z);
  const Cell p = cell_of(m.x, m.y, m.z, v.scale);
  float W[8] = {};
  if (in) add_weights<kTetra>(p, m.w, W);
  if (__any_sync(kFullMask, in))
    gather_wide<C, kTetra>(in, p.ix, p.iy, p.iz, W, v, tbl, acc);
}

// out: nullptr where only the residuals are wanted. kResid: resid [L, n,
// 4, B, C] gets every point's residual (see encode_one).
template <int C, bool kTetra, bool kResid>
__global__ void hash_encode_ms_kernel(const float* __restrict__ table,
                                      const float* __restrict__ x01,
                                      const float* __restrict__ stds,
                                      float* __restrict__ out,
                                      float* __restrict__ resid, int64_t B,
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
  const float* tbl = table + (int64_t)lv.offset[w.l] * C;
  if constexpr (C >= 8) {
    // Lane = sample for the cells and weights; a group's lanes read its
    // rows together (gather_wide), so a warp with any sample keeps all its
    // lanes, and each lane stores float4 p of its group's samples.
    if ((int)(threadIdx.x & ~31u) >= cnt) return;
    const bool active = (int)threadIdx.x < cnt;
    const Points pt =
        points_of(x01, stds, w.b0, cnt, n, stage ? smem : nullptr);
    constexpr int kG = C / 4;
    float4 acc[kG];
#pragma unroll
    for (int m = 0; m < kG; ++m) acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (v.mean) {
      encode_mean_wide<C, kTetra>(active, tbl, pt, n, v, acc);
    } else {
      encode_one_wide<C, kTetra>(active, tbl, pt, n, v, acc);
      const float fn = (float)n;
#pragma unroll
      for (int m = 0; m < kG; ++m)
        acc[m] = make_float4(acc[m].x / fn, acc[m].y / fn, acc[m].z / fn,
                             acc[m].w / fn);
    }
    const Group gr = group_of<C>();
    const int t0 = (int)(threadIdx.x & ~31u) + gr.base;
#pragma unroll
    for (int m = 0; m < kG; ++m) {
      if (out == nullptr || t0 + m >= cnt) break;
      const int64_t b = w.b0 + t0 + m;
      reinterpret_cast<float4*>(out + (b * L + w.l) * C)[gr.p] = acc[m];
    }
    if constexpr (kResid) {
      if (active)
        residuals_wide<C, kTetra>(
            tbl, pt, n, v,
            ResOut{resid + ((int64_t)w.l * n * 4 * B + w.b0 + threadIdx.x) *
                               C,
                   B * C});
    }
    return;
  }
  if ((int)threadIdx.x >= cnt) return;
  float acc[C] = {};
  const int64_t b = w.b0 + threadIdx.x;
  const Points pt = points_of(x01, stds, w.b0, cnt, n, stage ? smem : nullptr);
  const ResOut res{
      kResid ? resid + ((int64_t)w.l * n * 4 * B + b) * C : nullptr, B * C};
  if (v.mean) {
    encode_mean<C, kTetra, kResid>(tbl, pt, n, v, acc, res);
  } else {
    encode_one<C, kTetra, kResid>(tbl, pt, n, v, acc, res);
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] = acc[k] / (float)n;
  }
  if (out != nullptr) store_row<C>(out + (b * L + w.l) * C, acc);
}

// V = gcd(C, 4): the channels the general path takes a slice at a time.
__host__ __device__ constexpr int slice_width(int C) {
  return C % 4 == 0 ? 4 : (C % 2 == 0 ? 2 : 1);
}

// The general path's walks. A lane takes `ns` consecutive slices of V
// floats of every row (its span: channels [c0, c0 + ns V)), at most kS of
// them, so its sums stay in registers: in H1 (both modes) kLaneFloats
// floats (its residual mode keeps a run's 8 corner spans: 32 floats, the
// tuned C4 residual kernel's), a sample taking as many lanes as its row
// needs; in H1-bwd, whose warp merges need a lane a sample, kSpanSlices
// slices (g_out and the terms of 4 V floats: C3, C6, C12 in one walk),
// and in its deterministic variant (int64 terms) fixed_slices<V>().
// ops/grid.py:walk_plan picks the slices a lane takes, the lanes a sample
// and so the walks a level.
constexpr int kLaneFloats = 4;
constexpr int kSpanSlices = 4;

// Slices a walk of the deterministic backward: 4 floats at V = 1 (C3 in
// one walk), one slice above, so the warp's transposed int64 adds take a
// width known at compile time (C6 and C12 in S walks, as a block a slice
// took them; 2-slice and 4-slice walks were slower there: PERF.md).
template <int V>
__host__ __device__ constexpr int fixed_slices() {
  return V == 1 ? kLaneFloats : 1;
}

// A block of the general path: level l, walk `walk` of it, and a tile of
// `tile` samples from b0 (cnt of them present). A warp takes 32 / lanes
// samples, `lanes` neighbouring lanes each; blocks in work_of's orders over
// the L walks (level, walk) pairs.
struct WalkWork {
  int l, walk;
  int64_t b0;
  int cnt;
};

__device__ __forceinline__ WalkWork walk_work(int64_t tiles, int L, int walks,
                                              int lanes, int64_t B,
                                              bool level_major) {
  const int tile = (int)(blockDim.x >> 5) * (32 / lanes);
  const int64_t i = blockIdx.x, pairs = (int64_t)L * walks;
  const int64_t lw = level_major ? i / tiles : i % pairs;
  const int64_t t = level_major ? i % tiles : i / pairs;
  const int64_t b0 = t * tile, rem = B - b0;
  return WalkWork{(int)(lw / walks), (int)(lw % walks), b0,
                  rem < tile ? (int)rem : tile};
}

// Sample t's points in a tile of cnt samples from b0: staged or in device
// memory, as points_of.
__device__ __forceinline__ Points span_points(const float* x01,
                                              const float* stds, int64_t b0,
                                              int t, int cnt, int n,
                                              const float* stage) {
  if (stage != nullptr)
    return Points{stage + t * n * 3, stage + cnt * n * 3 + t * n};
  return Points{x01 + (b0 + t) * n * 3, stds + (b0 + t) * n};
}

// gather_run over a span: acc[0..ns V) += sum_c W[c] * the span of corner
// row c (tbl: the level's table at the span's first channel; rows C floats
// apart). Per channel the corners, weights, skips and order of adds are
// gather_run's, so each channel's sum is a C-wide instantiation's bits. A
// corner's slices load together, from the same sectors.
template <int V, int kS, bool kTetra>
__device__ __forceinline__ void gather_span(const float* tbl, int C, int ns,
                                            int ix, int iy, int iz,
                                            const float* W, const Level& v,
                                            float* acc) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (kTetra && W[c] == 0.f) continue;
    const float* p = tbl + (int64_t)corner_row<kTetra>(ix, iy, iz, c, v) * C;
#pragma unroll
    for (int q = 0; q < kS; ++q) {
      if (q >= ns) continue;
      float row[V];
      load_row<V>(p + q * V, row);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[q * V + k] += W[c] * row[k];
    }
  }
}

// load_corners over a span: the span of each corner row that `reach`
// names into rows[c], zeros past the ns slices.
template <int V, int kS, bool kTetra>
__device__ __forceinline__ void load_corner_spans(const float* tbl, int C,
                                                  int ns, int ix, int iy,
                                                  int iz, unsigned reach,
                                                  const Level& v,
                                                  float (*rows)[kS * V]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (!((reach >> c) & 1u)) continue;
    const float* p = tbl + (int64_t)corner_row<kTetra>(ix, iy, iz, c, v) * C;
#pragma unroll
    for (int q = 0; q < kS; ++q) {
      if (q < ns) {
        load_row<V>(p + q * V, rows[c] + q * V);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) rows[c][q * V + k] = 0.f;
      }
    }
  }
}

// store_residual over a span: point j's rows kx * df[d] and ks * f, the ns
// slices of the span (R's rows at the span's first channel).
template <int V, int kS>
__device__ __forceinline__ void store_residual_span(const ResOut& r, int j,
                                                    float kx, float ks,
                                                    const float* f,
                                                    const float (*df)[kS * V],
                                                    int ns) {
#pragma unroll
  for (int q = 0; q < kS; ++q) {
    if (q >= ns) continue;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float u[V];
#pragma unroll
      for (int k = 0; k < V; ++k) u[k] = kx * df[d][q * V + k];
      store_streaming<V>(r.row(j, d) + q * V, u);
    }
    float u[V];
#pragma unroll
    for (int k = 0; k < V; ++k) u[k] = ks * f[q * V + k];
    store_streaming<V>(r.row(j, 3) + q * V, u);
  }
}

template <int V, int kS>
__device__ __forceinline__ void store_zero_residual_span(const ResOut& r,
                                                         int j, int ns) {
  const float z[V] = {};
#pragma unroll
  for (int q = 0; q < kS; ++q) {
    if (q >= ns) continue;
#pragma unroll
    for (int d = 0; d < 4; ++d) store_streaming<V>(r.row(j, d) + q * V, z);
  }
}

// encode_one over a span of ns slices (the general path): the sample's
// points walked once, each point's cell, erf weight and corner weights
// computed once for every slice of the span; a run's corner rows read
// whole span by span when it ends (gather_span) or, with kResid, when it
// starts (8 spans kept in registers, taken from them when it ends), and
// every point's residual rows written in its own step.
template <int V, int kS, bool kTetra, bool kResid>
__device__ __forceinline__ void encode_span(const float* tbl, int C, int ns,
                                            Points pt, int n, const Level& v,
                                            float* acc, const ResOut& r) {
  constexpr int kW = kS * V;
  float W[8];
  float rows[kResid ? 8 : 1][kW];
  int cx = 0, cy = 0, cz = 0;
  bool have = false;
  const float inv_n = 1.0f / (float)n;
  for (int j = 0; j < n; ++j) {
    const float x = pt.x[3 * j], y = pt.x[3 * j + 1], z = pt.x[3 * j + 2];
    if (!in_unit_cube(x, y, z)) {  // encodes to 0, breaks no run
      if constexpr (kResid) store_zero_residual_span<V, kS>(r, j, ns);
      continue;
    }
    const float wl = erf_weight(pt.s[j], v);
    const Cell p = cell_of(x, y, z, v.scale);
    if (have && !same_cell(p, cx, cy, cz)) {
      if constexpr (kResid)
        add_run<kW, kTetra>(W, rows, acc);
      else
        gather_span<V, kS, kTetra>(tbl, C, ns, cx, cy, cz, W, v, acc);
      have = false;
    }
    if (!have) {
      cx = p.ix;
      cy = p.iy;
      cz = p.iz;
      have = true;
#pragma unroll
      for (int c = 0; c < 8; ++c) W[c] = 0.f;
      if constexpr (kResid)
        load_corner_spans<V, kS, kTetra>(tbl, C, ns, cx, cy, cz, 0xffu, v,
                                         rows);
    }
    add_weights<kTetra>(p, wl, W);
    if constexpr (kResid) {
      float f[kW], df[3][kW];
      point_terms<kW, kTetra>(p, rows, f, df);
      store_residual_span<V, kS>(r, j, wl * inv_n * v.scale,
                                 inv_n * erf_weight_grad(pt.s[j], v), f, df,
                                 ns);
    }
  }
  if (!have) return;
  if constexpr (kResid)
    add_run<kW, kTetra>(W, rows, acc);
  else
    gather_span<V, kS, kTetra>(tbl, C, ns, cx, cy, cz, W, v, acc);
}

// encode_mean over a span.
template <int V, int kS, bool kTetra, bool kResid>
__device__ __forceinline__ void encode_mean_span(const float* tbl, int C,
                                                 int ns, Points pt, int n,
                                                 const Level& v, float* acc,
                                                 const ResOut& r) {
  constexpr int kW = kS * V;
  const MeanPoint m = mean_of(pt, n, v);
  if (!in_unit_cube(m.x, m.y, m.z)) {
    if constexpr (kResid)
      for (int j = 0; j < n; ++j) store_zero_residual_span<V, kS>(r, j, ns);
    return;
  }
  const Cell p = cell_of(m.x, m.y, m.z, v.scale);
  float W[8] = {};
  add_weights<kTetra>(p, m.w, W);
  if constexpr (kResid) {
    float rows[8][kW], f[kW], df[3][kW];
    load_corner_spans<V, kS, kTetra>(tbl, C, ns, p.ix, p.iy, p.iz,
                                     reached_corners<kTetra>(p), v, rows);
    add_run<kW, kTetra>(W, rows, acc);
    point_terms<kW, kTetra>(p, rows, f, df);
    const float inv_n = 1.0f / (float)n, kx = m.w / (float)n * v.scale;
    for (int j = 0; j < n; ++j)
      store_residual_span<V, kS>(r, j, kx,
                                 inv_n * erf_weight_grad(pt.s[j], v), f, df,
                                 ns);
  } else {
    gather_span<V, kS, kTetra>(tbl, C, ns, p.ix, p.iy, p.iz, W, v, acc);
  }
}

// H1 at a width C that hash_encode_ms_kernel is not instantiated for (the
// general path): a row of C floats is S = C / V slices of V = gcd(C, 4)
// floats. A sample takes `lanes` neighbouring lanes of a warp, lane p of
// them `slices` slices of each row, so a walk of its points covers
// lanes * slices slices; a block takes one (level, walk) of a tile, `walks`
// = ceil(S / (lanes slices)) of them a level (walk_work). A lane runs
// encode_one's runs over its span (encode_span / encode_mean_span): the
// same runs, weights and order of sums for each channel as a C-wide
// instantiation, so the features (and with kResid R) are its bits.
// A lane takes up to kLaneFloats floats (with kResid it keeps a run's 8
// corner spans in registers), and a sample as many lanes as its row needs
// (C3: one, C6: two, C12: three, each a float4 of the 8 corners), which
// read and write the row's neighbouring spans together: one walk a level
// for C <= 128. (One lane a sample and 4 slices, C6 and C12 in one lane,
// took 90 registers and was slower on the train calls: PERF.md.)
template <int V, bool kTetra, bool kResid>
__global__ void hash_encode_ms_any_kernel(
    const float* __restrict__ table, const float* __restrict__ x01,
    const float* __restrict__ stds, float* __restrict__ out,
    float* __restrict__ resid, int64_t B, int n, int L, int C, int slices,
    int lanes, int walks, int64_t tiles, int level_major, int stage,
    GridLevels lv) {
  constexpr int kS = kLaneFloats / V;
  extern __shared__ __align__(16) float smem[];
  const WalkWork w = walk_work(tiles, L, walks, lanes, B, level_major != 0);
  const Level v = level_of(lv, w.l);
  if (stage) {
    stage_tile(x01, stds, w.b0, w.cnt, n, smem, smem + w.cnt * n * 3);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, per = 32 / lanes;
  const int t = (int)(threadIdx.x >> 5) * per + lane / lanes;
  const int q0 = (w.walk * lanes + lane % lanes) * slices;
  const int ns = min(slices, C / V - q0);
  if (lane >= per * lanes || t >= w.cnt || ns <= 0) return;
  const int64_t b = w.b0 + t;
  const Points pt =
      span_points(x01, stds, w.b0, t, w.cnt, n, stage ? smem : nullptr);
  const float* tbl = table + (int64_t)lv.offset[w.l] * C + q0 * V;
  const ResOut res{
      kResid ? resid + ((int64_t)w.l * n * 4 * B + b) * C + q0 * V : nullptr,
      B * C};
  float acc[kS * V] = {};
  if (v.mean) {
    encode_mean_span<V, kS, kTetra, kResid>(tbl, C, ns, pt, n, v, acc, res);
  } else {
    encode_span<V, kS, kTetra, kResid>(tbl, C, ns, pt, n, v, acc, res);
#pragma unroll
    for (int k = 0; k < kS * V; ++k) acc[k] = acc[k] / (float)n;
  }
  if (out == nullptr) return;
  float* o = out + (b * L + w.l) * C + q0 * V;
#pragma unroll
  for (int q = 0; q < kS; ++q)
    if (q < ns) store_row<V>(o + q * V, acc + q * V);
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

// The fixed-point scale of one exponent k: sc = 2^k where that is a normal
// float, else 0 (then to_fixed takes ldexpf).
struct FixedScale {
  float sc;
  int k;
};

__device__ __forceinline__ FixedScale fixed_scale(int k) {
  return FixedScale{
      k >= -126 && k <= 127 ? __int_as_float((127 + k) << 23) : 0.f, k};
}

// u * 2^k rounded to the nearest int64 (ties to even): one rounding, since
// scaling by a power of two is exact here (|u| * 2^k <= 2^62): a product by
// 2^k where that is a float (correctly rounded, as ldexpf is, also where it
// lands below the normal range), ldexpf elsewhere.
__device__ __forceinline__ long long to_fixed(float u, FixedScale f) {
  return __float2ll_rn(f.sc != 0.f ? u * f.sc : ldexpf(u, f.k));
}

// The index of set bit k of m, counting from 0 at the lowest (k < popc(m)):
// a binary search on popcounts.
__device__ __forceinline__ int nth_set_bit(unsigned m, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (k >= c) {
      k -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// Warp-collective int64 row adds into dst [rows, C], lane-transposed: every
// lane of the warp calls. A row's C sums are held by kG = C / kW
// neighbouring lanes, the first at a multiple of kG, each holding kW
// channels in v, all with the same `has` and `row`. Round by round, lane j
// adds channel j % C of the (j / C)-th row still to add (its value and row
// fetched by shuffles): one atomic instruction covers 32 / C whole rows,
// each row's C values contiguous (C4: 32 bytes, one sector), where a lane
// per row spends C instructions, each touching a sector of every row. A
// zero sum adds nothing. C = 1: each lane adds its own.
template <int C, int kW>
__device__ __forceinline__ void add_rows_transposed(unsigned long long* dst,
                                                    bool has, uint32_t row,
                                                    const long long* v) {
  if constexpr (C == 1) {
    if (has && v[0] != 0) atomicAdd(dst + row, (unsigned long long)v[0]);
  } else {
    constexpr int kG = C / kW, kRows = 32 / C;
    const int lane = threadIdx.x & 31;
    const int slot = lane / C, ch = lane % C;
    unsigned heads = __ballot_sync(kFullMask, has && lane % kG == 0);
    while (heads != 0u) {
      const int cnt = __popc(heads);
      const bool mine = slot < cnt;
      const int src = (mine ? nth_set_bit(heads, slot) : 0) + ch / kW;
      long long s = 0;
#pragma unroll
      for (int r = 0; r < kW; ++r) {
        const long long t = __shfl_sync(kFullMask, v[r], src);
        if (r == ch % kW) s = t;
      }
      const uint32_t to = __shfl_sync(kFullMask, row, src);
      if (mine && s != 0)
        atomicAdd(dst + (int64_t)to * C + ch, (unsigned long long)s);
      heads = cnt > kRows
                  ? heads & ~((2u << nth_set_bit(heads, kRows - 1)) - 1u)
                  : 0u;
    }
  }
}

// Where add_runs puts a segment's sum for one corner row: a float atomic on
// d_table (the default kernel), or exact int64 atomics on an accumulator of
// fixed-point terms (the deterministic one). term() and flush() are called
// by every lane of the warp; `act` says its run ends here, `add` that it
// holds a segment's sum.
template <int C>
struct FloatRows {
  using T = float;
  static constexpr bool kSegments = false;  // mean levels: add_runs
  float* dst;  // the level's d_table slice
  template <class Row>
  __device__ __forceinline__ T term(float w, float g, bool, int,
                                    Row) const {
    return w * g;
  }
  template <class Row>
  __device__ __forceinline__ void flush(bool add, Row row,
                                        const T* u) const {
    if (add) add_row<C>(dst + (int64_t)row() * C, u);
  }
};

// Float4s of a lane's staging slot in WideRows' buffer: kG = C / 4 for a
// row of sums or of g, 2 for the weights W[8] (add_mean_segments), and a
// pad, which keeps a quarter-warp's 16-byte accesses on distinct banks.
template <int C>
__host__ __device__ constexpr int wide_slot() {
  return C / 4 + 3;
}

// C >= 8: FloatRows' atomics lane-transposed, the float counterpart of
// add_rows_transposed. The lanes whose segment ends stage their sums in
// the warp's slots of shared memory (buf: 32 lanes x wide_slot<C>()
// float4s); then in round m lane base + p adds float4 p of the sums of
// sample base + m, so one atomic instruction of the warp covers 32 / kG
// whole rows in full sectors (C16: 8 rows) where a lane a row covered 32
// rows, half of each sector. A float4 of zeros adds nothing. The mean
// levels take add_mean_segments instead.
template <int C>
struct WideRows {
  using T = float;
  static constexpr bool kSegments = true;
  float* dst;   // the level's d_table slice
  float4* buf;  // this warp's staging slots
  template <class Row>
  __device__ __forceinline__ T term(float w, float g, bool, int,
                                    Row) const {
    return w * g;
  }
  template <class Row>
  __device__ __forceinline__ void flush(bool add, Row row,
                                        const T* u) const {
    constexpr int kG = C / 4, kS = wide_slot<C>();
    const unsigned adds = __ballot_sync(kFullMask, add);
    if (adds == 0u) return;
    const int lane = threadIdx.x & 31;
    const Group gr = group_of<C>();
    uint32_t r = 0u;
    if (add) {
      r = row();
#pragma unroll
      for (int q = 0; q < kG; ++q)
        buf[lane * kS + q] =
            make_float4(u[4 * q], u[4 * q + 1], u[4 * q + 2], u[4 * q + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < kG; ++m) {
      const int src = gr.base + m;
      const uint32_t to = __shfl_sync(kFullMask, r, src);
      if ((adds >> src) & 1u) {
        const float4 t = buf[src * kS + gr.p];
        if (t.x != 0.f || t.y != 0.f || t.z != 0.f || t.w != 0.f)
          atomicAdd(reinterpret_cast<float4*>(dst + (int64_t)to * C) + gr.p,
                    t);
      }
    }
    __syncwarp();  // the slots are read before the next flush writes them
  }
};

template <int C, bool kTetra>
struct FixedRows {
  using T = long long;
  static constexpr bool kSegments = false;  // mean levels: add_runs
  unsigned long long* acc;  // the level's slice of the [rows, C] sums
  unsigned* flags;          // the whole table's flags
  int64_t base;             // the level's first entry, offset * C
  FixedScale q[C];          // the level's exponent per channel
  // With tetra a weight of 0 is a corner that no point of the run reaches
  // (or a simplex vertex of weight 0): it adds nothing, also against a
  // non-finite g. Trilinear corners are all terms, as in JAX.
  template <class Row>
  __device__ __forceinline__ T term(float w, float g, bool act, int ch,
                                    Row row) const {
    if (kTetra && w == 0.f) return 0;
    const float u = w * g;
    if (isfinite(u)) return to_fixed(u, q[ch]);
    if (act) mark_nonfinite(flags, base + (int64_t)row() * C + ch, u);
    return 0;
  }
  // The segment sums leave by the warp's transposed atomics.
  template <class Row>
  __device__ __forceinline__ void flush(bool add, Row row,
                                        const T* u) const {
    add_rows_transposed<C, C>(acc, add, add ? row() : 0u, u);
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

// How K3 sums: the values with float atomics. term(v, row, channel) is a
// value's summand, add<W>(e, s) adds W channels of sums at entry e of the
// [rows, C] output. (The deterministic variant is a kernel of its own,
// scatter_add_rows_fixed_kernel.)
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

// K3's deterministic variant: scatter_add_rows_kernel's chunks, tiles and
// run sums, with each value rounded to fixed point (channel c at 2^k[c]) as
// it is loaded and the runs summed in int64; a non-finite value adds nothing
// and flags its entry. Every finished run is added by its warp together,
// lane-transposed (add_rows_transposed; C16: the kG = 4 lanes of a row
// hold its 16 channels, and one instruction adds two whole rows), so every
// lane walks the same tiles and steps: lanes past the chunk's end carry
// their run on. out / flags: [rows, C] int64 sums and their flags.
template <int C>
__global__ void __launch_bounds__(kScatterThreads)
    scatter_add_rows_fixed_kernel(const int32_t* __restrict__ idx,
                                  const float* __restrict__ vals,
                                  const int* __restrict__ k,
                                  unsigned long long* __restrict__ out,
                                  unsigned* __restrict__ flags, int64_t V,
                                  int64_t chunk, int tail, int64_t rows) {
  using Tile = ScatterTile<C>;
  constexpr int kW = Tile::kW, kP = Tile::kP, kG = Tile::kG;
  constexpr int kWarps = kScatterThreads / 32;
  __shared__ long long part[kWarps][kG * kW];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const auto in_rows = [&](int r) { return r >= 0 && r < rows; };
  if (blockIdx.x == gridDim.x - 1 && t < tail) {
    const int64_t e = 4 * V + t;
    const int r = __ldg(idx + e / C);
    const int c = (int)(e % C);
    const float v = __ldg(vals + e);
    if (in_rows(r)) {
      if (!isfinite(v))
        mark_nonfinite(flags, (int64_t)r * C + c, v);
      else if (const long long s = to_fixed(v, fixed_scale(__ldg(k + c))))
        atomicAdd(out + (int64_t)r * C + c, (unsigned long long)s);
    }
  }
  const int64_t v0 = (int64_t)blockIdx.x * chunk;
  const int64_t v1 = v0 + chunk < V ? v0 + chunk : V;
  if (v1 <= v0) return;  // the whole block: no float4 in its chunk
  const float4* vals4 = reinterpret_cast<const float4*>(vals);
  const int ch = (t % kG) * kW;
  FixedScale q[kW];
#pragma unroll
  for (int i = 0; i < kW; ++i) q[i] = fixed_scale(__ldg(k + ch + i));
  int cur = -1;  // the row being summed; -1 is dropped like any other
  long long acc[kW] = {};
  for (int64_t tile = v0; tile < v1;
       tile += kScatterUnroll * kScatterThreads) {
    const int64_t base = tile + t;
    float4 x[kScatterUnroll] = {};
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
      const bool valid = base + u * kScatterThreads < v1;
      const float f[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int rr = valid ? r[u][p] : cur;
        const bool ends = rr != cur;
        add_rows_transposed<C, kW>(out, ends && in_rows(cur), (uint32_t)cur,
                                   acc);
        if (ends) {
          cur = rr;
#pragma unroll
          for (int i = 0; i < kW; ++i) acc[i] = 0;
        }
        if (!valid) continue;
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          const float v = f[p * kW + i];
          if (isfinite(v))
            acc[i] += to_fixed(v, q[i]);
          else if (in_rows(rr))
            mark_nonfinite(flags, (int64_t)rr * C + ch + i, v);
        }
      }
    }
  }
  // The runs still open, as scatter_add_rows_kernel sums them: those on the
  // chunk's last row across the lanes of a group and across warps, then
  // added once by warp 0's first kG lanes; any other by its warp.
  const int last = __ldg(idx + (4 * v1 - 1) / C);
  const bool mine = cur == last;
  add_rows_transposed<C, kW>(out, !mine && in_rows(cur), (uint32_t)cur, acc);
  long long s[kW];
#pragma unroll
  for (int i = 0; i < kW; ++i) s[i] = mine ? acc[i] : 0;
#pragma unroll
  for (int off = 16; off >= kG; off >>= 1) {
#pragma unroll
    for (int i = 0; i < kW; ++i) s[i] += __shfl_xor_sync(kFullMask, s[i], off);
  }
  if (lane < kG) {
#pragma unroll
    for (int i = 0; i < kW; ++i) part[warp][lane * kW + i] = s[i];
  }
  __syncthreads();
  if (warp == 0) {
    long long sum[kW] = {};
    if (lane < kG) {
      for (int w = 0; w < kWarps; ++w) {
#pragma unroll
        for (int i = 0; i < kW; ++i) sum[i] += part[w][lane * kW + i];
      }
    }
    add_rows_transposed<C, kW>(out, lane < kG && in_rows(last),
                               (uint32_t)last, sum);
  }
}

// V floats of a slice of vals, streamed (read once).
template <int V>
__device__ __forceinline__ void load_slice(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldcs(p);
  }
}

// K3 and its deterministic variant (kFixed) at a width C that they are not
// instantiated for (the general path). The flattened [N, C] vals are U = N
// S slices of V = gcd(C, 4) floats (S = C / V a row): slice u is channels
// [V (u % S), V (u % S) + V) of row idx[u / S]. A block has `active` = S
// max(1, 256 / S) working threads (a multiple of S; the block rounded up to
// whole warps, whose extra lanes take no slice but join the warp's
// collectives) and walks its chunk (a multiple of `active` slices), thread t
// the slices t, t + active, ..., all of channel slice t % S, so a thread's
// loads of a step are neighbouring 4 V-byte slices and its run sums one
// slice of one row in registers, as scatter_add_rows_kernel's threads do.
// A finished run is added at once: one V-wide float atomic, or (kFixed,
// each value rounded to fixed point as it is loaded, channel c at 2^k[c])
// the warp's lane-transposed int64 atomics, the [rows, C] sums seen as
// [rows S, V] rows. At the chunk's end the runs still open on its last row
// are summed per slice in shared memory and added once; any other adds its
// own. Indices outside [0, rows) are dropped. out / acc: the float output
// or the int64 sums and flags.
template <int V, bool kFixed>
__global__ void __launch_bounds__(1024) scatter_add_slices_kernel(
    const int32_t* __restrict__ idx, const float* __restrict__ vals,
    const int* __restrict__ k, float* __restrict__ out,
    unsigned long long* __restrict__ acc, unsigned* __restrict__ flags,
    int64_t U, int S, int active, int64_t chunk, int64_t rows) {
  using T = typename std::conditional<kFixed, long long, float>::type;
  extern __shared__ __align__(16) unsigned char slice_smem[];
  T* part = reinterpret_cast<T*>(slice_smem);  // [blockDim.x][V]
  const int t = threadIdx.x;
  const bool on = t < active;
  const int q = on ? t % S : 0;
  const int64_t C = (int64_t)S * V;
  const int64_t u0 = (int64_t)blockIdx.x * chunk;
  const int64_t u1 = u0 + chunk < U ? u0 + chunk : U;
  if (u1 <= u0) return;  // the whole block: no slice in its chunk
  const auto in_rows = [&](int r) { return r >= 0 && r < rows; };
  // A run's sums s at channel slice `slice` of row r; every lane calls.
  const auto add = [&](bool has, int r, int slice, const T* s) {
    if constexpr (kFixed)
      add_rows_transposed<V, V>(
          acc, has, has ? (uint32_t)((int64_t)r * S + slice) : 0u, s);
    else if (has)
      add_row<V>(out + (int64_t)r * C + slice * V, s);
  };
  FixedScale sc[V];
  if constexpr (kFixed) {
#pragma unroll
    for (int i = 0; i < V; ++i) sc[i] = fixed_scale(__ldg(k + q * V + i));
  }
  int cur = -1;  // the row being summed; -1 is dropped like any other
  T run[V] = {};
  for (int64_t tile = u0; tile < u1;
       tile += (int64_t)kScatterUnroll * active) {
    float x[kScatterUnroll][V];
    int r[kScatterUnroll];
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u) {
      const int64_t s = tile + t + (int64_t)u * active;
      if (on && s < u1) {
        load_slice<V>(vals + s * V, x[u]);
        r[u] = __ldcs(idx + s / S);
      }
    }
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u) {
      const bool valid = on && tile + t + (int64_t)u * active < u1;
      const int rr = valid ? r[u] : cur;
      const bool ends = rr != cur;
      add(ends && in_rows(cur), cur, q, run);
      if (ends) {
        cur = rr;
#pragma unroll
        for (int i = 0; i < V; ++i) run[i] = 0;
      }
      if (!valid) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float val = x[u][i];
        if constexpr (kFixed) {
          if (isfinite(val))
            run[i] += to_fixed(val, sc[i]);
          else if (in_rows(rr))
            mark_nonfinite(flags, (int64_t)rr * C + q * V + i, val);
        } else {
          run[i] += val;
        }
      }
    }
  }
  const int last = __ldg(idx + (u1 - 1) / S);
  const bool mine = on && cur == last;
  add(!mine && in_rows(cur), cur, q, run);
#pragma unroll
  for (int i = 0; i < V; ++i) part[t * V + i] = mine ? run[i] : T(0);
  __syncthreads();
  T sum[V] = {};
  if (t < S) {
    for (int m = t; m < active; m += S) {
#pragma unroll
      for (int i = 0; i < V; ++i) sum[i] += part[m * V + i];
    }
  }
  add(t < S && in_rows(last), last, t, sum);
}

// The row updates of a run that ends: corner c of cell (ix, iy, iz) gets
// W[c] * g, where `act` says this lane has a run. All 32 lanes call
// (warp-uniform): a lane whose run is in the same cell as its left
// neighbour's joins that lane's segment, a segmented scan sums each
// segment (of Rows::T: float, or the int64 of each lane's fixed-point
// term), and its last lane adds the sum. With tetra a corner that no lane's
// run weights is skipped, and a segment whose sum is 0 adds nothing. In the
// preset modes (tetra, C >= 8) the scan stops below the longest segment's
// length, one warp reduction: the steps past it add nothing anywhere.
template <int C, bool kTetra, class Rows>
__device__ __forceinline__ void add_runs(bool act, int ix, int iy, int iz,
                                         const float* W, const float* g,
                                         const Rows& rows, const Level& v) {
  using T = typename Rows::T;
  constexpr bool kPreset = kTetra || C >= 8;
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
  int depth = 32;
  if (kPreset && scan)
    depth = (int)__reduce_max_sync(kFullMask, (unsigned)(lane - start + 1));
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (kTetra && !__any_sync(kFullMask, act && W[c] != 0.f)) continue;
    const auto row = [&] { return corner_row<kPreset>(ix, iy, iz, c, v); };
    T u[C];
#pragma unroll
    for (int k = 0; k < C; ++k) u[k] = rows.term(W[c], g[k], act, k, row);
    if (scan) {
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        if (kPreset && off >= depth) break;
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
    rows.flush(add, row, u);
  }
}

// A mean level's d_table updates for C >= 8 (WideRows: float sums),
// warp-collective: a lane whose mean point is in the same cell as its left
// neighbour's joins that lane's segment, as in add_runs. Every lane stages
// its g and its corner weights W[8] in the warp's slots; the warp then
// takes its segments 32 / (8 kG) at a time (C16: one), lane (c, q) of a
// segment summing W_m[c] * g_m[4q, 4q + 4) over the members m in order and
// adding that float4 to corner c's row, so one atomic instruction covers
// whole rows. add_runs instead runs a segmented scan of C values for each
// of the 8 corners over these levels' long segments (a ray's samples in
// one coarse cell); the pass issues fewer instructions (PERF.md, on an
// NVIDIA H100 80GB HBM3: the presets' whole backward calls 12-13% faster,
// each mean level alone within 10%).
template <int C, bool kTetra>
__device__ __forceinline__ void add_mean_segments(bool act, int ix, int iy,
                                                  int iz, const float* W,
                                                  const float* g,
                                                  const WideRows<C>& rows,
                                                  const Level& v) {
  constexpr int kG = C / 4, kS = wide_slot<C>(), kP = 8 * kG, kSeg = 32 / kP;
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
  float4* mine = rows.buf + lane * kS;
#pragma unroll
  for (int q = 0; q < kG; ++q)
    mine[q] = make_float4(g[4 * q], g[4 * q + 1], g[4 * q + 2], g[4 * q + 3]);
  mine[kG] = make_float4(W[0], W[1], W[2], W[3]);
  mine[kG + 1] = make_float4(W[4], W[5], W[6], W[7]);
  __syncwarp();
  const float* weights = reinterpret_cast<const float*>(rows.buf);
  const int t = lane % kP, c = t / kG, q = t % kG, slot = lane / kP;
  unsigned ends = __ballot_sync(kFullMask, last);
  while (ends != 0u) {
    const int cnt = __popc(ends);
    const bool mine_seg = slot < cnt;
    const int e = mine_seg ? nth_set_bit(ends, slot) : 0;
    const int s0 = __shfl_sync(kFullMask, start, e);
    const int ex = __shfl_sync(kFullMask, ix, e);
    const int ey = __shfl_sync(kFullMask, iy, e);
    const int ez = __shfl_sync(kFullMask, iz, e);
    if (mine_seg) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int m = s0; m <= e; ++m) {
        const float w = weights[(m * kS + kG) * 4 + c];
        const float4 gm = rows.buf[m * kS + q];
        a.x += w * gm.x;
        a.y += w * gm.y;
        a.z += w * gm.z;
        a.w += w * gm.w;
      }
      if (a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f)
        atomicAdd(reinterpret_cast<float4*>(
                      rows.dst + (int64_t)corner_row<true>(ex, ey, ez, c, v) *
                                     C) +
                      q,
                  a);
    }
    ends = cnt > kSeg ? ends & ~((2u << nth_set_bit(ends, kSeg - 1)) - 1u)
                      : 0u;
  }
  __syncwarp();  // the slots are read before the next flush writes them
}

// The backward of one sample at one level: d_table alone (d_x01 / d_stds
// come from H1's residuals, hash_encode_ms_pos_grads). Every lane of the
// warp calls (`active`: this lane holds a sample), because add_runs
// shuffles. g: g_out[b, l]; rows: where its d_table updates go.
template <int C, bool kTetra, class Rows>
__device__ __forceinline__ void backward_one(bool active, Points pt,
                                             const float* g,
                                             const Rows& rows, int n,
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
  if (__any_sync(kFullMask, have))
    add_runs<C, kTetra>(have, cx, cy, cz, W, g, rows, v);
}

// The backward of a mean-point level: the mean point's corners get
// w_mean * weight * g (one run; neighbouring lanes in the same cell are
// merged by add_runs). Warp-uniform, as backward_one.
template <int C, bool kTetra, class Rows>
__device__ __forceinline__ void backward_mean(bool active, Points pt,
                                              const float* g,
                                              const Rows& rows, int n,
                                              const Level& v) {
  MeanPoint m{0.f, 0.f, 0.f, 0.f};
  if (active) m = mean_of(pt, n, v);
  const bool in = active && in_unit_cube(m.x, m.y, m.z);
  const Cell p = cell_of(m.x, m.y, m.z, v.scale);
  if (!__any_sync(kFullMask, in)) return;
  float W[8] = {};
  if (in) add_weights<kTetra>(p, m.w, W);
  if constexpr (Rows::kSegments)
    add_mean_segments<C, kTetra>(in, p.ix, p.iy, p.iz, W, g, rows, v);
  else
    add_runs<C, kTetra>(in, p.ix, p.iy, p.iz, W, g, rows, v);
}

template <int C, bool kTetra>
__global__ void hash_encode_ms_bwd_kernel(
    const float* __restrict__ x01, const float* __restrict__ stds,
    const float* __restrict__ g_out, float* __restrict__ d_table, int64_t B,
    int n, int L, int64_t tiles, int level_major, int stage, GridLevels lv) {
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
  float g[C] = {};
  if (active) load_row<C>(g_out + (b * L + w.l) * C, g);
  const Points pt = points_of(x01, stds, w.b0, cnt, n, stage ? smem : nullptr);
  float* dst = d_table + (int64_t)lv.offset[w.l] * C;
  const auto run = [&](const auto& rows) {
    if (v.mean)
      backward_mean<C, kTetra>(active, pt, g, rows, n, v);
    else
      backward_one<C, kTetra>(active, pt, g, rows, n, v);
  };
  if constexpr (C >= 8) {
    __shared__ float4 slots[kThreads / 32][32 * wide_slot<C>()];
    run(WideRows<C>{dst, slots[threadIdx.x >> 5]});
  } else {
    run(FloatRows<C>{dst});
  }
}

// Static shared memory of hash_encode_ms_bwd_kernel<C>: WideRows' slots.
template <int C>
constexpr int bwd_static_smem() {
  return C >= 8 ? kThreads * wide_slot<C>() * 16 : 0;
}

// The deterministic d_table: hash_encode_ms_bwd_kernel's threads, block
// order and run merge, with each lane's merged corner values rounded to
// fixed point (k: [L, C] exponents) and summed into acc ([rows, C] int64)
// and flags (the non-finite terms) by the warp's transposed atomics.
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
  for (int c = 0; c < C; ++c) rows.q[c] = fixed_scale(__ldg(k + w.l * C + c));
  if (v.mean)
    backward_mean<C, kTetra>(active, pt, g, rows, n, v);
  else
    backward_one<C, kTetra>(active, pt, g, rows, n, v);
}

// add_rows_transposed at a runtime width: every lane of the warp calls, and
// a lane whose `has` is set holds a row's sums of w <= kW channels in v
// (their row `row`). Round by round, lane j adds channel j % w of the
// (j / w)-th row still to add (its value and row fetched by shuffles), so
// one atomic instruction covers 32 / w whole rows, each row's channels
// contiguous. A zero sum adds nothing. dst: the rows' first channel,
// `stride` entries from one row to the next.
template <int kW>
__device__ __forceinline__ void add_span_transposed(unsigned long long* dst,
                                                    bool has, uint32_t row,
                                                    const long long* v, int w,
                                                    int stride) {
  const int lane = threadIdx.x & 31;
  const int per = 32 / w, slot = lane / w, ch = lane % w;
  unsigned heads = __ballot_sync(kFullMask, has);
  while (heads != 0u) {
    const int cnt = __popc(heads);
    const bool mine = slot < per && slot < cnt;
    const int src = mine ? nth_set_bit(heads, slot) : 0;
    long long s = 0;
#pragma unroll
    for (int r = 0; r < kW; ++r) {
      if (r >= w) continue;  // w is the same on every lane
      const long long t = __shfl_sync(kFullMask, v[r], src);
      if (r == ch) s = t;
    }
    const uint32_t to = __shfl_sync(kFullMask, row, src);
    if (mine && s != 0)
      atomicAdd(dst + (int64_t)to * stride + ch, (unsigned long long)s);
    heads = cnt > per ? heads & ~((2u << nth_set_bit(heads, per - 1)) - 1u)
                      : 0u;
  }
}

// Where the general path's backward puts a segment's sums for one corner
// row, a span of w = ns V channels: float4 atomics on rows of a multiple of
// 4 floats (d_table where C % 4 == 0, or a zeroed scratch of rows padded to
// 4 ceil(C / 4) floats: one float4 where a C3 row takes 3 scalar atomics),
// V-float atomics a slice on d_table's rows otherwise, or (kFixed)
// FixedRows' int64 terms, summed into the [rows, C] sums by
// add_span_transposed. term() and flush() as FloatRows' / FixedRows'; the
// exponents are read when a term is rounded (held in registers, a C6
// span's took 128-141 of them).
template <int V, int kS, bool kTetra, bool kFixed>
struct SpanRows {
  static constexpr int kW = kS * V;
  using T = typename std::conditional<kFixed, long long, float>::type;
  float* dst;               // float: the level's row 0 at the span's channel
  unsigned long long* acc;  // kFixed: the level's int64 sums, the same
  unsigned* flags;          // kFixed: the whole table's flags
  int64_t base;             // kFixed: the entry of acc[0] in the table
  const int* k;             // kFixed: the span's exponents (read when used)
  int stride;               // floats (entries) from one row to the next
  int w;                    // channels of the span (a multiple of V)
  template <class Row>
  __device__ __forceinline__ T term(float wt, float g, bool act, int ch,
                                    Row row) const {
    if constexpr (kFixed) {
      if (kTetra && wt == 0.f) return 0;
      const float u = wt * g;
      if (isfinite(u)) return to_fixed(u, fixed_scale(__ldg(k + ch)));
      if (act) mark_nonfinite(flags, base + (int64_t)row() * stride + ch, u);
      return 0;
    } else {
      return wt * g;
    }
  }
  // u[w..kW) are 0.
  template <class Row>
  __device__ __forceinline__ void flush(bool add, Row row,
                                        const T* u) const {
    if constexpr (kFixed) {
      add_span_transposed<kW>(acc, add, add ? row() : 0u, u,
                              kS == 1 ? kW : w, stride);
    } else if (add && stride % 4 == 0) {  // the same on every lane
      float4* d = reinterpret_cast<float4*>(dst + (int64_t)row() * stride);
#pragma unroll
      for (int i = 0; i < (kW + 3) / 4; ++i) {
        if (4 * i >= w) continue;
        float t[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) t[k] = 4 * i + k < kW ? u[4 * i + k] : 0.f;
        if (t[0] != 0.f || t[1] != 0.f || t[2] != 0.f || t[3] != 0.f)
          atomicAdd(d + i, make_float4(t[0], t[1], t[2], t[3]));
      }
    } else if (add) {
      float* d = dst + (int64_t)row() * stride;
#pragma unroll
      for (int q = 0; q < kS; ++q)
        if (q * V < w) add_row<V>(d + q * V, u + q * V);
    }
  }
};

// add_runs over a span of rows.w channels: the same segments (a lane whose
// run ends in its left neighbour's cell joins that lane's segment), terms
// and segmented scan per channel, no deeper than the longest segment (the
// steps past it add nothing anywhere), and the segment's last lane flushes
// the whole span of the row at once.
template <int kW, bool kTetra, class Rows>
__device__ __forceinline__ void add_runs_span(bool act, int ix, int iy, int iz,
                                              const float* W, const float* g,
                                              const Rows& rows,
                                              const Level& v) {
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
  const int depth =
      heads == kFullMask
          ? 1
          : (int)__reduce_max_sync(kFullMask, (unsigned)(lane - start + 1));
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (kTetra && !__any_sync(kFullMask, act && W[c] != 0.f)) continue;
    const auto row = [&] { return corner_row<true>(ix, iy, iz, c, v); };
    T u[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k)
      u[k] = k < rows.w ? rows.term(W[c], g[k], act, k, row) : T(0);
    for (int off = 1; off < depth; off <<= 1) {
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        if (k >= rows.w) continue;  // the same on every lane
        const T t = __shfl_up_sync(kFullMask, u[k], off);
        if (lane - off >= start) u[k] += t;
      }
    }
    bool add = last;
    if (kTetra && add) {
      add = false;
#pragma unroll
      for (int k = 0; k < kW; ++k) add |= u[k] != T(0);
    }
    rows.flush(add, row, u);
  }
}

// backward_one over a span (the general path): the sample's points walked
// once a level, each run's updates added for the whole span.
template <int kW, bool kTetra, class Rows>
__device__ __forceinline__ void backward_span(bool active, Points pt,
                                              const float* g,
                                              const Rows& rows, int n,
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
    const bool in = active && in_unit_cube(x, y, z);
    const float coef = erf_weight(s, v) * inv_n;
    const Cell p = cell_of(x, y, z, v.scale);
    const bool ends = in && have && !same_cell(p, cx, cy, cz);
    if (__any_sync(kFullMask, ends))
      add_runs_span<kW, kTetra>(ends, cx, cy, cz, W, g, rows, v);
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
  if (__any_sync(kFullMask, have))
    add_runs_span<kW, kTetra>(have, cx, cy, cz, W, g, rows, v);
}

// backward_mean over a span.
template <int kW, bool kTetra, class Rows>
__device__ __forceinline__ void backward_mean_span(bool active, Points pt,
                                                   const float* g,
                                                   const Rows& rows, int n,
                                                   const Level& v) {
  MeanPoint m{0.f, 0.f, 0.f, 0.f};
  if (active) m = mean_of(pt, n, v);
  const bool in = active && in_unit_cube(m.x, m.y, m.z);
  const Cell p = cell_of(m.x, m.y, m.z, v.scale);
  if (!__any_sync(kFullMask, in)) return;
  float W[8] = {};
  if (in) add_weights<kTetra>(p, m.w, W);
  add_runs_span<kW, kTetra>(in, p.ix, p.iy, p.iz, W, g, rows, v);
}

// H1-bwd's d_table at a width C that hash_encode_ms_bwd_kernel and
// hash_encode_ms_bwd_fixed_kernel are not instantiated for (the general
// path): a thread a sample (lane = sample, for the warp's segment merge),
// holding g_out's span of `slices` slices of V = gcd(C, 4) floats (up to
// kSpanSlices: C3, C6 and C12 in one walk a level; kFixed:
// fixed_slices<V>(); a block takes one (level, walk) of a tile,
// walk_work's order). Each run's updates leave for
// the whole span at once (SpanRows: float4 atomics into `sums`, d_table or
// its padded scratch, rows `stride` floats apart, or V-float ones where
// the rows are not 16 bytes; kFixed: int64 terms at the exponents k [L, C]
// into acc / flags [rows, C]). The runs, segments and terms are a C-wide
// instantiation's, so the deterministic sums are the plain twin's.
template <int V, bool kTetra, bool kFixed>
__global__ void hash_encode_ms_bwd_any_kernel(
    const float* __restrict__ x01, const float* __restrict__ stds,
    const float* __restrict__ g_out, float* __restrict__ sums, int stride,
    const int* __restrict__ k, unsigned long long* __restrict__ acc,
    unsigned* __restrict__ flags, int64_t B, int n, int L, int C, int slices,
    int walks, int64_t tiles, int level_major, int stage, GridLevels lv) {
  constexpr int kS = kFixed ? fixed_slices<V>() : kSpanSlices, kW = kS * V;
  extern __shared__ __align__(16) float smem[];
  const WalkWork w = walk_work(tiles, L, walks, 1, B, level_major != 0);
  const Level v = level_of(lv, w.l);
  if (stage) {
    stage_tile(x01, stds, w.b0, w.cnt, n, smem, smem + w.cnt * n * 3);
    __syncthreads();
  }
  // No early return: the lanes past B join the warp's shuffles.
  const bool active = (int)threadIdx.x < w.cnt;
  const int64_t b = w.b0 + threadIdx.x;
  const int q0 = w.walk * slices, ns = min(slices, C / V - q0), c0 = q0 * V;
  float g[kW] = {};
  if (active) {
#pragma unroll
    for (int q = 0; q < kS; ++q)
      if (q < ns) load_row<V>(g_out + (b * L + w.l) * C + c0 + q * V, g + q * V);
  }
  const Points pt = span_points(x01, stds, w.b0, threadIdx.x, w.cnt, n,
                                stage ? smem : nullptr);
  SpanRows<V, kS, kTetra, kFixed> rows{};
  rows.w = ns * V;
  if constexpr (kFixed) {
    rows.base = (int64_t)lv.offset[w.l] * C + c0;
    rows.acc = acc + rows.base;
    rows.flags = flags;
    rows.k = k + w.l * C + c0;
    rows.stride = C;
  } else {
    rows.dst = sums + (int64_t)lv.offset[w.l] * stride + c0;
    rows.stride = stride;
  }
  if (v.mean)
    backward_mean_span<kW, kTetra>(active, pt, g, rows, n, v);
  else
    backward_span<kW, kTetra>(active, pt, g, rows, n, v);
}

// d_table [rows, C] = padded [rows, Cp] (the general path's float sums at
// C % 4 != 0): a thread a row, its Cp / 4 float4s read once (streamed).
__global__ void unpad_rows_kernel(const float* __restrict__ padded,
                                  float* __restrict__ out, int64_t rows,
                                  int C, int Cp) {
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < rows;
       r += (int64_t)gridDim.x * blockDim.x) {
    const float4* src = reinterpret_cast<const float4*>(padded + r * Cp);
    float* dst = out + r * C;
    for (int i = 0; i < Cp / 4; ++i) {
      const float4 t = __ldcs(src + i);
      const float u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * i + k < C) dst[4 * i + k] = u[k];
    }
  }
}

// d_x01 / d_stds from H1's residuals R [L, n, 4, B, C]: a block takes a
// tile of kPosSamples samples (threadIdx.x) and their points (threadIdx.y,
// striding over the n); a thread sums R[l, j, q, b, c] * g_out[b, l, c]
// over the levels in order and, within a level, the channels in order
// (each product and sum rounded on its own, as the plain version's torch
// ops round them), then writes its 3 + 1 outputs once. A warp reads a row
// of 32 neighbouring samples, 32 C contiguous floats (the layout H1's
// residual mode writes for this); the warps of a block read the same
// g_out rows, which the first brings into L1. Measured and dropped
// (PERF.md): a thread taking 4 / C samples at C < 4, a float4 a row, was
// slower (prop1 0.79 ms against 0.56 on the refinement step). d_x01 /
// d_stds: nullptr when not wanted.
template <int C>
__global__ void __launch_bounds__(kPosThreads)
    pos_grads_kernel(const float* __restrict__ resid,
                     const float* __restrict__ g_out,
                     float* __restrict__ d_x01, float* __restrict__ d_stds,
                     int64_t B, int n, int L) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t plane = B * C;
  for (int j = threadIdx.y; j < n; j += blockDim.y) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int l = 0; l < L; ++l) {
      float g[C];
      load_row<C>(g_out + (b * L + l) * C, g);
      const float* r = resid + ((int64_t)(l * n + j) * 4 * B + b) * C;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v[C];
        load_row<C>(r + q * plane, v);
#pragma unroll
        for (int c = 0; c < C; ++c)
          a[q] = __fadd_rn(a[q], __fmul_rn(v[c], g[c]));
      }
    }
    const int64_t t = b * n + j;
    if (d_x01 != nullptr) {
      d_x01[3 * t] = a[0];
      d_x01[3 * t + 1] = a[1];
      d_x01[3 * t + 2] = a[2];
    }
    if (d_stds != nullptr) d_stds[t] = a[3];
  }
}

// pos_grads_kernel at a width C it is not instantiated for (the general
// path): the same threads and order of sums (levels, then channels, each
// product and sum rounded on its own), a row of R and of g_out read as C /
// V loads of V = gcd(C, 4) floats, so the outputs are the plain version's
// bits.
template <int V>
__global__ void __launch_bounds__(kPosThreads)
    pos_grads_slices_kernel(const float* __restrict__ resid,
                            const float* __restrict__ g_out,
                            float* __restrict__ d_x01,
                            float* __restrict__ d_stds, int64_t B, int n,
                            int L, int C) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t plane = B * C;
  for (int j = threadIdx.y; j < n; j += blockDim.y) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int l = 0; l < L; ++l) {
      const float* gl = g_out + (b * L + l) * C;
      const float* r = resid + ((int64_t)(l * n + j) * 4 * B + b) * C;
      for (int c0 = 0; c0 < C; c0 += V) {
        float g[V];
        load_row<V>(gl + c0, g);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v[V];
          load_row<V>(r + q * plane + c0, v);
#pragma unroll
          for (int c = 0; c < V; ++c)
            a[q] = __fadd_rn(a[q], __fmul_rn(v[c], g[c]));
        }
      }
    }
    const int64_t t = b * n + j;
    if (d_x01 != nullptr) {
      d_x01[3 * t] = a[0];
      d_x01[3 * t + 1] = a[1];
      d_x01[3 * t + 2] = a[2];
    }
    if (d_stds != nullptr) d_stds[t] = a[3];
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
                      int threads = kThreads, int reserved = 0) {
  g->tiles = (B + threads - 1) / threads;
  if (g->tiles * L > 0x7fffffff) return cudaErrorInvalidValue;
  g->blocks = (unsigned)(g->tiles * L);
  const int64_t bytes = 16LL * threads * n;
  g->smem = level_major && bytes + reserved <= kStageBytes ? (int)bytes : 0;
  return cudaSuccess;
}

template <int C>
cudaError_t encode(const float* table, const float* x01, const float* stds,
                   float* out, float* resid, int64_t B, int n, int L,
                   const GridLevels& lv, int tetra, int level_major,
                   cudaStream_t s) {
  Launch g;
  const cudaError_t err = launch_of(B, n, L, level_major, &g);
  if (err != cudaSuccess) return err;
  const auto go = [&](auto kernel) {
    kernel<<<g.blocks, kThreads, g.smem, s>>>(table, x01, stds, out, resid, B,
                                              n, L, g.tiles, level_major,
                                              g.smem > 0, lv);
  };
  if (resid != nullptr)
    tetra ? go(hash_encode_ms_kernel<C, true, true>)
          : go(hash_encode_ms_kernel<C, false, true>);
  else
    tetra ? go(hash_encode_ms_kernel<C, true, false>)
          : go(hash_encode_ms_kernel<C, false, false>);
  return cudaGetLastError();
}

template <int C>
cudaError_t backward(const float* x01, const float* stds, const float* g_out,
                     float* d_table, int64_t B, int n, int L,
                     const GridLevels& lv, int tetra, int level_major,
                     cudaStream_t s) {
  Launch g;
  const cudaError_t err =
      launch_of(B, n, L, level_major, &g, kThreads, bwd_static_smem<C>());
  if (err != cudaSuccess) return err;
  if (tetra)
    hash_encode_ms_bwd_kernel<C, true><<<g.blocks, kThreads, g.smem, s>>>(
        x01, stds, g_out, d_table, B, n, L, g.tiles, level_major, g.smem > 0,
        lv);
  else
    hash_encode_ms_bwd_kernel<C, false><<<g.blocks, kThreads, g.smem, s>>>(
        x01, stds, g_out, d_table, B, n, L, g.tiles, level_major, g.smem > 0,
        lv);
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

// d_x01 / d_stds by pos_grads_kernel: blocks of kPosSamples samples x
// min(n, kPosThreads / kPosSamples) points.
template <int C>
cudaError_t pos_grads(const float* resid, const float* g_out, float* d_x01,
                      float* d_stds, int64_t B, int n, int L,
                      cudaStream_t s) {
  const int64_t blocks = (B + kPosSamples - 1) / kPosSamples;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 block(kPosSamples, n < kPosThreads / kPosSamples
                                    ? n
                                    : kPosThreads / kPosSamples);
  pos_grads_kernel<C><<<(unsigned)blocks, block, 0, s>>>(resid, g_out, d_x01,
                                                         d_stds, B, n, L);
  return cudaGetLastError();
}

// The general path (a width C that the kernels are not instantiated for):
// f(std::integral_constant<int, V>{}) for V = gcd(C, 4).
template <class F>
cudaError_t by_slice_width(int C, F f) {
  switch (slice_width(C)) {
    case 4: return f(std::integral_constant<int, 4>{});
    case 2: return f(std::integral_constant<int, 2>{});
    default: return f(std::integral_constant<int, 1>{});
  }
}

// The walks a level of a general-path plan (a sample's `lanes` lanes, each
// `slices` slices of V floats, at most `most`), or 0 for a plan the kernels
// do not take.
int walks_of(int C, int V, int slices, int lanes, int most) {
  if (slices < 1 || slices > most || lanes < 1 || lanes > 32) return 0;
  const int cover = lanes * slices;
  return (C / V + cover - 1) / cover;
}

// H1 by hash_encode_ms_any_kernel: L walks (level, walk) blocks a tile of
// 32 / lanes samples a warp.
template <int V>
cudaError_t encode_any(const float* table, const float* x01,
                       const float* stds, float* out, float* resid, int64_t B,
                       int n, int L, int C, int slices, int lanes,
                       const GridLevels& lv, int tetra, int level_major,
                       cudaStream_t s) {
  const bool res = resid != nullptr;
  const int walks = walks_of(C, V, slices, lanes, kLaneFloats / V);
  if (walks == 0) return cudaErrorInvalidValue;
  Launch g;
  const cudaError_t err = launch_of(B, n, L * walks, level_major, &g,
                                    kThreads / 32 * (32 / lanes));
  if (err != cudaSuccess) return err;
  const auto go = [&](auto kernel) {
    kernel<<<g.blocks, kThreads, g.smem, s>>>(
        table, x01, stds, out, resid, B, n, L, C, slices, lanes, walks,
        g.tiles, level_major, g.smem > 0, lv);
  };
  if (res)
    tetra ? go(hash_encode_ms_any_kernel<V, true, true>)
          : go(hash_encode_ms_any_kernel<V, false, true>);
  else
    tetra ? go(hash_encode_ms_any_kernel<V, true, false>)
          : go(hash_encode_ms_any_kernel<V, false, false>);
  return cudaGetLastError();
}

// H1-bwd's d_table by hash_encode_ms_bwd_any_kernel, in blocks of `threads`
// samples, `slices` slices a walk (the float sums: every walk but the last
// a multiple of 4 floats, so each span starts on 16 bytes): float4 atomics
// into d_table
// (C % 4 == 0) or, given `scratch` at C % 4 != 0, into that [rows, Cp = 4
// ceil(C / 4)] zero-filled buffer, whose sums unpad_rows_kernel then
// writes into the L levels' rows of d_table; V-float atomics into d_table
// without it; or (kFixed) int64 sums into acc / flags at the exponents k.
// B may be 0.
template <int V, bool kFixed>
cudaError_t backward_any(const float* x01, const float* stds,
                         const float* g_out, float* d_table, float* scratch,
                         const int* k, unsigned long long* acc,
                         unsigned* flags, int64_t B, int n, int L, int C,
                         int slices, const GridLevels& lv, int tetra,
                         int level_major, int threads, cudaStream_t s) {
  const int walks =
      walks_of(C, V, slices, 1, kFixed ? fixed_slices<V>() : kSpanSlices);
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || walks == 0 ||
      (!kFixed && walks > 1 && slices * V % 4 != 0) ||
      (scratch != nullptr && (kFixed || C % 4 == 0)))
    return cudaErrorInvalidValue;
  const bool padded = scratch != nullptr;
  const int stride = padded ? (C + 3) / 4 * 4 : C;
  float* sums = padded ? scratch : d_table;
  if (!kFixed && (sums == nullptr ||
                  (uintptr_t)sums % (stride % 4 == 0 ? 16 : 4 * V) != 0))
    return cudaErrorInvalidValue;
  if (B > 0) {
    Launch g;
    const cudaError_t err =
        launch_of(B, n, L * walks, level_major, &g, threads);
    if (err != cudaSuccess) return err;
    const auto go = [&](auto kernel) {
      kernel<<<g.blocks, threads, g.smem, s>>>(
          x01, stds, g_out, sums, stride, k, acc, flags, B, n, L, C, slices,
          walks, g.tiles, level_major, g.smem > 0, lv);
    };
    tetra ? go(hash_encode_ms_bwd_any_kernel<V, true, kFixed>)
          : go(hash_encode_ms_bwd_any_kernel<V, false, kFixed>);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return launched;
  }
  if (padded) {
    const int64_t first = lv.offset[0];
    const int64_t rows = (int64_t)lv.offset[L - 1] + lv.rows[L - 1] - first;
    const int64_t blocks = (rows + 255) / 256;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    if (blocks > 0)
      unpad_rows_kernel<<<(unsigned)blocks, 256, 0, s>>>(
          scratch + first * stride, d_table + first * C, rows, C, stride);
  }
  return cudaGetLastError();
}

// d_x01 / d_stds by pos_grads_slices_kernel, in pos_grads' blocks.
template <int V>
cudaError_t pos_grads_slices(const float* resid, const float* g_out,
                             float* d_x01, float* d_stds, int64_t B, int n,
                             int L, int C, cudaStream_t s) {
  const int64_t blocks = (B + kPosSamples - 1) / kPosSamples;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 block(kPosSamples, n < kPosThreads / kPosSamples
                                    ? n
                                    : kPosThreads / kPosSamples);
  pos_grads_slices_kernel<V><<<(unsigned)blocks, block, 0, s>>>(
      resid, g_out, d_x01, d_stds, B, n, L, C);
  return cudaGetLastError();
}

// K3's cut of V float4s (or, for the general path, slices): one chunk of
// whole tiles of `step` per block, with as many blocks as the card holds at
// once of `kernel` in blocks of `threads` with `smem` bytes of dynamic
// shared memory.
template <class Kernel>
cudaError_t scatter_plan(Kernel kernel, int64_t V, int device, int64_t* chunk,
                         int64_t* blocks, int threads = kScatterThreads,
                         size_t smem = 0, int step = kScatterThreads) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  const int64_t most = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t per_block = (V + most - 1) / most;
  const int64_t tiles = (per_block + step - 1) / step;
  *chunk = (tiles > 0 ? tiles : 1) * step;
  *blocks = V > 0 ? (V + *chunk - 1) / *chunk : 1;
  return cudaSuccess;
}

// K3 (kFixed: its deterministic variant) by scatter_add_slices_kernel on
// N x C values: N C / V slices, S = C / V of them a row, at most 1024 (C
// <= 1024 V) and rows S < 2^32 (the int64 sums' [rows S, V] view).
template <int V, bool kFixed>
cudaError_t scatter_slices(const int32_t* idx, const float* vals,
                           const int* k, float* out, unsigned long long* acc,
                           unsigned* flags, int64_t N, int C, int64_t rows,
                           int device, cudaStream_t s) {
  using T = typename std::conditional<kFixed, long long, float>::type;
  const int S = C / V;
  if (S > 1024 || rows * S > 0xffffffffLL) return cudaErrorInvalidValue;
  const int active = S * (S < kScatterThreads ? kScatterThreads / S : 1);
  const int threads = (active + 31) / 32 * 32;
  const size_t smem = (size_t)threads * V * sizeof(T);
  const int64_t U = N * S;
  int64_t chunk, blocks;
  const cudaError_t err =
      scatter_plan(scatter_add_slices_kernel<V, kFixed>, U, device, &chunk,
                   &blocks, threads, smem, active);
  if (err != cudaSuccess) return err;
  scatter_add_slices_kernel<V, kFixed><<<(unsigned)blocks, threads, smem, s>>>(
      idx, vals, k, out, acc, flags, U, S, active, chunk, rows);
  return cudaGetLastError();
}

// K3 on N x C values, summed by FloatSums.
template <int C, class Sums>
cudaError_t scatter(const int32_t* idx, const float* vals, Sums out,
                    int64_t N, int64_t rows, int device, cudaStream_t s) {
  const int64_t V = N * C / 4;
  const int tail = (int)(N * C - 4 * V);
  int64_t chunk, blocks;
  const cudaError_t err = scatter_plan(scatter_add_rows_kernel<C, Sums>, V,
                                       device, &chunk, &blocks);
  if (err != cudaSuccess) return err;
  scatter_add_rows_kernel<C, Sums>
      <<<(unsigned)blocks, kScatterThreads, 0, s>>>(idx, vals, out, V, chunk,
                                                    tail, rows);
  return cudaGetLastError();
}

// K3 at any C it takes, through `Sums` (FloatSums<C>).
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

// K3's deterministic variant on N x C values, in K3's chunks.
template <int C>
cudaError_t scatter_fixed(const int32_t* idx, const float* vals, const int* k,
                          unsigned long long* out, unsigned* flags, int64_t N,
                          int64_t rows, int device, cudaStream_t s) {
  const int64_t V = N * C / 4;
  const int tail = (int)(N * C - 4 * V);
  int64_t chunk, blocks;
  const cudaError_t err = scatter_plan(scatter_add_rows_fixed_kernel<C>, V,
                                       device, &chunk, &blocks);
  if (err != cudaSuccess) return err;
  scatter_add_rows_fixed_kernel<C>
      <<<(unsigned)blocks, kScatterThreads, 0, s>>>(idx, vals, k, out, flags,
                                                    V, chunk, tail, rows);
  return cudaGetLastError();
}

// The row ranges of fixed_to_float's exponent groups: H1-bwd's levels, or
// one group (K3).
struct Groups {
  int64_t start[kMaxLevels + 1];
  int count;
};

// One entry's float32 sum from its int64 sum a, its flags f and its
// exponent kk: NaN where a NaN term (or both infinities) was flagged, else
// +-inf where one was, else a * 2^-kk through float64, as the plain version
// takes it: the int64 rounded to double, an exact scaling (2^-kk is a
// normal double for the exponents of fixed_exponents), one rounding.
__device__ __forceinline__ float fixed_value(long long a, unsigned f,
                                             int kk) {
  const unsigned inf = kFlagPosInf | kFlagNegInf;
  if ((f & kFlagNaN) || (f & inf) == inf) return __int_as_float(0x7fc00000);
  if (f & kFlagPosInf) return __int_as_float(0x7f800000);
  if (f & kFlagNegInf) return __int_as_float((int)0xff800000u);
  const double scale = __longlong_as_double((long long)(1023 - kk) << 52);
  return __double2float_rn(__ll2double_rn(a) * scale);
}

// out = the deterministic kernels' sums of a [rows, C] output (C = 2^log2c;
// g: an entry's row group), and acc and flags zeroed as they are read, so
// that the next call finds them zero (the wrappers keep one accumulator a
// shape). Thread i takes entries [4i, 4i + 4): two 16-byte loads of acc,
// one of out, the upper or lower half of a flags word (the two threads of
// a word read it, then the even one clears it), and one group, since groups
// start on multiples of 4 entries. Zero words are not written again.
__global__ void fixed_to_float_kernel(long long* __restrict__ acc,
                                      unsigned* __restrict__ flags,
                                      const int* __restrict__ k,
                                      float* __restrict__ out, int64_t total,
                                      int log2c, Groups gr) {
  const int64_t e0 = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  const bool on = e0 < total;
  const unsigned word = on ? flags[e0 >> 3] : 0u;
  __syncwarp();  // both threads of a word have read it
  if (on && (e0 & 7) == 0 && word != 0u) flags[e0 >> 3] = 0u;
  if (!on) return;
  const unsigned f4 = word >> (4 * (e0 & 7));
  const int64_t r0 = e0 >> log2c;
  int g = 0;
  while (g + 1 < gr.count && r0 >= gr.start[g + 1]) ++g;
  const int mask = (1 << log2c) - 1;
  const int* kg = k + ((int64_t)g << log2c);
  if (e0 + 4 <= total) {
    longlong2* a2 = reinterpret_cast<longlong2*>(acc + e0);
    const longlong2 a = a2[0], b = a2[1];
    const long long v[4] = {a.x, a.y, b.x, b.y};
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = fixed_value(v[j], (f4 >> (4 * j)) & 0xfu,
                         __ldg(kg + ((e0 + j) & mask)));
    *reinterpret_cast<float4*>(out + e0) = make_float4(o[0], o[1], o[2], o[3]);
    if ((a.x | a.y) != 0) a2[0] = make_longlong2(0, 0);
    if ((b.x | b.y) != 0) a2[1] = make_longlong2(0, 0);
  } else {
    for (int64_t e = e0; e < total; ++e) {
      out[e] = fixed_value(acc[e], (f4 >> (4 * (e - e0))) & 0xfu,
                           __ldg(kg + (e & mask)));
      acc[e] = 0;
    }
  }
}

// fixed_to_float_kernel at any C and with groups that start on any row
// (the general path's widths): the same threads and loads, each entry's
// row (e / C), channel and group found on its own.
__global__ void fixed_to_float_any_kernel(long long* __restrict__ acc,
                                          unsigned* __restrict__ flags,
                                          const int* __restrict__ k,
                                          float* __restrict__ out,
                                          int64_t total, int C, Groups gr) {
  const int64_t e0 = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  const bool on = e0 < total;
  const unsigned word = on ? flags[e0 >> 3] : 0u;
  __syncwarp();  // both threads of a word have read it
  if (on && (e0 & 7) == 0 && word != 0u) flags[e0 >> 3] = 0u;
  if (!on) return;
  const unsigned f4 = word >> (4 * (e0 & 7));
  int g = 0;
  const auto value = [&](int64_t e, long long a) {
    const int64_t r = e / C;
    while (g + 1 < gr.count && r >= gr.start[g + 1]) ++g;
    return fixed_value(a, (f4 >> (4 * (e - e0))) & 0xfu,
                       __ldg(k + (int64_t)g * C + (e - r * C)));
  };
  if (e0 + 4 <= total) {
    longlong2* a2 = reinterpret_cast<longlong2*>(acc + e0);
    const longlong2 a = a2[0], b = a2[1];
    const long long v[4] = {a.x, a.y, b.x, b.y};
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = value(e0 + j, v[j]);
    *reinterpret_cast<float4*>(out + e0) = make_float4(o[0], o[1], o[2], o[3]);
    if ((a.x | a.y) != 0) a2[0] = make_longlong2(0, 0);
    if ((b.x | b.y) != 0) a2[1] = make_longlong2(0, 0);
  } else {
    for (int64_t e = e0; e < total; ++e) {
      out[e] = value(e, acc[e]);
      acc[e] = 0;
    }
  }
}

// The bound S of the deterministic sums, over the columns of v [N, F] (the
// K3 values' channels, or H1-bwd's g_out columns: level x channel): the
// float64 sum of |v| over the finite entries, in an order fixed by (N, F)
// and the plan (V, Q, P, chunk) that ops/grid.py:_bound_plan gives both
// this and the plain version (abs_bound_plain), so that S is the same bits
// on every run. One launch. A vector is V = 4 channels of a row (one
// 16-byte load) where F % 4 == 0, else one value. Block (b, y) takes rows
// [b chunk, (b + 1) chunk) and the vectors [256 y, 256 y + W) of a row
// (W = min(F / V - 256 y, 256)); thread t < W Q takes vector t % W of the
// rows q, q + Q, ... (q = t / W; Q a power of two, 1 for F / V > 256),
// each channel summed in that order, kU loads in flight (8 float4s or 16
// floats, 128 or 64 bytes a thread; the thread's last fewer than kU rows
// loaded together too), so a step of the block reads W Q V consecutive
// floats; the block then adds
// its Q row sums by a tree in shared memory (h = Q / 2, ..., 1: sum[q] +=
// sum[q + h] for q < h) into part[b, f]. The block that finishes last (a
// ticket, left 0 for the next call) sums each column's P partials: a warp
// a column, lane i the partials b = i, i + 32, ... in turn, then the lanes
// by a tree (h = 16, ..., 1), so S[f] is lane 0's; k[f] = 62 - ceil(log2
// S[f]) (0 where S is 0), as ops/grid.py:fixed_exponents computes it.
// Bound by bytes: v read once.
constexpr int kBoundThreads = 256;
constexpr int kFixedBits = 62;

__device__ __forceinline__ void add_abs(double* s, float x) {
  if (isfinite(x)) s[0] += (double)fabsf(x);
}

__device__ __forceinline__ void add_abs(double* s, float4 x) {
  add_abs(s, x.x);
  add_abs(s + 1, x.y);
  add_abs(s + 2, x.z);
  add_abs(s + 3, x.w);
}

template <int V>
__global__ void __launch_bounds__(kBoundThreads)
    abs_bound_kernel(const float* __restrict__ v, double* __restrict__ part,
                     unsigned* __restrict__ ticket, double* __restrict__ S,
                     int* __restrict__ k, int64_t N, int F, int Q,
                     int64_t chunk) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  __shared__ double sm[V * kBoundThreads];
  __shared__ bool last;
  const int nv = F / V;  // vectors a row
  const int c0 = blockIdx.y * kBoundThreads;
  const int W = min(nv - c0, kBoundThreads);
  const int t = threadIdx.x, q = t / W, c = t % W, nt = blockDim.x;
  const int64_t r0 = (int64_t)blockIdx.x * chunk;
  const int64_t r1 = min(r0 + chunk, N);
  double s[V] = {};
  constexpr int kU = V == 4 ? 8 : 16;
  if (q < Q) {
    const Vec* col = reinterpret_cast<const Vec*>(v) + c0 + c;
    const int64_t step = (int64_t)Q;
    int64_t r = r0 + q;
    for (; r + (kU - 1) * step < r1; r += kU * step) {
      Vec x[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) x[u] = __ldcs(col + (r + u * step) * nv);
#pragma unroll
      for (int u = 0; u < kU; ++u) add_abs(s, x[u]);
    }
    if (r < r1) {  // the thread's last rows, fewer than kU
      Vec x[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        x[u] = r + u * step < r1 ? __ldcs(col + (r + u * step) * nv) : Vec{};
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (r + u * step < r1) add_abs(s, x[u]);
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) sm[i * nt + t] = s[i];
  __syncthreads();
  for (int h = Q >> 1; h > 0; h >>= 1) {
    if (q < h) {
#pragma unroll
      for (int i = 0; i < V; ++i) sm[i * nt + t] += sm[i * nt + t + h * W];
    }
    __syncthreads();
  }
  if (q == 0) {
#pragma unroll
    for (int i = 0; i < V; ++i)
      part[(int64_t)blockIdx.x * F + (int64_t)(c0 + c) * V + i] =
          sm[i * nt + t];
    __threadfence();  // the partials reach L2 before the ticket
  }
  __syncthreads();
  if (t == 0)
    last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1u;
  __syncthreads();
  if (!last) return;
  const int lane = t & 31, P = (int)gridDim.x;
  for (int f = t >> 5; f < F; f += nt >> 5) {
    double a = 0.0;
#pragma unroll 8
    for (int b = lane; b < P; b += 32) a += __ldcg(part + (int64_t)b * F + f);
#pragma unroll
    for (int h = 16; h > 0; h >>= 1) a += __shfl_down_sync(kFullMask, a, h);
    if (lane == 0) {
      S[f] = a;
      int e = 0;
      const double m = frexp(a, &e);
      k[f] = a > 0.0 ? kFixedBits - (e - (m == 0.5 ? 1 : 0)) : 0;
    }
  }
  if (t == 0) *ticket = 0u;
}

// The two row sinks of the deterministic kernels alone, for the
// micro-benchmark of experiments/row_kernels_bench.py: thread i adds
// terms[i, 0..C) at row rows[i] of acc [*, C], by C scalar atomics of its
// own (transposed 0: the earlier sink, one lane a row) or
// warp-collectively through add_rows_transposed (1).
template <int C>
__global__ void fixed_sink_kernel(const uint32_t* __restrict__ rows,
                                  const long long* __restrict__ terms,
                                  int64_t M, unsigned long long* acc,
                                  int transposed) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool has = i < M;
  long long v[C] = {};
  uint32_t r = 0;
  if (has) {
    r = rows[i];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = terms[i * C + c];
  }
  if (transposed) {
    add_rows_transposed<C, C>(acc, has, r, v);
  } else if (has) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (v[c] != 0)
        atomicAdd(acc + (int64_t)r * C + c, (unsigned long long)v[c]);
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
// level_major: the block order (ops/grid.py:level_major). out: nullptr
// where only the residuals are wanted; resid: nullptr, or the residual
// mode's [L, n, 4, B, C] output (16-byte aligned). slices, lanes: the
// general path's plan (ops/grid.py:walk_plan; the tuned widths ignore it).
int nl_hash_encode_ms(const float* table, const float* x01, const float* stds,
                      float* out, float* resid, long long B, int n, int L,
                      int C, const float* scale, const float* grid_size,
                      const unsigned int* res, const unsigned int* rows,
                      const unsigned int* offset, const int* tiled,
                      const int* mean, int tetra, int level_major,
                      int slices, int lanes, int device, void* stream) {
  if (L <= 0 || L > kMaxLevels || n <= 0 || C <= 0 ||
      (uintptr_t)resid % 16 != 0 || (out == nullptr && resid == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  GridLevels lv;
  fill_levels(&lv, L, scale, grid_size, res, rows, offset, tiled, mean);
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The presets' grids: C = 1 and 4 (proposal), 4 and 16 (NeRF), 2
  // (objects, tiny_debug); and C = 8. Any other width: the general path.
  switch (C) {
    case 1:
      return encode<1>(table, x01, stds, out, resid, B, n, L, lv, tetra,
                       level_major, s);
    case 2:
      return encode<2>(table, x01, stds, out, resid, B, n, L, lv, tetra,
                       level_major, s);
    case 4:
      return encode<4>(table, x01, stds, out, resid, B, n, L, lv, tetra,
                       level_major, s);
    case 8:
      return encode<8>(table, x01, stds, out, resid, B, n, L, lv, tetra,
                       level_major, s);
    case 16:
      return encode<16>(table, x01, stds, out, resid, B, n, L, lv, tetra,
                        level_major, s);
    default:
      return by_slice_width(C, [&](auto w) {
        return encode_any<decltype(w)::value>(table, x01, stds, out, resid,
                                              B, n, L, C, slices, lanes, lv,
                                              tetra, level_major, s);
      });
  }
}

// d_table: zero-filled (or holding a sum to add to) by the caller; at a
// general-path width C % 4 != 0, scratch may be a zero-filled [rows, 4
// ceil(C / 4)] float buffer that takes the sums as float4 atomics, and the
// levels' rows of d_table are then written from it (their contents before
// are not read); else nullptr. mean, tetra, level_major:
// as the forward's; slices: the general path's plan (ops/grid.py:walk_plan).
int nl_hash_encode_ms_bwd(const float* x01, const float* stds,
                          const float* g_out, float* d_table, float* scratch,
                          long long B, int n, int L, int C,
                          const float* scale, const float* grid_size,
                          const unsigned int* res, const unsigned int* rows,
                          const unsigned int* offset, const int* tiled,
                          const int* mean, int tetra, int level_major,
                          int slices, int device, void* stream) {
  if (L <= 0 || L > kMaxLevels || n <= 0 || C <= 0 || d_table == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  GridLevels lv;
  fill_levels(&lv, L, scale, grid_size, res, rows, offset, tiled, mean);
  if (B == 0 && scratch == nullptr) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      return backward<1>(x01, stds, g_out, d_table, B, n, L, lv, tetra,
                         level_major, s);
    case 2:
      return backward<2>(x01, stds, g_out, d_table, B, n, L, lv, tetra,
                         level_major, s);
    case 4:
      return backward<4>(x01, stds, g_out, d_table, B, n, L, lv, tetra,
                         level_major, s);
    case 8:
      return backward<8>(x01, stds, g_out, d_table, B, n, L, lv, tetra,
                         level_major, s);
    case 16:
      return backward<16>(x01, stds, g_out, d_table, B, n, L, lv, tetra,
                          level_major, s);
    default:
      return by_slice_width(C, [&](auto w) {
        return backward_any<decltype(w)::value, false>(
            x01, stds, g_out, d_table, scratch, nullptr, nullptr, nullptr, B,
            n, L, C, slices, lv, tetra, level_major, kThreads, s);
      });
  }
}

// out: [rows, C], zero-filled (or holding a sum to add to) by the caller.
// C a power of two up to 32 (the tuned instantiations) or any other width
// (the general path, C <= 1024 gcd(C, 4)); idx and vals start on 16 bytes,
// out on 4 gcd(C, 4) bytes.
int nl_scatter_add_rows(const int* idx, const float* vals, float* out,
                        long long N, int C, long long rows, int device,
                        void* stream) {
  if (N < 0 || C <= 0 || ((uintptr_t)idx | (uintptr_t)vals) % 16 != 0 ||
      (uintptr_t)out % (4 * slice_width(C)) != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 32 && (C & (C - 1)) == 0)
    return scatter_any<FloatSums>(C, idx, vals, N, rows, device, s, out);
  return by_slice_width(C, [&](auto w) {
    return scatter_slices<decltype(w)::value, false>(
        idx, vals, nullptr, out, nullptr, nullptr, N, C, rows, device, s);
  });
}

// The deterministic K3: acc [rows, C] int64 and flags (4 bits an entry)
// zero-filled (or holding sums to add to) by the caller; k: [C] exponents
// on the device. Then nl_fixed_to_float. idx and vals start on 16 bytes.
// C as nl_scatter_add_rows takes it.
int nl_scatter_add_rows_fixed(const int* idx, const float* vals, const int* k,
                              long long* acc, unsigned* flags, long long N,
                              int C, long long rows, int device,
                              void* stream) {
  if (N < 0 || C <= 0 || ((uintptr_t)idx | (uintptr_t)vals) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* a = reinterpret_cast<unsigned long long*>(acc);
  switch (C) {
    case 1: return scatter_fixed<1>(idx, vals, k, a, flags, N, rows, device, s);
    case 2: return scatter_fixed<2>(idx, vals, k, a, flags, N, rows, device, s);
    case 4: return scatter_fixed<4>(idx, vals, k, a, flags, N, rows, device, s);
    case 8: return scatter_fixed<8>(idx, vals, k, a, flags, N, rows, device, s);
    case 16:
      return scatter_fixed<16>(idx, vals, k, a, flags, N, rows, device, s);
    case 32:
      return scatter_fixed<32>(idx, vals, k, a, flags, N, rows, device, s);
    default:
      return by_slice_width(C, [&](auto w) {
        return scatter_slices<decltype(w)::value, true>(
            idx, vals, k, nullptr, a, flags, N, C, rows, device, s);
      });
  }
}

// The deterministic H1-bwd d_table: acc [rows, C] int64 and flags
// zero-filled by the caller, k: [L, C] exponents on the device; then
// nl_fixed_to_float. threads: the block size (a multiple of 32). The other
// arguments as nl_hash_encode_ms_bwd's.
int nl_hash_encode_ms_bwd_fixed(const float* x01, const float* stds,
                                const float* g_out, const int* k,
                                long long* acc, unsigned* flags, long long B,
                                int n, int L, int C, const float* scale,
                                const float* grid_size,
                                const unsigned int* res,
                                const unsigned int* rows,
                                const unsigned int* offset, const int* tiled,
                                const int* mean, int tetra,
                                int level_major, int threads, int slices,
                                int device, void* stream) {
  if (L <= 0 || L > kMaxLevels || n <= 0 || C <= 0)
    return cudaErrorInvalidValue;
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
    case 8:
      return backward_fixed<8>(x01, stds, g_out, k, a, flags, B, n, L, lv,
                               tetra, level_major, threads, s);
    case 16:
      return backward_fixed<16>(x01, stds, g_out, k, a, flags, B, n, L, lv,
                                tetra, level_major, threads, s);
    default:
      return by_slice_width(C, [&](auto w) {
        return backward_any<decltype(w)::value, true>(
            x01, stds, g_out, nullptr, nullptr, k, a, flags, B, n, L, C,
            slices, lv, tetra, level_major, threads, s);
      });
  }
}

// d_x01 [B, n, 3] / d_stds [B, n] (each nullptr when not wanted; written,
// not added to) from H1's residuals resid [L, n, 4, B, C] and g_out
// [B, L, C], both 16-byte aligned.
int nl_hash_encode_ms_pos_grads(const float* resid, const float* g_out,
                                float* d_x01, float* d_stds, long long B,
                                int n, int L, int C, int device,
                                void* stream) {
  if (B < 0 || L <= 0 || n <= 0 || C <= 0 ||
      ((uintptr_t)resid | (uintptr_t)g_out) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || (d_x01 == nullptr && d_stds == nullptr)) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return pos_grads<1>(resid, g_out, d_x01, d_stds, B, n, L, s);
    case 2: return pos_grads<2>(resid, g_out, d_x01, d_stds, B, n, L, s);
    case 4: return pos_grads<4>(resid, g_out, d_x01, d_stds, B, n, L, s);
    case 8: return pos_grads<8>(resid, g_out, d_x01, d_stds, B, n, L, s);
    case 16: return pos_grads<16>(resid, g_out, d_x01, d_stds, B, n, L, s);
    default:
      return by_slice_width(C, [&](auto w) {
        return pos_grads_slices<decltype(w)::value>(resid, g_out, d_x01,
                                                    d_stds, B, n, L, C, s);
      });
  }
}

// out [rows, C] float32 from the deterministic kernels' acc, flags and k
// ([G, C] on the device), leaving acc and flags zero; starts: G + 1 row
// starts on the host (the groups' row ranges, starts[G] = rows). C a power
// of two with every group starting on a multiple of 4 entries takes
// fixed_to_float_kernel, any other C or start fixed_to_float_any_kernel.
// acc and out start on 16 bytes.
int nl_fixed_to_float(long long* acc, unsigned* flags, const int* k,
                      const long long* starts, int G, float* out,
                      long long rows, int C, int device, void* stream) {
  if (G <= 0 || G > kMaxLevels || C <= 0 || rows < 0 ||
      ((uintptr_t)acc | (uintptr_t)out) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Groups gr{};
  // fixed_to_float_kernel: C a power of two, every group on whole float4s.
  bool tuned = (C & (C - 1)) == 0;
  for (int g = 0; g <= G; ++g) {
    gr.start[g] = starts[g];
    if (g < G && starts[g] * C % 4 != 0) tuned = false;
  }
  gr.count = G;
  const int64_t total = rows * C;
  if (total == 0) return cudaSuccess;
  constexpr int kBlock = 256;
  const int64_t blocks = ((total + 3) / 4 + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tuned)
    fixed_to_float_kernel<<<(unsigned)blocks, kBlock, 0, s>>>(
        acc, flags, k, out, total, __builtin_ctz(C), gr);
  else
    fixed_to_float_any_kernel<<<(unsigned)blocks, kBlock, 0, s>>>(
        acc, flags, k, out, total, C, gr);
  return cudaGetLastError();
}

// The bound S [F] (float64) of the deterministic sums of v [N, F] and its
// exponents k [F] (int32): the sum of |v| over the finite entries of each
// column, in the order of the plan (V, Q, P, chunk) of
// ops/grid.py:_bound_plan (V = 4 where F % 4 == 0, else 1; Q a power of
// two, 1 for F / V > 256; P blocks of chunk rows, P * chunk >= N), in one
// launch. part: [P, F] float64 scratch; ticket: one unsigned, 0 before the
// call and after it. v starts on 4 V bytes.
int nl_abs_bound(const float* v, double* part, unsigned* ticket, double* S,
                 int* k, long long N, int F, int V, int Q, int P,
                 long long chunk, int device, void* stream) {
  const int nv = V > 0 ? F / V : 0;
  if (N < 0 || F <= 0 || (V != 1 && V != 4) || F % V != 0 || Q <= 0 ||
      (Q & (Q - 1)) != 0 || P <= 0 || P > 65535 || chunk <= 0 ||
      (int64_t)P * chunk < N ||
      (nv > kBoundThreads ? Q != 1 : Q * nv > kBoundThreads) ||
      (uintptr_t)v % (4 * V) != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = (min(nv, kBoundThreads) * Q + 31) / 32 * 32;
  const dim3 grid(P, (nv + kBoundThreads - 1) / kBoundThreads);
  if (V == 4)
    abs_bound_kernel<4><<<grid, threads, 0, s>>>(v, part, ticket, S, k, N,
                                                 F, Q, chunk);
  else
    abs_bound_kernel<1><<<grid, threads, 0, s>>>(v, part, ticket, S, k, N,
                                                 F, Q, chunk);
  return cudaGetLastError();
}

// The micro-benchmark of the deterministic kernels' row sinks: terms [M, C]
// int64 added at rows [M] of acc [*, C] (fixed_sink_kernel), C = 1, 2, 4,
// 8 or 16, blocks of kThreads.
int nl_fixed_sink(const unsigned* rows, const long long* terms, long long M,
                  int C, long long* acc, int transposed, int device,
                  void* stream) {
  if (M < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M == 0) return cudaSuccess;
  const int64_t blocks = (M + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* a = reinterpret_cast<unsigned long long*>(acc);
  switch (C) {
    case 1:
      fixed_sink_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(
          rows, terms, M, a, transposed);
      break;
    case 2:
      fixed_sink_kernel<2><<<(unsigned)blocks, kThreads, 0, s>>>(
          rows, terms, M, a, transposed);
      break;
    case 4:
      fixed_sink_kernel<4><<<(unsigned)blocks, kThreads, 0, s>>>(
          rows, terms, M, a, transposed);
      break;
    case 8:
      fixed_sink_kernel<8><<<(unsigned)blocks, kThreads, 0, s>>>(
          rows, terms, M, a, transposed);
      break;
    case 16:
      fixed_sink_kernel<16><<<(unsigned)blocks, kThreads, 0, s>>>(
          rows, terms, M, a, transposed);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
