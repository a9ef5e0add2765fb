#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`nerf_lidar_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases (each raises on failure, so the script exits non-zero):
1. device: needs CUDA; prints the card's name and power limit (nvidia-smi);
2. build: compiles csrc/*.cu with nvcc (sm_90a) and loads the library;
3. K1 `composite` vs its plain torch version at the slice's chunk
   (R = 16,384, S = 32, K = 19; opaque on/off; ragged R = 700; the sweep's
   last chunk, R = 2,432) on seeded uniform densities and on trained-like
   ones (log-normal up to 1e4, rays opaque at their first sample, rays of
   zero density); device times from torch.profiler;
4. H1 `hash_encode_ms` vs its plain torch version on the `nuscenes_single`
   NeRF (10 x C4, 14,995,560 rows) and proposal (C1) grids, each at the
   batch the main path gives it (16,384-ray chunk x 32 NeRF or 64 proposal
   samples), n = 7 multisamples: on uniform points with out-of-range ones,
   and on the (x01, stds) of the first render chunk of [5]; times and the
   bound per grid on both;
5. the slice: the port's `render_lidar` entry, in-process, renders two
   full 35,200-ray sweeps of `nuscenes_single` at full width (seeded fresh
   weights) with the kernels on; checks the files and values and counts the
   kernel launches of that run; records the encode's inputs of one more
   sweep's first chunk; times one sweep kernels on and off
   (`use_kernels=False`); then gives every hash table seeded uniform(-1, 1)
   values, so that the encode moves density, colour and the resampling,
   and compares the kernels-on render with the kernels-off one;
6. the H1 backward `hash_encode_ms_bwd` at the train step's shapes (20,480
   rays x 32 NeRF or 64 proposal samples, n = 7) vs its written-out plain
   twin (`index_add_`) on every grid, on uniform points and on the
   (x01, stds, g_out) one warm step of [8] gave it: d_table, and d_x01 /
   d_stds on the smallest proposal grid's uniform points, where it is also
   held against plain autograd through the plain encode; times and the
   bound per grid;
7. K3 `scatter_add_rows` vs `index_add_` at the shapes the train path gives
   it (the hash-decay level sums of the three grids: every row of a level
   onto one output row; against float64) and at K3's own shapes (rows 4,096
   and 2^17, N 2^20 and 2^22, C 16); kernel, plain and `index_add_` device
   times (torch.profiler) beside the bound at every shape;
8. the port's `train` entry, in-process, in a fresh experiment directory,
   fits `nuscenes_single` on the synthetic scene at full width for 30 steps
   with the kernels on: finite losses, a non-zero gradient on every hash
   table, the launch counts of H1, its backward and K3, warm ms/step,
   rays/s and peak memory; records the encode backward's inputs of one more
   step (for [6]); then 3 steps kernels on vs off from the same
   weights, batches and randomness (the loss of each; the first step's
   MLP gradients to 1e-3 of their largest value, each hash table's to
   float32 eps times the magnitudes of its summed terms beyond what the two
   sides' encode inputs carry, `table_grad_excess`; the hash-decay term);
   then 100 steps at the full learning rate (no warm-up), where the data
   loss must fall. The entry feeds its steps through the prefetcher (the
   JAX package's worker stream) and saves asynchronously: its
   checkpoint_30.pt, reloaded, equals the state at step 30 tensor for
   tensor; its first 5 losses equal 5 steps fed inline (a fresh init, the
   same batches and generator) at LOSS_TOL; `AsyncCheckpointer.save`'s
   hold on the loop, its writer's time and a synchronous `save_checkpoint`
   of the same state, and the state's bytes. With the profiler phases,
   `train --trace_dir` over 5 warm steps (no per-step print): wall and
   device-busy ms/step and the idle share from the trace, beside the
   earlier profile of the step fed inline (`hash_encode_bench.py
   --profile`), and each place a warm step still waits for the device;
9. train -> render: `render_lidar --params` renders one full sweep from the
   params_100.npz that [8]'s learning check wrote, through K1 and H1; then
   that sweep kernels on, every K1 and H1 call held against its plain
   version on its own inputs, vs kernels off (`use_kernels=False`) at
   [5]'s tolerances on all but TRAINED_SWEEP_SHARE of the values, and K1
   on with H1 off vs off at [5]'s tolerances on every value; then K1 vs
   plain, and its device time, on the recorded inputs of the sweep's first
   chunk;
10. the in-tile gathers (`ops/tile_gather.py`, `csrc/gather.cu`) at the TPU
   kernels' own shapes: K2 `tile_lane_gather` [8, 128], K4's other four
   forms (`take_along_axis` on (256, 128), (128, 128) axis 0 and (8, 2^15);
   `take_rows` (512, 128) <- 256) and K5 (`tile_grid_gather`, tbl [8, 128],
   idx [1024, 8, 128]), and `take_rows` at the gather bench's row gather
   (2^19, 16) <- 2^20, each exactly equal to its plain version, NaN
   positions included, on in-range indices and on negative and
   out-of-range ones; kernel, plain and library-call (`take_along_dim` /
   `index_select`) device times from torch.profiler, kernel and library
   call in turns (kernel, library, library, kernel; 50 calls each); and
   the device time of an empty kernel, the card's launch floor;
11. the port's gather-bench entry (`experiments/gather_bench.py`),
   in-process, at the JAX bench's sizes: every probe line prints, the K4
   forms pass, and the launch counts of that run; then the device time of
   one call of its row gather (both layouts) and row scatter-add at the
   hash grid's 2^19 x 16, without the bench's host loop;
12. dynamic objects: writes a synth_nusc scene (one moving "vehicle.car"
   and its track) with the port's copy of the writer, runs the port's
   `train` entry on it, in-process, with `nuscenes_single` at full width
   and the tracknet live from the first step (`track_start_opt=0`) for
   OBJ_STEPS steps: finite losses, obj_hit_frac > 0, obj_overflow 0, a
   non-zero gradient on every hash table, obj_latents and the tracknet's
   opt_t, the launch counts (and those on the object grid), warm ms/step
   and peak memory beside [8]'s; then 2 steps kernels on vs off under
   [8]'s rules (the object table, obj_latents and the tracknet included;
   without obj_nodecay, so that K3 sums the object table there too); then
   `render_lidar --mode replay` from the params it wrote, with the car
   (`--obj_mode replay`) and without it (`removal`), every K1 and H1 call
   held against its plain version: the files, a ray with a sample in a
   box, and the rays with no sample in a box at any level equal between
   the two renders at [5]'s tolerances; warm s/sweep of both; then H1 and
   H1-bwd (d_table, d_x01; also vs plain autograd) on the object grid at a
   train step's recorded call (n = 1, stds 0), in both block orders in
   turns, and K3 at the object table's hash-decay level sums, with device
   times and bounds; and a torch.profiler breakdown of 2 warm train steps
   with objects (`hash_encode_bench.profile_train`); these profiled parts
   run after [13];
13. ray-drop: writes a synth_nusc scene with dense LiDAR (RD_SWEEPS frames,
   1,100 returns per beam), trains a field on it for RD_FIELD_STEPS steps
   and renders RD_SWEEPS replay sweeps (the earlier entries), then, with
   every kernel count at 0, drives the ray-drop path through the port's
   CLI on the card: `raydrop_features` ([N, 32, 1024, 6] features),
   `raydrop_train` (the U-Net at 64-1024 with the VGG19 loss, 32 x 1024,
   batch 4, RD_EPOCHS epochs: one eval; the training CE must fall), a
   short `raydrop_train --darknet` (Darknet-53), `raydrop_drop --place_car
   --features` (velodyne/*.bin and labels/*.label read back against
   drop_sweep, ground returns below the sensor, the sensor metadata) and
   `raydrop_val_vis`; no kernel of the table launches there. Then the card
   against the CPU from the trained weights: eval logits, the keep mask,
   one train step in float64 (at RD_LOSS_TOL / RD_GRAD_TOL / RD_BN_TOL) and
   in float32 (its loss; its gradients reported); and the times of a train
   step (VGG; VGG + Darknet), a predict, and features / drop per sweep;
   the VGG step in turns with the port's resize and cross-entropy
   (interpolation matrices, a one-hot), torch's (`F.interpolate`,
   `F.cross_entropy`), and under `cli.deterministic_mode`;
14. evaluation, on [13]'s scene and field: the port's `eval` (every test
   view; K1 and H1), `lidar_eval --max_rays 0` (every replayed return,
   seeded per-point labels for the mIoU path; K1 and H1) and `render
   --path test --num_frames 1` (compute_extras: H1, no K1), each with the
   kernel counts at 0 just before it; their files and finite metrics; eval's
   first view with every K1 and H1 call held against its plain version,
   and kernels on vs off at [5]'s tolerances on all but
   TRAINED_SWEEP_SHARE of the values; the field's weights written as a JAX
   checkpoint_<step>.ckpt (Flax msgpack, the port's `utils/msgpack.py`
   writer) and evaluated through the port's decoder: metrics and images
   equal to the .npz's; PSNR / SSIM card vs CPU (rtol 1e-5) and Chamfer vs
   a float64 k-d tree (rtol 1e-5) on lidar_eval's clouds and on seeded
   clouds of 35,200 and 5 x 10^5 points; eval s/view, lidar_eval s, Chamfer
   ms, peak GiB.
15. the field presets: `nuscenes_single_fast` and `nuscenes_single_speed`
   train PRESET_STEPS steps each through the `train` entry at full width
   on the synthetic scene (finite losses, a gradient on every table,
   launches, warm ms/step, rays/s, peak memory), then 3 steps kernels on
   vs off under [8]'s rules (`_speed`'s bfloat16 MLP gradients at
   GRAD_TOL_BF16); `_speed` trains PRESET_LEARN_STEPS steps at the full
   learning rate, where the data loss must fall; `render_lidar` renders
   PRESET_SWEEPS sweeps from each trained field and from a seeded
   `nuscenes_single_mxu` (warm s/sweep), and its first sweep again with
   every K1 / H1 call held against its plain version, per mode
   combination (tetrahedral, mean-point levels, C16 rows), and against
   the sweep kernels off (the share outside [5]'s tolerances reported);
   `spectral_obj_variant(nuscenes_single_speed())` trains SPEC_OBJ_STEPS
   steps through `--config_json` on [12]'s scene with the tracknet live
   (H1-bwd's tetrahedral d_x01 on the object grid against its twin) and
   renders a replay sweep; then H1 / H1-bwd per grid on each path's own
   inputs (kernel, plain and bound), the speed field's Fourier band, and
   (with the profiler phases) a torch.profiler breakdown of one warm
   `_fast` and `_speed` step.
16. mesh extraction and the object-scene entries: `extract --resolution
   256 --clean --decimate 100000` of [8]'s learning-check weights with
   every H1 call held against its plain version (launches counted from 0
   just before it, read just after; no K1, no backward); the lattice
   kernels on vs off (rtol 1e-5 / atol 1e-6); a second mesh at a level
   taken from the lattice's densities (its 99.9th percentile), which must
   be non-empty, its vertex colours kernels on vs off (atol 1e-4), the
   seconds of the lattice, marching, welding, cleaning, decimation and
   colours, and the peak device and host memory; on [12]'s scene and
   weights `render_video --mode laneshift --num_frames 1`, once more with
   `--hq`, and `render_instance`, each with every H1 call held against
   its plain version, the laneshift frame kernels on vs off as [14] holds
   eval's view, the orbit views at [5]'s tolerances, s per frame / view;
   then `train --obj_ckpt` from a file of [12]'s object MLP, whose
   subtree must equal the file's at step 0 (H1, H1-bwd, K3 launched); and
   (with the profiler phases) H1's device time and bound on the lattice's
   first 65,536-point chunk.
17. data parallel at full width: two ranks on the one card, each a
   process of this script (`--dp_rank R --dp_world 2 --dp_port P`) that
   joins a gloo group over CUDA tensors (NCCL refuses two ranks on one
   device), run the port's `train` entry for 3 steps of `nuscenes_single`
   on the synthetic scene (20,480 rays a step, 10,240 a rank) and then a
   `render_lidar` sweep of the weights it wrote, with the kernel counts at
   0 before each; every rank's parameters equal; against one rank in this
   process from the same argv (the same init, batches and generator): the
   loss terms at LOSS_TOL, every parameter within twice the learning
   rates' sum (an entry whose gradient is within rounding of 0 may move
   either way), its last step's gradient to GRAD_TOL of its largest value,
   and the sweep at [5]'s tolerances; then the ranks train 2 steps on
   [12]'s scene with its car (the object sample budget counted over both
   ranks, the tracknet live), every logged term and stat at LOSS_TOL of
   one rank's; then an NCCL group of world 1 on the card runs
   `parallel/mesh.py`'s all_reduce, autograd all_gather, broadcast,
   barrier and bucketed gradient sum; the launches of H1, H1-bwd, K3
   (train, and with objects) and H1, K1 (sweep) on each rank, and the
   seconds.
18. the rest of the field and the other loaders: writes a 16-view 504 x
   378 COLMAP capture of the synthetic scene (PNG, binary sparse/0) and
   the same as RawNeRF mosaics with EXIF sidecars; `train --config default
   --set dataset_loader=llff` with the Ref-NeRF heads, the IDE of the
   reflection direction, n . v, finite-difference density normals, GLO and
   a background range (REF_SETS) at 16,384 rays a step for REF_STEPS
   steps (launches per step, ms/step, peak memory, a gradient on every
   table, the GLO vectors, the normal and roughness heads), 3 steps
   kernels on vs off under [8]'s rules, a REF_LEARN_STEPS-step learning
   check; `eval` on the llffhold split (s per view; its first view with
   every K1 and H1 call held against its plain version, kernels on vs off
   as [14]) and `render --path test`; the RawNeRF train (its loss terms, a
   gradient on the exposure offsets) and eval (every chunk carries the
   exposure keys); `validate_scene` on [13]'s scene (no ERROR); with the
   profiler phases, H1 / H1-bwd per grid, K1 and K3 on this path's own
   inputs.
19. determinism (torch's deterministic algorithms; `--deterministic`):
   on [8]'s recorded train inputs of every grid, H1-bwd's deterministic
   d_table (`hash_encode_ms_bwd_fixed` + `fixed_to_float`) the same bits
   on 3 fresh copies and in both block orders, against the float twin
   (4096 float32 eps of each entry's |terms| + half a quantum a term) and
   the plain deterministic twin (+ one quantum a term), and against the
   atomic kernel at [6]'s tolerance; the bound S and quantum per level,
   the peak memory of a call; K3's deterministic variant at each grid's
   hash-decay level sums and at K3's own shape (rows 2^17, N 2^22, C16)
   bit-identical to its plain twin and within half a quantum a term (and
   the sum's rounding to float32) of float64; the d_x01 / d_stds gather
   pass (`hash_encode_ms_pos_grads`) on [12]'s recorded object-grid call
   and [15]'s `_fast` NeRF call (mean-point levels): the same bits on 3
   copies, against the plain version and the atomic kernel at [6]'s
   tolerance; device times beside the atomic kernels (on the NeRF grid and
   K3's shape in turns, by kernel, and under the switch with and without
   torch's fill of uninitialized memory), the bound and (K3) `index_add_`
   under the switch; then `train --deterministic` twice from one seed on
   `nuscenes_single` (DET_STEPS steps, 20,480 rays a step; once more
   without the fill), on [12]'s object scene with the tracknet live
   (DET_OBJ_STEPS; the d_x01 pass) and on `nuscenes_single_fast`
   (DET_FAST_STEPS; tetrahedral, mean-point and C16 modes): every
   parameter, buffer, Adam moment and logged stat equal to the bit, no
   atomic kernel launched; `raydrop_train --deterministic` twice on [13]'s
   features (VGG loss), the same; each beside the default mode's two runs
   (their difference printed, not a condition); ms/step and peak GiB of
   both modes.
The phases run in the order 1, 2, 3, 5, 4, 8, 12, 13, 14, 15, 16, 17, 18,
12-profiled, 15-profiled, 16-profiled, 18-profiled, 8-profiled, 6, 7, 9,
10, 11, 19 ([19] last: it turns torch's process-wide switch on and off): [4]
and [6] time the encode on the inputs that [5] and [8] record, and what
times with torch.profiler ([3]'s timing, [7], [9], [10], [11], [12]'s
kernel times and profile) runs after the timed entries, [3]'s timing after
[7]. Then it fails if any
module of jax, jaxlib, flax, optax, msgpack or the JAX package
(`nerf_lidar_tpu`, `nerf_lidar_tpu.*`) was imported. Prints the kernels'
JSON line (every kernel's launches on each path, the object paths
`train_objects` and `render_lidar_objects`, the ray-drop path `raydrop`
(none), the eval entries `eval`, `lidar_eval`, `render`, [15]'s
`train_fast`, `render_lidar_fast`, `train_speed`, `render_lidar_speed`,
`render_lidar_mxu`, `train_spectral_obj`, `render_lidar_spectral_obj` and
[16]'s `extract`, `render_video`, `render_video_hq`, `render_instance`,
`train_obj_ckpt`, [17]'s `train_dp_rank<r>`, `render_lidar_dp_rank<r>`
and `train_objects_dp_rank<r>` and [18]'s `train_refnerf`,
`eval_refnerf`, `render_refnerf`, `train_rawnerf`, `eval_rawnerf`
included, times,
and its bound:
the larger of its bytes over the card's memory rate and its operations
over its float32 rate; H1 and its backward per grid too, and H1, H1-bwd
and K3 on the object grid under "obj_grid", H1 and H1-bwd per [15] path
and grid under "preset_modes", H1 on [16]'s lattice chunk under
"lattice_chunk", [18]'s numbers of each kernel on its path under
"refnerf", [19]'s under "deterministic" of H1-bwd and K3, with their
launches on [19]'s paths `train_static_deterministic`,
`train_objects_deterministic`, `train_fast_deterministic`), the
nvidia-smi line,
then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "nerf_lidar_tpu_torch/csrc/kernels.cu"
GATHER_SOURCE = "nerf_lidar_tpu_torch/csrc/gather.cu"
# Published peaks of one H100 SXM at 700 W: device memory 3.35 TB/s, float32
# outside the tensor cores 67 TFLOP/s (per millisecond below).
HBM_BYTES_PER_MS = 3.35e9
FP32_FLOP_PER_MS = 67e9
MODULES_BARRED = ("jax", "jaxlib", "flax", "optax", "msgpack",
                  "nerf_lidar_tpu")
# The main paths: the port's `render_lidar` and `train` entries, as a user
# would call them.
SLICE_ARGV = ["render_lidar", "--config", "nuscenes_single",
              "--set", "dataset_loader=synthetic", "--mode", "simu",
              "--num_sweeps", "2", "--allow_fresh", "--device", "cuda",
              "--exp_name", "chip_smoke"]
TRAIN_STEPS = 30
TRAIN_ARGV = ["train", "--config", "nuscenes_single",
              "--set", "dataset_loader=synthetic", "--set", "print_every=1",
              "--steps", str(TRAIN_STEPS), "--device", "cuda",
              "--exp_name", "chip_smoke_train"]
LEARN_ARGV = ["train", "--config", "nuscenes_single",
              "--set", "dataset_loader=synthetic", "--set", "print_every=1",
              "--set", "lr_delay_steps=0", "--steps", "100",
              "--device", "cuda", "--exp_name", "chip_smoke_learn"]
# [12]: the recipe on a synth_nusc scene with one moving car, whose track
# the tracknet refines from the first step.
OBJ_EXP = "chip_smoke_objects"
OBJ_SCENE = os.path.join("exp", OBJ_EXP, "scene")
OBJ_STEPS = 20
OBJ_TRAIN_ARGV = ["train", "--config", "nuscenes_single",
                  "--set", "dataset_loader=nusc", "--data_dir", OBJ_SCENE,
                  "--set", "track_start_opt=0", "--set", "print_every=1",
                  "--steps", str(OBJ_STEPS), "--device", "cuda",
                  "--exp_name", OBJ_EXP]
OBJ_RENDER_ARGV = ["render_lidar", "--config", "nuscenes_single",
                   "--set", "dataset_loader=nusc", "--data_dir", OBJ_SCENE,
                   "--mode", "replay", "--num_sweeps", "1", "--device",
                   "cuda", "--exp_name", OBJ_EXP]
# [13]: the ray-drop stage on a synth_nusc scene with dense LiDAR (1,100
# returns per beam, as real sweeps are: the 256-point default leaves the
# ground-truth range image 75% empty), a field trained on it briefly.
RD_EXP = "chip_smoke_raydrop"
RD_SCENE = os.path.join("exp", RD_EXP, "scene")
RD_SWEEPS = 8
RD_FIELD_STEPS = 60
RD_EPOCHS = 10
RD_FIELD_ARGV = ["--config", "nuscenes_single", "--set", "dataset_loader=nusc",
                 "--data_dir", RD_SCENE, "--set", "track_start_opt=0",
                 "--set", "lr_delay_steps=0", "--device", "cuda",
                 "--exp_name", RD_EXP]
RD_RENDER_ARGS = ["--mode", "replay", "--num_sweeps", str(RD_SWEEPS)]
RD_DEVICE = ["--device", "cuda"]
# Card against CPU from one set of weights (TF32 off): the U-Net's eval
# logits to 1e-4 of their max; one train step's loss rtol 1e-4, gradients
# 1e-3 of each tensor's max, BatchNorm buffers rtol 1e-5; the keep mask
# equal wherever the CPU's probability is farther than 1e-4 from 0.5.
RD_LOGIT_TOL = 1e-4
RD_LOSS_TOL = 1e-4
RD_GRAD_TOL = 1e-3
RD_BN_TOL = 1e-5
RD_KEEP_MARGIN = 1e-4
# What [5] and [8] measured, printed beside [12]'s.
STATIC = {}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def close(name, got, want, rtol, atol):
    """Max |got - want|; raises unless |got - want| <= atol + rtol |want|."""
    import torch
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        fail(f"{name}: {int(bad.sum())} of {got.numel()} values outside "
             f"rtol {rtol} / atol {atol} (max abs err {float(err.max())})")
    return float(err.max())


def rel_err(name, got, want, tol):
    """max |got - want| / max |want|; raises above tol. Returns (max abs
    err, relative err)."""
    import torch
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or scale == 0 \
            or err > tol * scale:
        fail(f"{name}: max abs err {err} against max |want| {scale} "
             f"(tolerance {tol} of it)")
    return err, err / scale


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device milliseconds per call of fn, timed with CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_once(fn):
    """(device milliseconds of one call of fn, its result)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def device_spans(fn, iters=50):
    """{device activity name: its device milliseconds per call of fn}, from
    `iters` calls under torch.profiler, so host launch gaps between short
    kernels do not count. This card's tracer now and then drops activities
    from a session (late in a long process, the first launch of every
    session, or most of them), so a session counts only if each activity
    name appears a whole multiple of `iters` times; up to five are taken,
    and if none is whole, the last one gives each name's mean duration
    times its launches per call, rounded."""
    import statistics
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                spans.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if spans and all(len(v) % iters == 0 for v in spans.values()):
            return {k: sum(v) / 1e3 / iters for k, v in spans.items()}
    return {k: statistics.fmean(v) * round(len(v) / iters) / 1e3
            for k, v in spans.items()}


def device_ms(fn, iters=50):
    """Device milliseconds per call of fn: the summed time of its device
    activities (kernels, copies, fills) by `device_spans`. If that is zero,
    CUDA events time fn, with a note."""
    ms = sum(device_spans(fn, iters).values())
    if ms > 0:
        return ms
    print("    (torch.profiler recorded no whole launch in five sessions: "
          "CUDA events instead)")
    return cuda_ms(fn, iters)


def queued_ms(fn, iters=20):
    """Device ms per call of fn by CUDA events around `iters` calls queued
    behind a device sleep (`torch.cuda._sleep`), so the kernels run back
    to back and a wrapper's host side, longer than a short kernel, does not
    count. The sleep outlasts the host's enqueueing by twice its measured
    time, doubled up to twice more while the host outlasts it; None if it
    still does."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10**6)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10**6 / start.elapsed_time(end)
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    sleep_ms = 2e3 * (time.perf_counter() - t) + 5
    for _ in range(3):
        torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
        t = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = 1e3 * (time.perf_counter() - t)
        torch.cuda.synchronize()
        if queued < sleep_ms:
            return start.elapsed_time(end) / iters
        sleep_ms *= 2
    return None


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes, flops):
    """The least time the card could take: {"bound_ms", "bound_by"}, the
    larger of bytes over the memory rate and float32 operations over the
    float32 rate."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_MS, flops / FP32_FLOP_PER_MS
    if by_bytes >= by_ops:
        return dict(bound_ms=by_bytes, bound_by="bytes")
    return dict(bound_ms=by_ops, bound_by="operations")


# K1 against its plain version, per output: (rtol, atol).
COMPOSITE_TOL = dict(weights=(1e-5, 1e-6), depth=(1e-4, 1e-5),
                     acc=(1e-5, 1e-6), rgb=(1e-5, 1e-5),
                     semantic=(1e-5, 1e-5), intensity=(1e-5, 1e-5))


def composite_inputs(dev, r, s, k, g, trained=False, opaque=True,
                     with_int=False):
    """Seeded K1 inputs: densities uniform in [0, 3), or (`trained`) what a
    trained field gives K1: log-normal densities up to 1e4, every 8th ray
    opaque at its first sample (1e4 there) and every 16th ray of zero
    density, so that T underflows to 0 and the last sample takes it all."""
    import torch
    rand = lambda *shape: torch.rand(*shape, device=dev, generator=g)
    density = rand(r, s) * 3
    if trained:
        density = torch.exp(torch.randn(r, s, device=dev, generator=g) * 3
                            ).clamp(max=1e4)
        density[::8, 0] = 1e4
        density[::16] = 0.0
    return dict(density=density,
                tdist=torch.sort(rand(r, s + 1) * 5, dim=-1).values,
                dirs=torch.randn(r, 3, device=dev, generator=g),
                rgb=rand(r, s, 3), semantic=rand(r, s, k) if k else None,
                intensity=rand(r, s) if with_int else None,
                opaque_background=opaque, bg_value=1.0)


def check_composite(what, args):
    """K1 vs its plain version on `args` at COMPOSITE_TOL; the max abs
    error."""
    import torch
    from nerf_lidar_tpu_torch.ops import render_fused
    got = render_fused.fused_composite(**args)
    want = render_fused.fused_composite_plain(**args)
    torch.cuda.synchronize()
    if set(got) != set(want):
        fail(f"composite outputs {sorted(got)} != {sorted(want)}")
    return max(close(f"composite {what} {key}", got[key], want[key],
                     *COMPOSITE_TOL[key]) for key in want)


def composite_bound(args):
    """K1's bound on `args`: every input read once, every output written
    once; operations, the weighted sums of depth, rgb and semantics (2 per
    sample each)."""
    import torch
    from nerf_lidar_tpu_torch.ops import render_fused
    out = render_fused.fused_composite(**args)
    r, s = args["density"].shape
    k = args["semantic"].shape[-1] if args["semantic"] is not None else 0
    return bound(nbytes(*(v for v in args.values()
                          if isinstance(v, torch.Tensor)), *out.values()),
                 2 * r * s * (4 + k))


def phase_composite(dev):
    """K1 vs plain on the card. Returns the max abs error."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for r, trained, opaque, with_int in (
            (16384, False, True, False), (16384, False, False, True),
            (700, False, True, True), (16384, True, True, False),
            (2432, True, False, True)):
        args = composite_inputs(dev, r, 32, 19, g, trained, opaque, with_int)
        worst = max(worst, check_composite(
            f"R={r} trained-like={trained} opaque={opaque}", args))
    print(f"[3] composite vs plain: max abs err {worst:.3e}")
    return worst


def time_composite(dev, worst):
    """[3]'s timing, after the timed entries (a torch.profiler session
    slows a later host-bound phase), on [3]'s first inputs (R = 16,384,
    opaque, no intensity): the numbers of K1's kernels line, by device time
    (CUDA events would time the wrapper's host side)."""
    import torch
    from nerf_lidar_tpu_torch.ops import render_fused
    timed = composite_inputs(dev, 16384, 32, 19,
                             torch.Generator(device=dev).manual_seed(0))
    ms = device_ms(lambda: render_fused.fused_composite(**timed))
    plain_ms = device_ms(lambda: render_fused.fused_composite_plain(**timed),
                         iters=10)
    lim = composite_bound(timed)
    print(f"[3] composite R=16384 S=32 K=19: device ms kernel {ms:.5f}, "
          f"plain {plain_ms:.4f}; bound {lim['bound_ms']:.5f} ms "
          f"({lim['bound_by']})")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                library_ms=None, **lim)


def main_path_grids(cfg):
    """[(name, GridConfig, samples per ray)] of the NeRF and proposal grids."""
    m = cfg.model
    return [("nerf", m.nerf_mlp.grid, m.num_nerf_samples)] + [
        (f"prop{i}", m.prop_mlp_for_level(i).grid, samples)
        for i, samples in enumerate(m.num_prop_samples)]


def phase_hash_encode(dev, cfg, render_inputs):
    """H1 vs plain on the card, each grid at the batch the main path gives
    it (a render chunk times that grid's samples): on uniform points, and
    on `render_inputs` ({grid: (table, x01, stds, spec)} of a render chunk
    of [5]). Returns the numbers of its kernels line: the NeRF grid's on the
    render's points, with every grid's beside."""
    import torch
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.ops import grid

    g = torch.Generator(device=dev).manual_seed(1)
    n = cfg.model.sample_n
    worst, grids = 0.0, {}
    for name, grid_cfg, samples in main_path_grids(cfg):
        b = cfg.render_chunk_size * samples
        spec = grid.spec_for(grid_cfg)
        table = torch.rand(spec.total_rows, spec.level_dim, device=dev,
                           generator=g) * 2 - 1
        x01 = torch.rand(b, n, 3, device=dev, generator=g) * 1.1 - 0.05
        stds = torch.rand(b, n, device=dev, generator=g) * 0.01 + 1e-5
        nums = {}
        for inputs, args in (("uniform", (table, x01, stds, spec)),
                             ("render", render_inputs[name])):
            got = grid.hash_encode_multisample(*args)
            want = grid.hash_encode_multisample_plain(*args)[0]
            torch.cuda.synchronize()
            err = close(f"hash_encode_ms {name} {inputs}", got, want, 1e-5,
                        1e-6)
            worst = max(worst, err)
            ms = cuda_ms(lambda: grid.hash_encode_multisample(*args),
                         iters=5, warmup=1)
            plain_ms = cuda_ms(lambda: grid.hash_encode_multisample_plain(
                *args), iters=5, warmup=1)
            # Bound: the points, the features and the distinct table rows
            # read; operations, one multiply-add per corner channel.
            lim = bound(*hb.fwd_bound(spec, args[1], args[2]))
            x = args[1]
            oob = float(((x < 0) | (x > 1)).any(-1).float().mean())
            print(f"[4] hash_encode_ms {name} on {inputs} points: "
                  f"{spec.num_levels} levels x C{spec.level_dim}, "
                  f"{spec.total_rows} rows, B={args[2].numel() // n} n={n} "
                  f"(out of range {oob:.3f}): max abs err {err:.3e}; kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms; bound "
                  f"{lim['bound_ms']:.4f} ms ({lim['bound_by']})")
            nums[inputs] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                **lim)
            del got, want
        grids[name] = nums
        del table, x01, stds
    return dict(grids["nerf"]["render"], max_abs_err=worst, library_ms=None,
                uniform_ms=grids["nerf"]["uniform"]["ms"],
                uniform_bound_ms=grids["nerf"]["uniform"]["bound_ms"],
                grids=grids)


def phase_slice(dev):
    """The port's render_lidar entry at full width, kernels on; then the
    same sweep kernels off. Returns the launch counts of the entry's run
    and the encode's inputs of one sweep's first chunk, per grid."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.lidar.render import render_sweep
    from nerf_lidar_tpu_torch.ops import grid, render_fused
    from nerf_lidar_tpu_torch.renderer import ChunkRenderer

    torch.cuda.reset_peak_memory_stats(dev)
    render_fused.fused_composite.launches = 0
    grid.hash_encode_multisample.launches = 0
    t0 = time.perf_counter()
    run = cli.main(SLICE_ARGV)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    launches = dict(composite=render_fused.fused_composite.launches,
                    hash_encode_ms=grid.hash_encode_multisample.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[5] render_lidar (2 sweeps, cold, weights init included): "
          f"{entry_s:.2f} s; launches {launches}; peak memory "
          f"{peak / 2**30:.2f} GiB")
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched on the main path")

    n_rays = 32 * 1100
    for i in range(2):
        pts = np.load(os.path.join(run.sweep_dir, f"points_{i:04d}.npy"))
        sem = np.load(os.path.join(run.sweep_dir,
                                   f"points_semantic_{i:04d}.npy"))
        rgb = np.load(os.path.join(run.sweep_dir, f"points_rgb_{i:04d}.npy"))
        if pts.shape != (n_rays, 3) or sem.shape != (n_rays, 19) \
                or rgb.shape != (n_rays, 3):
            fail(f"sweep {i}: shapes {pts.shape} {sem.shape} {rgb.shape}")
        for name, a in (("points", pts), ("semantic", sem), ("rgb", rgb)):
            if not np.isfinite(a).all():
                fail(f"sweep {i}: non-finite {name}")
        if np.abs(sem.sum(-1) - 1).max() > 1e-3:
            fail(f"sweep {i}: semantic rows do not sum to 1")
    if np.load(os.path.join(run.sweep_dir, "lidar2globals.npy")).shape \
            != (2, 4, 4):
        fail("lidar2globals.npy has the wrong shape")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sweep = run.sweeps[0]
    kern = ChunkRenderer(run.model, run.cfg, run.cfg.render_chunk_size)
    plain = ChunkRenderer(run.model, run.cfg, run.cfg.render_chunk_size,
                          use_kernels=False)

    def timed(renderer):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = render_sweep(renderer, sweep, run.near, run.far, run.frame)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def check_depth(out, what):
        lo, hi = run.near * (1 - 1e-4), run.far * (1 + 1e-4)
        if out["depth"].min() < lo or out["depth"].max() > hi:
            fail(f"{what}: depth outside [near, far]: {out['depth'].min()} "
                 f"{out['depth'].max()}")

    # The points and stds H1 gets from one render chunk, for [4].
    render_inputs = hb.record_render_inputs(kern, sweep, run.near, run.far,
                                            run.frame)

    # Timing, on the entry's own (fresh) weights.
    times = dict(kernels=[], plain=[])
    for _ in range(3):
        for name, renderer in (("kernels", kern), ("plain", plain)):
            out, sec = timed(renderer)
            times[name].append(sec)
            check_depth(out, f"fresh weights, {name}")
    med = {k: statistics.median(v) for k, v in times.items()}
    STATIC["s_per_sweep"] = med["kernels"]
    print(f"[5] warm s/sweep (35,200 rays, median of 3, TF32 off): "
          f"kernels {med['kernels']:.4f} (runs {times['kernels']}), "
          f"plain {med['plain']:.4f} (runs {times['plain']})")

    # Agreement. Fresh tables are uniform(+-1e-4), so the encode barely
    # moves the field; uniform(-1, 1) tables make a wrong row or level
    # order in H1 change density, colour and the resampled intervals.
    g = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():
        for mlp in (run.model.nerf_mlp, *run.model.prop_mlps):
            mlp.table.uniform_(-1.0, 1.0, generator=g)
    a, _ = timed(kern)
    b, _ = timed(plain)
    check_depth(a, "uniform(-1, 1) tables, kernels")
    errs, _, _, spread = compare_sweeps("slice", a, b)
    print(f"[5] kernels on vs off (uniform(-1, 1) tables), max abs diff "
          f"{errs}; std across rays of the kernels' render {spread}")
    return launches, render_inputs


def compare_sweeps(what, a, b, share=0.0, cap=100.0):
    """A sweep rendered kernels on (a) vs off (b): depth rtol 1e-3, rgb and
    semantic atol 1e-4 (the kernels change summation order only, and the
    resampling chain amplifies that), on all but `share` of each output's
    values, and none beyond `cap` times the tolerance (None: no cap).
    Returns ({key: max abs diff}, {key: values outside the tolerance},
    [rays] mask of the rays with a value outside, {key: std across rays of
    a})."""
    import torch
    errs, outside, rays, spread = {}, {}, None, {}
    for key, rtol, atol in (("depth", 1e-3, 0.0), ("rgb", 0.0, 1e-4),
                            ("semantic", 0.0, 1e-4)):
        if key not in b:  # a field without a semantic head
            continue
        got, want = torch.from_numpy(a[key]), torch.from_numpy(b[key])
        err = (got - want).abs()
        tol = atol + rtol * want.abs()
        out = err > tol
        n_out = int(out.sum())
        if not bool(torch.isfinite(got).all()) or n_out > share * \
                err.numel() or (cap is not None
                                and bool((err > cap * tol).any())):
            fail(f"{what} {key}: {n_out} of {err.numel()} values outside "
                 f"rtol {rtol} / atol {atol} (allowed: {share} of them, "
                 f"none beyond {cap} times; max abs err "
                 f"{float(err.max())})")
        out = out.reshape(out.shape[0], -1).any(-1)
        rays = out if rays is None else rays | out
        errs[key], outside[key] = float(err.max()), n_out
        spread[key] = float(got.std())
    return errs, outside, rays, spread


# Atomics sum each gradient row in an order that changes from run to run:
# relative to the largest value, 1e-4 leaves room for the coarse levels,
# where thousands of fp32 terms land on one row.
BWD_TOL = 1e-4
GRADS = ("d_table", "d_x01", "d_stds")


def phase_hash_encode_bwd(dev, cfg, train_inputs):
    """H1 backward vs its written-out plain twin, each grid at the train
    step's batch: on uniform points, and on `train_inputs` ({grid: (table,
    x01, stds, g_out, spec, needs)} of a train step of [8]); on prop0's
    uniform points (the smallest grid) also vs plain autograd through the
    plain encode, which takes seconds there (an accumulating index_put_ per
    corner and level). Returns the numbers of its kernels line: the NeRF
    grid's d_table on the train step's inputs, with every grid's beside,
    and "prop0_vs_autograd"."""
    import torch
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.ops import grid

    g = torch.Generator(device=dev).manual_seed(6)
    n = cfg.model.sample_n
    rays = cfg.batch_size + cfg.batch_size // cfg.lidar_batch_ratio
    grids, vs_autograd = {}, None
    for name, grid_cfg, samples in main_path_grids(cfg):
        b = rays * samples
        spec = grid.spec_for(grid_cfg)
        table = torch.rand(spec.total_rows, spec.level_dim, device=dev,
                           generator=g) * 2 - 1
        x01 = torch.rand(b, n, 3, device=dev, generator=g) * 1.1 - 0.05
        stds = torch.rand(b, n, device=dev, generator=g) * 0.01 + 1e-5
        g_out = torch.randn(b, spec.output_dim, device=dev, generator=g)
        inputs = name == "prop0"
        nums = {}
        for kind, (args, needs) in (
                ("uniform", ((table, x01, stds, g_out, spec),
                             (True, inputs, inputs))),
                ("train", (train_inputs[name][:5], train_inputs[name][5]))):
            got = grid.hash_encode_multisample_bwd(*args, needs=needs)
            twin_ms, want = cuda_ms_once(
                lambda: grid.hash_encode_multisample_bwd_plain(
                    *args, needs=needs))
            errs = {key: rel_err(f"hash_encode_ms_bwd {name} {kind} {key} "
                                 "vs twin", got[i], want[i], BWD_TOL)
                    for i, key in enumerate(GRADS) if needs[i]}
            ms = cuda_ms(lambda: grid.hash_encode_multisample_bwd(
                *args, needs=(True, False, False)), iters=3, warmup=1)
            # Bound: the points and g_out read, the whole d_table written;
            # operations, a multiply and an add per corner channel.
            lim = bound(*hb.bwd_bound(spec, *args[1:4]))
            print(f"[6] hash_encode_ms_bwd {name} on {kind} points: "
                  f"{spec.num_levels} levels x C{spec.level_dim}, "
                  f"B={args[2].numel() // n} n={n}: vs written-out twin (max "
                  f"abs err, relative to max) {errs}; kernel {ms:.3f} ms "
                  f"(d_table only), twin {twin_ms:.1f} ms"
                  f"{' (all three inputs)' if all(needs) else ''}; bound "
                  f"{lim['bound_ms']:.4f} ms ({lim['bound_by']})")
            nums[kind] = dict(max_abs_err=errs["d_table"][0], ms=ms,
                              plain_ms=twin_ms, **lim)
            if kind == "uniform" and inputs:
                vs_autograd = _bwd_vs_autograd(name, spec, args, got)
            del got, want
        grids[name] = nums
        del table, x01, stds, g_out
        torch.cuda.empty_cache()
    return dict(grids["nerf"]["train"], library_ms=None,
                uniform_ms=grids["nerf"]["uniform"]["ms"],
                uniform_bound_ms=grids["nerf"]["uniform"]["bound_ms"],
                grids=grids, prop0_vs_autograd=vs_autograd)


def _bwd_vs_autograd(name, spec, args, got):
    """H1-bwd's three gradients (`got`) vs plain autograd through the plain
    encode; prints and returns (max abs err, kernel ms, autograd ms)."""
    import torch
    from nerf_lidar_tpu_torch.ops import grid
    table, x01, stds, g_out = args[:4]
    ms_all = cuda_ms(lambda: grid.hash_encode_multisample_bwd(*args),
                     iters=3, warmup=1)
    leaves = [t.clone().requires_grad_(True) for t in (table, x01, stds)]
    out = grid.hash_encode_multisample_plain(*leaves, spec)[0]
    auto_ms, auto = cuda_ms_once(lambda: torch.autograd.grad(out, leaves,
                                                             g_out))
    errs = {key: rel_err(f"hash_encode_ms_bwd {name} {key} vs autograd",
                         got[i], auto[i], BWD_TOL)
            for i, key in enumerate(GRADS)}
    print(f"[6] hash_encode_ms_bwd {name} vs plain autograd {errs}; all "
          f"three inputs: kernel {ms_all:.3f} ms, autograd {auto_ms:.1f} ms")
    return dict(max_abs_err=max(e[0] for e in errs.values()), ms=ms_all,
                plain_ms=auto_ms)


# Relative to the largest sum. At K3's own shapes (~1,000 values a row),
# against index_add_. On the path a level of up to 2^21 values lands on
# one row: the kernel adds ~16,000 partial sums there in any order, so it
# is held against index_add_ in float64, to 1e-4; index_add_ in float32,
# the timed plain version, is itself ~1e-3 off there.
SCATTER_TOL = 1e-5
PATH_SCATTER_TOL = 1e-4


def phase_scatter(dev, cfg):
    """K3 vs index_add_, at the train path's shapes (the hash-decay level
    sums of each grid, table uniform(-1, 1)) and at K3's own; kernel, plain
    version and `index_add_` alone, beside the bound, at every shape.
    Returns the numbers of its kernels line for the NeRF grid's level sums
    (every grid's under "grids", every own shape's under "own_shapes"), and
    the same at K3's rows 2^17, N 2^22."""
    import torch
    from nerf_lidar_tpu_torch.ops import grid

    g = torch.Generator(device=dev).manual_seed(7)
    grids = {}
    for name, grid_cfg, _ in main_path_grids(cfg):
        spec = grid.spec_for(grid_cfg)
        table = torch.rand(spec.total_rows, spec.level_dim, device=dev,
                           generator=g) * 2 - 1
        ids = grid.level_ids(spec, dev)
        vals = table**2
        rows = spec.num_levels
        got = grid.scatter_add_rows(ids, vals, rows)
        want = grid.scatter_add_rows_plain(ids, vals.double(), rows)
        err, rel = rel_err(f"scatter_add_rows hash decay {name}",
                           got.double(), want, PATH_SCATTER_TOL)
        plain32 = float((grid.scatter_add_rows_plain(ids, vals, rows)
                         - want).abs().max() / want.abs().max())
        # Device time (torch.profiler): the proposal grids' kernels take
        # less time than the wrapper's host side, which CUDA events would
        # time instead.
        ms = device_ms(lambda: grid.scatter_add_rows(ids, vals, rows))
        plain_ms = device_ms(lambda: grid.scatter_add_rows_plain(
            ids, vals, rows), iters=5)
        ids64 = ids.long()
        library_ms = device_ms(lambda: vals.new_zeros(
            rows, spec.level_dim).index_add_(0, ids64, vals), iters=5)
        # Bound: idx and vals read, the sums written; one add a value.
        lim = bound(nbytes(ids, vals, got), vals.numel())
        grids[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, **lim)
        print(f"[7] scatter_add_rows hash decay {name}: N={spec.total_rows}"
              f" rows onto {rows} C={spec.level_dim}: max abs err "
              f"{err:.3e} ({rel:.2e} of max; index_add_ in float32 "
              f"{plain32:.2e}); device ms: kernel {ms:.4f}, plain "
              f"{plain_ms:.4f}, index_add_ alone {library_ms:.4f}; bound "
              f"{lim['bound_ms']:.4f} ms ({lim['bound_by']})")
        del table, vals, got, want, ids64

    c, own_shapes = 16, {}
    for rows in (4096, 1 << 17):
        for n in (1 << 20, 1 << 22):
            idx = torch.randint(0, rows, (n,), device=dev, generator=g,
                                dtype=torch.int32)
            idx64 = idx.long()
            vals = torch.randn(n, c, device=dev, generator=g)
            plain = lambda: vals.new_zeros(rows, c).index_add_(0, idx64,
                                                               vals)
            got = grid.scatter_add_rows(idx, vals, rows)
            err, rel = rel_err(f"scatter_add_rows rows={rows} N={n}", got,
                               plain(), SCATTER_TOL)
            ms = device_ms(lambda: grid.scatter_add_rows(idx, vals, rows))
            plain_ms = device_ms(plain, iters=5)
            lim = bound(nbytes(idx, vals, got), vals.numel())
            print(f"[7] scatter_add_rows rows={rows} N={n} C={c}: max abs "
                  f"err {err:.3e} ({rel:.2e} of max); device ms: kernel "
                  f"{ms:.4f}, index_add_ {plain_ms:.4f}; bound "
                  f"{lim['bound_ms']:.4f} ms ({lim['bound_by']})")
            own_shapes[f"rows={rows} N={n} C={c}"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=plain_ms, **lim)
    return (dict(grids["nerf"], grids=grids, own_shapes=own_shapes),
            own_shapes[f"rows={1 << 17} N={1 << 22} C={c}"])


def _table_grads_nonzero(model, what):
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    for name, mlp in hb.grid_names(model):
        grad = mlp.table.grad
        if grad is None or float(grad.abs().max()) == 0.0:
            fail(f"{what}: the {name} hash table got no gradient")


# Kernels on vs off, the first step from the same weights: every MLP
# parameter's gradient relative to its largest value (no atomic sums them;
# a zero, wrong-sign or misplaced gradient is off by 1 or more, summation
# order moves it by ~2e-4), and each step's loss (measured spread 1.5e-5
# over 3 steps).
GRAD_TOL = 1e-3
LOSS_TOL = 1e-4
ON_OFF_STEPS = 3
# A hash table's gradient is a sum of terms, each row's in an order that
# atomics change from run to run, and a row whose terms cancel can end far
# below its terms (prop0's table once differed by 3.6e-11 against a 2.2e-8
# maximum on an NVIDIA H100 80GB HBM3, 700 W, and failed 1e-3 of max). So
# each row is held to the magnitudes of its terms:
# |g_on - g_off| <= TABLE_GRAD_EPS_MULT * eps32 * terms + upstream, where
# terms sums |term| over both steps (the encode backward over |g_out|, plus
# the hash-decay gradient) and upstream is what the two steps' different
# encode inputs carry (the written-out backward on each side's inputs,
# differenced). Four float32 sums stand behind that difference (the two
# gradients, the two written-out backwards); the error of one grows like
# sqrt(N) eps times its terms for terms in random order (N ~ 15,000 on the
# coarsest rows of these grids), and 4096 leaves that room three times
# over. A zero, wrong-sign or misplaced row taken by few terms is off by
# ~1 / eps32 (8.4e6) of them.
EPS32 = 2.0**-23
TABLE_GRAD_EPS_MULT = 4096


def table_params(model):
    """{parameter name: grid name} of a model's hash tables (the object
    grids' too)."""
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    grids = {id(mlp.table): name for name, mlp in hb.grid_names(model)}
    return {pname: grids[id(p)] for pname, p in model.named_parameters()
            if id(p) in grids}


def decayed_grids(model, cfg):
    """[(grid name, MLP)] of the tables the hash-decay term holds: every
    grid, the object grids only without `obj_nodecay`."""
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    return [(name, mlp) for name, mlp in hb.grid_names(model)
            if not (name.startswith("obj") and cfg.obj_nodecay)]
# The hash-decay term is K3's output on the path. It is held against the
# same term from per-level slice sums in float64 (K3's level sums are
# within ~5e-6 of those, [7]); the plain side, index_add_ in float32, is
# itself ~1e-3 off, so it is reported, not held.
HASH_DECAY_TOL = 1e-4


def fresh_exp_dir(argv):
    """Remove the experiment directory an entry would resume from."""
    from nerf_lidar_tpu_torch import cli
    shutil.rmtree(cli.exp_dir(cli.build_config(cli.parse_args(argv))),
                  ignore_errors=True)


def hash_decay_f64(model, cfg):
    """The hash-decay loss term from per-level slice sums in float64."""
    import torch
    total = 0.0
    for _, mlp in decayed_grids(model, cfg):
        spec, table = mlp.spec, mlp.table.detach().double()
        sums = torch.stack([table[o:o + r].square().sum(0) / r for o, r in
                            zip(spec.offsets, spec.rows_per_level)])
        total += float(sums.mean())
    return cfg.hash_decay_mults * total


def table_grad_excess(got, want, terms, upstream):
    """The largest (|got - want| - upstream) / (eps32 * terms) over a hash
    table's entries: how many float32 eps of its terms' magnitudes a
    gradient (`got`) is off the other (`want`), beyond what `upstream`
    carries. inf where got is not finite or a row without terms differs."""
    import torch
    need = ((got - want).abs() - upstream).clamp(min=0)
    ratio = torch.where(need > 0, need / (EPS32 * terms), 0.0)
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float(ratio.max())


def table_grad_bounds(spec, table, on, off, decay):
    """(terms, upstream) of one hash table's gradient, kernels on vs off,
    for `table_grad_excess`. on / off: the (x01, stds, g_out[,
    coarse_res_cutoff]) of every encode call whose output took a gradient
    on each side (the object grids are encoded at every level); decay: the
    table's gradient from the hash-decay term, which both sides add.
    Through the written-out backward in float32, which picks the kernel's
    cells."""
    from nerf_lidar_tpu_torch.ops import grid

    def bwd(calls, absolute=False):
        return sum(grid.hash_encode_multisample_bwd_plain(
            table, x01, stds, g_out.abs() if absolute else g_out, spec,
            needs=(True, False, False),
            coarse_res_cutoff=rest[0] if rest else 0)[0]
            for x01, stds, g_out, *rest in calls)

    terms = bwd(on, True) + bwd(off, True) + 2 * decay.abs()
    upstream = (bwd(on) - bwd(off)).abs()
    return terms, upstream


def step_table_bounds(model, cfg, seen_on, seen_off, what):
    """{table parameter name: (terms, upstream)} of one train step, kernels
    on (seen_on: `recording_all` of the backward kernel) vs off (seen_off:
    `recording_plain_encode`), for `_grads_close`."""
    import torch
    dev = next(model.parameters()).device
    decayed = {name for name, _ in decayed_grids(model, cfg)}
    tables = {}
    for pname, gname in table_params(model).items():
        on = seen_on.get(gname, [])
        off = [rec for rec in seen_off.get(gname, []) if rec[2] is not None]
        if not on or not off:
            fail(f"{what}: the {gname} table's encode got no gradient on "
                 f"{'the kernels' if not on else 'the plain'} side")
        table, spec = on[0][0].to(dev), on[0][4]
        decay = (hash_decay_grad(table, spec, cfg.hash_decay_mults)
                 if gname in decayed else torch.zeros_like(table))
        tables[pname] = table_grad_bounds(
            spec, table,
            [[t.to(dev) for t in rec[1:4]] + [rec[6]] for rec in on],
            [[t.to(dev) for t in rec[:3]] + [rec[4]] for rec in off], decay)
    return tables



def hash_decay_grad(table, spec, mult):
    """The gradient of `losses.hash_decay_loss`'s term of one table: 2
    mult table / (L C rows of the row's level)."""
    import torch
    from nerf_lidar_tpu_torch.ops import grid
    rows = torch.tensor(spec.rows_per_level, dtype=table.dtype,
                        device=table.device)
    count = rows[grid.level_ids(spec, table.device).long()][:, None]
    return 2 * mult * table / (spec.num_levels * spec.level_dim * count)


def to_host(t):
    """A host copy of a tensor, anything else as it is."""
    import torch
    return t.detach().to("cpu", copy=True) if isinstance(
        t, torch.Tensor) else t


@contextlib.contextmanager
def recording_plain_encode(model):
    """Within the block, the plain encode records, per hash table of
    `model`, every call's [x01, stds, g_out, spec, coarse_res_cutoff] (g_out
    from a hook on its features, set once backward reaches them, None where
    no gradient does), tensors in host memory."""
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.ops import grid
    orig = grid.hash_encode_multisample_plain
    names = hb.grid_tables(model)
    calls = {}

    def wrapper(table, x01, stds, spec, coarse_res_cutoff=0):
        out = orig(table, x01, stds, spec, coarse_res_cutoff)
        name = names.get(table.data_ptr())
        if name is not None and out[0].requires_grad:
            rec = [to_host(x01), to_host(stds), None, spec,
                   coarse_res_cutoff]
            calls.setdefault(name, []).append(rec)
            out[0].register_hook(lambda g: rec.__setitem__(2, to_host(g)))
        return out

    grid.hash_encode_multisample_plain = wrapper
    try:
        yield calls
    finally:
        grid.hash_encode_multisample_plain = orig


@contextlib.contextmanager
def recording_all(module, name, model):
    """Within the block, module.<name> (the encode's backward wrapper)
    records every call per hash table of `model`: {grid name: [(table,
    x01, stds, g_out, spec, needs, coarse_res_cutoff), ...]}, tensors
    cloned (`calls_to_host` moves them off the card). The wrapper carries
    the function's launch count, and gives it back."""
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    orig = getattr(module, name)
    names = hb.grid_tables(model)
    calls = {}

    def wrapper(*args, **kw):
        grid_name = names.get(args[0].data_ptr())
        if grid_name is not None:
            needs = kw.get("needs", args[5] if len(args) > 5
                           else (True, True, True))
            cutoff = kw.get("coarse_res_cutoff",
                            args[6] if len(args) > 6 else 0)
            calls.setdefault(grid_name, []).append(tuple(
                a.detach().clone() if hasattr(a, "detach") else a
                for a in args[:5]) + (needs, cutoff))
        return orig(*args, **kw)

    wrapper.launches = orig.launches
    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        orig.launches = wrapper.launches
        setattr(module, name, orig)


def calls_to_host(calls):
    """`recording_all`'s calls with their tensors in host memory."""
    return {k: [tuple(to_host(t) for t in rec) for rec in v]
            for k, v in calls.items()}


def _grads_close(model, model_p, what, tables, grad_tol=None):
    """Kernels on (model) vs off (model_p) after one step. MLP parameters:
    max |grad - grad_p| / max |grad_p|, failing above `grad_tol` (default
    GRAD_TOL); hash tables
    (`tables`: {parameter name: (terms, upstream)}): `table_grad_excess`,
    failing above TABLE_GRAD_EPS_MULT. Fails on a non-finite gradient, or
    where one side has none. Returns (worst MLP ratio, its parameter,
    {grid: table excess in eps})."""
    import torch
    grad_tol = GRAD_TOL if grad_tol is None else grad_tol
    worst, where, excess = 0.0, None, {}
    for (name, p), q in zip(model.named_parameters(), model_p.parameters()):
        if (p.grad is None) != (q.grad is None):
            fail(f"{what}: {name} has a gradient on one side only")
        if p.grad is None:
            continue
        if name in tables:
            e = table_grad_excess(p.grad, q.grad, *tables[name])
            if not e <= TABLE_GRAD_EPS_MULT:
                fail(f"{what}: {name} gradient differs by {e} float32 eps "
                     f"of its terms beyond the upstream difference "
                     f"(tolerance {TABLE_GRAD_EPS_MULT})")
            excess[table_params(model)[name]] = e
            continue
        scale = float(q.grad.abs().max())
        err = float((p.grad - q.grad).abs().max())
        if not bool(torch.isfinite(p.grad).all()) or err > grad_tol * scale:
            fail(f"{what}: {name} gradient differs by {err} against max "
                 f"|grad| {scale} (tolerance {grad_tol} of it)")
        if scale > 0 and err / scale > worst:
            worst, where = err / scale, name
    if set(excess) != set(table_params(model).values()):
        fail(f"{what}: hash tables checked {sorted(excess)}")
    return worst, where, excess


def train_on_vs_off(dev, run, first_step, what, grad_tol=GRAD_TOL):
    """ON_OFF_STEPS train steps of the train entry's `run` kernels on, and
    of a copy of its model and optimizer state kernels off, from the same
    weights, batches and random draws: each step's loss (LOSS_TOL), the
    first step's gradients (`_grads_close`: MLP parameters to `grad_tol` of
    their largest value, hash tables by `table_grad_excess`) and its
    hash-decay term (K3 on the path) against float64 slice sums. Returns a
    printable summary line."""
    import torch
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.ops import grid
    from nerf_lidar_tpu_torch.train import train_step
    cfg = run.cfg
    model_p = copy.deepcopy(run.model)
    opt_p = train_step.make_optimizer(model_p, cfg)
    # A deep copy: load_state_dict keeps the very moment tensors it is
    # given, which both optimizers would then update.
    opt_p.load_state_dict(copy.deepcopy(run.optimizer.state_dict()))
    batches = [cli.to_device(run.batcher.next(), dev)
               for _ in range(ON_OFF_STEPS)]
    gens = [torch.Generator(device=dev).manual_seed(99) for _ in range(2)]
    decay_ref = hash_decay_f64(run.model, cfg)
    worst_loss = 0.0
    step_s = dict(on=[], off=[])
    rays = run.batcher.total_rays
    torch.cuda.reset_peak_memory_stats(dev)
    for i, batch in enumerate(batches):
        step = first_step + i
        # The first step records what each side's encode saw, for the
        # table gradients' bounds.
        with (recording_all(grid, "hash_encode_multisample_bwd", run.model)
              if i == 0 else contextlib.nullcontext({})) as seen_on:
            t0 = time.perf_counter()
            on = train_step.train_step(run.model, run.optimizer, cfg, batch,
                                       step, run.batcher.num_patch_rays,
                                       gens[0])
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        # Held in host memory, off the plain step's device memory peak.
        seen_on = calls_to_host(seen_on)
        with (recording_plain_encode(model_p) if i == 0
              else contextlib.nullcontext({})) as seen_off:
            off = train_step.train_step(model_p, opt_p, cfg, batch, step,
                                        run.batcher.num_patch_rays, gens[1],
                                        use_kernels=False)
            torch.cuda.synchronize()
        step_s["on"].append(t1 - t0)
        step_s["off"].append(time.perf_counter() - t1)
        a, b = float(on["loss"]), float(off["loss"])
        worst_loss = max(worst_loss, abs(a - b) / abs(b))
        if abs(a - b) > LOSS_TOL * abs(b):
            fail(f"{what} {step}: loss kernels {a} vs plain {b}")
        if i == 0:
            label = f"{what} {step}, kernels on vs off"
            grad_err = _grads_close(
                run.model, model_p, label,
                step_table_bounds(run.model, cfg, seen_on, seen_off, label),
                grad_tol)
            del seen_on, seen_off
            decay = [abs(float(stats["hash_decay"]) - decay_ref) / decay_ref
                     for stats in (on, off)]
            if not decay[0] <= HASH_DECAY_TOL:
                fail(f"{what} {step}: hash decay (K3 on the path) "
                     f"{float(on['hash_decay'])} vs {decay_ref} in float64")
    _table_grads_nonzero(model_p, f"{what}: kernels-off steps")
    med = {k: 1e3 * statistics.median(v) for k, v in step_s.items()}
    summary = (
        f"loss rel diff {worst_loss:.2e} (tol {LOSS_TOL}); first step's "
        f"gradients: MLPs, worst relative to max {grad_err[0]:.2e} "
        f"({grad_err[1]}; tol {grad_tol}); hash tables, float32 eps of the "
        f"terms beyond the upstream difference "
        f"{ {k: round(v, 2) for k, v in grad_err[2].items()} } (tol "
        f"{TABLE_GRAD_EPS_MULT}); hash decay vs float64 slice sums, "
        f"relative: K3 {decay[0]:.2e} (tol {HASH_DECAY_TOL}), index_add_ "
        f"{decay[1]:.2e}; ms/step (median of {ON_OFF_STEPS}, host clock, "
        f"synchronised) kernels {med['on']:.1f} "
        f"({rays / med['on'] * 1e3:,.0f} rays/s), plain {med['off']:.1f} "
        f"({rays / med['off'] * 1e3:,.0f} rays/s); peak memory of the two "
        f"models and the plain steps "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    del model_p, opt_p, batches
    torch.cuda.empty_cache()
    return summary


def phase_train(dev):
    """The port's train entry at full width, kernels on; then kernels on vs
    off for 3 steps; then the learning check. Each entry starts from a
    fresh experiment directory (it would resume from a checkpoint there).
    Returns (launch counts of the entry's run, path of the params it
    wrote, the encode backward's inputs of one more warm step per grid)."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.ops import grid

    fresh_exp_dir(TRAIN_ARGV)
    fresh_exp_dir(LEARN_ARGV)

    counters = dict(hash_encode_ms=grid.hash_encode_multisample,
                    hash_encode_ms_bwd=grid.hash_encode_multisample_bwd,
                    scatter_add_rows=grid.scatter_add_rows)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run = cli.main(TRAIN_ARGV)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched on the train path")
    hist = run.history
    if len(hist) != TRAIN_STEPS or not all(
            np.isfinite(h["loss"]) and np.isfinite(h["psnr"]) for h in hist):
        fail(f"train: {len(hist)} steps logged, or a loss is not finite")
    _table_grads_nonzero(run.model, "train entry")
    host_side = train_host_side(dev, run)
    step_ms = 1e3 * statistics.median(h["step_s"] for h in hist[-20:])
    rays = run.batcher.total_rays
    STATIC.update(ms_per_step=step_ms, peak_gib=peak / 2**30)
    print(f"[8] train (nuscenes_single, synthetic, {rays} rays/step, "
          f"{TRAIN_STEPS} steps, cold, init included): {entry_s:.2f} s; "
          f"launches {launches}; warm {step_ms:.1f} ms/step (median of the "
          f"last 20), {rays / step_ms * 1e3:,.0f} rays/s; peak memory "
          f"{peak / 2**30:.2f} GiB; loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f}")
    print(f"[8] prefetcher and asynchronous saves: {host_side}")

    # The points, stds and feature gradients the H1 backward gets in one
    # warm step, for [6].
    train_inputs = hb.record_train_inputs(run, TRAIN_STEPS)

    # Kernels on vs off: the same weights, optimizer state, batches and
    # random draws (tolerances above).
    on_off = train_on_vs_off(dev, run, TRAIN_STEPS + 1, "train step")
    print(f"[8] {ON_OFF_STEPS} steps kernels on vs off: {on_off}")
    del run
    torch.cuda.empty_cache()

    learn = cli.main(LEARN_ARGV)
    params = learn.params
    data = [h["data"] for h in learn.history]
    first, last = float(np.mean(data[:5])), float(np.mean(data[-5:]))
    if not (len(data) == 100 and last < first):
        fail(f"learning check: data loss {first} (first 5) -> {last} "
             f"(last 5) over {len(data)} steps")
    print(f"[8] learning check (100 steps, no warm-up): data loss "
          f"{first:.4f} (mean of first 5) -> {last:.4f} (mean of last 5); "
          f"psnr {learn.history[0]['psnr']:.2f} -> "
          f"{learn.history[-1]['psnr']:.2f}")
    del learn
    torch.cuda.empty_cache()
    return launches, params, train_inputs


INLINE_STEPS = 5


def _state_tensors(state):
    """{(name, ...): tensor} of a train state as checkpoint_<step>.pt holds
    it: the model's state dict and the optimizer's moments and steps."""
    out = {("model", k): v for k, v in state["model"].items()}
    for idx, moments in state["optimizer"]["state"].items():
        out.update({("optimizer", idx, k): v for k, v in moments.items()})
    return out


def train_host_side(dev, run):
    """[8] The train entry's host side, on its `run` (the state at its last
    step, saved asynchronously): its checkpoint_<step>.pt reloaded equals
    that state, tensor for tensor; its first INLINE_STEPS losses against
    the same steps fed inline (a fresh init, the JAX worker stream from
    `cli.step_batchers`, `to_device`, the same generator) at LOSS_TOL; the
    time `AsyncCheckpointer.save` holds the loop, the writer's time, and a
    synchronous `save_checkpoint` of the same state, with its bytes.
    Returns a printable summary."""
    import torch
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.models.model import Model
    from nerf_lidar_tpu_torch.train import checkpoints, train_step
    saved = torch.load(run.checkpoint, map_location=dev, weights_only=False)
    state = _state_tensors(dict(model=run.model.state_dict(),
                                optimizer=run.optimizer.state_dict()))
    got = _state_tensors(saved)
    if set(got) != set(state):
        fail(f"[8] {run.checkpoint}: other tensors than the state's")
    for name, want in state.items():
        if not torch.equal(got[name].to(want.device), want):
            fail(f"[8] {run.checkpoint}: {name} differs from the state at "
                 f"step {saved['step']}")
    del saved, got
    nbytes = sum(t.numel() * t.element_size() for t in state.values())

    cfg = run.cfg
    scene = cli.load_scene_for(cfg, "train")
    model = Model(cfg.model, device=dev)
    model.init_weights(torch.Generator().manual_seed(cfg.seed))
    opt = train_step.make_optimizer(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 17)
    workers = cli.step_batchers(cfg, scene, True)
    worst = 0.0
    for k in range(INLINE_STEPS):
        stats = train_step.train_step(
            model, opt, cfg, cli.to_device(workers[k % 2].next(), dev), k,
            run.batcher.num_patch_rays, gen)
        got, want = float(stats["loss"]), run.history[k]["loss"]
        worst = max(worst, abs(got - want) / abs(want))
        if abs(got - want) > LOSS_TOL * abs(want):
            fail(f"[8] step {k}: the entry's loss {want} vs {got} inline")
    del model, opt

    out = os.path.join(run.out, "saves")
    ck = checkpoints.AsyncCheckpointer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(out, run.model, run.optimizer, TRAIN_STEPS + 1)
    t1 = time.perf_counter()
    ck.wait()
    t2 = time.perf_counter()
    checkpoints.save_checkpoint(out, run.model, run.optimizer,
                                TRAIN_STEPS + 2)
    t3 = time.perf_counter()
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    return (f"checkpoint_{TRAIN_STEPS}.pt equal to the state at its step "
            f"({len(state)} tensors, {nbytes / 2**30:.3f} GiB); first "
            f"{INLINE_STEPS} losses vs inline steps: rel diff {worst:.2e} "
            f"(tol {LOSS_TOL}); AsyncCheckpointer.save holds the loop "
            f"{(t1 - t0) * 1e3:.2f} ms (host clock; its writer then "
            f"{(t2 - t1):.2f} s), synchronous save_checkpoint "
            f"{(t3 - t2):.2f} s")


# [8] profiled: the train entry with --trace_dir over TRACE_STEPS warm steps
# (no per-step print, so nothing but the step itself waits for the device),
# beside the earlier profile of the step fed inline (`hash_encode_bench.py
# --profile` on an NVIDIA H100 80GB HBM3 at 700 W, before the prefetcher).
TRACE_STEPS = 5
TRACE_ARGV = ["train", "--config", "nuscenes_single",
              "--set", "dataset_loader=synthetic", "--set", "print_every=100",
              "--steps", "16", "--trace_start", "10", "--trace_stop",
              str(10 + TRACE_STEPS - 1), "--trace_dir",
              os.path.join("exp", "chip_smoke_trace", "trace"),
              "--device", "cuda", "--exp_name", "chip_smoke_trace"]
INLINE_WALL_MS, INLINE_BUSY_MS = 118.9, 101.8


def trace_wall_busy(path, steps):
    """(wall ms/step, device busy ms/step, idle share) of a Chrome trace
    of `steps` steps: its span from the first to the last event, and the
    union of its device intervals (kernels, copies, sets)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, last = 0.0, None
    for a, b in spans:
        if last is None or a > last:
            busy += b - a
            last = b
        elif b > last:
            busy += b - last
            last = b
    wall = (end - start) / 1e3 / steps
    return wall, busy / 1e3 / steps, 1 - busy / 1e3 / steps / wall


def phase_train_trace(dev):
    """[8] profiled: `train --trace_dir` over TRACE_STEPS warm steps with
    the prefetcher (wall, busy, idle share from the trace), then where a
    warm step still waits for the device (`host_wait_sites`)."""
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    fresh_exp_dir(TRACE_ARGV)
    run = cli.main(TRACE_ARGV)
    trace_dir = TRACE_ARGV[TRACE_ARGV.index("--trace_dir") + 1]
    names = os.listdir(trace_dir)
    if len(names) != 1:
        fail(f"[8] profiled: {names} in {trace_dir}")
    wall, busy, idle = trace_wall_busy(os.path.join(trace_dir, names[0]),
                                       TRACE_STEPS)
    sites = hb.host_wait_sites(run, 16)
    print(f"[8] profiled: train --trace_dir over {TRACE_STEPS} warm steps "
          f"with the prefetcher: wall {wall:.1f} ms/step, device busy "
          f"{busy:.1f} ms/step, idle share {idle:.1%} (the step fed inline, "
          f"earlier: wall {INLINE_WALL_MS}, busy {INLINE_BUSY_MS}); host "
          f"waits for the device per warm step, by call site: {sites}")
    del run
    return dict(wall_ms=wall, busy_ms=busy, idle=idle, waits=sites)


# [17]: data parallel at full width, two ranks on the one card over gloo
# (NCCL refuses two ranks on one device), each a process of its own that
# runs the train entry for DP_STEPS steps and then a sweep; one rank in
# this process from the same argv as the reference.
DP_EXP = "chip_smoke_dp"
DP_STEPS = 3
DP_WORLD = 2
DP_TIMEOUT_S = 600
ADAM_STEP_BOUND = 1.01
DP_TRAIN_ARGV = ["train", "--config", "nuscenes_single",
                 "--set", "dataset_loader=synthetic", "--set",
                 "print_every=1", "--steps", str(DP_STEPS), "--device",
                 "cuda:0", "--exp_name", DP_EXP]
# With [12]'s scene and its car: the object budget counted over both ranks.
DP_OBJ_STEPS = 2
DP_OBJ_ARGV = ["train", "--config", "nuscenes_single",
               "--set", "dataset_loader=nusc", "--data_dir", OBJ_SCENE,
               "--set", "track_start_opt=0", "--set", "print_every=1",
               "--steps", str(DP_OBJ_STEPS), "--device", "cuda:0",
               "--exp_name", f"{DP_EXP}_objects"]
DP_RENDER_ARGV = ["render_lidar", "--config", "nuscenes_single",
                  "--set", "dataset_loader=synthetic", "--mode", "simu",
                  "--num_sweeps", "1", "--device", "cuda:0",
                  "--params", os.path.join("exp", DP_EXP,
                                           f"params_{DP_STEPS}.npz")]


def _dp_state(run):
    """{name: (parameter, its last step's summed gradient)} on the host."""
    return {k: (p.detach().cpu(), None if p.grad is None
                else p.grad.detach().cpu())
            for k, p in run.model.named_parameters()}


def dp_rank(rank, world, port):
    """One rank of [17] (`chip_smoke.py --dp_rank R --dp_world W
    --dp_port P`): joins a gloo group over CUDA tensors, runs the train
    entry and the sweep with the kernel counts at 0 before each, checks
    that every rank holds the same parameters, and writes its results
    (rank 0 also its parameters and gradients) under exp/DP_EXP/."""
    import torch
    import torch.distributed as dist
    os.chdir(HERE)
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.ops import _build
    _build.library()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        with counted_launches() as train_launches:
            run = cli.main(DP_TRAIN_ARGV)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        unequal = []
        for name, p in run.model.named_parameters():
            total = p.detach().clone()
            dist.all_reduce(total)
            if not torch.equal(total, world * p.detach()):
                unequal.append(name)
        with counted_launches() as render_launches:
            render = cli.main(DP_RENDER_ARGV + ["--exp_name",
                                                f"{DP_EXP}_sweep"])
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        with counted_launches() as obj_launches:
            obj = cli.main(DP_OBJ_ARGV)
            torch.cuda.synchronize()
        out = dict(history=run.history, train_launches=train_launches,
                   render_launches=render_launches, unequal=unequal,
                   train_s=t1 - t0, render_s=t2 - t1,
                   mesh=None if run.mesh is None else run.mesh.world,
                   sweep=render.paths[0], obj_history=obj.history,
                   obj_launches=obj_launches)
        if rank == 0:
            out["state"] = _dp_state(run)
        torch.save(out, os.path.join("exp", DP_EXP, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def nccl_world1(dev):
    """An NCCL group of world 1 on the card: `parallel/mesh.py`'s
    all_reduce, autograd all_gather, broadcast, barrier and flat-bucket
    gradient sum. Returns a printable summary."""
    import torch
    import torch.distributed as dist
    from nerf_lidar_tpu_torch import parallel
    from nerf_lidar_tpu_torch.parallel import mesh as meshlib
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = parallel.data_mesh(0, 1)
        g = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn(4096, 5, device=dev, generator=g, requires_grad=True)
        y = mesh.all_gather_rows(x)
        w = torch.randn(y.shape, device=dev, generator=g)
        (y * w).sum().backward()
        t = torch.arange(7.0, device=dev)
        mesh.all_reduce(t)
        mesh.broadcast(t)
        parallel.barrier()
        big = torch.nn.Parameter(torch.zeros(meshlib.BUCKET_BYTES // 4 + 1,
                                             device=dev))
        small = [torch.nn.Parameter(torch.zeros(3, device=dev))
                 for _ in range(3)]
        big.grad = torch.ones_like(big)
        small[0].grad = torch.full_like(small[0], 2.0)
        mesh.all_reduce_grads([big, *small])
        torch.cuda.synchronize()
        ok = (torch.equal(y, x) and torch.equal(x.grad, w)
              and torch.equal(t, torch.arange(7.0, device=dev))
              and bool((big.grad == 1).all())
              and bool((small[0].grad == 2).all())
              and all(p.grad is not None and not bool(p.grad.any())
                      for p in small[1:]))
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    if not ok:
        fail("[17] NCCL world 1: a collective of parallel/mesh.py changed "
             "its input")
    return (f"{backend} world 1: all_gather_rows + backward, all_reduce, "
            f"broadcast, barrier, all_reduce_grads (a {big.numel()}-float "
            "gradient alone, three in a bucket, two of them None) exact")


def _rounded(errs):
    return {k: float(f"{v:.2e}") for k, v in errs.items()}


def phase_data_parallel(dev):
    """[17] Two ranks of the train entry on one card over gloo, DP_STEPS
    steps of nuscenes_single at full width (20,480 rays a step, 10,240 a
    rank), against one rank in this process from the same argv (the same
    init, batches and generator): every logged loss term at LOSS_TOL,
    every parameter within what Adam can move an entry of a near-zero
    gradient the other way (twice the learning rates' sum), its last
    step's gradient to GRAD_TOL of its largest value, every rank's
    parameters equal; then one sweep over both ranks against the one-rank
    sweep of the same weights at [5]'s tolerances; then DP_OBJ_STEPS steps
    with [12]'s car against one rank (every logged term and stat at
    LOSS_TOL); then NCCL at world 1. Returns (launches per path and rank,
    a summary)."""
    import types
    import torch
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.train import train_step
    fresh_exp_dir(DP_TRAIN_ARGV)
    for name in ("sweep", "one", "objects", "objects_one"):
        shutil.rmtree(os.path.join("exp", f"{DP_EXP}_{name}"),
                      ignore_errors=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp_rank", str(r),
         "--dp_world", str(DP_WORLD), "--dp_port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(DP_WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"[17] rank {r} exited {p.returncode}:\n{log[-6000:]}")
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join("exp", DP_EXP, f"rank{r}.pt"),
                        weights_only=False) for r in range(DP_WORLD)]
    for r, res in enumerate(ranks):
        if res["mesh"] != DP_WORLD or res["unequal"]:
            fail(f"[17] rank {r}: mesh {res['mesh']}, parameters unlike "
                 f"the other rank's: {res['unequal'][:5]}")
        need_launches(f"[17] train, rank {r}", res["train_launches"],
                      ["hash_encode_ms", "hash_encode_ms_bwd",
                       "scatter_add_rows"])
        need_launches(f"[17] render_lidar, rank {r}",
                      res["render_launches"],
                      ["hash_encode_ms", "composite"])

    def stats_close(what, got, want, steps):
        """Every logged loss term and stat of each step at LOSS_TOL
        (relative); returns the worst per key."""
        if len(got) != steps or len(want) != steps:
            fail(f"[17] {what}: not every step was logged")
        worst = {}
        for step, (a, b) in enumerate(zip(got, want)):
            for k, w in b.items():
                if k in ("step", "step_s", "rays_per_sec"):
                    continue
                err = abs(a[k] - w) / max(abs(w), 1e-12)
                worst[k] = max(worst.get(k, 0.0), err)
                if err > LOSS_TOL:
                    fail(f"[17] {what}, step {step + 1} {k}: two ranks "
                         f"{a[k]} vs one {w}")
        return worst

    one_argv = DP_TRAIN_ARGV[:-1] + [f"{DP_EXP}_one"]
    one = cli.main(one_argv)
    worst = stats_close("train", ranks[0]["history"], one.history, DP_STEPS)
    # A parameter may differ by what Adam moves it in the steps: a
    # gradient entry within rounding of 0 takes either sign, and Adam moves
    # the entry by up to lr either way (|m_hat| <= sqrt(v_hat) to 1% in
    # these first steps); beyond that only the update's rounding.
    lr = train_step.lr_schedule(one.cfg)
    adam_tol = 2 * ADAM_STEP_BOUND * sum(lr(k) for k in range(DP_STEPS))
    p_err = g_err = 0.0
    params = dict(one.model.named_parameters())
    for name, (p, g) in ranks[0]["state"].items():
        q = params[name].detach().cpu()
        err = float((p - q).abs().max())
        tol = adam_tol + 1e-6 * float(q.abs().max())
        if not err <= tol:
            fail(f"[17] parameter {name}: two ranks vs one differ by {err} "
                 f"(tolerance {tol}: two Adam steps' worth, {adam_tol})")
        p_err = max(p_err, err / tol)
        want = params[name].grad.detach().cpu()
        if not bool(want.any()):
            if bool(g.any()):
                fail(f"[17] gradient of {name}: zero on one rank only")
            continue
        g_err = max(g_err, rel_err(f"[17] gradient of {name}", g, want,
                                   GRAD_TOL)[1])
    del params
    del one
    torch.cuda.empty_cache()
    sweep_one = cli.main(DP_RENDER_ARGV + ["--exp_name", f"{DP_EXP}_one"])
    two = types.SimpleNamespace(
        paths=[ranks[0]["sweep"]], frame=sweep_one.frame,
        sweeps=sweep_one.sweeps, sweep_dir=os.path.dirname(ranks[0]["sweep"]))
    errs = compare_sweeps("[17] two-rank sweep vs one-rank sweep",
                          sweep_files(two), sweep_files(sweep_one))[0]
    del sweep_one
    torch.cuda.empty_cache()
    obj_one = cli.main(DP_OBJ_ARGV[:-1] + [f"{DP_EXP}_objects_one"])
    obj_worst = stats_close("train with objects", ranks[0]["obj_history"],
                            obj_one.history, DP_OBJ_STEPS)
    if not obj_one.history[0]["obj_hit_frac"] > 0:
        fail("[17] train with objects: no sample in a box")
    del obj_one
    torch.cuda.empty_cache()
    nccl = nccl_world1(dev)
    launches = {}
    for r, res in enumerate(ranks):
        need_launches(f"[17] train with objects, rank {r}",
                      res["obj_launches"], ["hash_encode_ms",
                                            "hash_encode_ms_bwd",
                                            "scatter_add_rows"])
        launches[f"train_dp_rank{r}"] = res["train_launches"]
        launches[f"render_lidar_dp_rank{r}"] = res["render_launches"]
        launches[f"train_objects_dp_rank{r}"] = res["obj_launches"]
    summary = (
        f"two ranks (gloo on cuda:0) vs one, {DP_STEPS} steps of "
        f"nuscenes_single at full width: loss terms worst rel diff "
        f"{_rounded(worst)} (tol "
        f"{LOSS_TOL}); parameters at {p_err:.2f} of their tolerance (twice "
        f"the learning rates' sum, {adam_tol:.3e}, plus 1e-6 of the "
        f"largest value), last gradients {g_err:.2e} of their largest "
        f"value (tol {GRAD_TOL}); every "
        f"rank's parameters equal; the sweep over both ranks vs one rank's: "
        f"max abs diff {errs}; with [12]'s car ({DP_OBJ_STEPS} steps, the "
        f"object budget over both ranks, tracknet live) vs one rank, worst "
        f"rel diff {_rounded(obj_worst)}; {nccl}; launches per rank "
        f"{launches}; "
        f"rank seconds: train {[round(r['train_s'], 1) for r in ranks]}, "
        f"sweep {[round(r['render_s'], 2) for r in ranks]}; ranks' "
        f"processes {ranks_s:.1f} s (gloo moves every gradient through "
        f"host memory: a correctness run, not a speed)")
    return launches, summary


# The trained sweep, kernels on vs off: the share of each output's values
# that may lie outside [5]'s tolerances. On a trained field the proposal
# levels' resampling turns the encode's float rounding into shifts of the
# final sample intervals on a few rays, which move their rgb. Measured on
# an NVIDIA H100 80GB HBM3, 700 W: H1 within 2.4e-7 of its plain version on
# every call; intervals moved by up to 1.1e-3 on 14-28 rays, whose rgb
# moved by up to 4.2e-4 (22-43 of 105,600 values, under 0.05%); K1 on with
# H1 off moved nothing beyond 3.1e-7. So every K1 and H1 call of the sweep
# is held against its plain version on its own inputs, and the K1-only
# sweep to [5]'s tolerances on every value.
TRAINED_SWEEP_SHARE = 2e-3


@contextlib.contextmanager
def kernels_checked():
    """Within the block, every call of K1 (`render_fused.fused_composite`)
    and H1 (`grid.hash_encode_multisample`) is held against its plain
    version on its own inputs, at [3]'s and [4]'s tolerances, and the plain
    compositor records the sample intervals it gets. Yields {"k1_args": the
    first K1 call's arguments by name (tensors cloned), "k1" / "h1": each
    call's max abs error, "h1_modes": the largest H1 error per mode
    combination (`encode_mode`), "tdist_kernels" / "tdist_plain": each
    call's intervals}. The wrappers carry the kernels' launch counts and give them
    back."""
    import inspect
    import torch
    from nerf_lidar_tpu_torch.ops import grid, render_fused
    k1, k1_plain = render_fused.fused_composite, \
        render_fused.fused_composite_plain
    h1, h1_plain = grid.hash_encode_multisample, \
        grid.hash_encode_multisample_plain
    sig = inspect.signature(k1)
    rec = dict(k1_args={}, k1=[], h1=[], h1_modes={}, tdist_kernels=[],
               tdist_plain=[])

    def k1_checked(*a, **kw):
        args = sig.bind(*a, **kw)
        args.apply_defaults()
        args = args.arguments
        if not rec["k1_args"]:
            rec["k1_args"].update({k: v.detach().clone() if isinstance(
                v, torch.Tensor) else v for k, v in args.items()})
        rec["tdist_kernels"].append(args["tdist"].detach().clone())
        got, want = k1(*a, **kw), k1_plain(*a, **kw)
        rec["k1"].append(max(close(f"trained sweep K1 call {len(rec['k1'])}"
                                   f" {key}", got[key], want[key],
                                   *COMPOSITE_TOL[key]) for key in want))
        return got

    def k1_plain_recorded(*a, **kw):
        args = sig.bind(*a, **kw).arguments
        rec["tdist_plain"].append(args["tdist"].detach().clone())
        return k1_plain(*a, **kw)

    def h1_checked(table, x01, stds, spec, coarse_res_cutoff=0):
        got = h1(table, x01, stds, spec, coarse_res_cutoff)
        err = close(f"trained sweep H1 call {len(rec['h1'])}", got,
                    h1_plain(table, x01, stds, spec, coarse_res_cutoff)[0],
                    1e-5, 1e-6)
        rec["h1"].append(err)
        mode = encode_mode(spec, coarse_res_cutoff)
        rec["h1_modes"][mode] = max(rec["h1_modes"].get(mode, 0.0), err)
        return got

    k1_checked.launches, h1_checked.launches = k1.launches, h1.launches
    render_fused.fused_composite = k1_checked
    render_fused.fused_composite_plain = k1_plain_recorded
    grid.hash_encode_multisample = h1_checked
    try:
        yield rec
    finally:
        k1.launches, h1.launches = k1_checked.launches, h1_checked.launches
        render_fused.fused_composite = k1
        render_fused.fused_composite_plain = k1_plain
        grid.hash_encode_multisample = h1


def phase_train_to_render(dev, params):
    """render_lidar --params <the weights [8] trained>: one full sweep; then
    that sweep kernels on (every K1 and H1 call held against its plain
    version) vs off, on all but TRAINED_SWEEP_SHARE of the values at [5]'s
    tolerances, and K1 on with H1 off vs off on every value; then K1 vs its
    plain version on the inputs of the sweep's first chunk (recorded), which
    also go to exp/chip_smoke_train/k1_chunk.pt for
    `experiments/composite_gather_bench.py --chunk`. Returns the numbers of
    K1's kernels line on that chunk."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.lidar.render import render_sweep
    from nerf_lidar_tpu_torch.ops import grid, render_fused
    from nerf_lidar_tpu_torch.renderer import ChunkRenderer

    render_fused.fused_composite.launches = 0
    grid.hash_encode_multisample.launches = 0
    run = cli.main(["render_lidar", "--config", "nuscenes_single",
                    "--set", "dataset_loader=synthetic", "--mode", "simu",
                    "--num_sweeps", "1", "--params", params,
                    "--device", "cuda", "--exp_name", "chip_smoke_train"])
    launches = dict(composite=render_fused.fused_composite.launches,
                    hash_encode_ms=grid.hash_encode_multisample.launches)
    for name, count in launches.items():
        if count == 0:
            fail(f"render from trained params: {name} was not launched")
    pts = np.load(run.paths[0])
    origin = run.sweeps[0].origins
    depth = np.linalg.norm(pts - origin, axis=-1)
    if pts.shape != (32 * 1100, 3) or not np.isfinite(pts).all():
        fail(f"render from trained params: points {pts.shape}, or not "
             "finite")
    print(f"[9] render_lidar --params {params}: 1 sweep, {pts.shape[0]} "
          f"rays, launches {launches}; hit distance {depth.min():.3f} .. "
          f"{depth.max():.3f} (median {np.median(depth):.3f})")

    # The trained field's sweep, kernels on (every K1 and H1 call held
    # against its plain version) vs off.
    sweep = run.sweeps[0]
    kern = ChunkRenderer(run.model, run.cfg, run.cfg.render_chunk_size)
    plain = ChunkRenderer(run.model, run.cfg, run.cfg.render_chunk_size,
                          use_kernels=False)
    with kernels_checked() as rec:
        a = render_sweep(kern, sweep, run.near, run.far, run.frame)
        b = render_sweep(plain, sweep, run.near, run.far, run.frame)
    errs, outside, rays, spread = compare_sweeps(
        "trained sweep", a, b, share=TRAINED_SWEEP_SHARE)
    # K1 on, H1 off: the plain render with the kernel compositor, which
    # gets the plain render's very inputs, so [5]'s tolerances hold on every
    # value.
    plain_composite = render_fused.fused_composite_plain
    render_fused.fused_composite_plain = render_fused.fused_composite
    try:
        c = render_sweep(plain, sweep, run.near, run.far, run.frame)
    finally:
        render_fused.fused_composite_plain = plain_composite
    k1_errs = compare_sweeps("trained sweep, K1 on and H1 off", c, b)[0]
    n = rays.shape[0]
    moved = (torch.cat(rec["tdist_kernels"])[:n]
             - torch.cat(rec["tdist_plain"])[:n]).abs().amax(-1).cpu()
    print(f"[9] trained sweep: every call vs its plain version, max abs "
          f"err K1 {max(rec['k1']):.3e} ({len(rec['k1'])} calls), H1 "
          f"{max(rec['h1']):.3e} ({len(rec['h1'])} calls); kernels on vs "
          f"off, max abs diff {errs}, values outside [5]'s tolerances "
          f"{outside} (allowed {TRAINED_SWEEP_SHARE} of each); the final "
          f"sample intervals moved by up to "
          f"{float(moved[rays].max()) if bool(rays.any()) else 0.0:.3e} on "
          f"the {int(rays.sum())} rays outside, 99th percentile over all "
          f"rays {float(moved.quantile(0.99)):.3e}; K1 on and H1 off vs "
          f"off, max abs diff {k1_errs}; std across rays of the kernels' "
          f"render {spread}")

    # K1 alone on the first chunk: what the trained field hands it.
    chunk = rec["k1_args"]
    err = check_composite("trained chunk", chunk)
    ms = device_ms(lambda: render_fused.fused_composite(**chunk))
    lim = composite_bound(chunk)
    w = render_fused.fused_composite_plain(**chunk)["weights"]
    sigma = chunk["density"]
    print(f"[9] K1 on the trained sweep's first chunk (R, S, K = "
          f"{tuple(chunk['semantic'].shape)}): max abs err vs plain "
          f"{err:.3e}; device ms {ms:.5f} (bound {lim['bound_ms']:.5f}); "
          f"density max {float(sigma.max()):.4g}, median "
          f"{float(sigma.median()):.4g}; rays with weight > 0.99 on their "
          f"first sample {float((w[:, 0] > 0.99).float().mean()):.4f}, with "
          f"T = 0 before the last sample "
          f"{float((w[:, -1] == 0).float().mean()):.4f}")
    torch.save(chunk, os.path.join(cli.exp_dir(run.cfg), "k1_chunk.pt"))
    return dict(trained_chunk_ms=ms, trained_chunk_max_err=err,
                trained_chunk_bound_ms=lim["bound_ms"])


@contextlib.contextmanager
def obj_grid_launches(spec):
    """Within the block, counts the launches of H1, its backward and K3 on
    the object grids (hash grid `spec`; K3 at an object table's hash-decay
    shape): yields {"hash_encode_ms", "hash_encode_ms_bwd",
    "scatter_add_rows": count}. Installed last, its wrappers take the
    kernels' counts (as `hb.recording` does) and give them back."""
    from nerf_lidar_tpu_torch.ops import grid
    is_obj = dict(
        hash_encode_multisample=lambda a: a[3] == spec,
        hash_encode_multisample_bwd=lambda a: a[4] == spec,
        scatter_add_rows=lambda a: (
            tuple(a[1].shape) == (spec.total_rows, spec.level_dim)
            and a[2] == spec.num_levels))
    names = dict(hash_encode_multisample="hash_encode_ms",
                 hash_encode_multisample_bwd="hash_encode_ms_bwd",
                 scatter_add_rows="scatter_add_rows")
    counts = {v: 0 for v in names.values()}
    origs = {}

    def counting(name, orig):
        def wrapper(*a, **kw):
            before = wrapper.launches
            out = orig(*a, **kw)
            if is_obj[name](a):
                counts[names[name]] += wrapper.launches - before
            return out
        wrapper.launches = orig.launches
        return wrapper

    for name in names:
        origs[name] = getattr(grid, name)
        setattr(grid, name, counting(name, origs[name]))
    try:
        yield counts
    finally:
        for name, orig in origs.items():
            orig.launches = getattr(grid, name).launches
            setattr(grid, name, orig)


@contextlib.contextmanager
def box_hits():
    """Within the block, records which rays have a sample in a box at each
    composite_objects call ([R] bool per call, host memory)."""
    from nerf_lidar_tpu_torch.models import objects as objlib
    orig = objlib.composite_objects
    calls = []

    def wrapper(*a, **kw):
        out = orig(*a, **kw)
        calls.append(out["obj_mask"].flatten(1).any(-1).cpu())
        return out

    objlib.composite_objects = wrapper
    try:
        yield calls
    finally:
        objlib.composite_objects = orig


def rays_in_a_box(calls, levels, n):
    """[n] bool: rays with a sample in a box at any level, from `box_hits`'s
    calls (chunk by chunk, `levels` calls a chunk)."""
    import torch
    per_chunk = torch.stack(calls).reshape(-1, levels, calls[0].shape[0])
    return per_chunk.any(1).reshape(-1)[:n].numpy()


def sweep_files(run):
    """{depth, rgb, semantic} of a render_lidar run's first sweep, read back
    from its files; depth is the distance from each ray's origin to its
    point, in the world frame."""
    import numpy as np
    pts = np.load(run.paths[0])
    sem = np.load(run.paths[0].replace("points_", "points_semantic_"))
    rgb = np.load(run.paths[0].replace("points_", "points_rgb_"))
    origin = run.frame.scene_to_world_points(run.sweeps[0].origins)
    n = run.sweeps[0].num_rays
    if pts.shape != (n, 3) or rgb.shape != (n, 3) or sem.shape[0] != n:
        fail(f"render_lidar {run.sweep_dir}: shapes {pts.shape} "
             f"{sem.shape} {rgb.shape} for {n} rays")
    for name, a in (("points", pts), ("semantic", sem), ("rgb", rgb)):
        if not np.isfinite(a).all():
            fail(f"render_lidar {run.sweep_dir}: non-finite {name}")
    return dict(depth=np.linalg.norm(pts - origin, axis=-1), rgb=rgb,
                semantic=sem)


def phase_objects(dev):
    """[12] The recipe with dynamic objects: a synth_nusc scene (one moving
    car and its track), the port's train entry for OBJ_STEPS steps with the
    tracknet live from the first, 2 steps kernels on vs off, H1 / H1-bwd /
    K3 on the object grid against their plain versions, and the trained
    params rendered by render_lidar with the car (--obj_mode replay) and
    without it (removal). Returns {"train_objects": launches,
    "render_lidar_objects": launches, "obj_grid": {kernel: numbers}}."""
    import dataclasses
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.data import synth_nusc
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.lidar.render import render_sweep
    from nerf_lidar_tpu_torch.ops import grid, render_fused
    from nerf_lidar_tpu_torch.train import train_step

    fresh_exp_dir(OBJ_TRAIN_ARGV)
    t0 = time.perf_counter()
    synth_nusc.write_scene_dir(OBJ_SCENE, sensor_num=1)
    print(f"[12] synth_nusc scene written in {time.perf_counter() - t0:.1f} "
          f"s: {OBJ_SCENE}")
    spec = grid.spec_for(
        cli.build_config(cli.parse_args(OBJ_TRAIN_ARGV)).model.obj_mlp.grid)

    # The train entry, kernels on.
    counters = dict(hash_encode_ms=grid.hash_encode_multisample,
                    hash_encode_ms_bwd=grid.hash_encode_multisample_bwd,
                    scatter_add_rows=grid.scatter_add_rows)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with obj_grid_launches(spec) as obj_launches:
        run = cli.main(OBJ_TRAIN_ARGV)
        torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched on the objects train path")
    for name in ("hash_encode_ms", "hash_encode_ms_bwd"):
        if obj_launches[name] == 0:
            fail(f"kernel {name} was not launched on the object grid")
    cfg, hist = run.cfg, run.history
    if run.tracknet is None or cfg.model.num_objects < 1:
        fail(f"objects train: {cfg.model.num_objects} object slots, "
             f"tracknet {run.tracknet}")
    if len(hist) != OBJ_STEPS or not all(
            np.isfinite(h["loss"]) and np.isfinite(h["psnr"]) for h in hist):
        fail(f"objects train: {len(hist)} steps logged, or a loss is not "
             "finite")
    hit = [h["obj_hit_frac"] for h in hist]
    overflow = [h["obj_overflow"] for h in hist]
    if not max(hit) > 0 or any(o != 0 for o in overflow):
        fail(f"objects train: obj_hit_frac {hit}, obj_overflow {overflow}")
    _table_grads_nonzero(run.model, "objects train entry")
    for name, p in (("obj_latents", run.model.obj_latents),
                    ("tracknet opt_t", run.tracknet.opt_t)):
        if p.grad is None or float(p.grad.abs().max()) == 0.0:
            fail(f"objects train entry: {name} got no gradient")
    step_ms = 1e3 * statistics.median(h["step_s"] for h in hist[-10:])
    rays = run.batcher.total_rays
    print(f"[12] train with objects (nuscenes_single, synth_nusc, "
          f"{cfg.model.num_objects} object slot(s), sem ids "
          f"{cfg.model.obj_sem_ids}, {rays} rays/step, {OBJ_STEPS} steps, "
          f"cold, init included): {entry_s:.2f} s; launches {launches}, on "
          f"the object grid {obj_launches}; warm {step_ms:.1f} ms/step "
          f"(median of the last 10; static [8] "
          f"{STATIC.get('ms_per_step', float('nan')):.1f}), "
          f"{rays / step_ms * 1e3:,.0f} rays/s; peak memory "
          f"{peak / 2**30:.2f} GiB (static [8] "
          f"{STATIC.get('peak_gib', float('nan')):.2f}); obj_hit_frac "
          f"{min(hit):.4f} .. {max(hit):.4f}, obj_overflow {max(overflow)}; "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")

    # Kernels on vs off, 2 steps from the same weights, optimizer state,
    # batches and random draws, under [8]'s rules. Without obj_nodecay
    # here (the recipe keeps it on), so that K3 sums the object table's
    # hash decay inside a step too.
    cfg = dataclasses.replace(cfg, obj_nodecay=False)
    model_p = copy.deepcopy(run.model)
    tracknet_p = copy.deepcopy(run.tracknet)
    posenet_p = copy.deepcopy(run.posenet)
    opt_p = train_step.make_optimizer(model_p, cfg, posenet_p, tracknet_p)
    # A deep copy: load_state_dict keeps the very moment tensors it is
    # given, which both optimizers would then update.
    opt_p.load_state_dict(copy.deepcopy(run.optimizer.state_dict()))
    batches = [cli.to_device(run.batcher.next(), dev) for _ in range(2)]
    gens = [torch.Generator(device=dev).manual_seed(98) for _ in range(2)]
    decay_ref = hash_decay_f64(run.model, cfg)
    refine = dict(tracks=run.tracks, track_mask=run.track_mask)
    worst_loss, step_obj = 0.0, {}
    for i, batch in enumerate(batches):
        step = OBJ_STEPS + i
        with (recording_all(grid, "hash_encode_multisample_bwd", run.model)
              if i == 0 else contextlib.nullcontext({})) as seen_on, \
                obj_grid_launches(spec) as counts:
            on = train_step.train_step(
                run.model, run.optimizer, cfg, batch, step,
                run.batcher.num_patch_rays, gens[0], posenet=run.posenet,
                tracknet=run.tracknet, **refine)
            torch.cuda.synchronize()
        seen_on = calls_to_host(seen_on)
        step_obj = {k: step_obj.get(k, 0) + v for k, v in counts.items()}
        with (recording_plain_encode(model_p) if i == 0
              else contextlib.nullcontext({})) as seen_off:
            off = train_step.train_step(
                model_p, opt_p, cfg, batch, step, run.batcher.num_patch_rays,
                gens[1], use_kernels=False, posenet=posenet_p,
                tracknet=tracknet_p, **refine)
            torch.cuda.synchronize()
        a, b = float(on["loss"]), float(off["loss"])
        worst_loss = max(worst_loss, abs(a - b) / abs(b))
        if abs(a - b) > LOSS_TOL * abs(b):
            fail(f"objects train step {step}: loss kernels {a} vs plain {b}")
        if i > 0:
            continue
        what = f"objects train step {step}, kernels on vs off"
        grad_err = _grads_close(run.model, model_p, what, step_table_bounds(
            run.model, cfg, seen_on, seen_off, what))
        refiner_err = {}
        for (name, p), q in zip(run.tracknet.named_parameters(),
                                tracknet_p.parameters()):
            scale = float(q.grad.abs().max())
            err = float((p.grad - q.grad).abs().max())
            if scale == 0 or err > GRAD_TOL * scale:
                fail(f"{what}: tracknet {name} gradient differs by {err} "
                     f"against max |grad| {scale} (tolerance {GRAD_TOL})")
            refiner_err[name] = err / scale
        decay = abs(float(on["hash_decay"]) - decay_ref) / decay_ref
        if not decay <= HASH_DECAY_TOL:
            fail(f"{what}: hash decay (K3, object table included) "
                 f"{float(on['hash_decay'])} vs {decay_ref} in float64")
        # The object grid's backward call, for H1 / H1-bwd below.
        bwd_rec = seen_on[next(k for k in seen_on if k.startswith("obj"))][0]
        del seen_on, seen_off
    if step_obj["scatter_add_rows"] == 0:
        fail("objects train steps without obj_nodecay: K3 was not launched "
             "on the object table")
    print(f"[12] 2 steps kernels on vs off (obj_nodecay off): loss rel diff "
          f"{worst_loss:.2e} (tol {LOSS_TOL}); first step's gradients: MLPs "
          f"and obj_latents, worst relative to max {grad_err[0]:.2e} "
          f"({grad_err[1]}; tol {GRAD_TOL}); tracknet {refiner_err}; hash "
          f"tables, float32 eps of the terms beyond the upstream difference "
          f"{ {k: round(v, 2) for k, v in grad_err[2].items()} } (tol "
          f"{TABLE_GRAD_EPS_MULT}); hash decay vs float64 {decay:.2e}; "
          f"launches on the object grid in the 2 kernel steps {step_obj}")
    params = run.params
    del model_p, opt_p, tracknet_p, posenet_p, batches
    torch.cuda.empty_cache()

    # render_lidar from the trained params, with the car and without.
    renders = {}
    for mode in ("replay", "removal"):
        render_fused.fused_composite.launches = 0
        grid.hash_encode_multisample.launches = 0
        with kernels_checked() as rec, box_hits() as hits, \
                obj_grid_launches(spec) as obj_counts:
            rr = cli.main([*OBJ_RENDER_ARGV, "--obj_mode", mode,
                           "--params", params])
        counts = dict(composite=render_fused.fused_composite.launches,
                      hash_encode_ms=grid.hash_encode_multisample.launches)
        for name, count in counts.items():
            if count == 0:
                fail(f"render_lidar --obj_mode {mode}: {name} was not "
                     "launched")
        renders[mode] = dict(run=rr, files=sweep_files(rr), launches=counts,
                             obj=obj_counts["hash_encode_ms"], hits=hits,
                             k1=max(rec["k1"]), h1=max(rec["h1"]),
                             calls=(len(rec["k1"]), len(rec["h1"])))
    rep, rem = renders["replay"], renders["removal"]
    if rep["obj"] == 0 or rem["obj"] != 0 or rem["hits"]:
        fail(f"render_lidar: object-grid encodes replay {rep['obj']}, "
             f"removal {rem['obj']}")
    n = rep["run"].sweeps[0].num_rays
    levels = rep["run"].cfg.model.num_levels
    in_box = rays_in_a_box(rep["hits"], levels, n)
    if not in_box.any():
        fail("render_lidar --obj_mode replay: no ray has a sample in a box")
    free = ~in_box
    errs = compare_sweeps(
        "objects replay vs removal, rays in no box",
        {k: v[free] for k, v in rep["files"].items()},
        {k: v[free] for k, v in rem["files"].items()})[0]
    moved = {k: float(np.abs(rep["files"][k][in_box]
                             - rem["files"][k][in_box]).max())
             for k in ("depth", "rgb", "semantic")}
    car = rep["files"]["semantic"][in_box].argmax(-1)
    # Warm s/sweep, with the car and without, kernels on.
    times = {}
    for mode, r in renders.items():
        rr = r["run"]
        sec = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            render_sweep(rr.renderer, rr.sweeps[0], rr.near, rr.far,
                         rr.frame, rr.tracks, rr.track_mask)
            torch.cuda.synchronize()
            sec.append(time.perf_counter() - t)
        times[mode] = (statistics.median(sec), sec)
    print(f"[12] render_lidar --mode replay from {params}: {n} rays; "
          f"launches replay {rep['launches']} (object grid "
          f"{rep['obj']}), removal {rem['launches']}; every K1 / H1 call vs "
          f"its plain version, max abs err replay {rep['k1']:.3e} / "
          f"{rep['h1']:.3e} ({rep['calls']} calls), removal "
          f"{rem['k1']:.3e} / {rem['h1']:.3e}; {int(in_box.sum())} rays "
          f"with a sample in a box (class ids there "
          f"{np.bincount(car).nonzero()[0].tolist()}), replay vs removal on "
          f"the {int(free.sum())} others: max abs diff {errs}, on the rays "
          f"in a box {moved}; warm s/sweep (median of 3) replay "
          f"{times['replay'][0]:.4f} {times['replay'][1]}, removal "
          f"{times['removal'][0]:.4f} {times['removal'][1]} (static [5] "
          f"{STATIC.get('s_per_sweep', float('nan')):.4f})")
    paths = dict(train_objects=launches, render_lidar_objects=rep["launches"])
    on_obj_grid = dict(train_objects=obj_launches,
                       render_lidar_objects=dict(hash_encode_ms=rep["obj"]))
    del renders, rep, rem

    def profiled():
        """What [12] times with torch.profiler, run after every timed phase
        ([13] included: a profiler session slows later host work): where a
        step with objects spends its time, and the kernels on the object
        grid alone (device time). Returns {kernel: numbers}."""
        nonlocal run
        prof = hb.profile_train(run, OBJ_STEPS + 2)
        print(f"[12] profile of 2 warm train steps with objects: "
              f"{json.dumps(prof)}")
        del run
        torch.cuda.empty_cache()
        obj_grid = dict(
            hash_encode_ms=obj_encode(dev, bwd_rec, fwd=True),
            hash_encode_ms_bwd=obj_encode(dev, bwd_rec, fwd=False),
            scatter_add_rows=obj_scatter(dev, spec))
        for name, nums in obj_grid.items():
            nums["launches_by_path"] = {p: c.get(name, 0)
                                        for p, c in on_obj_grid.items()}
        return obj_grid

    return dict(paths=paths, profiled=profiled, det_rec=bwd_rec)


def _rd_host_step(trainer, state, batch, shift, noise, dtype):
    """One ray-drop train step of a copy of `state` on the CPU in `dtype`,
    with the card trainer's loss networks: (stats, the copy's model)."""
    import torch
    from nerf_lidar_tpu_torch.raydrop.trainer import RayDropTrainer
    cpu = RayDropTrainer(trainer.cfg, device="cpu")
    cpu.vgg_model = copy.deepcopy(trainer.vgg_model).cpu().to(dtype)
    if trainer.dk_model is not None:
        cpu.dk_model = copy.deepcopy(trainer.dk_model).cpu().to(dtype)
    st = cpu.make_state(copy.deepcopy(state.model).cpu().to(dtype))
    stats = cpu.train_step(st, *(t.cpu().to(dtype) if t.is_floating_point()
                                 else t.cpu() for t in batch),
                           shift=shift, noise=noise.cpu().to(dtype))
    return stats, st.model, cpu


def _rd_step_vs_cpu(trainer, state, batch, shift, noise, dtype):
    """One train step from `state`'s weights on the card and on the CPU in
    `dtype` (same batch, roll shift and Gumbel noise; fresh Adam each):
    (loss rel diff, worst gradient error relative to its tensor's max and
    that tensor, worst BatchNorm buffer error relative to the buffer)."""
    import torch
    from nerf_lidar_tpu_torch.raydrop.trainer import RayDropTrainer
    card = RayDropTrainer(trainer.cfg, device=state.model.outc.weight.device)
    card.vgg_model = copy.deepcopy(trainer.vgg_model).to(dtype)
    card.dk_model = (None if trainer.dk_model is None
                     else copy.deepcopy(trainer.dk_model).to(dtype))
    st = card.make_state(copy.deepcopy(state.model).to(dtype))
    on = card.train_step(st, *(t.to(dtype) if t.is_floating_point() else t
                               for t in batch), shift=shift,
                         noise=noise.to(dtype))
    off, model_cpu, _ = _rd_host_step(trainer, state, batch, shift, noise,
                                      dtype)
    loss = abs(float(on["loss"]) - float(off["loss"])) / abs(
        float(off["loss"]))
    grad, grad_at = 0.0, ""
    for (name, p), q in zip(st.model.named_parameters(),
                            model_cpu.parameters()):
        scale = float(q.grad.abs().max())
        err = float((p.grad.cpu() - q.grad).abs().max()) / max(scale, 1e-30)
        if err > grad:
            grad, grad_at = err, name
    bn = 0.0
    for (name, a), b in zip(st.model.named_buffers(), model_cpu.buffers()):
        if name.endswith("num_batches_tracked"):
            continue
        err = (a.cpu() - b).abs() / b.abs().clamp(min=1e-3 * float(
            b.abs().max()))
        bn = max(bn, float(err.max()))
    del st, model_cpu, card
    return loss, grad, grad_at, bn


def phase_raydrop(dev):
    """[13] The ray-drop stage through the port's CLI: a synth_nusc scene
    with dense LiDAR, a field trained on it for RD_FIELD_STEPS steps and
    RD_SWEEPS replay sweeps rendered (the earlier slices' entries), then,
    with every kernel count at 0, raydrop_features, raydrop_train (VGG, 32 x
    1024, batch 4, RD_EPOCHS epochs: one eval), a short raydrop_train
    --darknet, raydrop_drop --place_car --features and raydrop_val_vis;
    checks their outputs and the card against the CPU from one set of
    weights; times a train step, a predict, and features / drop per sweep.
    Returns the kernel counts of the ray-drop path (none launches)."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.data import synth_nusc
    from nerf_lidar_tpu_torch.lidar import export
    from nerf_lidar_tpu_torch.ops import grid, render_fused
    from nerf_lidar_tpu_torch.raydrop import features as feat_lib
    from nerf_lidar_tpu_torch.raydrop import infer

    shutil.rmtree(os.path.join("exp", RD_EXP), ignore_errors=True)
    for sub in ("unet", "darknet"):
        shutil.rmtree(os.path.join("exp", f"{RD_EXP}_{sub}"),
                      ignore_errors=True)
    t0 = time.perf_counter()
    synth_nusc.write_scene_dir(RD_SCENE, num_frames=RD_SWEEPS, sensor_num=1,
                               lidar_points_per_beam=1100)
    field = cli.main(["train", *RD_FIELD_ARGV, "--steps",
                      str(RD_FIELD_STEPS), "--set", "print_every=20"])
    render = cli.main(["render_lidar", *RD_FIELD_ARGV, *RD_RENDER_ARGS,
                       "--params", field.params])
    torch.cuda.synchronize()
    sim_dir = render.sweep_dir
    print(f"[13] dense synth_nusc scene ({RD_SWEEPS} frames, 1,100 returns "
          f"per beam), field trained {RD_FIELD_STEPS} steps (loss "
          f"{field.history[0]['loss']:.4f} -> "
          f"{field.history[-1]['loss']:.4f}), {len(render.paths)} replay "
          f"sweeps of {render.sweeps[0].num_rays} rays: "
          f"{time.perf_counter() - t0:.1f} s")
    del field, render
    torch.cuda.empty_cache()

    counters = dict(composite=render_fused.fused_composite,
                    hash_encode_ms=grid.hash_encode_multisample,
                    hash_encode_ms_bwd=grid.hash_encode_multisample_bwd,
                    scatter_add_rows=grid.scatter_add_rows)
    for fn in counters.values():
        fn.launches = 0
    feats_path = os.path.join("exp", RD_EXP, "features.npy")
    t0 = time.perf_counter()
    data = cli.main(["raydrop_features", "--pair", f"{RD_SCENE}:{sim_dir}",
                     "--out", feats_path])
    feat_s = (time.perf_counter() - t0) / RD_SWEEPS
    n = data["images"].shape[0]
    if data["images"].shape != (RD_SWEEPS, 32, 1024, 6) or \
            data["masks"].shape != (n, 32, 1024) or \
            not np.isfinite(data["images"]).all():
        fail(f"raydrop_features: images {data['images'].shape}, masks "
             f"{data['masks'].shape}")
    keep_rate = float(data["masks"].mean())
    if not 0.05 < keep_rate < 1.0:
        fail(f"raydrop_features: ground-truth keep rate {keep_rate}")

    # Peak memory above what earlier phases still hold.
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    rd = cli.main(["raydrop_train", "--features", feats_path, "--exp_name",
                   f"{RD_EXP}_unet", "--epochs", str(RD_EPOCHS),
                   "--batch_size", "4", *RD_DEVICE])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak_vgg = torch.cuda.max_memory_allocated(dev) - held
    hist = rd.history
    if not all(np.isfinite(h["loss"]) for h in hist) or \
            not hist[-1]["ce"] < hist[0]["ce"] or "val_ce" not in hist[-1] \
            or "vgg" not in hist[0]:
        fail(f"raydrop_train: CE {[round(h['ce'], 4) for h in hist]}, "
             f"val_ce in the last epoch: {'val_ce' in hist[-1]}")
    ckpt = os.path.join(rd.out, f"raydrop_{rd.state.step:05d}.pt")
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    dk = cli.main(["raydrop_train", "--features", feats_path, "--exp_name",
                   f"{RD_EXP}_darknet", "--epochs", "1", "--batch_size", "4",
                   "--darknet", *RD_DEVICE])
    torch.cuda.synchronize()
    peak_dk = torch.cuda.max_memory_allocated(dev) - held
    if not all(np.isfinite(h["darknet"]) and h["darknet"] > 0
               for h in dk.history):
        fail(f"raydrop_train --darknet: {dk.history}")

    kitti = os.path.join("exp", RD_EXP, "kitti")
    t0 = time.perf_counter()
    drop = cli.main(["raydrop_drop", "--ckpt", ckpt, "--simulation_path",
                     sim_dir, "--out", kitti, "--place_car", "--features",
                     feats_path, *RD_DEVICE])
    drop_cli_s = (time.perf_counter() - t0) / RD_SWEEPS
    vis = cli.main(["raydrop_val_vis", "--features", feats_path, "--ckpt",
                    ckpt, "--out", os.path.join("exp", RD_EXP, "val_vis"),
                    *RD_DEVICE])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    if any(launches.values()):
        fail(f"the ray-drop path launched a kernel of the table: {launches}")

    # The export, read back: sweep 0 against drop_sweep on the same input.
    sweeps, l2g = feat_lib.load_sim_sweep_dir(sim_dir)
    sweeps = [(feat_lib.world_points_to_sensor(p, l2g[i]), s_, r)
              for i, (p, s_, r) in enumerate(sweeps)]
    trainer, state = drop.trainer, drop.state
    ref = infer.drop_sweep(trainer, state, *sweeps[0], car_median_rule=True)
    b = export.read_bin(os.path.join(kitti, "velodyne", "000000.bin"))
    lab = export.read_label(os.path.join(kitti, "labels", "000000.label"))
    if not len(b) == len(lab) == len(ref["points"]) > 0 or \
            not np.array_equal(b[:, :3], ref["points"]) or \
            not np.array_equal(lab, ref["labels"].astype(np.uint32)):
        fail(f"raydrop_drop: velodyne/000000.bin {b.shape}, labels "
             f"{lab.shape}, drop_sweep {ref['points'].shape}")
    if not b[:, 2].min() < -0.5:
        fail(f"raydrop_drop: lowest exported point at z = {b[:, 2].min()} "
             "in the sensor frame (ground returns lie below the sensor)")
    l2e = np.load(os.path.join(kitti, "lidar2egos.npy"))
    e2g = np.load(os.path.join(kitti, "ego2globals.npy"))
    if l2e.shape != (n, 4, 4) or e2g.shape != (n, 4, 4) or \
            drop.summary["sweeps"] != n:
        fail(f"raydrop_drop: sensor metadata {l2e.shape} {e2g.shape}")
    if not vis["frames"] or not os.path.exists(os.path.join(
            "exp", RD_EXP, "val_vis", f"pred_{vis['frames'][0]:04d}.obj")):
        fail(f"raydrop_val_vis: frames {vis['frames']}")
    print(f"[13] ray-drop path (features -> train -> drop -> export) "
          f"launches of the table's kernels: {launches}")
    print(f"[13] raydrop_features: {tuple(data['images'].shape)} images, "
          f"ground-truth keep rate {keep_rate:.4f}; raydrop_train (VGG, "
          f"batch 4, {len(hist)} epochs, {rd.state.step} steps): "
          f"{train_s:.1f} s, CE {hist[0]['ce']:.4f} -> {hist[-1]['ce']:.4f}, "
          f"val_ce {hist[-1]['val_ce']:.4f}; --darknet {dk.state.step} "
          f"steps, darknet term {dk.history[0]['darknet']:.4f} -> "
          f"{dk.history[-1]['darknet']:.4f}; raydrop_drop: "
          f"{drop.summary['points_per_sweep']:.0f} points/sweep, iou "
          f"{drop.summary['iou']:.4f}, precision "
          f"{drop.summary['precision']:.4f}, recall "
          f"{drop.summary['recall']:.4f}; sweep 0 read back: {len(b)} "
          f"points, lowest z {b[:, 2].min():.2f} m; val_vis frames "
          f"{vis['frames']} acc {vis['acc_mean']:.4f}")

    # The card against the CPU, from the trained weights.
    frame = data["images"][:1]
    logits = {}
    with torch.no_grad():
        state.model.eval()
        from nerf_lidar_tpu_torch.raydrop.trainer import to_nchw
        logits["card"] = state.model(to_nchw(frame, dev)).cpu()
        cpu_model = copy.deepcopy(state.model).cpu().eval()
        logits["cpu"] = cpu_model(to_nchw(frame, "cpu"))
    logit_err = rel_err("[13] U-Net eval logits, card vs CPU",
                        logits["card"], logits["cpu"], RD_LOGIT_TOL)[1]
    from nerf_lidar_tpu_torch.raydrop.trainer import RayDropTrainer
    cpu_trainer = RayDropTrainer(trainer.cfg, device="cpu")
    cpu_state = cpu_trainer.make_state(cpu_model)
    card_out = infer.drop_sweep(trainer, state, *sweeps[0])
    cpu_out = infer.drop_sweep(cpu_trainer, cpu_state, *sweeps[0])
    safe = np.abs(cpu_out["keep_prob"] - 0.5) > RD_KEEP_MARGIN
    prob_err = float(np.abs(card_out["keep_prob"]
                            - cpu_out["keep_prob"]).max())
    if not np.array_equal(card_out["keep_mask"][safe],
                          cpu_out["keep_mask"][safe]):
        fail("[13] keep mask, card vs CPU, differs where the CPU's "
             "probability is farther than 1e-4 from 0.5")
    vgg_trainer = rd.trainer
    g = torch.Generator().manual_seed(13)
    idx = np.arange(4) % n
    batch = vgg_trainer.batch(data["images"], data["masks"],
                               data["ranges"], idx)
    shift = int(torch.randint(0, 1024, (), generator=g))
    noise = -torch.empty(4, 2, 32, 1024).exponential_(generator=g).log()
    step_err = {}
    for dtype, rows in ((torch.float64, 2), (torch.float32, 4)):
        sub = tuple(t[:rows] for t in batch)
        step_err[dtype] = _rd_step_vs_cpu(vgg_trainer, rd.state, sub, shift,
                                          noise[:rows].to(dev), dtype)
    loss64, grad64, at64, bn64 = step_err[torch.float64]
    if not (loss64 <= RD_LOSS_TOL and grad64 <= RD_GRAD_TOL
            and bn64 <= RD_BN_TOL):
        fail(f"[13] train step in float64, card vs CPU: loss {loss64}, "
             f"gradients {grad64} ({at64}), BatchNorm buffers {bn64}")
    loss32, grad32, at32, bn32 = step_err[torch.float32]
    if not loss32 <= RD_LOSS_TOL:
        fail(f"[13] train step in float32, card vs CPU: loss {loss32}")
    print(f"[13] card vs CPU (TF32 off): eval logits on one frame "
          f"{logit_err:.2e} of max (tol {RD_LOGIT_TOL}); keep probability "
          f"max abs diff {prob_err:.2e}, keep mask equal on the "
          f"{int(safe.sum())} of {safe.size} pixels farther than "
          f"{RD_KEEP_MARGIN} from 0.5; one train step (VGG on, same batch, "
          f"roll shift {shift}, Gumbel noise) in float64, batch 2: loss "
          f"{loss64:.2e} (tol {RD_LOSS_TOL}), gradients {grad64:.2e} of max "
          f"({at64}; tol {RD_GRAD_TOL}), BatchNorm buffers {bn64:.2e} (tol "
          f"{RD_BN_TOL}); in float32, batch 4: loss {loss32:.2e}, gradients "
          f"{grad32:.2e} of max ({at32}), BatchNorm buffers {bn32:.2e}")

    # Times on the card: a train step (VGG; VGG + Darknet), a predict.
    def step_ms(tr, st):
        b4 = tr.batch(data["images"], data["masks"], data["ranges"], idx)
        gen = torch.Generator().manual_seed(1)
        ng = torch.Generator(device=dev).manual_seed(2)
        sec = []
        for i in range(13):
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.train_step(st, *b4, generator=gen, noise_generator=ng)
            torch.cuda.synchronize()
            if i >= 3:
                sec.append(1e3 * (time.perf_counter() - t))
        return statistics.median(sec), min(sec)

    vgg_ms = step_ms(vgg_trainer, rd.state)
    dk_ms = step_ms(dk.trainer, dk.state)
    pred = []
    for i in range(13):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.predict_prob(state, frame)
        torch.cuda.synchronize()
        if i >= 3:
            pred.append(1e3 * (time.perf_counter() - t))
    drop_s = []
    for sw in sweeps:
        t = time.perf_counter()
        infer.drop_sweep(trainer, state, *sw, car_median_rule=True)
        drop_s.append(time.perf_counter() - t)
    print(f"[13] times on the card: raydrop_train step (batch 4, 32 x 1024) "
          f"with VGG {vgg_ms[0]:.1f} ms (median of 10; min {vgg_ms[1]:.1f}), "
          f"with VGG + Darknet {dk_ms[0]:.1f} ms (min {dk_ms[1]:.1f}); "
          f"predict_prob on one sweep {statistics.median(pred):.2f} ms "
          f"(median of 10, host copies included); raydrop_features "
          f"{feat_s:.3f} s/sweep (host); drop_sweep "
          f"{statistics.median(drop_s):.3f} s/sweep (median of "
          f"{len(drop_s)}; host projection, depth filter and predict), "
          f"raydrop_drop entry {drop_cli_s:.3f} s/sweep (export and the "
          f"--features evaluation included); peak memory training (above what "
          f"earlier phases hold) with VGG "
          f"{peak_vgg / 2**30:.2f} GiB, with VGG + Darknet "
          f"{peak_dk / 2**30:.2f} GiB")
    forms = rd_form_times(lambda: step_ms(vgg_trainer, rd.state))
    print(f"[13] raydrop_train step with VGG by the forms of its resize and "
          f"cross-entropy (the port's: interpolation matrices, a one-hot), "
          f"in turns (ms, median of 10 each turn): "
          + "; ".join(f"{k} {v}" for k, v in forms.items()))
    del rd, dk, drop, trainer, state, vgg_trainer, cpu_model, cpu_state
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def torch_rd_forms():
    """Within the block the ray-drop modules resize by `F.interpolate` and
    take `F.cross_entropy`, torch's forms of the port's interpolation
    matrices (`unet.resize_bilinear`) and one-hot cross-entropy
    (`trainer.cross_entropy`)."""
    import torch.nn.functional as F
    from nerf_lidar_tpu_torch.raydrop import pretrain, trainer, unet, vgg
    saved = [(m, "resize_bilinear", m.resize_bilinear)
             for m in (unet, vgg, pretrain)]
    saved.append((trainer, "cross_entropy", trainer.cross_entropy))
    for m in (unet, vgg, pretrain):
        m.resize_bilinear = lambda x, size: F.interpolate(
            x, size=size, mode="bilinear", align_corners=False)
    trainer.cross_entropy = F.cross_entropy
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def rd_form_times(step_ms):
    """[13] `step_ms()` (a U-Net train step's median ms) in turns: the
    port's resize and cross-entropy, torch's (`torch_rd_forms`), and the
    port's under `cli.deterministic_mode()`. Returns {form: [ms of each
    turn]}."""
    from nerf_lidar_tpu_torch import cli
    cases = {"port's": contextlib.nullcontext,
             "torch's F.interpolate, F.cross_entropy": torch_rd_forms,
             "deterministic mode": cli.deterministic_mode}
    out = {k: [] for k in cases}
    for name in [*cases, *reversed(cases)]:
        with cases[name]():
            out[name].append(round(step_ms()[0], 2))
    return out


EVAL_CKPT_EXP = "chip_smoke_eval_ckpt"
# [14]'s Chamfer sizes: one sweep's rays, and a cloud of 10^6 points (what
# `lidar_eval --max_rays 0` scores on a scene of ~30 sweeps).
CHAMFER_SIZES = (35200, 10 ** 6)
METRIC_TOL = 1e-5


def chamfer_f64(a, b):
    """Chamfer of two float32 clouds in float64 on the host: exact nearest
    neighbours by a k-d tree."""
    import numpy as np
    from scipy.spatial import cKDTree
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d_ab = float(cKDTree(b).query(a)[0].mean())
    d_ba = float(cKDTree(a).query(b)[0].mean())
    return {"chamfer": 0.5 * (d_ab + d_ba), "chamfer_a_to_b": d_ab,
            "chamfer_b_to_a": d_ba}


def view_on_vs_off(what, renderer, plain, rays, tracks, track_mask,
                   levels):
    """A [H, W] view kernels on (`renderer`, every K1 and H1 call held
    against its plain version) vs off (`plain`). H1's rounding in the
    proposal levels shifts the final intervals the resampling draws, and a
    shifted interval can move a ray's values past [5]'s tolerances. Those
    values (at most TRAINED_SWEEP_SHARE) are bounded by a third render
    instead: the plain chain given the kernel render's final intervals must
    reproduce the kernel render at [5]'s tolerances on every value, so what
    differs comes from the intervals and not from a kernel. Returns {"a",
    "b": the two views, "rec": `kernels_checked`'s record, "errs",
    "outside", "off_rays": `compare_sweeps`' of a vs b, "replay_errs":
    its max abs diffs of a vs the replay}."""
    import torch
    from nerf_lidar_tpu_torch.ops import stepfun
    from nerf_lidar_tpu_torch.renderer import render_view
    sample = stepfun.sample_intervals
    final_sdist, calls = [], [0]

    def sample_recorded(*a, **kw):
        sdist = sample(*a, **kw)
        calls[0] += 1
        if calls[0] % levels == 0:
            final_sdist.append(sdist.detach().clone())
        return sdist

    def sample_replayed(*a, **kw):
        sdist = sample(*a, **kw)
        calls[0] += 1
        if calls[0] % levels:
            return sdist
        given = final_sdist[calls[0] // levels - 1]
        if given.shape != sdist.shape:
            fail(f"{what}: replayed intervals {tuple(given.shape)} for a "
                 f"level of {tuple(sdist.shape)}")
        return given

    with kernels_checked() as rec:
        stepfun.sample_intervals = sample_recorded
        try:
            a = render_view(renderer, rays, tracks, track_mask)
        finally:
            stepfun.sample_intervals = sample
        b = render_view(plain, rays, tracks, track_mask)
    calls[0] = 0
    stepfun.sample_intervals = sample_replayed
    try:
        c = render_view(plain, rays, tracks, track_mask)
    finally:
        stepfun.sample_intervals = sample
    if calls[0] != levels * len(final_sdist):
        fail(f"{what}: the replay drew {calls[0]} levels, the kernel render "
             f"{levels * len(final_sdist)}")
    flat = lambda img: {k: v.reshape((-1,) + v.shape[2:])  # noqa: E731
                        for k, v in img.items()}
    errs, outside, off_rays, _ = compare_sweeps(
        f"{what}, kernels on vs off", flat(a), flat(b),
        share=TRAINED_SWEEP_SHARE, cap=None)
    replay_errs = compare_sweeps(
        f"{what}, kernels on vs the plain chain on their final "
        "intervals", flat(a), flat(c))[0]
    return dict(a=a, b=b, rec=rec, errs=errs, outside=outside,
                off_rays=off_rays, replay_errs=replay_errs)


def phase_eval(dev):
    """[14] Evaluation, on [13]'s dense synth_nusc scene and its 60-step
    field (params_60.npz), at full width: the port's `eval` (every test
    view), `lidar_eval --max_rays 0` (every replayed return; seeded
    per-point labels written beside the sweeps, so the mIoU path runs) and
    `render --path test --num_frames 1` (compute_extras: H1 only), each with
    the kernel counts at 0 just before it and read just after; the files
    and finite metrics of each. Then eval's first view again with every K1
    and H1 call held against its plain version, and kernels off
    (`use_kernels=False`) at [5]'s tolerances on all but
    TRAINED_SWEEP_SHARE of the values, and the plain chain on the kernel
    render's final intervals at [5]'s tolerances on all of them; the same
    weights written as a JAX checkpoint_60.ckpt (the port's
    `msgpack.msgpack_serialize`) evaluated through the port's decoder,
    equal to the .npz's metrics; PSNR / SSIM on the card vs the
    CPU and the Chamfer distances vs a float64 k-d tree; times (eval s per
    view, lidar_eval s, Chamfer ms at CHAMFER_SIZES, peak GiB). Returns
    the kernel counts per entry."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli, convert
    from nerf_lidar_tpu_torch.ops import grid, render_fused
    from nerf_lidar_tpu_torch.renderer import ChunkRenderer
    from nerf_lidar_tpu_torch.utils import image, msgpack, pc_metrics

    counters = dict(composite=render_fused.fused_composite,
                    hash_encode_ms=grid.hash_encode_multisample,
                    hash_encode_ms_bwd=grid.hash_encode_multisample_bwd,
                    scatter_add_rows=grid.scatter_add_rows)
    rng = np.random.RandomState(14)
    for path in sorted(os.listdir(os.path.join(RD_SCENE, "lidar_points"))):
        if path.endswith(".bin"):
            n = os.path.getsize(os.path.join(RD_SCENE, "lidar_points",
                                             path)) // 20
            rng.randint(0, 19, n).astype(np.uint32).tofile(os.path.join(
                RD_SCENE, "lidar_points", path[:-4] + ".label"))
    shutil.rmtree(os.path.join("exp", EVAL_CKPT_EXP), ignore_errors=True)
    out = os.path.join("exp", RD_EXP)
    launches, seconds = {}, {}
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)

    def entry(name, argv):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        run = cli.main(argv)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        launches[name] = {k: fn.launches for k, fn in counters.items()}
        return run

    ev = entry("eval", ["eval", *RD_FIELD_ARGV])
    le = entry("lidar_eval", ["lidar_eval", *RD_FIELD_ARGV, "--max_rays",
                              "0"])
    rd = entry("render", ["render", *RD_FIELD_ARGV, "--path", "test",
                          "--num_frames", "1"])
    peak = (torch.cuda.max_memory_allocated(dev) - held) / 2 ** 30
    for name in ("eval", "lidar_eval"):
        if not (launches[name]["composite"] and
                launches[name]["hash_encode_ms"]):
            fail(f"[14] {name} did not launch K1 and H1: {launches[name]}")
    if launches["render"]["composite"] or \
            not launches["render"]["hash_encode_ms"]:
        fail(f"[14] render (compute_extras: H1, no K1): {launches['render']}")
    n_views = ev.data.num_views
    step = ev.steps[-1]
    want = [os.path.join(out, "eval", f) for f in (
        "metrics.json", f"metrics_{step}.json", f"render_times_{step}.txt",
        *(f"rgb_{i:03d}.npy" for i in range(n_views)))]
    want += [os.path.join(out, "lidar_eval", f) for f in (
        "metrics.json", "iou.txt", "pred_depth.npy", "gt_depth.npy",
        "pred_semantic.npy")]
    want += [os.path.join(rd.render_dir, f"{p}_000.png")
             for p in ("color", "depth", "acc", "semantic")]
    missing = [f for f in want if not os.path.exists(f)]
    frame = rd.frames[0]
    values = [*ev.metrics.values(), *(v for v in le.metrics.values())]
    if missing or not all(np.isfinite(v) for v in values) or \
            not {"distance_median", "acc"} <= set(frame) or \
            not all(np.isfinite(v).all() for v in frame.values()):
        fail(f"[14] entries: missing {missing}, eval {ev.metrics}, "
             f"lidar_eval {le.metrics}, render keys {sorted(frame)}")
    print(f"[14] eval ({n_views} test views of {ev.data.height} x "
          f"{ev.data.width}, step {step}): {ev.metrics}; launches "
          f"{launches['eval']}")
    print(f"[14] lidar_eval (--max_rays 0): {le.metrics['num_rays']} rays, "
          f"depth MAE {le.metrics['depth_mae']:.4f} / median "
          f"{le.metrics['depth_median']:.4f} / RMSE "
          f"{le.metrics['depth_rmse']:.4f}, Chamfer "
          f"{le.metrics['chamfer']:.4f}, mIoU (seeded labels) "
          f"{le.metrics['miou']:.4f}; launches {launches['lidar_eval']}")
    print(f"[14] render --path test: panels in {rd.render_dir}, distance "
          f"median {float(np.median(frame['distance_median'])):.3f}; "
          f"launches {launches['render']}")

    # Eval's first view kernels on vs off (`view_on_vs_off`); the rays
    # outside are logged with their 3 x 3 neighbourhood's depth span (an
    # occlusion edge spans metres).
    rays = cli._view_rays(ev.data, 0)
    plain = ChunkRenderer(ev.model, ev.cfg, ev.cfg.render_chunk_size,
                          use_kernels=False)
    on_off = view_on_vs_off("[14] eval view 0", ev.renderer, plain, rays,
                            ev.tracks, ev.track_mask,
                            ev.cfg.model.num_levels)
    a, b, rec, errs, outside, off_rays, replay_errs = (on_off[k] for k in (
        "a", "b", "rec", "errs", "outside", "off_rays", "replay_errs"))
    n = off_rays.shape[0]
    moved = (torch.cat(rec["tdist_kernels"])[:n]
             - torch.cat(rec["tdist_plain"])[:n]).abs().amax(-1).cpu()
    h, w = ev.data.height, ev.data.width
    depth = torch.from_numpy(b["depth"].reshape(1, h, w))
    span = (torch.nn.functional.max_pool2d(depth, 3, 1, 1)
            + torch.nn.functional.max_pool2d(-depth, 3, 1, 1))[0]
    off = torch.nonzero(off_rays).flatten()
    diff = (torch.from_numpy(a["depth"].reshape(h, w))
            - depth[0]).abs().flatten()
    worst = off[diff[off].argsort(descending=True)][:8].tolist()
    print(f"[14] eval view 0: every call vs its plain version, max abs err "
          f"K1 {max(rec['k1']):.3e} ({len(rec['k1'])} calls), H1 "
          f"{max(rec['h1']):.3e} ({len(rec['h1'])} calls); kernels on vs "
          f"off, max abs diff {errs}, values outside [5]'s tolerances "
          f"{outside} (allowed {TRAINED_SWEEP_SHARE} of each) on "
          f"{off.numel()} rays; kernels on vs the plain chain on their "
          f"final intervals, max abs diff {replay_errs}")
    print(f"[14] eval view 0, rays outside: median 3 x 3 depth span "
          f"{float(span.flatten()[off].median()) if off.numel() else 0:.3f}"
          f" m (all rays {float(span.median()):.3f} m); largest depth "
          f"differences (row, col, depth on / off, span, intervals moved): "
          + "; ".join(f"({r // w}, {r % w}, {float(a['depth'].flat[r]):.3f}"
                      f" / {float(depth.flatten()[r]):.3f}, "
                      f"{float(span.flatten()[r]):.3f}, "
                      f"{float(moved[r]):.2e})" for r in worst))

    # The same weights as a JAX train state's msgpack checkpoint.
    params = convert.load_npz_params(os.path.join(out, f"params_{step}.npz"))
    state = torch.load(os.path.join(out, f"checkpoint_{step}.pt"),
                       map_location="cpu", weights_only=True)
    train_state = {"step": np.asarray(step, np.int32), "params": {
        "model": params, "tracknet": {"params": {
            k: v.numpy() for k, v in state["tracknet"].items()}}}}
    os.makedirs(os.path.join("exp", EVAL_CKPT_EXP))
    with open(os.path.join("exp", EVAL_CKPT_EXP,
                           f"checkpoint_{step}.ckpt"), "wb") as f:
        f.write(msgpack.msgpack_serialize(train_state))
    ev_ckpt = cli.main(["eval", *RD_FIELD_ARGV, "--exp_name", EVAL_CKPT_EXP])
    same = {k: (ev_ckpt.metrics[k], ev.metrics[k]) for k in ev.metrics
            if k != "median_render_time_s"
            and ev_ckpt.metrics[k] != ev.metrics[k]}
    for i in range(n_views):
        name = f"rgb_{i:03d}.npy"
        if not np.array_equal(
                np.load(os.path.join("exp", EVAL_CKPT_EXP, "eval", name)),
                np.load(os.path.join(out, "eval", name))):
            same[name] = "differs"
    if same or ev_ckpt.steps != [step]:
        fail(f"[14] eval of checkpoint_{step}.ckpt vs params_{step}.npz: "
             f"{same}, steps {ev_ckpt.steps}")
    print(f"[14] eval of the same weights as a JAX checkpoint_{step}.ckpt "
          f"(model + tracknet, msgpack): metrics and images equal to the "
          f".npz run's")

    # Card vs CPU: PSNR / SSIM over the same arrays; Chamfer vs float64.
    rgb = np.load(os.path.join(out, "eval", "rgb_000.npy"))
    gt = np.asarray(ev.data.images[0], np.float32)
    card = {f.__name__: float(f(torch.from_numpy(rgb).to(dev),
                                torch.from_numpy(gt).to(dev)))
            for f in (image.psnr, image.ssim)}
    cpu = {f.__name__: float(f(rgb, gt)) for f in (image.psnr, image.ssim)}
    for k in card:
        if abs(card[k] - cpu[k]) > METRIC_TOL * abs(cpu[k]):
            fail(f"[14] {k} card {card[k]} vs CPU {cpu[k]}")
    ref = chamfer_f64(le.pred_pts, le.gt_pts)
    chamfer_err = {k: abs(le.metrics[k] - ref[k]) / ref[k] for k in ref}
    if max(chamfer_err.values()) > METRIC_TOL:
        fail(f"[14] lidar_eval Chamfer {le.metrics['chamfer']} vs float64 "
             f"{ref['chamfer']}: {chamfer_err}")
    timings = {}
    for n in CHAMFER_SIZES:
        g = torch.Generator(device=dev).manual_seed(n)
        pa = torch.rand(n, 3, generator=g, device=dev) * 100 - 50
        pb = pa[torch.randperm(n, generator=g, device=dev)] + 0.05 * \
            torch.randn(n, 3, generator=g, device=dev)
        pc_metrics.chamfer_distance(pa[:1000], pb[:1000])  # warm
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = pc_metrics.chamfer_distance(pa, pb)
        ms = 1e3 * (time.perf_counter() - t)
        extra = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
        ref = chamfer_f64(pa.cpu().numpy(), pb.cpu().numpy())
        err = abs(got["chamfer"] - ref["chamfer"]) / ref["chamfer"]
        if err > METRIC_TOL:
            fail(f"[14] Chamfer {n} x {n}: {got} vs float64 {ref}")
        timings[n] = (ms, extra, err, pc_metrics.block_rows(n))
        del pa, pb
    print(f"[14] card vs CPU: PSNR {card['psnr']:.6f} / {cpu['psnr']:.6f}, "
          f"SSIM {card['ssim']:.6f} / {cpu['ssim']:.6f} (rtol "
          f"{METRIC_TOL}); lidar_eval Chamfer vs float64 k-d tree, relative "
          f"err {max(chamfer_err.values()):.2e}; seeded Chamfer "
          + "; ".join(f"{n} x {n}: rel err {e:.2e}" for n, (_, _, e, _)
                      in timings.items()))
    render_times = [float(x) for x in open(os.path.join(
        out, "eval", f"render_times_{step}.txt")).read().split()]
    print(f"[14] times on the card: eval {statistics.median(render_times):.3f}"
          f" s/view ({ev.data.height * ev.data.width} rays; entry "
          f"{seconds['eval']:.1f} s with scene load and metrics); lidar_eval "
          f"{seconds['lidar_eval']:.2f} s for {le.metrics['num_rays']} rays; "
          f"render entry {seconds['render']:.1f} s; Chamfer "
          + "; ".join(f"{n} x {n} {ms:.1f} ms (block {blk} rows, "
                      f"{extra:.2f} GiB above its inputs)"
                      for n, (ms, extra, _, blk) in timings.items())
          + f"; peak memory of the three entries {peak:.2f} GiB")
    del ev, le, rd, ev_ckpt, plain
    torch.cuda.empty_cache()
    return launches


# [15]: the field presets on the card (`_fast`, `_speed`, `_mxu`), through
# the same entries a user calls: `nuscenes_single_fast` and
# `nuscenes_single_speed` train PRESET_STEPS steps on the synthetic scene
# (`_speed` also PRESET_LEARN_STEPS at the full learning rate), each trained
# field and a seeded `nuscenes_single_mxu` render PRESET_SWEEPS sweeps, and
# `spectral_obj_variant(nuscenes_single_speed())` (--config_json) trains
# SPEC_OBJ_STEPS steps on [12]'s scene and renders one replay sweep.
PRESET_STEPS = 30
PRESET_LEARN_STEPS = 60
PRESET_SWEEPS = 2
PRESET_CONFIGS = {"fast": ["--config", "nuscenes_single_fast"],
                  "speed": ["--config", "nuscenes_single_speed"],
                  "mxu": ["--config", "nuscenes_single_mxu"]}
PRESET_ARGS = ["--set", "dataset_loader=synthetic", "--device", "cuda"]
SPEC_OBJ_EXP = "chip_smoke_spectral_obj"
SPEC_OBJ_STEPS = 5
SPEC_OBJ_ARGS = ["--set", "dataset_loader=nusc", "--data_dir", OBJ_SCENE,
                 "--set", "track_start_opt=0", "--device", "cuda",
                 "--exp_name", SPEC_OBJ_EXP]
# Kernels on vs off with bfloat16 MLPs (`_speed`): the MLP gradients to
# 1e-2 of their largest value, 2.5 bfloat16 ulps (2^-8 each). The encode's
# float32 rounding (~1e-7 relative, [4]) moves a feature across a bfloat16
# rounding boundary on a few in 10^4 inputs, which then differs by one
# bfloat16 ulp, and so do the activations and the backward's products
# downstream of it; a gradient entry sums such terms (measured 1.33e-3 of
# max, the NeRF semantic head's first layer; NVIDIA H100 80GB HBM3,
# 700 W). The float32 presets keep GRAD_TOL; the tables keep
# `table_grad_excess` (its upstream term takes each side's g_out).
GRAD_TOL_BF16 = 1e-2


def encode_mode(spec, cutoff):
    """A grid's mode combination as [15] names it: interpolation, channels,
    and per level kind (the mean point or every point; tiled or hashed),
    e.g. "tetra C16: mean-tiled x2, point-hashed x2"."""
    kinds = []
    for l, r in enumerate(spec.resolutions):
        kinds.append(("mean" if r <= cutoff else "point") + "-"
                     + ("tiled" if spec.is_tiled(l) else "hashed"))
    parts = []
    for k in dict.fromkeys(kinds):
        parts.append(f"{k} x{kinds.count(k)}")
    return f"{spec.interp} C{spec.level_dim}: {', '.join(parts)}"


def preset_argv(key, cmd, exp, *extra):
    return [cmd, *PRESET_CONFIGS[key], *PRESET_ARGS, "--exp_name", exp,
            *extra]


@contextlib.contextmanager
def counted_launches():
    """Within the block, every kernel of the render and train paths counts
    from 0; yields {kernel: launches}, filled when the block ends."""
    from nerf_lidar_tpu_torch.ops import grid, render_fused
    fns = dict(composite=render_fused.fused_composite,
               hash_encode_ms=grid.hash_encode_multisample,
               hash_encode_ms_bwd=grid.hash_encode_multisample_bwd,
               scatter_add_rows=grid.scatter_add_rows)
    for fn in fns.values():
        fn.launches = 0
    out = {}
    try:
        yield out
    finally:
        out.update({k: fn.launches for k, fn in fns.items()})


def need_launches(what, launches, names, absent=()):
    for name in names:
        if launches.get(name, 0) == 0:
            fail(f"{what}: kernel {name} was not launched")
    for name in absent:
        if launches.get(name, 0):
            fail(f"{what}: kernel {name} was launched {launches[name]} times "
                 "(the preset composites with the plain version)")


def preset_train(dev, key):
    """[15] The train entry on a preset at full width for PRESET_STEPS
    steps (finite losses, a gradient on every table, launches, warm
    ms/step, rays/s, peak GiB), one more step's encode-backward inputs per
    grid, then 3 steps kernels on vs off under [8]'s rules. Returns
    ({"launches", "params": the params file it wrote, "inputs": the encode
    backward's inputs per grid}, the entry's run)."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    argv = preset_argv(key, "train", f"chip_smoke_{key}", "--set",
                       "print_every=1", "--steps", str(PRESET_STEPS))
    fresh_exp_dir(argv)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with counted_launches() as launches:
        run = cli.main(argv)
        torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    need_launches(f"train_{key}", launches,
                  ("hash_encode_ms", "hash_encode_ms_bwd", "scatter_add_rows"))
    hist = run.history
    if len(hist) != PRESET_STEPS or not all(
            np.isfinite(h["loss"]) and np.isfinite(h["psnr"]) for h in hist):
        fail(f"train_{key}: {len(hist)} steps logged, or a loss is not "
             "finite")
    _table_grads_nonzero(run.model, f"train_{key}")
    step_ms = 1e3 * statistics.median(h["step_s"] for h in hist[-20:])
    rays = run.batcher.total_rays
    modes = {name: encode_mode(mlp.spec, mlp.cfg.ms_coarse_res_cutoff)
             for name, mlp in hb.grid_names(run.model)}
    print(f"[15] train {PRESET_CONFIGS[key][-1]} (synthetic, {rays} "
          f"rays/step, {PRESET_STEPS} steps, cold, init included): "
          f"{entry_s:.2f} s; grids {modes}; MLPs "
          f"{run.cfg.model.nerf_mlp.compute_dtype}; launches {launches}; "
          f"warm {step_ms:.1f} ms/step (median of the last 20), "
          f"{rays / step_ms * 1e3:,.0f} rays/s; peak memory {peak:.2f} GiB; "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    inputs = hb.record_train_inputs(run, PRESET_STEPS)
    bf16 = run.cfg.model.nerf_mlp.compute_dtype == "bfloat16"
    on_off = train_on_vs_off(dev, run, PRESET_STEPS + 1,
                             f"train_{key} step",
                             GRAD_TOL_BF16 if bf16 else GRAD_TOL)
    print(f"[15] train_{key}, {ON_OFF_STEPS} steps kernels on vs off"
          f"{' (bfloat16 MLPs)' if bf16 else ''}: {on_off}")
    return dict(launches=launches, params=run.params, inputs=inputs), run


def preset_learn(dev):
    """[15] `_speed` for PRESET_LEARN_STEPS steps at the full learning rate
    (no warm-up): the data loss must fall."""
    import numpy as np
    from nerf_lidar_tpu_torch import cli
    argv = preset_argv("speed", "train", "chip_smoke_speed_learn", "--set",
                       "print_every=1", "--set", "lr_delay_steps=0",
                       "--steps", str(PRESET_LEARN_STEPS))
    fresh_exp_dir(argv)
    learn = cli.main(argv)
    data = [h["data"] for h in learn.history]
    first, last = float(np.mean(data[:5])), float(np.mean(data[-5:]))
    if not (len(data) == PRESET_LEARN_STEPS and last < first):
        fail(f"[15] speed learning check: data loss {first} (first 5) -> "
             f"{last} (last 5) over {len(data)} steps")
    print(f"[15] speed learning check ({PRESET_LEARN_STEPS} steps, no "
          f"warm-up): data loss {first:.4f} (mean of first 5) -> "
          f"{last:.4f} (mean of last 5); psnr "
          f"{learn.history[0]['psnr']:.2f} -> "
          f"{learn.history[-1]['psnr']:.2f}")


def check_sweep_files(what, run, classes):
    import numpy as np
    n_rays = 32 * 1100
    for path in run.paths:
        pts = np.load(path)
        if pts.shape != (n_rays, 3) or not np.isfinite(pts).all():
            fail(f"{what}: {path} has shape {pts.shape} or is not finite")
    sem = np.load(run.paths[0].replace("points_", "points_semantic_"))
    if sem.shape != (n_rays, classes) or np.abs(sem.sum(-1) - 1).max() > 1e-3:
        fail(f"{what}: semantic {sem.shape}, rows not summing to 1")


def preset_render(dev, key, params):
    """[15] render_lidar on a preset: PRESET_SWEEPS sweeps from `params`
    (or seeded fresh weights), the launches of that run; warm s/sweep
    (median of 3); the first sweep again with every K1 and H1 call held
    against its plain version (per mode combination), against the sweep
    kernels off. Returns {"launches", "inputs": the encode's inputs of one
    chunk per grid}."""
    import torch
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.lidar.render import render_sweep
    from nerf_lidar_tpu_torch.renderer import ChunkRenderer
    argv = preset_argv(key, "render_lidar", f"chip_smoke_{key}", "--mode",
                       "simu", "--num_sweeps", str(PRESET_SWEEPS),
                       *(["--params", params] if params else
                         ["--allow_fresh"]))
    t0 = time.perf_counter()
    with counted_launches() as launches:
        run = cli.main(argv)
        torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    fused = run.cfg.render_fused is not False
    need_launches(f"render_lidar_{key}", launches,
                  ("hash_encode_ms",) + (("composite",) if fused else ()),
                  () if fused else ("composite",))
    check_sweep_files(f"render_lidar_{key}", run,
                      run.cfg.model.nerf_mlp.class_num)
    sweep = run.sweeps[0]
    chunk = run.cfg.render_chunk_size
    kern = ChunkRenderer(run.model, run.cfg, chunk)
    plain = ChunkRenderer(run.model, run.cfg, chunk, use_kernels=False)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        render_sweep(kern, sweep, run.near, run.far, run.frame)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    with kernels_checked() as rec:
        a = render_sweep(kern, sweep, run.near, run.far, run.frame)
        b = render_sweep(plain, sweep, run.near, run.far, run.frame)
    errs, outside, rays, _ = compare_sweeps(f"[15] {key} sweep", a, b,
                                            share=TRAINED_SWEEP_SHARE)
    n_values = {k: int(a[k].size) for k in outside}
    inputs = hb.record_render_inputs(kern, sweep, run.near, run.far,
                                     run.frame)
    s_per_sweep = statistics.median(times)
    print(f"[15] render_lidar {PRESET_CONFIGS[key][-1]} "
          f"({'--params ' + params if params else 'seeded fresh weights'}, "
          f"{PRESET_SWEEPS} sweeps, chunk {chunk}, "
          f"{'K1' if fused else 'plain compositor'}; cold, init included "
          f"{entry_s:.2f} s): launches {launches}; warm s/sweep "
          f"{s_per_sweep:.4f} (median of 3: {times}); every call vs its "
          f"plain version, max abs err K1 "
          f"{max(rec['k1']) if rec['k1'] else None} ({len(rec['k1'])} calls),"
          f" H1 {max(rec['h1']):.3e} ({len(rec['h1'])} calls), per mode "
          f"{ {m: f'{e:.2e}' for m, e in rec['h1_modes'].items()} }; "
          f"kernels on vs off, max abs diff {errs}, values outside [5]'s "
          f"tolerances {outside} of {n_values} on {int(rays.sum())} rays")
    return dict(launches=launches, inputs=inputs)


def preset_objects(dev):
    """[15] spectral_obj_variant(nuscenes_single_speed()) through
    --config_json on [12]'s scene: SPEC_OBJ_STEPS train steps with the
    tracknet live, H1-bwd's tetrahedral d_x01 (and d_table) on the object
    grid against the written-out twin at [6]'s tolerance, and one replay
    sweep. Returns {"train" / "render": launches, "inputs": the encode
    backward's inputs per grid of a train step}."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli, configs
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.ops import grid
    cfg_path = os.path.join("exp", f"{SPEC_OBJ_EXP}.json")
    os.makedirs("exp", exist_ok=True)
    with open(cfg_path, "w") as f:
        f.write(configs.spectral_obj_variant(
            configs.nuscenes_single_speed()).to_json())
    argv = ["train", "--config_json", cfg_path, *SPEC_OBJ_ARGS,
            "--set", "print_every=1", "--steps", str(SPEC_OBJ_STEPS)]
    fresh_exp_dir(argv)
    spec = grid.spec_for(cli.build_config(cli.parse_args(argv))
                         .model.obj_mlp.grid)
    with counted_launches() as launches, \
            obj_grid_launches(spec) as obj_launches:
        run = cli.main(argv)
        torch.cuda.synchronize()
    need_launches("train_spectral_obj", launches,
                  ("hash_encode_ms", "hash_encode_ms_bwd", "scatter_add_rows"))
    need_launches("train_spectral_obj, object grid", obj_launches,
                  ("hash_encode_ms", "hash_encode_ms_bwd"))
    hist = run.history
    hit = [h["obj_hit_frac"] for h in hist]
    if run.tracknet is None or len(hist) != SPEC_OBJ_STEPS or not all(
            np.isfinite(h["loss"]) for h in hist) or not max(hit) > 0:
        fail(f"train_spectral_obj: tracknet {run.tracknet}, {len(hist)} "
             f"steps, obj_hit_frac {hit}")
    _table_grads_nonzero(run.model, "train_spectral_obj")
    if float(run.tracknet.opt_t.grad.abs().max()) == 0.0:
        fail("train_spectral_obj: the tracknet's opt_t got no gradient")
    step_ms = 1e3 * statistics.median(h["step_s"] for h in hist[-3:])
    inputs = hb.record_train_inputs(run, SPEC_OBJ_STEPS)
    table, x01, stds, g_out, ospec, needs, cutoff = inputs["obj"]
    if not needs[1] or ospec.interp != "tetra":
        fail(f"train_spectral_obj: the object encode's backward got needs "
             f"{needs}, interp {ospec.interp} (expected d_x01, tetra)")
    asked = (True, True, False)
    got = grid.hash_encode_multisample_bwd(table, x01, stds, g_out, ospec,
                                           asked, cutoff)
    twin = grid.hash_encode_multisample_bwd_plain(table, x01, stds, g_out,
                                                  ospec, asked, cutoff)
    errs = {key: rel_err(f"[15] spectral object grid {key} vs twin",
                         got[i], twin[i], BWD_TOL)
            for i, key in enumerate(("d_table", "d_x01"))}
    render_argv = ["render_lidar", "--config_json", cfg_path,
                   *SPEC_OBJ_ARGS, "--mode", "replay", "--num_sweeps", "1",
                   "--params", run.params]
    with counted_launches() as render_launches:
        rendered = cli.main(render_argv)
        torch.cuda.synchronize()
    need_launches("render_lidar_spectral_obj", render_launches,
                  ("hash_encode_ms",), ("composite",))
    pts = np.load(rendered.paths[0])
    if not np.isfinite(pts).all():
        fail("render_lidar_spectral_obj: non-finite points")
    print(f"[15] spectral objects ({encode_mode(ospec, cutoff)}, "
          f"{ospec.total_rows} rows; Fourier "
          f"{tuple(run.model.obj_mlp.fourier_freqs.shape)}): train "
          f"{SPEC_OBJ_STEPS} steps, launches {launches}, on the object grid "
          f"{obj_launches}; warm {step_ms:.1f} ms/step; obj_hit_frac "
          f"{max(hit):.4f}; H1-bwd on a recorded step (B="
          f"{stds.numel() // stds.shape[-1]}, n={stds.shape[-1]}) vs twin "
          f"(max abs err, "
          f"relative to max) {errs}; replay sweep {pts.shape[0]} rays, "
          f"launches {render_launches}")
    return dict(train=launches, render=render_launches, inputs=inputs)


def time_preset_encodes(dev, path, inputs, fwd, tag="[15]"):
    """H1 (fwd: render chunk inputs {grid: (table, x01, stds, spec,
    cutoff)}) or H1-bwd (train step inputs {grid: (table, x01, stds,
    g_out, spec, needs, cutoff)}) per grid of a [15] path on its own
    inputs: the kernel's device ms (torch.profiler, as [12] times the
    object grid) and its ms per call under CUDA events (back to back, so
    the host's launch gaps count where they outlast the kernel), the plain
    version's ms (CUDA events), the bound, the error, printed under `tag`
    ([18] times its path the same way). Returns {"<path> <grid>":
    numbers}."""
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.ops import grid
    out = {}
    for name, rec in inputs.items():
        if fwd:
            table, x01, stds, spec, cutoff = rec
            call = lambda: grid.hash_encode_multisample(table, x01, stds,
                                                        spec, cutoff)
            plain = lambda: grid.hash_encode_multisample_plain(
                table, x01, stds, spec, cutoff)[0]
            err = close(f"{tag} {path} {name} H1", call(), plain(), 1e-5,
                        1e-6)
            lim = bound(*hb.fwd_bound(spec, x01, stds, cutoff))
        else:
            table, x01, stds, g_out, spec, needs, cutoff = rec
            call = lambda: grid.hash_encode_multisample_bwd(
                table, x01, stds, g_out, spec, needs, cutoff)
            plain = lambda: grid.hash_encode_multisample_bwd_plain(
                table, x01, stds, g_out, spec, needs, cutoff)
            got, want = call(), plain()
            err = max(rel_err(f"{tag} {path} {name} H1-bwd {key}", got[i],
                              want[i], BWD_TOL)[0]
                      for i, key in enumerate(GRADS) if needs[i])
            lim = bound(*hb.bwd_bound(spec, x01, stds, g_out, cutoff))
        ms = device_ms(call, iters=10)
        events_ms = cuda_ms(call, iters=5, warmup=1)
        plain_ms = cuda_ms_once(plain)[0]
        n = stds.shape[-1]
        out[f"{path} {name}"] = dict(
            mode=encode_mode(spec, cutoff), B=stds.numel() // n, n=n,
            ms=ms, events_ms=events_ms, plain_ms=plain_ms, max_abs_err=err,
            **lim)
        print(f"{tag} {'H1' if fwd else 'H1-bwd'} {path} {name} "
              f"({encode_mode(spec, cutoff)}; B={stds.numel() // n} n={n}): "
              f"kernel {ms:.4f} ms on the device ({events_ms:.4f} ms per "
              f"call, CUDA events), plain {plain_ms:.2f} ms, bound "
              f"{lim['bound_ms']:.4f} ms ({lim['bound_by']}); max err "
              f"{err:.2e}")
    return out


def obj_bwd_split(rec):
    """Where H1-bwd's time goes on the spectral object grid, on a train
    step's recorded call `rec`: device ms (torch.profiler) of d_table with
    d_x01 (as the step asks), of each alone, and of the first on the valid
    slots only (the object budget's padding slots, which all repeat one
    point, dropped), beside the first's ms per call under CUDA events."""
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.ops import grid
    table, x01, stds, g_out, spec, _, cutoff = rec
    n = stds.shape[-1]
    b = stds.numel() // n
    x, s, g = x01.reshape(b, n, 3), stds.reshape(b, n), g_out.reshape(b, -1)
    # The padding slots are the tail that repeats the last slot's point.
    repeats = (x.reshape(b, -1) == x.reshape(b, -1)[-1]).all(-1)
    pad = int(repeats.flip(0).int().cumprod(0).sum())
    k = b - pad
    cases = {"d_table + d_x01": ((True, True, False), b),
             "d_table": ((True, False, False), b),
             "d_x01": ((False, True, False), b),
             "d_table + d_x01, valid slots": ((True, True, False), k)}
    ms = {name: device_ms(lambda: grid.hash_encode_multisample_bwd(
              table, x[:m], s[:m], g[:m], spec, asked, cutoff), iters=20)
          for name, (asked, m) in cases.items()}
    events = cuda_ms(lambda: grid.hash_encode_multisample_bwd(
        table, x, s, g, spec, (True, True, False), cutoff))
    pad_in = hb.points_in_range(x[k:]) if pad else 0
    pad_g = float(g[k:].abs().max()) if pad else 0.0
    print(f"[15] H1-bwd on the spectral object grid, split (B={b}: {k} "
          f"valid slots, {pad} padding slots repeating one point, {pad_in} "
          f"of them in range, max |g_out| on them {pad_g:.3g}): device ms "
          f"{ {key: round(v, 5) for key, v in ms.items()} }; "
          f"d_table + d_x01 per call under CUDA events {events:.4f} ms")


def phase_presets(dev):
    """[15] The presets on the card: training (`_fast`, `_speed`, with
    kernels on vs off and `_speed`'s learning check), render_lidar
    (`_fast`, `_speed`, seeded `_mxu`), the spectral object variant, then
    H1 / H1-bwd per grid on every path's own inputs. Returns {"paths":
    {path: launches}, "h1" / "h1_bwd": {"<path> <grid>": numbers},
    "profiled": a callable that profiles two warm `_fast` and `_speed`
    steps (run with the other profiler phases)}."""
    import torch
    from nerf_lidar_tpu_torch.ops import fourier
    paths, trains, renders, runs = {}, {}, {}, {}
    for key in ("fast", "speed"):
        trains[key], runs[key] = preset_train(dev, key)
        paths[f"train_{key}"] = trains[key]["launches"]
    preset_learn(dev)
    for key, params in (("fast", trains["fast"]["params"]),
                        ("speed", trains["speed"]["params"]),
                        ("mxu", None)):
        renders[key] = preset_render(dev, key, params)
        paths[f"render_lidar_{key}"] = renders[key]["launches"]
    objects = preset_objects(dev)
    paths["train_spectral_obj"] = objects["train"]
    paths["render_lidar_spectral_obj"] = objects["render"]

    speed_nerf_points = trains["speed"]["inputs"]["nerf"][1:3]
    det_rec = trains["fast"]["inputs"]["nerf"]  # for [19]
    h1, h1_bwd = {}, {}
    for key in ("fast", "speed", "mxu"):
        h1.update(time_preset_encodes(dev, f"render_lidar_{key}",
                                      renders[key].pop("inputs"), True))
    for key in ("fast", "speed"):
        h1_bwd.update(time_preset_encodes(dev, f"train_{key}",
                                          trains[key].pop("inputs"), False))
    obj_rec = objects.pop("inputs")["obj"]
    h1_bwd.update(time_preset_encodes(dev, "train_spectral_obj",
                                      {"obj": obj_rec}, False))
    obj_bwd_split(obj_rec)
    del obj_rec

    # The speed field's Fourier band on its train step's NeRF points:
    # forward and backward of the pooled IPE features (the [N, 3] @ [3, F]
    # product, sin, cos, exp), the share a fused kernel could take.
    nerf = runs["speed"].model.nerf_mlp
    xs, ss = (t.clone().requires_grad_(True)
              for t in speed_nerf_points)
    g = torch.randn_like(fourier.fourier_encode_pooled(
        xs.detach(), ss.detach(), nerf.fourier_freqs))

    def band():
        out = fourier.fourier_encode_pooled(xs, ss, nerf.fourier_freqs)
        torch.autograd.grad(out, (xs, ss), g)

    band_ms = cuda_ms(band, iters=5, warmup=1)
    n = ss.shape[-1]
    print(f"[15] speed NeRF Fourier band (pooled IPE, forward + backward, "
          f"B={ss.numel() // n} n={n} F={nerf.fourier_freqs.shape[1]}): "
          f"{band_ms:.3f} ms per train step")
    del xs, ss, g

    def profiled():
        from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
        out = {}
        for key, run in runs.items():
            prof = hb.profile_train(run, PRESET_STEPS + 10)
            out[key] = prof
            print(f"[15] profile of 2 warm {key} steps: "
                  f"{json.dumps(prof)}")
        runs.clear()
        torch.cuda.empty_cache()
        return out

    return dict(paths=paths, h1=h1, h1_bwd=h1_bwd, profiled=profiled,
                det_rec=det_rec)


def obj_encode(dev, rec, fwd):
    """H1 (fwd) or H1-bwd (d_table and d_x01) on the object grid at a train
    step's recorded backward call `rec` (table, x01, stds, g_out, spec,
    needs; n = 1, stds 0), against its plain version (the backward also
    against plain autograd through the plain encode), with the kernel's
    device ms in both block orders in turns (the one `grid.level_major`
    picks, the other, the other, the picked), the plain version's and the
    bound. Returns its kernels-line numbers."""
    import torch
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.ops import grid
    table, x01, stds, g_out = (t.to(dev) for t in rec[:4])
    spec, needs = rec[4], rec[5]
    n = stds.shape[-1]
    b = stds.numel() // n
    if n != 1 or bool(stds.any()) or not needs[1]:
        fail(f"object grid's encode: n = {n}, stds max "
             f"{float(stds.abs().max())}, needs {needs} (expected n = 1, "
             "stds 0 and d_x01)")
    if fwd:
        name = "hash_encode_ms"
        call = lambda: grid.hash_encode_multisample(table, x01, stds, spec)
        plain = lambda: grid.hash_encode_multisample_plain(table, x01, stds,
                                                           spec)[0]
        err = close(f"{name} object grid", call(), plain(), 1e-5, 1e-6)
        errs = dict(features=err)
        lim = bound(*hb.fwd_bound(spec, x01, stds))
    else:
        name, asked = "hash_encode_ms_bwd", (True, True, False)
        call = lambda: grid.hash_encode_multisample_bwd(
            table, x01, stds, g_out, spec, needs=asked)
        plain = lambda: grid.hash_encode_multisample_bwd_plain(
            table, x01, stds, g_out, spec, needs=asked)
        got, twin = call(), plain()
        leaves = [t.clone().requires_grad_(True) for t in (table, x01)]
        auto = torch.autograd.grad(grid.hash_encode_multisample_plain(
            *leaves, stds, spec)[0], leaves, g_out)
        errs = {}
        for i, key in enumerate(("d_table", "d_x01")):
            for what, want in (("twin", twin[i]), ("autograd", auto[i])):
                errs[f"{key} vs {what}"] = rel_err(
                    f"{name} object grid {key} vs {what}", got[i], want,
                    BWD_TOL)
        err = errs["d_table vs twin"][0]
        lim = bound(*hb.bwd_bound(spec, x01, stds, g_out))
    order = {"picked": [], "other": []}
    for turn in ("picked", "other", "other", "picked"):
        with (hb.other_order(grid) if turn == "other"
              else contextlib.nullcontext()):
            order[turn].append(device_ms(call))
    plain_ms = device_ms(plain, iters=5)
    picked = ("level-major" if grid.level_major(spec, grid._l2_bytes(
        dev.index)) else "side by side")
    ms = statistics.fmean(order["picked"])
    print(f"[12] {name} on the object grid ({spec.num_levels} levels x "
          f"C{spec.level_dim}, {spec.total_rows} rows, one train step's "
          f"B={b} n=1 stds=0): vs plain {errs}; device ms kernel "
          f"{order['picked']} ({picked}, picked), {order['other']} (the "
          f"other order), plain {plain_ms:.4f}; bound {lim['bound_ms']:.5f} "
          f"ms ({lim['bound_by']})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                **lim, block_order=picked,
                other_order_ms=statistics.fmean(order["other"]),
                inputs=f"object grid, one train step's B={b} points, n=1")


def obj_scatter(dev, spec):
    """K3 at the object table's hash-decay level sums (table uniform(-1,
    1)) vs float64, with kernel, plain (index_add_ in float32) and
    index_add_ device ms beside the bound. Returns its kernels-line
    numbers."""
    import torch
    from nerf_lidar_tpu_torch.ops import grid
    g = torch.Generator(device=dev).manual_seed(12)
    table = torch.rand(spec.total_rows, spec.level_dim, device=dev,
                       generator=g) * 2 - 1
    ids, vals, rows = grid.level_ids(spec, dev), table**2, spec.num_levels
    got = grid.scatter_add_rows(ids, vals, rows)
    want = grid.scatter_add_rows_plain(ids, vals.double(), rows)
    err, rel = rel_err("scatter_add_rows hash decay object grid",
                       got.double(), want, PATH_SCATTER_TOL)
    ms = device_ms(lambda: grid.scatter_add_rows(ids, vals, rows))
    plain_ms = device_ms(lambda: grid.scatter_add_rows_plain(ids, vals, rows),
                         iters=5)
    ids64 = ids.long()
    library_ms = device_ms(lambda: vals.new_zeros(rows, spec.level_dim)
                           .index_add_(0, ids64, vals), iters=5)
    lim = bound(nbytes(ids, vals, got), vals.numel())
    print(f"[12] scatter_add_rows hash decay on the object grid: "
          f"N={spec.total_rows} rows onto {rows} C={spec.level_dim}: max abs "
          f"err {err:.3e} ({rel:.2e} of max, float64); device ms: kernel "
          f"{ms:.4f}, plain {plain_ms:.4f}, index_add_ alone "
          f"{library_ms:.4f}; bound {lim['bound_ms']:.4f} ms "
          f"({lim['bound_by']})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, **lim,
                inputs="object grid's hash-decay level sums")


def _bad_indices(idx, size, g):
    """idx's shape, values in [-2 size, 2 size) (wrapped, in range and NaN
    cases) and the int32 extremes, -size, size and -1 in its first cells."""
    import torch
    bad = torch.randint(-2 * size, 2 * size, idx.shape, device=idx.device,
                        generator=g, dtype=torch.int32)
    flat = bad.view(-1)
    flat[:5] = torch.tensor([-2**31, 2**31 - 1, -size, size, -1],
                            dtype=torch.int32)
    return bad


# [16]: mesh extraction of [8]'s learning-check field, and the object-scene
# entries on [12]'s scene and field.
MESH_EXP = "chip_smoke_mesh"
MESH_RES = 256
MESH_DECIMATE = 100000
# The stated level of the second mesh: this percentile of the lattice's
# densities (a 100-step field may have none above the default 20).
MESH_PERCENTILE = 99.9
MESH_ARGV = ["extract", "--config", "nuscenes_single",
             "--set", "dataset_loader=synthetic",
             "--resolution", str(MESH_RES), "--clean",
             "--decimate", str(MESH_DECIMATE), "--device", "cuda",
             "--exp_name", MESH_EXP]
# The lattice kernels on vs off at H1's [4] tolerances; the vertex colours
# (8 samples through the NeRF MLP and the plain compositor) at atol 1e-4.
LATTICE_TOL = (1e-5, 1e-6)
COLOR_TOL = 1e-4
OBJ_ENTRY_ARGS = ["--config", "nuscenes_single", "--set",
                  "dataset_loader=nusc", "--data_dir", OBJ_SCENE,
                  "--device", "cuda", "--exp_name", OBJ_EXP]
OBJ_CKPT_EXP = "chip_smoke_obj_ckpt"


@contextlib.contextmanager
def stage_seconds(stages):
    """Within the block, each (module, function name, label) of `stages`
    adds its synchronised wall seconds to {label: s}, which it yields."""
    import torch
    times, saved = {}, []
    for mod, name, label in stages:
        fn = getattr(mod, name)

        def timed(*a, _fn=fn, _label=label, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            times[_label] = times.get(_label, 0.0) + time.perf_counter() - t
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, timed)
    try:
        yield times
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def host_peak():
    """Within the block, a thread reads the process's resident memory every
    5 ms; yields {"gib": the largest reading, "base_gib": the first}, set
    when the block ends (the kernel's own peak, VmHWM, cannot be reset in
    every sandbox)."""
    import threading
    page = os.sysconf("SC_PAGE_SIZE")

    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page / 2 ** 30

    out, done = dict(base_gib=rss(), gib=rss()), threading.Event()

    def poll():
        while not done.wait(0.005):
            out["gib"] = max(out["gib"], rss())

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        done.set()
        thread.join()
        out["gib"] = max(out["gib"], rss())


def mesh_stages():
    from nerf_lidar_tpu_torch import extract
    from nerf_lidar_tpu_torch.utils import marching
    return [(extract, "density_on_lattice", "lattice"),
            (marching, "marching_tetrahedra", "marching"),
            (marching, "weld_vertices", "weld"),
            (marching, "clean_mesh", "clean"),
            (marching, "decimate_mesh", "decimate"),
            (extract, "rgb_by_projection", "colour")]


def phase_extract(dev, params):
    """[16] The extract entry at --resolution MESH_RES on the weights [8]'s
    learning check wrote, at the default level (20) with --clean and
    --decimate MESH_DECIMATE, every H1 call held against its plain version;
    the lattice kernels off; a second mesh at the lattice's MESH_PERCENTILE
    percentile (stage seconds, peak device and host memory), whose lattice
    equals the kernels-off one at LATTICE_TOL and whose vertex colours
    equal the kernels-off colours of the same vertices at COLOR_TOL.
    Returns {"launches", "profiled": H1 on the lattice's first chunk by
    device time (run with the other profiler phases)}."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli, extract
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.ops import grid

    fresh_exp_dir(MESH_ARGV)
    argv = [*MESH_ARGV, "--params", params]
    with counted_launches() as launches, kernels_checked() as rec, \
            stage_seconds(mesh_stages()) as cli_s:
        run = cli.main(argv)
        torch.cuda.synchronize()
    need_launches("[16] extract", launches, ["hash_encode_ms"],
                  absent=["composite", "hash_encode_ms_bwd",
                          "scatter_add_rows"])
    if len(rec["h1"]) != launches["hash_encode_ms"]:
        fail(f"[16] extract: {len(rec['h1'])} H1 calls checked of "
             f"{launches['hash_encode_ms']}")
    print(f"[16] extract --resolution {MESH_RES} --threshold 20 --clean "
          f"--decimate {MESH_DECIMATE} ({params}): {len(run.verts)} "
          f"vertices, {len(run.faces)} faces; launches {launches}; every H1 "
          f"call vs its plain version, max abs err {max(rec['h1']):.3e} "
          f"({len(rec['h1'])} calls); stage s (the lattice and colours with "
          f"each H1 call checked) {json.dumps(cli_s)}")

    model = run.model
    # Kernels off in chunks of 2^20 points: the plain encode is many small
    # launches, so 256 chunks of 2^16 would take seconds of host time.
    t = time.perf_counter()
    grid_off = extract.density_on_lattice(model, MESH_RES, chunk=2 ** 20,
                                          use_kernels=False)[0]
    off_s = time.perf_counter() - t
    level = float(np.percentile(grid_off, MESH_PERCENTILE))
    lattice = {}
    orig = extract.density_on_lattice

    def kept(*a, **kw):
        out = orig(*a, **kw)
        lattice["grid"] = out[0]
        return out

    extract.density_on_lattice = kept
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    try:
        with hb.recording(grid, "hash_encode_multisample", model) as first, \
                stage_seconds(mesh_stages()) as secs, host_peak() as host:
            verts, faces, colors = extract.extract_mesh(
                model, MESH_RES, level, clean=True,
                decimate_target=MESH_DECIMATE,
                out_path=os.path.join(cli.exp_dir(run.cfg),
                                      "mesh_level.ply"))
    finally:
        extract.density_on_lattice = orig
    device_gib = (torch.cuda.max_memory_allocated(dev) - held) / 2 ** 30
    if len(faces) == 0 or colors is None or len(faces) > MESH_DECIMATE:
        fail(f"[16] mesh at level {level}: {len(verts)} vertices, "
             f"{len(faces)} faces")
    err = close("[16] lattice kernels on vs off",
                torch.from_numpy(lattice["grid"]),
                torch.from_numpy(grid_off), *LATTICE_TOL)
    colors_off = extract.rgb_by_projection(model, verts, faces,
                                           use_kernels=False)
    c_err = close("[16] vertex colours kernels on vs off",
                  torch.from_numpy(colors), torch.from_numpy(colors_off),
                  0.0, COLOR_TOL)
    print(f"[16] mesh at the lattice's {MESH_PERCENTILE} percentile "
          f"(level {level:.4g}; lattice max {float(grid_off.max()):.4g}, "
          f"median {float(np.median(grid_off)):.4g}; above 20: "
          f"{int((grid_off > 20).sum())} points): {len(verts)} vertices, "
          f"{len(faces)} faces; lattice kernels on vs off max abs err "
          f"{err:.3e}, colours {c_err:.3e}; stage s {json.dumps(secs)}, "
          f"lattice kernels off {off_s:.2f} s; peak memory device "
          f"{device_gib:.2f} GiB above the {held / 2 ** 30:.2f} held, host "
          f"{host['gib']:.2f} GiB resident "
          f"({host['gib'] - host['base_gib']:.2f} above the "
          f"{host['base_gib']:.2f} before it)")
    chunk = first["nerf"]
    del run, model, grid_off, lattice
    torch.cuda.empty_cache()

    def profiled():
        table, x01, stds, spec = chunk[:4]
        args = chunk
        ms = device_ms(lambda: grid.hash_encode_multisample(*args))
        # The plain encode by CUDA events, as [4] times it: its hundreds of
        # launches a call make torch.profiler's event lists take tens of
        # seconds.
        plain_ms = cuda_ms(lambda: grid.hash_encode_multisample_plain(
            *args), iters=5, warmup=1)
        lim = bound(*hb.fwd_bound(spec, x01, stds))
        err = close("[16] H1 on a lattice chunk",
                    grid.hash_encode_multisample(*args),
                    grid.hash_encode_multisample_plain(*args)[0], 1e-5, 1e-6)
        print(f"[16] H1 on the lattice's first chunk (NeRF grid, B="
              f"{stds.shape[0]} n={stds.shape[-1]}, stds 0): device ms "
              f"kernel {ms:.5f}, plain {plain_ms:.4f} (CUDA events); bound "
              f"{lim['bound_ms']:.5f} ms ({lim['bound_by']}); max abs err "
              f"{err:.3e}")
        return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, **lim)

    return dict(launches=launches, profiled=profiled)


def phase_object_entries(dev):
    """[16] On [12]'s scene and weights: `render_video --mode laneshift
    --num_frames 1`, once more with --hq, and `render_instance`, each with
    every H1 call held against its plain version and its launches counted;
    the laneshift frame kernels on vs off as [14] holds eval's view (all
    but TRAINED_SWEEP_SHARE of the values at [5]'s tolerances, the plain
    chain on the kernel render's final intervals at [5]'s on every value),
    the orbit views at [5]'s; s per frame and per view. Then `train
    --obj_ckpt` from a file of [12]'s object MLP (`save_obj_mlp_params`):
    the subtree equal to the file at step 0. Returns {path: launches}."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli, convert
    from nerf_lidar_tpu_torch.models import objects as objlib
    from nerf_lidar_tpu_torch.renderer import ChunkRenderer, render_view
    from nerf_lidar_tpu_torch.train import checkpoints, train_step

    params = os.path.join("exp", OBJ_EXP, f"params_{OBJ_STEPS}.npz")
    weights = ["--params", params]
    paths = {}
    for name, extra in (("render_video", []), ("render_video_hq", ["--hq"])):
        argv = ["render_video", *OBJ_ENTRY_ARGS, *weights, "--mode",
                "laneshift", "--num_frames", "1", *extra]
        with counted_launches() as launches, kernels_checked() as rec:
            run = cli.main(argv)
            torch.cuda.synchronize()
        need_launches(f"[16] {name}", launches, ["hash_encode_ms"],
                      absent=["composite"])
        paths[name] = launches
        rays = cli._view_rays(run.data, 0)
        frame_s = statistics.median(cuda_ms_once(lambda: render_view(
            run.renderer, rays, run.tracks, run.track_mask))[0] / 1e3
            for _ in range(3 if name == "render_video" else 1))
        print(f"[16] {name} --mode laneshift ({run.cfg.model.num_objects} "
              f"object(s), samples {run.cfg.model.num_prop_samples} + "
              f"{run.cfg.model.num_nerf_samples}): launches {launches}; "
              "every "
              f"H1 call vs its plain version, max abs err "
              f"{max(rec['h1']):.3e} ({len(rec['h1'])} calls); "
              f"{frame_s:.3f} s per frame ({rays['near'].size} rays, warm"
              f"{', median of 3' if name == 'render_video' else ''})")
        if name == "render_video":
            plain = ChunkRenderer(run.model, run.cfg,
                                  run.cfg.render_chunk_size,
                                  use_kernels=False, compute_extras=True)
            out = view_on_vs_off("[16] render_video frame 0", run.renderer,
                                 plain, rays, run.tracks, run.track_mask,
                                 run.cfg.model.num_levels)
            print(f"[16] render_video frame 0 kernels on vs off: max abs "
                  f"diff {out['errs']}, values outside [5]'s tolerances "
                  f"{out['outside']} (allowed {TRAINED_SWEEP_SHARE} of "
                  f"each); kernels on vs the plain chain on their final "
                  f"intervals {out['replay_errs']}")
        del run
        torch.cuda.empty_cache()

    argv = ["render_instance", *OBJ_ENTRY_ARGS, *weights]
    with counted_launches() as launches, kernels_checked() as rec:
        run = cli.main(argv)
        torch.cuda.synchronize()
    need_launches("[16] render_instance", launches, ["hash_encode_ms"],
                  absent=["composite"])
    paths["render_instance"] = launches
    n_views = len(run.frames)
    view_s, off = cuda_ms_once(lambda: objlib.render_instance(
        run.model, 0, num_views=n_views, use_kernels=False))
    on_s = cuda_ms_once(lambda: objlib.render_instance(
        run.model, 0, num_views=n_views))[0]
    err = close("[16] render_instance kernels on vs off",
                torch.from_numpy(run.frames), torch.from_numpy(off),
                0.0, 1e-4)
    if float(np.ptp(run.frames)) == 0.0:
        fail("[16] render_instance: every pixel of every view is equal")
    print(f"[16] render_instance ({n_views} views of "
          f"{run.frames.shape[1]} x {run.frames.shape[2]}): launches "
          f"{launches}; every H1 call vs its plain version, max abs err "
          f"{max(rec['h1']):.3e} ({len(rec['h1'])} calls); kernels on vs "
          f"off max abs diff {err:.3e}; {on_s / 1e3 / n_views:.4f} s per "
          f"view (plain {view_s / 1e3 / n_views:.4f})")

    # An object MLP of [12]'s field into a fresh run of the same recipe.
    name = next(n for n in convert.flax_module_names(run.model)
                if n.startswith("obj_mlp"))
    path = checkpoints.save_obj_mlp_params(
        run.model, name, os.path.join("exp", OBJ_EXP, f"{name}.ckpt"))
    want = {k: v.detach().clone() for k, v in run.model.state_dict().items()
            if convert.flax_module_of(k) == name}
    del run
    argv = [*OBJ_TRAIN_ARGV, "--exp_name", OBJ_CKPT_EXP, "--steps", "1",
            "--obj_ckpt", f"{name}={path}"]
    fresh_exp_dir(argv)
    seen = {}
    orig = train_step.train_step

    def first(model, *a, **kw):
        if not seen:
            seen.update({k: v.detach().clone()
                         for k, v in model.state_dict().items()
                         if convert.flax_module_of(k) == name})
        return orig(model, *a, **kw)

    train_step.train_step = first
    try:
        with counted_launches() as launches:
            run = cli.main(argv)
            torch.cuda.synchronize()
    finally:
        train_step.train_step = orig
    need_launches("[16] train --obj_ckpt", launches,
                  ["hash_encode_ms", "hash_encode_ms_bwd",
                   "scatter_add_rows"])
    paths["train_obj_ckpt"] = launches
    if run.init_step != 0 or set(seen) != set(want) or not all(
            torch.equal(seen[k], want[k]) for k in want):
        fail(f"[16] train --obj_ckpt {name}={path}: the subtree at step 0 "
             "differs from the file's")
    print(f"[16] train --obj_ckpt {name}={path}: {len(want)} tensors equal "
          f"to the file's at step 0; 1 step, loss "
          f"{run.history[-1]['loss'] if run.history else float('nan'):.4f};"
          f" launches {launches}")
    del run
    torch.cuda.empty_cache()
    return paths


# [18]: the rest of the field (Ref-NeRF heads, IDE, reflections, n . v,
# finite-difference density normals, GLO, a random background) on an LLFF
# capture through the COLMAP / llff loader, at the full width of
# `configs.Config()` ("default"), with the settings of multinerf's
# configs/blender_refnerf.gin for the normal losses; then a RawNeRF capture
# (mosaics, exposures, learned exposure scaling, the Bayer mask and the
# rawnerf data loss); then validate_scene. A capture carries no labels, so
# the semantic head is off (multinerf's Ref-NeRF has none): without labels
# it trains only through the semantic smoothness term, whose |difference|
# terms of a near-uniform softmax take either sign on a rounding, so that
# its gradients (~1e-9) differ in sign, kernels on vs off, beyond [8]'s
# 1e-3 of their largest value (5.7% measured, NVIDIA H100 80GB HBM3,
# 700.00 W).
REF_EXP = "chip_smoke_refnerf"
# Outside every experiment directory the phase trains in (a train entry
# starts from an empty one).
REF_DATA = os.path.join("exp", "chip_smoke_captures")
REF_CAPTURE = os.path.join(REF_DATA, "llff")
REF_RAW_CAPTURE = os.path.join(REF_DATA, "raw")
# An LLFF frame at factor 8 (4032 x 3024 / 8), 16 views around the scene.
REF_VIEWS = 16
REF_HW = (378, 504)
REF_STEPS = 30
REF_LEARN_STEPS = 60
REF_RAW_STEPS = 10
REF_SETS = [
    "dataset_loader=llff", "llffhold=8",
    "model.nerf_mlp.use_directional_enc=true",
    "model.nerf_mlp.use_reflections=true", "model.nerf_mlp.deg_view=5",
    "model.nerf_mlp.enable_pred_normals=true",
    "model.nerf_mlp.enable_pred_roughness=true",
    "model.nerf_mlp.use_diffuse_color=true",
    "model.nerf_mlp.use_specular_tint=true",
    "model.nerf_mlp.use_n_dot_v=true", "model.nerf_mlp.bottleneck_width=128",
    "model.nerf_mlp.net_depth_viewdirs=8",
    "model.nerf_mlp.disable_density_normals=false",
    "orientation_loss_mult=0.1", "orientation_coarse_loss_mult=0.01",
    "predicted_normal_loss_mult=3e-4",
    "predicted_normal_coarse_loss_mult=3e-5",
    "model.num_glo_features=64", "model.nerf_mlp.num_glo_features=64",
    "model.bg_intensity_range=(0,1)", "model.use_semantic=false",
    "model.nerf_mlp.use_semantic=false"]
REF_ARGS = ["--config", "default", "--data_dir", REF_CAPTURE,
            "--device", "cuda", *(a for kv in REF_SETS for a in ("--set", kv))]
REF_RAW_SETS = ["dataset_loader=llff", "llffhold=8", "rawnerf_mode=true",
                "data_loss_type=rawnerf",
                "model.learned_exposure_scaling=true",
                "apply_bayer_mask=true"]
REF_RAW_ARGS = ["--config", "default", "--data_dir", REF_RAW_CAPTURE,
                "--device", "cuda",
                *(a for kv in REF_RAW_SETS for a in ("--set", kv)),
                "--exp_name", REF_EXP + "_raw"]
# The parameters the train must give a gradient, beyond the hash tables.
REF_GRADS = ("glo_vecs.weight", "nerf_mlp.normal_layer.weight",
             "nerf_mlp.roughness_layer.weight",
             "nerf_mlp.glo_layers.0.weight")


def _nonzero_grads(model, names, what):
    params = dict(model.named_parameters())
    for name in names:
        g = params[name].grad
        if g is None or not float(g.abs().max()) > 0:
            fail(f"{what}: {name} got no gradient")


def _train_entry(dev, argv, what, steps):
    """The train entry on `argv` from a fresh experiment directory, with
    the kernel counts at 0 just before it: (run, launches, s, peak GiB),
    failing on a loss that is not finite or a step not logged."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli
    fresh_exp_dir(argv)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with counted_launches() as launches:
        run = cli.main(argv)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    hist = run.history
    if len(hist) != steps or not all(
            np.isfinite(h["loss"]) and np.isfinite(h["psnr"]) for h in hist):
        fail(f"{what}: {len(hist)} of {steps} steps logged, or a loss is "
             "not finite")
    return run, launches, seconds, \
        torch.cuda.max_memory_allocated(dev) / 2**30


def phase_refnerf(dev):
    """[18] The Ref-NeRF / GLO field on an LLFF capture and RawNeRF: writes
    the captures (`data/synth_llff.py`: REF_VIEWS views of REF_HW, PNG and
    a binary COLMAP sparse/0; the same scene as RGGB mosaics with EXIF
    sidecars), then `train --config default --set dataset_loader=llff`
    with REF_SETS for REF_STEPS steps at 16,384 rays a step (launches per
    step, warm ms/step, peak GiB, a gradient on every table and on
    REF_GRADS), 3 steps kernels on vs off under [8]'s rules, a
    REF_LEARN_STEPS-step learning check at lr 1e-2; `eval` on the llffhold
    split (s per view; the first view with every K1 and H1 call held
    against its plain version, kernels on vs off as [14]) and `render
    --path test --num_frames 1`; the RawNeRF train (REF_RAW_STEPS steps:
    its loss terms, a gradient on the exposure offsets) and eval (the
    exposure keys reach the model); `validate_scene` on [13]'s scene (no
    ERROR). Returns {"paths": {path: launches}, "profiled": a callable
    that times H1 / H1-bwd per grid, K1 and K3 on this path's own
    inputs}."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.data import synth_llff
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.models import model as model_lib
    from nerf_lidar_tpu_torch.ops import grid
    from nerf_lidar_tpu_torch.renderer import ChunkRenderer

    shutil.rmtree(REF_DATA, ignore_errors=True)
    t0 = time.perf_counter()
    h, w = REF_HW
    synth_llff.write_capture(REF_CAPTURE, num_views=REF_VIEWS, height=h,
                             width=w)
    synth_llff.write_capture(REF_RAW_CAPTURE, num_views=REF_VIEWS, height=h,
                             width=w, raw=True)
    print(f"[18] captures ({REF_VIEWS} views of {w} x {h}, PNG + COLMAP "
          f"sparse/0; RawNeRF mosaics + EXIF): "
          f"{time.perf_counter() - t0:.1f} s")
    paths = {}

    # Train.
    train_argv = ["train", *REF_ARGS, "--set", "print_every=1", "--steps",
                  str(REF_STEPS), "--exp_name", REF_EXP]
    run, launches, entry_s, peak = _train_entry(dev, train_argv,
                                                "[18] train", REF_STEPS)
    need_launches("[18] train", launches,
                  ("hash_encode_ms", "hash_encode_ms_bwd",
                   "scatter_add_rows"), ("composite",))
    paths["train_refnerf"] = launches
    _table_grads_nonzero(run.model, "[18] train")
    _nonzero_grads(run.model, REF_GRADS, "[18] train")
    hist = run.history
    step_ms = 1e3 * statistics.median(x["step_s"] for x in hist[-20:])
    rays = run.batcher.total_rays
    per_step = {k: v / REF_STEPS for k, v in launches.items()}
    terms = {k: round(v, 6) for k, v in hist[-1].items()
             if k in ("data", "orientation", "predicted_normals",
                      "interlevel", "distortion", "hash_decay")}
    print(f"[18] train (config default + Ref-NeRF / GLO / background, "
          f"llff capture, {rays} rays/step, {REF_STEPS} steps, cold, init "
          f"included): {entry_s:.2f} s; launches {launches} ({per_step} a "
          f"step); warm {step_ms:.1f} ms/step (median of the last 20), "
          f"{rays / step_ms * 1e3:,.0f} rays/s; peak memory {peak:.2f} GiB; "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; last "
          f"step's terms {terms}; a gradient on every table and on "
          f"{list(REF_GRADS)}")
    train_inputs = hb.record_train_inputs(run, REF_STEPS)
    on_off = train_on_vs_off(dev, run, REF_STEPS + 1, "[18] train step")
    print(f"[18] {ON_OFF_STEPS} steps kernels on vs off: {on_off}")
    del run
    torch.cuda.empty_cache()

    learn_argv = ["train", *REF_ARGS, "--set", "print_every=1", "--set",
                  "lr_delay_steps=0", "--steps", str(REF_LEARN_STEPS),
                  "--exp_name", REF_EXP + "_learn"]
    learn = _train_entry(dev, learn_argv, "[18] learning check",
                         REF_LEARN_STEPS)[0]
    data = [x["data"] for x in learn.history]
    first, last = float(np.mean(data[:5])), float(np.mean(data[-5:]))
    if not last < first:
        fail(f"[18] learning check: data loss {first} (first 5) -> {last} "
             "(last 5)")
    print(f"[18] learning check ({REF_LEARN_STEPS} steps at lr 1e-2, no "
          f"warm-up): data loss {first:.5f} (mean of first 5) -> "
          f"{last:.5f} (mean of last 5); psnr "
          f"{learn.history[0]['psnr']:.2f} -> "
          f"{learn.history[-1]['psnr']:.2f}")
    del learn
    torch.cuda.empty_cache()

    # Eval and render of the 30-step field.
    ev_argv = ["eval", *REF_ARGS, "--exp_name", REF_EXP]
    with counted_launches() as ev_launches:
        ev = cli.main(ev_argv)
        torch.cuda.synchronize()
    need_launches("[18] eval", ev_launches, ("composite", "hash_encode_ms"),
                  ("hash_encode_ms_bwd",))
    paths["eval_refnerf"] = ev_launches
    if not all(np.isfinite(v) for v in ev.metrics.values()):
        fail(f"[18] eval: metrics {ev.metrics}")
    n_views = ev.data.num_views
    print(f"[18] eval ({n_views} llffhold views of {ev.data.width} x "
          f"{ev.data.height}, step {ev.steps[-1]}): {ev.metrics} "
          f"({ev.metrics['median_render_time_s']:.3f} s/view, median); "
          f"launches {ev_launches}")
    view = cli._view_rays(ev.data, 0)
    plain = ChunkRenderer(ev.model, ev.cfg, ev.cfg.render_chunk_size,
                          use_kernels=False)
    on_off = view_on_vs_off("[18] eval view 0", ev.renderer, plain, view,
                            None, None, ev.cfg.model.num_levels)
    rec = on_off["rec"]
    print(f"[18] eval view 0: every call vs its plain version, max abs err "
          f"K1 {max(rec['k1']):.3e} ({len(rec['k1'])} calls), H1 "
          f"{max(rec['h1']):.3e} ({len(rec['h1'])} calls; 7 a chunk on the "
          f"NeRF grid: the point and its six normal offsets); kernels on "
          f"vs off, max abs diff {on_off['errs']}, values outside [5]'s "
          f"tolerances {on_off['outside']} (allowed {TRAINED_SWEEP_SHARE} "
          f"of each); kernels on vs the plain chain on their final "
          f"intervals, max abs diff {on_off['replay_errs']}")
    k1_args = rec["k1_args"]
    chunk = {k: np.asarray(v).reshape((-1,) + np.asarray(v).shape[2:])[
        :ev.cfg.render_chunk_size] for k, v in view.items()}
    with hb.recording(grid, "hash_encode_multisample", ev.model) as h1_in:
        ev.renderer.render(chunk)
        torch.cuda.synchronize()
    del on_off, plain
    render_argv = ["render", *REF_ARGS, "--exp_name", REF_EXP, "--path",
                   "test", "--num_frames", "1"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    with counted_launches() as rd_launches:
        rd = cli.main(render_argv)
        torch.cuda.synchronize()
    rd_s = time.perf_counter() - t
    need_launches("[18] render", rd_launches, ("hash_encode_ms",),
                  ("composite",))
    paths["render_refnerf"] = rd_launches
    frame = rd.frames[0]
    if not {"normals", "normals_pred", "acc"} <= set(frame) or not all(
            np.isfinite(v).all() for v in frame.values()):
        fail(f"[18] render: keys {sorted(frame)}, or a value not finite")
    print(f"[18] render --path test (compute_extras: the plain compositor, "
          f"normals composited): 1 frame in {rd_s:.2f} s with the entry's "
          f"start-up; launches {rd_launches}")
    del ev, rd
    torch.cuda.empty_cache()

    # RawNeRF.
    raw, raw_launches, raw_s, raw_peak = _train_entry(
        dev, ["train", *REF_RAW_ARGS, "--set", "print_every=1", "--steps",
              str(REF_RAW_STEPS)], "[18] rawnerf train", REF_RAW_STEPS)
    need_launches("[18] rawnerf train", raw_launches,
                  ("hash_encode_ms", "hash_encode_ms_bwd",
                   "scatter_add_rows"))
    paths["train_rawnerf"] = raw_launches
    _nonzero_grads(raw.model, ("exposure_scaling_offsets.weight",),
                   "[18] rawnerf train")
    offsets = raw.model.exposure_scaling_offsets.weight.detach()
    print(f"[18] rawnerf train ({REF_RAW_STEPS} steps, exposures "
          f"{sorted(set(raw.batcher.scene.exposure_values.tolist()))}): "
          f"{raw_s:.2f} s, peak {raw_peak:.2f} GiB; loss terms "
          f"{ {k: round(v, 6) for k, v in raw.history[-1].items()} }; "
          f"learned exposure offsets of index 1 "
          f"{offsets[1].tolist()}; launches {raw_launches}")
    del raw
    seen = []
    forward = model_lib.Model.forward

    def keys_seen(self, batch, *a, **kw):
        seen.append(set(batch))
        return forward(self, batch, *a, **kw)

    model_lib.Model.forward = keys_seen
    try:
        with counted_launches() as raw_ev_launches:
            rev = cli.main(["eval", *REF_RAW_ARGS])
            torch.cuda.synchronize()
    finally:
        model_lib.Model.forward = forward
    paths["eval_rawnerf"] = raw_ev_launches
    if not seen or not all({"exposure_values", "exposure_idx"} <= k
                           for k in seen) or not all(
            np.isfinite(v) for v in rev.metrics.values()):
        fail(f"[18] rawnerf eval: batch keys {seen[:1]}, metrics "
             f"{rev.metrics}")
    print(f"[18] rawnerf eval: {rev.metrics}; every one of {len(seen)} "
          f"chunks carried exposure_values and exposure_idx; launches "
          f"{raw_ev_launches}")
    del rev
    torch.cuda.empty_cache()

    report = cli.main(["validate_scene", RD_SCENE, "--sensor_num", "1"])
    if report.code != 0 or not report.report.ok:
        fail(f"[18] validate_scene {RD_SCENE}: "
             f"{[str(i) for i in report.report.issues]}")
    print(f"[18] validate_scene {RD_SCENE}: OK, "
          f"{len(report.report.issues)} warnings")

    def profiled():
        """H1 per grid on eval's first chunk, H1-bwd per grid on one train
        step, K1 on eval's first chunk, K3 at the NeRF table's hash-decay
        level sums: kernel device ms, plain ms, bound, error."""
        from nerf_lidar_tpu_torch.ops import render_fused
        out = dict(h1=time_preset_encodes(dev, "eval_refnerf", h1_in, True,
                                          "[18]"),
                   h1_bwd=time_preset_encodes(dev, "train_refnerf",
                                              train_inputs, False, "[18]"))
        err = check_composite("[18] eval chunk", k1_args)
        ms = device_ms(lambda: render_fused.fused_composite(**k1_args))
        plain_ms = cuda_ms(lambda: render_fused.fused_composite_plain(
            **k1_args), iters=5, warmup=1)
        out["k1"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                         **composite_bound(k1_args))
        table, spec = train_inputs["nerf"][0], train_inputs["nerf"][4]
        ids = grid.level_ids(spec, table.device)
        vals = table.detach() ** 2
        got = grid.scatter_add_rows(ids, vals, spec.num_levels)
        want = torch.stack([vals[o:o + r].double().sum(0) for o, r in zip(
            spec.offsets, spec.rows_per_level)])
        k3_err = float((got.double() - want).abs().max()
                       / want.abs().max())
        if not k3_err <= PATH_SCATTER_TOL:
            fail(f"[18] K3 on the NeRF table's level sums: {k3_err} of max "
                 "against float64")
        out["k3"] = dict(
            ms=device_ms(lambda: grid.scatter_add_rows(ids, vals,
                                                       spec.num_levels)),
            plain_ms=cuda_ms(lambda: grid.scatter_add_rows_plain(
                ids, vals, spec.num_levels), iters=5, warmup=1),
            max_rel_err=k3_err,
            **bound(nbytes(ids, vals) + spec.num_levels * spec.level_dim * 4,
                    vals.numel()))
        print(f"[18] K1 on eval's first chunk (R, S = "
              f"{tuple(k1_args['density'].shape)}): device {ms:.5f} ms, "
              f"plain {plain_ms:.4f} ms, bound "
              f"{out['k1']['bound_ms']:.5f} ms; max abs err {err:.3e}. K3 "
              f"at the NeRF table's level sums: device "
              f"{out['k3']['ms']:.4f} ms, plain {out['k3']['plain_ms']:.3f}"
              f" ms, bound {out['k3']['bound_ms']:.4f} ms; {k3_err:.2e} of "
              f"max against float64")
        return out

    return dict(paths=paths, profiled=profiled)


def phase_gathers(dev):
    """K2, K4's five forms and K5 vs their plain versions, exactly, at the
    TPU kernels' shapes, on in-range and on negative / out-of-range
    indices; device times of kernel, plain version and library call, and
    the bound. Returns {"K2" | "K4" | "K5": numbers of its kernels line};
    K4's are the sums over its forms 2-5 (form 1 is K2), each beside."""
    import torch
    from nerf_lidar_tpu_torch.experiments import gather_bench
    from nerf_lidar_tpu_torch.ops import tile_gather as tg

    g = torch.Generator(device=dev).manual_seed(10)
    forms = gather_bench.mosaic_forms(dev)
    k5 = "K5 (8,128) x 1024 tiles"
    forms[k5] = (tg.tile_grid_gather, tg.tile_grid_gather_plain, (
        torch.randn(8, 128, device=dev, generator=g),
        torch.randint(0, 128, (1024, 8, 128), device=dev, generator=g,
                      dtype=torch.int32)))
    # take_rows above the card's launch floor: the gather bench's row
    # gather (the finest hash level's 2^19 rows x 16 channels, 2^20
    # indices).
    big = "take rows (2^19,16)<-2^20"
    forms[big] = (tg.take_rows, tg.take_rows_plain, (
        torch.randn(2**19, 16, device=dev, generator=g),
        torch.randint(0, 2**19, (2**20,), device=dev, generator=g,
                      dtype=torch.int32)))
    result = {}
    for name, (fn, plain, args) in forms.items():
        tbl, idx, rest = args[0], args[1], args[2:]
        rows = fn is tg.take_rows
        axis = 0 if rows else (rest[0] if rest else 1)
        size = tbl.shape[axis]
        nan_share = 0.0
        for case in (idx, _bad_indices(idx, size, g)):
            got, want = fn(tbl, case, *rest), plain(tbl, case, *rest)
            torch.cuda.synchronize()
            if not tg.same_values(got, want):
                fail(f"gather {name}: the kernel differs from its plain "
                     f"version (indices in [{int(case.min())}, "
                     f"{int(case.max())}])")
            nan_share = float(got.isnan().float().mean())
        if not 0 < nan_share < 1:
            fail(f"gather {name}: the out-of-range case gave NaN share "
                 f"{nan_share}")
        idx64 = idx.long()
        if rows:
            library = lambda: tbl.index_select(0, idx)
            read = int(torch.unique(idx64).numel()) * tbl.shape[1]
        else:
            src = tbl if idx.dim() == 2 else tbl[None]
            library = lambda: torch.take_along_dim(src, idx64, dim=axis - 2)
            lanes = torch.arange(idx.shape[-2 + (1 - axis)], device=dev)
            lanes = lanes[:, None] if axis == 1 else lanes[None, :]
            flat = (lanes * tbl.shape[1] + idx64 if axis == 1
                    else idx64 * tbl.shape[1] + lanes)
            read = int(torch.unique(flat).numel())
        out = fn(tbl, idx, *rest)
        if not tg.same_values(library(), out):
            fail(f"gather {name}: the library call differs from the kernel")
        # Kernel and library call in turns (kernel, library, library,
        # kernel), 50 calls each: at the card's launch floor they move by
        # more between runs than they differ.
        kern = lambda: fn(tbl, idx, *rest)
        turns = [device_ms(f) for f in (kern, library, library, kern)]
        # Bound: the indices read, the output written, and the distinct
        # table entries the indices touch; no arithmetic.
        nums = dict(max_abs_err=0.0, ms=(turns[0] + turns[3]) / 2,
                    plain_ms=device_ms(lambda: plain(tbl, idx, *rest)),
                    library_ms=(turns[1] + turns[2]) / 2, turns=turns,
                    **bound(nbytes(idx, out) + 4 * read, 0))
        print(f"[10] {fn.__name__} {name}: idx {tuple(idx.shape)}, exact on "
              f"in-range and on out-of-range indices (NaN share "
              f"{nan_share:.3f}); device ms: kernel {nums['ms']:.5f}, plain "
              f"{nums['plain_ms']:.5f}, library {nums['library_ms']:.5f} "
              f"(kernel, library, library, kernel: {turns}); bound "
              f"{nums['bound_ms']:.6f} ({nums['bound_by']})")
        result[name] = nums
    # The card's launch floor: the device time of an empty kernel (one
    # block of 32 threads), which no launch beats (K2's bound is below it).
    from nerf_lidar_tpu_torch.ops import _build
    floor_ms = device_ms(lambda: _build.launch_empty(dev))
    print(f"[10] launch floor: an empty kernel takes {floor_ms:.5f} ms of "
          f"device time")
    k2 = "take_along_axis (8,128)"
    k4 = {k: v for k, v in result.items() if k not in (k2, k5, big)}
    sums = {key: sum(v[key] for v in k4.values())
            for key in ("max_abs_err", "ms", "plain_ms", "library_ms",
                        "bound_ms")}
    return {"K2": dict(result[k2], shape=k2, launch_floor_ms=floor_ms),
            "K4": dict(sums, bound_by="bytes", forms=k4,
                       take_rows_2e19x16_from_2e20=result[big]),
            "K5": dict(result[k5], shape=k5)}


BENCH_RATE_PROBES = 17
BENCH_FORMS = 5


def phase_gather_bench(dev):
    """The port's gather-bench entry at the JAX bench's sizes. Returns the
    launch counts of its run, by kernels-line entry."""
    import math
    from nerf_lidar_tpu_torch.experiments import gather_bench
    from nerf_lidar_tpu_torch.ops import tile_gather as tg

    counters = dict(tile_lane_gather=tg.tile_lane_gather,
                    take_along_axis=tg.take_along_axis,
                    take_rows=tg.take_rows,
                    tile_grid_gather=tg.tile_grid_gather)
    for fn in counters.values():
        fn.launches = 0
    recs = gather_bench.main(["--device", "cuda"])
    launches = {k: fn.launches for k, fn in counters.items()}
    rates = [r for r in recs if "rate_M_per_s" in r]
    forms = [r for r in recs if "result" in r]
    if len(rates) != BENCH_RATE_PROBES or len(forms) != BENCH_FORMS \
            or any(r["result"] != "ok" for r in forms):
        fail(f"gather_bench: {len(rates)} rate lines (want "
             f"{BENCH_RATE_PROBES}), forms {forms}")
    if not all(math.isfinite(r["rate_M_per_s"]) and r["rate_M_per_s"] > 0
               for r in rates):
        fail(f"gather_bench: a rate is not finite and positive: {rates}")
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched on the gather-bench path")
    print(f"[11] gather_bench: {len(rates)} probes and {len(forms)} kernel "
          f"forms; launches {launches}")

    # The bench times 20 chained iterations of eager torch ops, so the host
    # may bound a probe. The device time of one call of its central row
    # gather and scatter-add at the hash grid's size (2^19 x 16), alone, by
    # CUDA events: each call keeps the device busy (0.04-0.6 ms) longer than
    # its launch takes, and torch.profiler sessions this late in the
    # process lose launches.
    import torch
    g = torch.Generator(device=dev).manual_seed(11)
    rows, c = 2**19, 16
    tbl = torch.randn(rows, c, device=dev, generator=g)
    idx = torch.randint(0, rows, (2**20,), device=dev, generator=g,
                        dtype=torch.int32)
    vals = torch.randn(2**18, c, device=dev, generator=g)
    lanes = tbl.T.contiguous()  # [C, R], the JAX production layout
    calls = {
        "gather_row N=2^20 (index_select dim 0)":
            (2**20, lambda: tbl.index_select(0, idx)),
        "gather_lane N=2^20 (index_select dim 1 of [C, R])":
            (2**20, lambda: lanes.index_select(1, idx)),
        "scatter_row N=2^18 (zeros + index_add_ dim 0)":
            (2**18, lambda: tbl.new_zeros(rows, c).index_add_(
                0, idx[:2**18], vals)),
    }
    for name, (n, fn) in calls.items():
        ms = cuda_ms(fn)
        print(f"[11] device time, R=2^19 C=16 {name}: {ms:.4f} ms, "
              f"{n / ms / 1e3:,.0f} M indices/s")
    return dict(tile_lane_gather=launches["tile_lane_gather"],
                mosaic_gather_forms=launches["take_along_axis"]
                + launches["take_rows"],
                tile_grid_gather=launches["tile_grid_gather"])


# [19]: determinism. H1-bwd's deterministic d_table against its float and
# plain twins: 4096 float32 eps of each entry's summed |terms| plus half a
# quantum (2^-k of its level and channel) per written-out term against
# the float sum of the same terms (the written-out backward, index_add_),
# plus one quantum per term against the plain deterministic twin, which
# rounds the same merged terms (each side once; a term's float value may
# differ by the kernel's fused multiply-adds). K3's deterministic variant
# rounds the same float32 values as its plain twin, with no product
# before, so it must equal the twin bit for bit, and lie within half a
# quantum a term of the float64 sum, plus the sum's one rounding to
# float32 (half its float32 ulp) and float64's own (2^-53 of the terms a
# term). The d_x01 / d_stds gather pass sums in float32, as the atomic
# kernel does: [6]'s BWD_TOL of max against the plain version.
DET_EPS_MULT = 4096
DET_STEPS = 10
DET_OBJ_STEPS = 5
DET_FAST_STEPS = 5
DET_RD_EPOCHS = 1  # 2 epochs of [13]'s 7 training sweeps: 4 steps
DET_TRAIN = {
    "static": ["train", "--config", "nuscenes_single", "--set",
               "dataset_loader=synthetic", "--steps", str(DET_STEPS)],
    "objects": ["train", "--config", "nuscenes_single", "--set",
                "dataset_loader=nusc", "--data_dir", OBJ_SCENE, "--set",
                "track_start_opt=0", "--steps", str(DET_OBJ_STEPS)],
    "fast": ["train", "--config", "nuscenes_single_fast", "--set",
             "dataset_loader=synthetic", "--steps", str(DET_FAST_STEPS)],
}
DET_COMMON = ["--set", "print_every=1", "--device", "cuda"]
# Keys of a train entry's history that are times, not results.
DET_TIME_KEYS = ("step_s", "rays_per_sec")


def det_within(name, got, want, terms, counts, quantum, per_term):
    """max (|got - want| - 4096 eps32 terms) / quantum over the entries, and
    the count of entries that differ at all; fails where |got - want|
    exceeds 4096 eps32 terms + per_term quanta per term."""
    import torch
    err = (got.double() - want.double()).abs()
    allowed = DET_EPS_MULT * EPS32 * terms + per_term * quantum * counts
    bad = err > allowed
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        fail(f"{name}: {int(bad.sum())} of {got.numel()} entries outside "
             f"{DET_EPS_MULT} eps of their terms + {per_term} quantum a "
             f"term (worst excess {float((err - allowed).max())})")
    beyond = ((err - DET_EPS_MULT * EPS32 * terms) / quantum).clamp(min=0)
    return dict(max_abs_err=float(err.max()),
                quanta_beyond_eps=float(beyond.max()),
                entries_differing=int((err > 0).sum()))


def det_exact_within(name, got, exact, terms, counts, quantum):
    """Fails unless |got - exact| <= quantum counts / 2 + half got's float32
    ulp + 2^-53 terms counts (exact: the float64 sum). Returns the worst
    error, and in float32 ulps beyond the quanta."""
    import torch
    err = (got.double() - exact.double()).abs()
    mag = got.abs()
    ulp = (torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
           ).double().clamp(min=2.0**-149)
    allowed = 0.5 * quantum * counts + 0.5 * ulp + 2.0**-53 * terms * counts
    bad = err > allowed
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        fail(f"{name}: {int(bad.sum())} of {got.numel()} entries outside "
             f"half a quantum a term + half a float32 ulp (worst excess "
             f"{float((err - allowed).max())})")
    beyond = ((err - 0.5 * quantum * counts).clamp(min=0) / ulp)
    return dict(max_abs_err=float(err.max()),
                ulps_beyond_quanta=float(beyond.max()),
                entries_differing=int((err > 0).sum()))


def same_values(name, got, want):
    """Fails unless got equals want bit for bit (NaN where NaN)."""
    import torch
    if got.shape != want.shape or not bool(
            (torch.eq(got, want) | (torch.isnan(got) & torch.isnan(want)))
            .all()):
        fail(f"{name}: not bit-identical ("
             f"{int((got != want).sum())} entries differ)")


def short_spans(spans):
    """device_spans' {name: ms} with names cut before their argument list,
    largest first, rounded for printing."""
    out = {}
    for name, ms in spans.items():
        key = (name.removeprefix("void ")
               .replace("(anonymous namespace)::", "")
               .replace("at::native::", "").split("(")[0][:60].strip())
        out[key] = out.get(key, 0.0) + ms
    return {k: round(v, 4) for k, v in sorted(out.items(),
                                              key=lambda kv: -kv[1])}


@contextlib.contextmanager
def det_switch(fill):
    """torch's deterministic algorithms on within the block, with
    `torch.utils.deterministic.fill_uninitialized_memory` = fill (torch's
    default under the switch: True, every torch.empty filled)."""
    import torch
    from torch.utils import deterministic
    was = (torch.are_deterministic_algorithms_enabled(),
           deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    deterministic.fill_uninitialized_memory = fill
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0])
        deterministic.fill_uninitialized_memory = was[1]


def det_turns(det, atomic, iters, full):
    """Device ms of det and atomic: with full, in turns (det, atomic,
    atomic, det) and det also under the switch with and without the fill
    of uninitialized memory; else once each. Returns {"det": [ms],
    "atomic": [ms], "det_split": det's first turn by kernel, and with full
    "switch_fill" / "switch_no_fill": {kernel: ms}}."""
    out = {"det": [], "atomic": []}
    for name in ("det", "atomic", "atomic", "det")[:4 if full else 2]:
        spans = device_spans(det if name == "det" else atomic, iters)
        out[name].append(round(sum(spans.values()), 4))
        if name == "det" and "det_split" not in out:
            out["det_split"] = short_spans(spans)
    for fill in (True, False) if full else ():
        with det_switch(fill):
            out["switch_fill" if fill else "switch_no_fill"] = short_spans(
                device_spans(det, iters))
    return out


def same_bits(name, runs):
    """Fails unless every tensor of every run equals the first run's."""
    import torch
    for i, run in enumerate(runs[1:], 1):
        for a, b in zip(runs[0], run):
            if (a is None) != (b is None) or (
                    a is not None and not torch.equal(a, b)):
                fail(f"{name}: run {i} differs from run 0")


def det_bwd_grid(dev, name, args, cutoff, full):
    """[19] H1-bwd's deterministic d_table on one grid's recorded train
    inputs: bit-identical on 3 fresh copies and in both block orders,
    against its float twin (and, with full, its plain deterministic twin),
    the bound S and quantum per level, device ms beside the atomic
    kernel's (with full, in turns and under the switch, `det_turns`) and
    by kernel, the bound, the peak memory of a call."""
    import torch
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.ops import grid
    table, x01, stds, g_out, spec = args
    only = (True, False, False)
    runs = [grid.hash_encode_multisample_bwd_det(
        *(t.clone() for t in args[:4]), spec, only, cutoff,
        level_major_order=order) for order in (None, None, None, True, False)]
    same_bits(f"hash_encode_ms_bwd_det {name} (3 copies, both orders)", runs)
    got = runs[0][0]
    del runs
    terms, counts = grid.table_grad_terms(x01, stds, g_out, spec, cutoff)
    quantum = grid.table_grad_quantum(g_out, spec)
    twin_ms, float_twin = cuda_ms_once(
        lambda: grid.hash_encode_multisample_bwd_plain(
            *args, only, cutoff)[0])
    vs_float = det_within(f"hash_encode_ms_bwd_det {name} vs float twin",
                          got, float_twin, terms, counts, quantum, 0.5)
    del float_twin
    det_twin_ms = vs_twin = None
    if full:
        det_twin_ms, twin = cuda_ms_once(
            lambda: grid.hash_encode_multisample_bwd_det_plain(
                *args, only, cutoff)[0])
        vs_twin = det_within(f"hash_encode_ms_bwd_det {name} vs det twin",
                             got, twin, terms, counts, quantum, 1.0)
        del twin
    atomic = grid.hash_encode_multisample_bwd(*args, only, cutoff)[0]
    vs_atomic = rel_err(f"hash_encode_ms_bwd_det {name} vs atomic", got,
                        atomic, BWD_TOL)
    del atomic, terms, counts
    bound_s = grid._abs_bound(g_out.reshape(-1, spec.output_dim)).reshape(
        spec.num_levels, spec.level_dim).amax(-1)
    k = grid.fixed_exponents(bound_s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    grid.hash_encode_multisample_bwd_det(*args, only, cutoff)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - held
    turns = det_turns(
        lambda: grid.hash_encode_multisample_bwd_det(*args, only, cutoff),
        lambda: grid.hash_encode_multisample_bwd(*args, only, cutoff), 5,
        full)
    lim = bound(*hb.bwd_bound(spec, x01, stds, g_out, cutoff))
    out = dict(max_abs_err=vs_float["max_abs_err"],
               ms=statistics.fmean(turns["det"]), plain_ms=twin_ms,
               det_plain_ms=det_twin_ms,
               atomic_ms=statistics.fmean(turns["atomic"]), library_ms=None,
               **lim, turns=turns, vs_float_twin=vs_float,
               vs_det_twin=vs_twin, vs_atomic_rel=vs_atomic[1],
               bound_s=[float(v) for v in bound_s],
               quantum=[float(2.0 ** -int(e)) for e in k],
               peak_gib=peak / 2**30, mode=encode_mode(spec, cutoff))
    print(f"[19] hash_encode_ms_bwd_det {name} ({out['mode']}, B="
          f"{stds.shape[0]}): same bits on 3 copies and both orders; vs "
          f"float twin {vs_float}, vs det twin {vs_twin}, vs atomic "
          f"{vs_atomic[1]:.2e} of max; S per level {out['bound_s']}, quantum "
          f"{out['quantum']}; device ms in turns: det {turns['det']}, atomic "
          f"{turns['atomic']}; det by kernel {turns['det_split']}; under "
          f"the switch {turns.get('switch_fill')}, without its fill "
          f"{turns.get('switch_no_fill')}; bound {lim['bound_ms']:.4f} "
          f"({lim['bound_by']}); float twin {twin_ms:.1f} ms, det twin "
          f"{det_twin_ms} ms (CUDA events); peak {out['peak_gib']:.3f} GiB "
          f"a call")
    return out


def det_pos_grads(dev, name, rec):
    """[19] The deterministic d_x01 / d_stds pass (`hash_encode_ms_pos_grads`:
    a gather, one thread a sample, no atomics) on a train step's recorded
    call `rec`: the same bits on 3 fresh copies, against the plain version
    and the atomic kernel at [6]'s BWD_TOL of max (an all-zero gradient
    exactly), device ms in turns with the atomic kernel's (`queued_ms`:
    torch.profiler records no activity of these calls late in the
    script), the bound (the encode's bytes, d_x01 and d_stds written; a
    multiply-add per corner channel)."""
    import torch
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.ops import grid
    args = tuple(t.to(dev) for t in rec[:4])
    spec = rec[4]
    cutoff = rec[6] if len(rec) > 6 else 0
    x01, stds = args[1], args[2]
    asked = (False, True, True)
    runs = [grid.hash_encode_multisample_bwd_det(
        *(t.clone() for t in args), spec, asked, cutoff)[1:]
        for _ in range(3)]
    same_bits(f"hash_encode_ms_pos_grads {name} (3 copies)", runs)
    got = runs[0]
    plain_ms, plain = cuda_ms_once(
        lambda: grid.hash_encode_multisample_bwd_plain(
            *args, spec, asked, cutoff)[1:])
    atomic = grid.hash_encode_multisample_bwd(*args, spec, asked, cutoff)[1:]
    errs = {}
    for i, key in enumerate(GRADS[1:]):
        for what, want in (("plain", plain[i]), ("atomic", atomic[i])):
            label = f"hash_encode_ms_pos_grads {name} {key} vs {what}"
            if not bool(want.any()):
                same_values(label, got[i], want)
                errs[f"{key} vs {what}"] = 0.0
            else:
                errs[f"{key} vs {what}"] = rel_err(label, got[i], want,
                                                   BWD_TOL)[1]
    del runs, got, plain
    det = lambda: grid.hash_encode_multisample_bwd_det(*args, spec, asked,
                                                       cutoff)
    atomic = lambda: grid.hash_encode_multisample_bwd(*args, spec, asked,
                                                      cutoff)
    turns = {"det": [], "atomic": []}
    for turn in ("det", "atomic", "atomic", "det"):
        turns[turn].append(queued_ms(det if turn == "det" else atomic))
    n_bytes, flops = hb.fwd_bound(spec, x01, stds, cutoff)
    lim = bound(n_bytes + nbytes(x01, stds), flops)
    n = stds.shape[-1]
    mean = lambda v: None if None in v else statistics.fmean(v)
    out = dict(max_abs_err=max(errs.values()), ms=mean(turns["det"]),
               plain_ms=plain_ms, atomic_ms=mean(turns["atomic"]),
               library_ms=None, **lim, errs=errs, turns=turns,
               mode=encode_mode(spec, cutoff), B=stds.numel() // n, n=n)
    print(f"[19] hash_encode_ms_pos_grads {name} ({out['mode']}; "
          f"B={out['B']} n={n}): same bits on 3 copies; errors (of max) "
          f"{errs}; device ms in turns (CUDA events, calls queued behind a "
          f"device sleep): det {turns['det']}, atomic {turns['atomic']}; "
          f"plain {plain_ms:.1f} ms (CUDA events); "
          f"bound {lim['bound_ms']:.5f} ({lim['bound_by']})")
    return out


def det_scatter(dev, name, idx, vals, rows, full):
    """[19] K3's deterministic variant: bit-identical on 3 fresh copies and
    to its plain twin, within half a quantum a term (and the sum's rounding
    to float32) of float64, device ms beside the atomic K3's (with full,
    in turns and under the switch, `det_turns`) and by kernel, `index_add_`
    under torch's deterministic algorithms, and the bound."""
    import torch
    from nerf_lidar_tpu_torch.ops import grid
    runs = [(grid.scatter_add_rows_det(idx.clone(), vals.clone(), rows),)
            for _ in range(3)]
    same_bits(f"scatter_add_rows_det {name} (3 copies)", runs)
    got = runs[0][0]
    ok = (idx >= 0) & (idx < rows)
    i64 = idx[ok].long()
    terms = torch.zeros(rows, vals.shape[1], dtype=torch.float64,
                        device=dev).index_add_(0, i64, vals[ok].abs().double())
    counts = torch.zeros(rows, 1, dtype=torch.float64, device=dev).index_add_(
        0, i64, torch.ones(len(i64), 1, dtype=torch.float64, device=dev))
    quantum = torch.exp2(-grid.fixed_exponents(grid._abs_bound(vals))
                         .double()).expand(rows, -1)
    exact = grid.scatter_add_rows_plain(idx, vals.double(), rows)
    plain_ms, twin = cuda_ms_once(
        lambda: grid.scatter_add_rows_det_plain(idx, vals, rows))
    vs_exact = det_exact_within(f"scatter_add_rows_det {name} vs float64",
                                got, exact, terms, counts, quantum)
    same_values(f"scatter_add_rows_det {name} vs det twin", got, twin)
    del exact, twin, terms, counts
    turns = det_turns(lambda: grid.scatter_add_rows_det(idx, vals, rows),
                      lambda: grid.scatter_add_rows(idx, vals, rows), 20,
                      full)
    ids64 = idx.long().clamp(0, rows - 1)
    keep = ok[:, None].to(vals.dtype)
    kept = vals * keep
    with det_switch(True):
        library_ms = device_ms(lambda: vals.new_zeros(
            rows, vals.shape[1]).index_add_(0, ids64, kept), iters=5)
    lim = bound(nbytes(idx, vals, got), vals.numel())
    out = dict(max_abs_err=vs_exact["max_abs_err"],
               ms=statistics.fmean(turns["det"]), plain_ms=plain_ms,
               atomic_ms=statistics.fmean(turns["atomic"]),
               library_ms=library_ms, **lim, turns=turns,
               vs_float64=vs_exact, vs_det_twin="bit-identical")
    print(f"[19] scatter_add_rows_det {name} (N={vals.shape[0]} onto {rows},"
          f" C{vals.shape[1]}): same bits on 3 copies and as its det twin; "
          f"vs float64 {vs_exact}; device ms in turns: det {turns['det']}, "
          f"atomic {turns['atomic']}; det by kernel {turns['det_split']}; "
          f"under the switch {turns.get('switch_fill')}, without its fill "
          f"{turns.get('switch_no_fill')}; index_add_ (deterministic) "
          f"{library_ms:.4f}; bound {lim['bound_ms']:.4f} ({lim['bound_by']})"
          f"; plain twin {plain_ms:.1f} ms (CUDA events)")
    return out


def _train_state(run):
    """[(name, tensor)] of a train entry's result: parameters and buffers
    (model, posenet, tracknet), each Adam group's moments and step."""
    out = []
    for prefix, mod in (("model", run.model), ("posenet", run.posenet),
                        ("tracknet", run.tracknet)):
        if mod is not None:
            out += [(f"{prefix}.{k}", v.detach().clone())
                    for k, v in mod.state_dict().items()]
    for group in run.optimizer.param_groups:
        for i, p in enumerate(group["params"]):
            for key, v in run.optimizer.state.get(p, {}).items():
                out.append((f"adam.{group['name']}.{i}.{key}",
                            v.detach().clone()))
    return out


def _two_run_diff(a, b):
    """(bit-identical?, max abs difference) of two runs' [(name, tensor)]
    states and histories."""
    import torch
    sa, ha = a
    sb, hb_ = b
    if [k for k, _ in sa] != [k for k, _ in sb]:
        fail(f"two runs hold different tensors: {len(sa)} vs {len(sb)}")
    same = all(torch.equal(x, y) for (_, x), (_, y) in zip(sa, sb))
    diff = max((float((x.double() - y.double()).abs().max())
                for (_, x), (_, y) in zip(sa, sb) if x.numel()), default=0.0)
    strip = lambda h: [{k: v for k, v in row.items()
                        if k not in DET_TIME_KEYS} for row in h]
    same_hist = strip(ha) == strip(hb_)
    loss_diff = max(abs(x["loss"] - y["loss"]) for x, y in zip(ha, hb_))
    return same and same_hist, max(diff, loss_diff)


def _det_counters():
    from nerf_lidar_tpu_torch.ops import grid
    return dict(hash_encode_ms_bwd=(grid.hash_encode_multisample_bwd,
                                    "launches"),
                hash_encode_ms_bwd_det=(grid.hash_encode_multisample_bwd_det,
                                        "launches"),
                hash_encode_ms_pos_grads=(
                    grid.hash_encode_multisample_bwd_det,
                    "position_launches"),
                scatter_add_rows=(grid.scatter_add_rows, "launches"),
                scatter_add_rows_det=(grid.scatter_add_rows_det, "launches"))


def det_train_run(dev, key, argv, deterministic, tag):
    """One run of a train argv in a fresh directory, with or without
    --deterministic: (its [(name, tensor)] state, history, ms/step of its
    later half, peak GiB, launches)."""
    import torch
    from nerf_lidar_tpu_torch import cli
    counters = _det_counters()
    exp = f"chip_smoke_det_{key}_{tag}"
    full = [*argv, *DET_COMMON, "--exp_name", exp,
            *(["--deterministic"] if deterministic else [])]
    fresh_exp_dir(full)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    run = cli.main(full)
    torch.cuda.synchronize()
    if torch.are_deterministic_algorithms_enabled():
        fail("the train entry left torch's deterministic switch on")
    peak = (torch.cuda.max_memory_allocated(dev) - held) / 2**30
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    hist = run.history
    ms = 1e3 * statistics.median(h["step_s"] for h in hist[len(hist) // 2:])
    out = (_train_state(run), run.history, ms, peak, launches)
    del run
    torch.cuda.empty_cache()
    return out


def det_train_pair(dev, key, argv, deterministic):
    """Two runs of one train argv (fresh directories), with or without
    --deterministic: (bit-identical?, max difference, ms/step of the
    first run's later half, its peak GiB, launches of the first run, the
    first run's (state, history))."""
    mode = "det" if deterministic else "def"
    first = det_train_run(dev, key, argv, deterministic, f"{mode}0")
    second = det_train_run(dev, key, argv, deterministic, f"{mode}1")
    same, diff = _two_run_diff(first[:2], second[:2])
    return same, diff, first[2], first[3], first[4], first[:2]


def det_raydrop_pair(dev, feats, deterministic):
    """Two raydrop_train runs of [13]'s features (VGG loss): (bit-identical
    U-Net state, Adam moments and history?, max difference)."""
    import torch
    from nerf_lidar_tpu_torch import cli
    runs = []
    for i in range(2):
        exp = f"chip_smoke_det_raydrop_{'det' if deterministic else 'def'}{i}"
        shutil.rmtree(os.path.join("exp", exp), ignore_errors=True)
        rd = cli.main(["raydrop_train", "--features", feats, "--exp_name",
                       exp, "--epochs", str(DET_RD_EPOCHS), "--batch_size",
                       "4", "--device", "cuda",
                       *(["--deterministic"] if deterministic else [])])
        torch.cuda.synchronize()
        state = [(k, v.detach().clone())
                 for k, v in rd.state.model.state_dict().items()]
        for i_p, p in enumerate(rd.state.model.parameters()):
            for key, v in rd.state.optimizer.state.get(p, {}).items():
                state.append((f"adam.{i_p}.{key}", v.detach().clone()))
        runs.append((state, rd.history))
        steps = sum(h["steps"] for h in rd.history)
        del rd
    same, diff = _two_run_diff(*runs)
    return same, diff, steps


def phase_determinism(dev, train_inputs, pos_inputs):
    """[19] The deterministic mode: H1-bwd's and K3's deterministic kernels
    on [8]'s recorded train inputs (and K3's own shape), the d_x01 / d_stds
    pass on `pos_inputs` ({name: a train step's recorded encode backward
    call}: [12]'s object grid, [15]'s `_fast` NeRF grid with its
    mean-point levels), then `train --deterministic` twice per path (static
    nuscenes_single, [12]'s object scene with track refinement,
    nuscenes_single_fast; the static path once more without torch's fill
    of uninitialized memory) and `raydrop_train --deterministic` twice,
    each beside the default mode's two runs (the evidence that the check
    sees a difference; not a failure condition). Returns the
    "deterministic" numbers of the kernels line and the launches by
    path."""
    import torch
    from torch.utils import deterministic as torch_det
    from nerf_lidar_tpu_torch.ops import grid

    bwd_grids, k3_grids, pos = {}, {}, {}
    for name, rec in train_inputs.items():
        table, x01, stds, g_out, spec = rec[:5]
        cutoff = rec[6] if len(rec) > 6 else 0
        bwd_grids[name] = det_bwd_grid(dev, name,
                                       (table, x01, stds, g_out, spec),
                                       cutoff, full=name == "nerf")
        k3_grids[name] = det_scatter(dev, f"hash decay {name}",
                                     grid.level_ids(spec, dev), table**2,
                                     spec.num_levels, full=name == "nerf")
        torch.cuda.empty_cache()
    for name, rec in pos_inputs.items():
        pos[name] = det_pos_grads(dev, name, rec)
        torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(19)
    rows, n = 1 << 17, 1 << 22
    idx = torch.randint(0, rows, (n,), device=dev, generator=g,
                        dtype=torch.int32)
    k3_own = det_scatter(dev, f"rows={rows} N={n}", idx,
                         torch.randn(n, 16, device=dev, generator=g), rows,
                         full=True)
    del idx

    paths, train = {}, {}
    for key, argv in DET_TRAIN.items():
        res = {}
        for det in (True, False):
            same, diff, ms, peak, launches, first = det_train_pair(
                dev, key, argv, det)
            res["det" if det else "default"] = dict(
                bit_identical=same, max_diff=diff, ms_per_step=ms,
                peak_gib=peak)
            if det:
                if not same:
                    fail(f"train --deterministic ({key}): two runs differ "
                         f"(max difference {diff})")
                if launches["hash_encode_ms_bwd"] or \
                        launches["scatter_add_rows"]:
                    fail(f"train --deterministic ({key}) launched an "
                         f"atomic kernel: {launches}")
                need = ["hash_encode_ms_bwd_det", "scatter_add_rows_det"]
                if key == "objects":
                    need.append("hash_encode_ms_pos_grads")
                need_launches(f"train --deterministic ({key})", launches,
                              need)
                paths[f"train_{key}_deterministic"] = launches
                if key == "static":
                    torch_det.fill_uninitialized_memory = False
                    try:
                        nofill = det_train_run(dev, key, argv, True,
                                               "det_nofill")
                    finally:
                        torch_det.fill_uninitialized_memory = True
                    res["det_no_fill"] = dict(
                        same_as_filled=_two_run_diff(first, nofill[:2])[0],
                        ms_per_step=nofill[2], peak_gib=nofill[3])
                    del nofill
            elif launches["hash_encode_ms_bwd_det"] or \
                    launches["scatter_add_rows_det"]:
                fail(f"train ({key}) without the switch launched a "
                     f"deterministic kernel: {launches}")
            del first
        train[key] = res
        print(f"[19] train {key}: --deterministic twice: bit-identical "
              f"{res['det']['bit_identical']} (max diff "
              f"{res['det']['max_diff']}), {res['det']['ms_per_step']:.1f} "
              f"ms/step, peak {res['det']['peak_gib']:.2f} GiB; default "
              f"twice: bit-identical {res['default']['bit_identical']} (max "
              f"diff {res['default']['max_diff']:.3e}), "
              f"{res['default']['ms_per_step']:.1f} ms/step, peak "
              f"{res['default']['peak_gib']:.2f} GiB; launches "
              f"{paths[f'train_{key}_deterministic']}")
        if "det_no_fill" in res:
            nf = res["det_no_fill"]
            print(f"[19] train {key} --deterministic without torch's fill of "
                  f"uninitialized memory: {nf['ms_per_step']:.1f} ms/step, "
                  f"peak {nf['peak_gib']:.2f} GiB, the same bits as with it: "
                  f"{nf['same_as_filled']}")

    feats = os.path.join("exp", RD_EXP, "features.npy")
    if not os.path.exists(feats):
        fail(f"[19] needs [13]'s features at {feats}")
    rd = {}
    for det in (True, False):
        same, diff, steps = det_raydrop_pair(dev, feats, det)
        rd["det" if det else "default"] = dict(bit_identical=same,
                                               max_diff=diff, steps=steps)
    if not rd["det"]["bit_identical"]:
        fail(f"raydrop_train --deterministic: two runs differ (max "
             f"difference {rd['det']['max_diff']})")
    print(f"[19] raydrop_train ({rd['det']['steps']} steps, VGG): "
          f"--deterministic twice bit-identical; default twice: "
          f"bit-identical {rd['default']['bit_identical']} (max diff "
          f"{rd['default']['max_diff']:.3e})")

    by_path = lambda name: {p: c[name] for p, c in paths.items()}
    bwd = dict(bwd_grids["nerf"], grids=bwd_grids,
               launches=sum(by_path("hash_encode_ms_bwd_det").values()),
               launches_by_path=by_path("hash_encode_ms_bwd_det"),
               source=KERNEL_SOURCE, train=train, raydrop=rd,
               pos_grads=dict(
                   pos["object grid"], grids=pos,
                   launches=sum(by_path("hash_encode_ms_pos_grads").values()),
                   launches_by_path=by_path("hash_encode_ms_pos_grads")))
    k3 = dict(k3_grids["nerf"], grids=k3_grids,
              launches=sum(by_path("scatter_add_rows_det").values()),
              launches_by_path=by_path("scatter_add_rows_det"),
              source=KERNEL_SOURCE,
              k3_shape_rows131072_n4194304_c16=k3_own)
    return dict(hash_encode_ms_bwd=bwd, scatter_add_rows=k3)


def main():
    if "--dp_rank" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        dp_rank(int(args["--dp_rank"]), int(args["--dp_world"]),
                int(args["--dp_port"]))
        return
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not os.path.isdir(os.path.join(HERE, "nerf_lidar_tpu_torch")):
        fail(f"no nerf_lidar_tpu_torch package beside {__file__}: run it "
             "from a checkout of the repository")
    os.chdir(HERE)
    sys.path.insert(0, HERE)
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.ops import _build

    # [1] device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1] device: {kind}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # [2] build
    t0 = time.perf_counter()
    _build.library()
    print(f"[2] built {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s")

    cfg = cli.build_config(cli.parse_args(SLICE_ARGV))
    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"    ({name}: {time.perf_counter() - t:.1f} s)")
        return out

    k1_err = timed("[3]", phase_composite, dev)
    render_launches, render_inputs = timed("[5]", phase_slice, dev)
    h1 = timed("[4]", phase_hash_encode, dev, cfg, render_inputs)
    del render_inputs
    train_launches, params, train_inputs = timed("[8]", phase_train, dev)
    objects = timed("[12]", phase_objects, dev)
    raydrop_launches = timed("[13]", phase_raydrop, dev)
    eval_launches = timed("[14]", phase_eval, dev)
    presets = timed("[15]", phase_presets, dev)
    mesh = timed("[16] extract", phase_extract, dev, params)
    obj_entries = timed("[16] object entries", phase_object_entries, dev)
    dp_launches, dp_summary = timed("[17]", phase_data_parallel, dev)
    print(f"[17] {dp_summary}")
    refnerf = timed("[18]", phase_refnerf, dev)
    obj_grid = timed("[12] profiled", objects.pop("profiled"))
    timed("[15] profiled", presets.pop("profiled"))
    lattice_chunk = timed("[16] profiled", mesh.pop("profiled"))
    ref_kernels = timed("[18] profiled", refnerf.pop("profiled"))
    timed("[8] profiled", phase_train_trace, dev)
    h1_bwd = timed("[6]", phase_hash_encode_bwd, dev, cfg, train_inputs)
    k3_path, k3_own = timed("[7]", phase_scatter, dev, cfg)
    k1 = timed("[3] timing", time_composite, dev, k1_err)
    k1_trained = timed("[9]", phase_train_to_render, dev, params)
    gathers = timed("[10]", phase_gathers, dev)
    bench_launches = timed("[11]", phase_gather_bench, dev)
    det = timed("[19]", phase_determinism, dev, train_inputs,
                {"object grid": objects.pop("det_rec"),
                 "_fast nerf": presets.pop("det_rec")})
    del train_inputs
    barred = sorted(m for m in sys.modules
                    if m.split(".")[0] in MODULES_BARRED)
    if barred:
        fail(f"the port imported JAX or the JAX package: {barred[:10]}")

    # Launches per main path: the render entry's run [5], the train entry's
    # run [8], the gather bench's run [11], with dynamic objects [12]'s
    # train entry and its replay render, [13]'s ray-drop path (features
    # to export, which launches none), [14]'s eval, lidar_eval and render
    # entries, [15]'s preset paths, [16]'s extract, render_video (and
    # --hq), render_instance and train --obj_ckpt, [17]'s train and
    # sweep on each rank, and [18]'s Ref-NeRF train, eval and render and
    # RawNeRF train and eval; `launches` is their sum.
    paths = (("render_lidar", render_launches), ("train", train_launches),
             ("gather_bench", bench_launches),
             *objects["paths"].items(), ("raydrop", raydrop_launches),
             *eval_launches.items(), *presets["paths"].items(),
             ("extract", mesh["launches"]), *obj_entries.items(),
             *dp_launches.items(), *refnerf["paths"].items())

    def entry(name, source, replaces, inputs, nums, **extra):
        """`inputs`: what the top-level numbers were measured on."""
        by_path = {p: counts[name] for p, counts in paths if name in counts}
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=sum(by_path.values()),
                    launches_by_path=by_path, inputs=inputs, **nums, **extra)

    kernels = [
        # trained_chunk_*: on the inputs of [9]'s first render chunk.
        entry("composite", KERNEL_SOURCE,
              "nerf_lidar_tpu/ops/render_pallas.py:109",
              "seeded uniform, R=16384 S=32 K=19, opaque", k1, **k1_trained,
              refnerf=ref_kernels["k1"]),
        # Every grid's numbers on the path's and on uniform points under
        # "grids".
        # obj_grid: on the object grid's points of one [12] train step
        # (the JAX `hash_encode`, n = 1 and stds 0), with its launches.
        # preset_modes: [15]'s paths, each grid's mode combination on its
        # own render chunk (tetrahedral, mean-point levels, C16 rows).
        entry("hash_encode_ms", KERNEL_SOURCE,
              "nerf_lidar_tpu/ops/grid.py:366",
              "NeRF grid, the first 16,384-ray chunk of a [5] sweep "
              "(uniform_*: uniform points of the same shape)", h1,
              obj_grid=obj_grid["hash_encode_ms"],
              preset_modes=presets["h1"], lattice_chunk=lattice_chunk,
              refnerf=ref_kernels["h1"]),
        # Against the written-out twin; prop0 also vs autograd; obj_grid
        # d_table and d_x01 vs both.
        entry("hash_encode_ms_bwd", KERNEL_SOURCE,
              "nerf_lidar_tpu/ops/grid.py:366",
              "NeRF grid, d_table of one warm [8] train step (uniform_*: "
              "uniform points of the same shape)", h1_bwd,
              obj_grid=obj_grid["hash_encode_ms_bwd"],
              preset_modes=presets["h1_bwd"], refnerf=ref_kernels["h1_bwd"],
              deterministic=det["hash_encode_ms_bwd"]),
        # Every grid's hash-decay level sums under "grids", every own
        # shape under "own_shapes".
        entry("scatter_add_rows", KERNEL_SOURCE,
              "experiments/scatter_variants.py:81",
              "NeRF grid's hash-decay level sums (train path); K3's own "
              "shape beside", k3_path,
              k3_shape_rows131072_n4194304_c16=k3_own,
              obj_grid=obj_grid["scatter_add_rows"],
              refnerf=ref_kernels["k3"],
              deterministic=det["scatter_add_rows"]),
        # K2, on the bench's path as K4's form 1 (which computes the same).
        entry("tile_lane_gather", GATHER_SOURCE,
              "nerf_lidar_tpu/ops/grid_pallas.py:51",
              "seeded indices, tbl [8, 128]", gathers["K2"]),
        # K4's forms 2-5 (wrappers take_along_axis and take_rows), summed;
        # take_rows at the gather bench's (2^19, 16) <- 2^20 beside.
        entry("mosaic_gather_forms", GATHER_SOURCE,
              "experiments/gather_bench.py:263",
              "seeded indices at the TPU kernel's four shapes, summed",
              gathers["K4"]),
        entry("tile_grid_gather", GATHER_SOURCE,
              "experiments/gather_bench.py:327",
              "seeded indices, tbl [8, 128], idx [1024, 8, 128]",
              gathers["K5"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
