# Copy of nerf_lidar_tpu/lidar/sensor.py (see tests/test_torch_host.py).
"""nuScenes 32-beam LiDAR sensor model.

TPU-native rewrite of the sweep-pattern construction in reference
internal/lidar_utils.py:34-190: 32 fixed elevation angles, 1100 azimuth
steps sweeping 270 deg -> -90 deg, 20 Hz rolling-shutter origin
interpolation between consecutive frame centers, replay (real trajectory)
and simulated (straight-line / perturbed) modes. All host-side numpy; the
output is a [32*1100]-ray pytree per sweep fed to the chunked renderer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .transforms import SceneFrame, apply_rotation

# The 32 beam elevations (deg) of the nuScenes HDL-32E
# (reference lidar_utils.py:36-37), sorted ascending.
NUSC_ELEVATIONS_DEG: Tuple[float, ...] = tuple(sorted([
    -30.67, -9.33, -29.33, -8.00, -28.00, -6.67, -26.67, -5.33, -25.33,
    -4.00, -24.00, -2.67, -22.67, -1.33, -21.33, 0.00, -20.00, 1.33,
    -18.67, 2.67, -17.33, 4.00, -16.00, 5.33, -14.67, 6.67, -13.33, 8.00,
    -12.00, 9.33, -10.67, 10.67]))

NUM_BEAMS = 32
POINTS_PER_BEAM = 1100  # azimuth steps per revolution
SWEEP_PERIOD_S = 0.05  # 20 Hz
LIDAR_RAY_RADIUS = 5e-4


def azimuth_angles(points_per_beam: int = POINTS_PER_BEAM) -> np.ndarray:
    """Azimuths (rad): 270 deg -> -90 deg (one full clockwise revolution)."""
    return np.linspace(270.0, -90.0, points_per_beam) / 180.0 * np.pi


def beam_directions(elevations_deg=NUSC_ELEVATIONS_DEG,
                    azimuths: Optional[np.ndarray] = None) -> np.ndarray:
    """Unit directions in the LiDAR frame (x right, y forward, z up):
    [sin(phi)cos(theta), cos(phi)cos(theta), sin(theta)], ordered
    beam-major ([n_beams * n_azimuth, 3]), reference lidar_utils.py:559-568.
    """
    if azimuths is None:
        azimuths = azimuth_angles()
    theta = np.deg2rad(np.asarray(elevations_deg))[:, None]
    phi = azimuths[None, :]
    d = np.stack([
        np.cos(theta) * np.sin(phi),
        np.cos(theta) * np.cos(phi),
        np.broadcast_to(np.sin(theta), (theta.shape[0], phi.shape[1])),
    ], axis=-1)
    return d.reshape(-1, 3).astype(np.float32)


@dataclasses.dataclass
class Sweep:
    """One 32x1100-ray sweep in scene coordinates."""
    origins: np.ndarray  # [N, 3] rolling-shutter origins (scene coords)
    directions: np.ndarray  # [N, 3] unit directions (scene coords)
    timestamp: float = 0.0

    @property
    def num_rays(self) -> int:
        return self.origins.shape[0]

    def ray_batch(self, near: float, far: float) -> Dict[str, np.ndarray]:
        n = self.num_rays
        d = self.directions
        return dict(
            origins=self.origins.astype(np.float32),
            directions=d.astype(np.float32),
            viewdirs=d.astype(np.float32),
            radii=np.full((n, 1), LIDAR_RAY_RADIUS, np.float32),
            base_x=d.astype(np.float32),
            base_y=d.astype(np.float32),
            near=np.full((n, 1), near, np.float32),
            far=np.full((n, 1), far, np.float32),
            timestamp=np.full((n,), self.timestamp, np.float32))


def rolling_origins(origin: np.ndarray, origin_next: np.ndarray,
                    points_per_beam: int = POINTS_PER_BEAM,
                    num_beams: int = NUM_BEAMS) -> np.ndarray:
    """Interpolate per-azimuth origins across the 50 ms sweep and tile over
    beams (reference lidar_utils.py:79-84: origins move backwards along the
    ego displacement at 20 Hz)."""
    time_interval = np.linspace(0, SWEEP_PERIOD_S, points_per_beam)
    delta = (origin_next - origin)[None, :]
    per_azimuth = origin[None, :] - time_interval[:, None] @ delta / (0.5 / 10)
    return np.tile(per_azimuth, (num_beams, 1)).astype(np.float32)


def replay_sweeps(centers_world: np.ndarray, lidar2globals: np.ndarray,
                  frame: SceneFrame,
                  elevations_deg=NUSC_ELEVATIONS_DEG,
                  points_per_beam: int = POINTS_PER_BEAM,
                  timestamps: Optional[np.ndarray] = None) -> List[Sweep]:
    """Replay the real trajectory: one sweep per recorded frame.

    centers_world: [F, 3] LiDAR centers in world coords; lidar2globals:
    [F, 4, 4]; frame: world->scene mapping. Mirrors get_gt_info
    (lidar_utils.py:34-101) minus the file plumbing.
    """
    dirs_lidar = beam_directions(elevations_deg,
                                 azimuth_angles(points_per_beam))
    centers_scene = frame.world_to_scene_points(centers_world)
    sweeps = []
    F = centers_world.shape[0]
    for i in range(F):
        nxt = centers_scene[min(i + 1, F - 1)]
        origins = rolling_origins(centers_scene[i], nxt, points_per_beam,
                                  len(elevations_deg))
        d_world = apply_rotation(lidar2globals[i], dirs_lidar)
        d_scene = frame.world_to_scene_dirs(d_world)
        d_scene = d_scene / np.linalg.norm(d_scene, axis=-1, keepdims=True)
        ts = float(timestamps[i]) if timestamps is not None else float(i)
        sweeps.append(Sweep(origins, d_scene.astype(np.float32), ts))
    return sweeps


def simulated_sweeps(start_world: np.ndarray, end_world: np.ndarray,
                     lidar2global0: np.ndarray, frame: SceneFrame,
                     num_sweeps: int = 100, complicated: bool = False,
                     seed: int = 0,
                     elevations_deg=NUSC_ELEVATIONS_DEG,
                     points_per_beam: int = POINTS_PER_BEAM,
                     timestamps: Optional[np.ndarray] = None
                     ) -> Tuple[List[Sweep], np.ndarray]:
    """Synthetic ego trajectory: straight line from start to end (optionally
    laterally perturbed), fixed sensor orientation from frame 0
    (lidar_utils.py:103-190). Returns (sweeps, ego_trace_world [S+1, 3]).

    `timestamps` (scene-normalized seconds, one per sweep) place dynamic
    objects along the simulated drive — the reference stamps simu batches
    with the real per-sweep lidar timestamps (datasets.py:703-704,
    `lidar_timestamps[lidar_idx]`); sweeps past the recorded range clamp to
    the last timestamp (objects hold their final pose, obj_utils.get_pose's
    out-of-range behavior). Without timestamps, sweeps are stamped 0..S-1
    (only meaningful for object-free scenes)."""
    p0 = frame.world_to_scene_points(start_world)
    p1 = frame.world_to_scene_points(end_world)
    interval = np.linspace(0, 1, num_sweeps + 1)[:, None] * (p1 - p0)[None]
    if complicated:
        rng = np.random.RandomState(seed)
        interval[:, 1] += 0.1 * rng.randn(len(interval))
        interval[:, [0, 2]] += 2 * (rng.rand(len(interval), 2) * 2 - 1) \
            * frame.scale
    trace_scene = interval + p0[None]
    ego_trace_world = frame.scene_to_world_points(trace_scene)

    dirs_lidar = beam_directions(elevations_deg,
                                 azimuth_angles(points_per_beam))
    d_world = apply_rotation(lidar2global0, dirs_lidar)
    d_scene = frame.world_to_scene_dirs(d_world)
    d_scene = (d_scene / np.linalg.norm(d_scene, axis=-1, keepdims=True)
               ).astype(np.float32)

    sweeps = []
    for i in range(num_sweeps):
        origins = rolling_origins(trace_scene[i], trace_scene[i + 1],
                                  points_per_beam, len(elevations_deg))
        if timestamps is not None:
            ts = float(timestamps[min(i, len(timestamps) - 1)])
        else:
            ts = float(i)
        sweeps.append(Sweep(origins, d_scene, ts))
    return sweeps, ego_trace_world
