# Copy of nerf_lidar_tpu/data/camera.py (see tests/test_torch_host.py).
"""Camera ray casting and pose normalization (host-side numpy).

Faithful to reference internal/camera_utils.py semantics: OpenCV->OpenGL
axis flip, half-pixel centers, mip-NeRF cone radii from neighbor-pixel
deltas, and the ZipNeRF pixel-plane basis vectors base_x/base_y
(camera_utils.py:454-564) consumed by multisample ray casting. Stays in
numpy: ray generation is part of the input pipeline, not the XLA graph.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def intrinsic_matrix(fx, fy, cx, cy) -> np.ndarray:
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def get_pixtocam(focal, width, height) -> np.ndarray:
    """Inverse intrinsics for a centered pinhole camera."""
    return np.linalg.inv(
        intrinsic_matrix(focal, focal, width * 0.5, height * 0.5)).astype(
            np.float32)


def undistort_points(xd: np.ndarray, yd: np.ndarray, k1=0.0, k2=0.0,
                     k3=0.0, k4=0.0, p1=0.0, p2=0.0, eps: float = 1e-9,
                     iters: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """Invert the OpenCV radial(k1..k4)+tangential(p1,p2) distortion model.

    Solves distort(x, y) = (xd, yd) by Newton iteration on the image plane
    (reference camera_utils.py:379-445 semantics). Vectorized over any
    shape; points where the Jacobian is singular keep their estimate.
    """
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r = x * x + y * y
        d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))
        fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
        fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd
        d_r = k1 + r * (2 * k2 + r * (3 * k3 + r * 4 * k4))
        fx_x = d + 2 * x * x * d_r + 2 * p1 * y + 6 * p2 * x
        fx_y = 2 * x * y * d_r + 2 * p1 * x + 2 * p2 * y
        fy_x = 2 * x * y * d_r + 2 * p2 * y + 2 * p1 * x
        fy_y = d + 2 * y * y * d_r + 2 * p2 * x + 6 * p1 * y
        det = fy_x * fx_y - fx_x * fy_y
        safe = np.abs(det) > eps
        inv = np.where(safe, det, 1.0)
        x = x + np.where(safe, (fx * fy_y - fy * fx_y) / inv, 0.0)
        y = y + np.where(safe, (fy * fx_x - fx * fy_x) / inv, 0.0)
    return x, y


def convert_to_ndc(origins: np.ndarray, directions: np.ndarray,
                   pixtocam: np.ndarray, near: float = 1.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Map forward-facing rays (dz < 0, OpenGL) into the NDC cube.

    Shifts origins to the z = -near plane, then projects the t=0 and
    t=inf points perspectively; directions_ndc spans near plane (ndc z=-1)
    to far plane (ndc z=1). Reference camera_utils.py:10-74 / NeRF
    appendix C semantics.
    """
    t = -(near + origins[..., 2]) / directions[..., 2]
    origins = origins + t[..., None] * directions
    dx, dy, dz = np.moveaxis(directions, -1, 0)
    ox, oy, oz = np.moveaxis(origins, -1, 0)
    xmult = 1.0 / pixtocam[0, 2]
    ymult = 1.0 / pixtocam[1, 2]
    origins_ndc = np.stack(
        [xmult * ox / oz, ymult * oy / oz, -np.ones_like(oz)], axis=-1)
    infinity_ndc = np.stack(
        [xmult * dx / dz, ymult * dy / dz, np.ones_like(oz)], axis=-1)
    return (origins_ndc.astype(np.float32),
            (infinity_ndc - origins_ndc).astype(np.float32))


def pixels_to_rays(pix_x_int, pix_y_int, pixtocams, camtoworlds,
                   distortion_params: Optional[Dict[str, float]] = None,
                   camtype: str = "perspective",
                   pixtocam_ndc: Optional[np.ndarray] = None):
    """Pixel coords -> world rays (perspective pinhole or fisheye).

    pix_x_int/pix_y_int: int arrays of any shape SH; pixtocams broadcastable
    to SH + [3,3]; camtoworlds broadcastable to SH + [3,4] in OpenGL
    convention (x right, y up, z backward). distortion_params: optional
    k1..k4/p1/p2 dict, inverted with undistort_points. camtype
    'fisheye' applies the equidistant model (plane radius = view angle).
    pixtocam_ndc: optional [3,3] inverse intrinsics — forward-facing LLFF
    mode, rays are projected into the NDC cube (camera_utils.py:457,
    540-546); viewdirs stay world-space.

    Returns dict with origins, directions, viewdirs, radii [SH,1], base_x,
    base_y (unit pixel-plane bases, camera_utils.py:540-548).
    """
    def pix_to_dir(x, y):
        return np.stack([x + 0.5, y + 0.5, np.ones_like(x, np.float32)],
                        axis=-1)

    pixel_dirs_stacked = np.stack([
        pix_to_dir(pix_x_int, pix_y_int),
        pix_to_dir(pix_x_int + 1, pix_y_int),
        pix_to_dir(pix_x_int, pix_y_int + 1)], axis=0)

    mat_vec_mul = lambda A, b: np.matmul(A, b[..., None])[..., 0]
    camera_dirs_stacked = mat_vec_mul(pixtocams, pixel_dirs_stacked)
    if distortion_params is not None:
        x, y = undistort_points(camera_dirs_stacked[..., 0],
                                camera_dirs_stacked[..., 1],
                                **distortion_params)
        camera_dirs_stacked = np.stack([x, y, np.ones_like(x)], axis=-1)
    if camtype == "fisheye":
        # Equidistant: the plane radius is the angle from the optical axis.
        theta = np.minimum(np.pi, np.linalg.norm(
            camera_dirs_stacked[..., :2], axis=-1))
        sin_over_theta = np.sin(theta) / np.maximum(theta, 1e-12)
        camera_dirs_stacked = np.stack([
            camera_dirs_stacked[..., 0] * sin_over_theta,
            camera_dirs_stacked[..., 1] * sin_over_theta,
            np.cos(theta)], axis=-1)
    elif camtype != "perspective":
        raise ValueError(f"unknown camtype {camtype!r}")
    # OpenCV -> OpenGL.
    camera_dirs_stacked = camera_dirs_stacked @ np.diag(
        np.array([1.0, -1.0, -1.0], np.float32))

    directions_stacked = mat_vec_mul(camtoworlds[..., :3, :3],
                                     camera_dirs_stacked)
    directions, dx, dy = directions_stacked
    origins = np.broadcast_to(camtoworlds[..., :3, -1], directions.shape)
    viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)

    if pixtocam_ndc is None:
        pix_x = dx - directions
        pix_y = dy - directions
    else:
        # Forward-facing NDC: in projective space neighbor-pixel deltas
        # live on the origins, not the directions (camera_utils.py:98-105;
        # the reference's NDC branch leaves its base vectors unset — a
        # latent bug there — so the origin deltas define them here).
        origins_dx, _ = convert_to_ndc(origins, dx, pixtocam_ndc)
        origins_dy, _ = convert_to_ndc(origins, dy, pixtocam_ndc)
        origins, directions = convert_to_ndc(origins, directions,
                                             pixtocam_ndc)
        pix_x = origins_dx - origins
        pix_y = origins_dy - origins
    dx_norm = np.linalg.norm(pix_x, axis=-1)
    dy_norm = np.linalg.norm(pix_y, axis=-1)
    base_x = pix_x / np.maximum(
        np.linalg.norm(pix_x, axis=-1, keepdims=True), 1e-12)
    base_y = pix_y / np.maximum(
        np.linalg.norm(pix_y, axis=-1, keepdims=True), 1e-12)
    radii = (0.5 * (dx_norm + dy_norm))[..., None] * 2 / np.sqrt(12)

    return dict(
        origins=np.ascontiguousarray(origins, np.float32),
        directions=directions.astype(np.float32),
        viewdirs=viewdirs.astype(np.float32),
        radii=radii.astype(np.float32),
        base_x=base_x.astype(np.float32),
        base_y=base_y.astype(np.float32))


def camera_rays(camtoworld: np.ndarray, height: int, width: int,
                focal: float) -> Dict[str, np.ndarray]:
    """Full-image ray grid for a pinhole camera: [H, W, ...] fields."""
    x, y = np.meshgrid(np.arange(width), np.arange(height))
    pixtocam = get_pixtocam(focal, width, height)
    return pixels_to_rays(x, y, pixtocam, camtoworld)


def focus_point_fn(poses: np.ndarray) -> np.ndarray:
    """Point nearest to all camera optical axes (least squares)."""
    directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    # pinv: a parallel rig (all optical axes aligned, e.g. forward-facing
    # LLFF) makes the normal matrix singular; the pseudo-inverse returns
    # the minimum-norm focus point instead of raising.
    return np.linalg.pinv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def transform_poses_pca(poses: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Recenter/rotate poses onto PCA axes and rescale into [-1, 1].

    Reference camera_utils.py:162-203: returns (new poses [N,3,4],
    transform [4,4], scale) with scale clamped to at most 1/10 so far
    content stays within the contraction shell. World-to-new transform is
    `scale * transform`.
    """
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    t = t - t_mean

    eigval, eigvec = np.linalg.eig(t.T @ t)
    inds = np.argsort(eigval)[::-1]
    eigvec = eigvec[:, inds]
    rot = eigvec.T
    if np.linalg.det(rot) < 0:
        rot = np.diag(np.array([1, 1, -1])) @ rot

    transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
    poses_recentered = unpad_poses(transform @ pad_poses(poses))
    transform = np.concatenate([transform, np.eye(4)[3:]], axis=0)

    # Flip coordinate system if z component of y-axis is negative.
    if poses_recentered.mean(axis=0)[2, 1] < 0:
        poses_recentered = np.diag(np.array([1, -1, -1])) @ poses_recentered
        transform = np.diag(np.array([1, -1, -1, 1])) @ transform

    # Just make sure it's it in the [-1, 1]^3 cube (with clamp, reference
    # camera_utils.py:199).
    scale_factor = 1.0 / np.max(np.abs(poses_recentered[:, :3, 3]))
    scale_factor = min(1.0 / 10.0, scale_factor)
    poses_recentered[:, :3, 3] *= scale_factor
    transform = np.diag(np.array([scale_factor] * 3 + [1])) @ transform

    return poses_recentered.astype(np.float32), transform.astype(np.float32), \
        float(scale_factor)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """[3,4] central pose: mean position, mean viewing direction, mean up
    (LLFF view-matrix construction, reference camera_utils.py:117-130)."""
    position = poses[:, :3, 3].mean(0)
    z = poses[:, :3, 2].mean(0)  # OpenGL: -z is forward, so mean back-axis
    up = poses[:, :3, 1].mean(0)
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, position], axis=-1)


def recenter_poses(poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Recenter so the average pose is the identity (reference
    camera_utils.py:133-139). Returns (new_poses [N,3,4], transform [4,4])."""
    cam2world = average_pose(poses)
    transform = np.linalg.inv(pad_poses(cam2world[None])[0])
    poses_re = unpad_poses(transform[None] @ pad_poses(poses))
    return poses_re.astype(np.float32), transform


def generate_spiral_path(poses: np.ndarray, bounds: np.ndarray,
                         n_frames: int = 120, n_rots: int = 2,
                         zrate: float = 0.5) -> np.ndarray:
    """Forward-facing spiral render path (LLFF convention, reference
    camera_utils.py:142-160). Expects recentered poses (average pose ==
    identity); cameras orbit an ellipse fit to the 90th-percentile spread
    and look at a focus point `focal` in front of the rig."""
    close_depth, inf_depth = float(bounds.min()) * 0.9, float(bounds.max())
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    radii = np.percentile(np.abs(poses[:, :3, 3]), 90, axis=0)
    target = np.array([0.0, 0.0, -focal])
    up = np.array([0.0, 1.0, 0.0])
    out = []
    for theta in np.linspace(0, 2 * np.pi * n_rots, n_frames,
                             endpoint=False):
        eye = np.array([np.cos(theta) * radii[0],
                        -np.sin(theta) * radii[1],
                        -np.sin(theta * zrate) * radii[2]])
        out.append(lookat_pose(eye, target, up=up))
    return np.stack(out)


def pad_poses(p: np.ndarray) -> np.ndarray:
    """[..., 3, 4] -> [..., 4, 4]."""
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p: np.ndarray) -> np.ndarray:
    return p[..., :3, :4]


def generate_ellipse_path(poses: np.ndarray, n_frames: int = 120,
                          z_variation: float = 0.0,
                          z_phase: float = 0.0) -> np.ndarray:
    """Inward-facing elliptical render path fitted to the training cameras
    (reference camera_utils.py:206-276, low/high-percentile ellipse)."""
    center = focus_point_fn(poses)
    offset = np.array([center[0], center[1], 0])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    if np.linalg.norm(sc[:2]) < 1e-8:
        # A parallel/collinear rig has no lateral spread around the focus
        # point: every ellipse position would equal the center and the
        # lookat poses would be NaN. Fail loudly; forward-facing captures
        # should use generate_spiral_path.
        raise ValueError(
            "generate_ellipse_path: cameras have no lateral spread around "
            "the focus point (forward-facing rig?); use the spiral path")
    low = -sc + offset
    high = sc + offset
    z_low = np.percentile(poses[:, :3, 3], 10, axis=0)
    z_high = np.percentile(poses[:, :3, 3], 90, axis=0)

    def get_positions(theta):
        return np.stack([
            low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
            low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
            z_variation * (z_low[2] + (z_high - z_low)[2] *
                           (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5))
            + (1 - z_variation) * poses[:, 2, 3].mean(),
        ], -1)

    theta = np.linspace(0, 2 * np.pi, n_frames + 1, endpoint=True)[:-1]
    positions = get_positions(theta)
    return np.stack([lookat_pose(p, center) for p in positions])


def cast_spherical_rays(camtoworld: np.ndarray, height: int, width: int,
                        near: float, far: float) -> Dict[str, np.ndarray]:
    """Equirectangular ray grid for 360 panoramas / object-instance renders
    (reference camera_utils.py:644-687). Returns [H, W, ...] ray fields; the
    pixel bases fall back to the finite-difference neighbor directions."""
    theta_vals = np.linspace(0, 2 * np.pi, width + 1)
    phi_vals = np.linspace(0, np.pi, height + 1)
    theta, phi = np.meshgrid(theta_vals, phi_vals, indexing="xy")

    directions = np.stack([
        -np.sin(phi) * np.sin(theta),
        np.cos(phi),
        np.sin(phi) * np.cos(theta)], axis=-1)
    directions = (camtoworld[:3, :3] @ directions[..., None])[..., 0]

    dy = np.diff(directions[:, :-1], axis=0)
    dx = np.diff(directions[:-1, :], axis=1)
    directions = directions[:-1, :-1]
    origins = np.broadcast_to(camtoworld[:3, -1], directions.shape)

    dx_norm = np.linalg.norm(dx, axis=-1)
    dy_norm = np.linalg.norm(dy, axis=-1)
    radii = (0.5 * (dx_norm + dy_norm))[..., None] * 2 / np.sqrt(12)
    base_x = dx / np.maximum(dx_norm[..., None], 1e-12)
    base_y = dy / np.maximum(dy_norm[..., None], 1e-12)

    shape = directions.shape[:-1]
    return dict(
        origins=np.ascontiguousarray(origins, np.float32),
        directions=directions.astype(np.float32),
        viewdirs=directions.astype(np.float32),
        radii=radii.astype(np.float32),
        base_x=base_x.astype(np.float32),
        base_y=base_y.astype(np.float32),
        near=np.full(shape + (1,), near, np.float32),
        far=np.full(shape + (1,), far, np.float32))


def lookat_pose(eye: np.ndarray, target: np.ndarray,
                up: Optional[np.ndarray] = None) -> np.ndarray:
    """OpenGL camera-to-world [3,4]: -z looks from eye toward target."""
    if up is None:
        up = np.array([0.0, 0.0, 1.0])
    fwd = target - eye
    n = np.linalg.norm(fwd)
    if n < 1e-12:
        raise ValueError("lookat_pose: target coincides with eye")
    fwd = fwd / n
    z = -fwd  # OpenGL: camera looks down -z
    x = np.cross(up, z)
    nx = np.linalg.norm(x)
    if nx < 1e-8:  # looking straight along up: pick any orthogonal basis
        up = np.array([0.0, 1.0, 0.0])
        x = np.cross(up, z)
        nx = np.linalg.norm(x)
    x = x / nx
    y = np.cross(z, x)
    return np.stack([x, y, z, eye], axis=-1).astype(np.float32)
