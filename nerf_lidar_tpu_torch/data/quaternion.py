# Copy of nerf_lidar_tpu/data/quaternion.py (see tests/test_torch_host.py).
"""Minimal quaternion utilities (numpy), replacing the reference's
pyquaternion dependency (not available in this environment). Conventions
match pyquaternion: q = [w, x, y, z]."""

from __future__ import annotations

import numpy as np


def normalize(q: np.ndarray) -> np.ndarray:
    return q / np.linalg.norm(q)


def to_rotation_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = normalize(np.asarray(q, np.float64))
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def from_rotation_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> [w, x, y, z] (Shepperd's method)."""
    m = np.asarray(m, np.float64)
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return normalize(np.array([w, x, y, z]))


def multiply(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def yaw_pitch_roll(q: np.ndarray):
    """(yaw, pitch, roll) about z, y', x'' — pyquaternion convention."""
    w, x, y, z = normalize(np.asarray(q, np.float64))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    arg = np.clip(2 * (w * y - z * x), -1, 1)
    pitch = np.arcsin(arg)
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    return yaw, pitch, roll


def slerp(q0: np.ndarray, q1: np.ndarray, amount: float) -> np.ndarray:
    """Spherical linear interpolation (pyquaternion Quaternion.slerp)."""
    q0 = normalize(np.asarray(q0, np.float64))
    q1 = normalize(np.asarray(q1, np.float64))
    dot = float(np.dot(q0, q1))
    if dot < 0:
        q1 = -q1
        dot = -dot
    if dot > 0.9995:
        return normalize(q0 + amount * (q1 - q0))
    theta0 = np.arccos(np.clip(dot, -1, 1))
    theta = theta0 * amount
    s0 = np.cos(theta) - dot * np.sin(theta) / np.sin(theta0)
    s1 = np.sin(theta) / np.sin(theta0)
    return normalize(s0 * q0 + s1 * q1)
