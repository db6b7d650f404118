"""The view rotations of the multi-view pretraining datasets: copies of
``geot_tpu/data/data_util.py:48-81`` (numpy only), kept here so the port
does not import the JAX package."""
from __future__ import annotations

import numpy as np


def rotate_angle_vector(theta: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rodrigues rotation matrices about the axes ``v`` by the angles
    ``theta``: theta (B, 1), v (B, 3) -> (B, 3, 3) float32."""
    cos_a = np.cos(theta)
    sin_a = np.sin(theta)
    x, y, z = v[:, 0:1], v[:, 1:2], v[:, 2:3]
    rows = [
        np.concatenate([cos_a + (1 - cos_a) * x * x,
                        (1 - cos_a) * x * y - sin_a * z,
                        (1 - cos_a) * x * z + sin_a * y], axis=-1),
        np.concatenate([(1 - cos_a) * y * x + sin_a * z,
                        cos_a + (1 - cos_a) * y * y,
                        (1 - cos_a) * y * z - sin_a * x], axis=-1),
        np.concatenate([(1 - cos_a) * z * x - sin_a * y,
                        (1 - cos_a) * z * y + sin_a * x,
                        cos_a + (1 - cos_a) * z * z], axis=-1),
    ]
    return np.stack(rows, axis=1).astype(np.float32)


def rotate_theta_phi(angles: np.ndarray) -> np.ndarray:
    """View rotation matrices: angles (B, 2) = (theta, phi) in radians ->
    (B, 3, 3) float32 inverse view rotations, a turn of -theta about z
    times a turn of -phi about the axis (sin theta, -cos theta, 0)."""
    angles = np.asarray(angles, dtype=np.float64)
    if angles.ndim != 2 or angles.shape[1] != 2:
        raise ValueError(f"angles must be (B, 2), got {angles.shape}")
    B = angles.shape[0]
    theta, phi = angles[:, 0:1], angles[:, 1:2]
    v1 = np.broadcast_to(np.array([[0.0, 0.0, 1.0]]), (B, 3))
    v2 = np.concatenate([np.sin(theta), -np.cos(theta),
                         np.zeros_like(theta)], axis=-1)
    r1_inv = rotate_angle_vector(-theta, v1)
    r2_inv = rotate_angle_vector(-phi, v2)
    return (r1_inv @ r2_inv).astype(np.float32)
