"""Affine 4x4 transforms for scene loading (counterpart of
mitsuba_tpu/core/transform.py).

Transforms are built once, on the host, while a scene is loaded, so they
stay numpy float32 matrices: the loader bakes them into vertex positions
and the camera matrix before anything reaches a device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Transform:
    m: np.ndarray        # [4,4] float32
    inv: np.ndarray      # [4,4] float32 inverse

    @staticmethod
    def identity():
        eye = np.eye(4, dtype=np.float32)
        return Transform(eye, eye)

    @staticmethod
    def from_matrix(m):
        m = np.asarray(m, np.float32)
        return Transform(m, np.linalg.inv(m).astype(np.float32))

    @staticmethod
    def translate(v):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = v
        mi = np.eye(4, dtype=np.float32)
        mi[:3, 3] = -np.asarray(v)
        return Transform(m, mi)

    @staticmethod
    def scale(v):
        v = np.broadcast_to(np.asarray(v, np.float32), (3,))
        m = np.diag(np.concatenate([v, [1.0]]).astype(np.float32))
        mi = np.diag(np.concatenate([1.0 / v, [1.0]]).astype(np.float32))
        return Transform(m, mi)

    @staticmethod
    def rotate(axis, angle_deg):
        """Rotation about `axis` by `angle_deg` degrees."""
        a = np.asarray(axis, np.float64)
        a = a / np.linalg.norm(a)
        th = np.deg2rad(angle_deg)
        c, s = np.cos(th), np.sin(th)
        x, y, z = a
        R = np.array(
            [
                [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
                [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
                [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
            ]
        )
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = R
        mi = np.eye(4, dtype=np.float32)
        mi[:3, :3] = R.T
        return Transform(m, mi)

    @staticmethod
    def look_at(origin, target, up):
        """Camera-to-world: +z looks from origin toward target."""
        origin = np.asarray(origin, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)
        d = target - origin
        d = d / np.linalg.norm(d)
        left = np.cross(up / np.linalg.norm(up), d)
        if np.linalg.norm(left) < 1e-8:
            # up parallel to the view direction: take another axis instead
            # of producing a NaN frame
            alt = np.array([1.0, 0, 0]) if abs(d[0]) < 0.9 else np.array([0, 1.0, 0])
            left = np.cross(alt, d)
        left = left / np.linalg.norm(left)
        new_up = np.cross(d, left)
        m = np.eye(4, dtype=np.float32)
        m[:3, 0] = left
        m[:3, 1] = new_up
        m[:3, 2] = d
        m[:3, 3] = origin
        return Transform.from_matrix(m)

    def __matmul__(self, other):
        return Transform(self.m @ other.m, other.inv @ self.inv)


def build_transform(spec):
    """A Transform from a scene-dict spec: a Transform, a 4x4 nested list,
    or a list of op dicts applied in order (translate, scale, rotate,
    look_at, matrix)."""
    if isinstance(spec, Transform):
        return spec
    if isinstance(spec, dict):
        spec = [spec]
    if isinstance(spec, (list, tuple)) and len(spec) and isinstance(spec[0], (list, tuple, np.ndarray)):
        return Transform.from_matrix(np.asarray(spec, np.float32))
    t = Transform.identity()
    for op in spec:
        kind = op["type"]
        if kind == "translate":
            s = Transform.translate(op["value"])
        elif kind == "scale":
            s = Transform.scale(op["value"])
        elif kind == "rotate":
            s = Transform.rotate(op["axis"], op["angle"])
        elif kind in ("look_at", "lookat"):
            s = Transform.look_at(op["origin"], op["target"], op["up"])
        elif kind == "matrix":
            s = Transform.from_matrix(op["value"])
        else:
            raise ValueError(f"unknown transform op {kind!r}")
        t = s @ t
    return t
