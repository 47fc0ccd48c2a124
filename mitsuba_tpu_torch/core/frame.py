"""Orthonormal shading frames and vector helpers (counterpart of
mitsuba_tpu/core/frame.py).

All functions take tensors with a trailing dimension of 3 and broadcast
over the leading (wavefront) axes. Dot and cross products are written out
component by component, so that the order of the float operations is fixed
and the same on the CPU and the card.
"""
from __future__ import annotations

import torch


def dot(a, b, keepdims=False):
    r = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return r[..., None] if keepdims else r


def cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def norm(v, keepdims=False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdims=keepdims), min=1e-30))


def normalize(v):
    return v / norm(v, keepdims=True)


def coordinate_system(n):
    """Orthonormal basis (s, t) around the unit normal n (the branchless
    construction of Duff et al. 2017, as in the reference)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    s = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        dim=-1,
    )
    t = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return s, t


class Frame:
    """Shading frame whose local +z is the normal."""

    __slots__ = ("s", "t", "n")

    def __init__(self, n, s=None, t=None):
        if s is None:
            s, t = coordinate_system(n)
        self.s, self.t, self.n = s, t, n

    def to_local(self, v):
        return frame_to_local(self.n, self.s, self.t, v)

    def to_world(self, v):
        return frame_to_world(self.n, self.s, self.t, v)


def frame_to_local(n, s, t, v):
    return torch.stack([dot(v, s), dot(v, t), dot(v, n)], dim=-1)


def frame_to_world(n, s, t, v):
    return v[..., 0:1] * s + v[..., 1:2] * t + v[..., 2:3] * n


def reflect(wi):
    """Mirror reflection about the local normal (+z)."""
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)
