"""Wavefront interaction records (counterpart of mitsuba_tpu/render/records.py).

Struct-of-arrays layout: every field is a tensor whose leading axis is the
wavefront [N]. Masked lanes carry inert values (t=inf, zeros) instead of
garbage, so later math stays NaN-free without branches.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.frame import coordinate_system, dot, frame_to_local, frame_to_world
from ..core.math import RAY_EPSILON


@dataclass
class Ray:
    """o + t*d, t in [0, maxt]."""

    o: torch.Tensor          # [N, 3]
    d: torch.Tensor          # [N, 3] normalized
    maxt: torch.Tensor       # [N]

    @staticmethod
    def make(o, d, maxt=None):
        if maxt is None:
            maxt = torch.full(o.shape[:-1], float("inf"), dtype=o.dtype, device=o.device)
        return Ray(o=o, d=d, maxt=maxt)

    def at(self, t):
        return self.o + t[..., None] * self.d


def spawn_ray(p, n, d, maxt=None):
    """Offset the ray origin along the geometric normal, on the side of the
    new direction, so that the ray does not hit the surface it leaves."""
    sign = torch.sign(dot(n, d, keepdims=True))
    o = p + sign * RAY_EPSILON * n + RAY_EPSILON * d
    if maxt is None:
        maxt = torch.full(p.shape[:-1], float("inf"), dtype=p.dtype, device=p.device)
    return Ray(o=o, d=d, maxt=maxt)


@dataclass
class PreliminaryIntersection:
    """Closest-hit record before shading: (t, prim, barycentrics)."""

    t: torch.Tensor           # [N], inf = miss
    prim_index: torch.Tensor  # [N] int32, -1 = miss
    prim_uv: torch.Tensor     # [N, 2]

    @property
    def is_valid(self):
        return torch.isfinite(self.t)


@dataclass
class SurfaceInteraction:
    """Shaded surface hit; wi is stored in the local shading frame."""

    t: torch.Tensor           # [N]
    p: torch.Tensor           # [N, 3]
    n: torch.Tensor           # [N, 3] geometric normal
    sh_n: torch.Tensor        # [N, 3] shading normal (frame z)
    sh_s: torch.Tensor        # [N, 3] shading tangent (frame x)
    sh_t: torch.Tensor        # [N, 3] shading bitangent (frame y)
    uv: torch.Tensor          # [N, 2]
    wi: torch.Tensor          # [N, 3] incident direction, local frame
    shape_index: torch.Tensor  # [N] int32, -1 = none
    prim_index: torch.Tensor   # [N] int32
    prim_uv: torch.Tensor      # [N, 2] raw barycentrics

    @property
    def is_valid(self):
        return torch.isfinite(self.t)

    def to_local(self, v):
        return frame_to_local(self.sh_n, self.sh_s, self.sh_t, v)

    def to_world(self, v):
        return frame_to_world(self.sh_n, self.sh_s, self.sh_t, v)


@dataclass
class DirectionSample:
    """Emitter direction sample."""

    p: torch.Tensor          # [N, 3] point on the emitter
    n: torch.Tensor          # [N, 3] emitter normal
    d: torch.Tensor          # [N, 3] unit direction reference -> emitter
    dist: torch.Tensor       # [N]
    pdf: torch.Tensor        # [N] solid-angle density (0 = invalid)
    delta: torch.Tensor      # [N] bool, Dirac emitter
    emitter_index: torch.Tensor  # [N] int32
    uv: torch.Tensor         # [N, 2] emitter-surface uv


@dataclass
class BSDFSample:
    wo: torch.Tensor         # [N, 3] local outgoing direction
    pdf: torch.Tensor        # [N]
    eta: torch.Tensor        # [N] relative IOR of the sampled event
    delta: torch.Tensor      # [N] bool, Dirac lobe sampled


@dataclass
class MediumInteraction:
    """A scattering event inside a medium. As in the reference, the shading
    frame is Frame(ray.d): sh_n is the propagation direction and the
    incident direction is (0, 0, -1) in local space."""

    t: torch.Tensor           # [N], inf = no event
    p: torch.Tensor           # [N, 3]
    sh_n: torch.Tensor        # [N, 3] = ray.d
    sh_s: torch.Tensor        # [N, 3]
    sh_t: torch.Tensor        # [N, 3]
    medium_index: torch.Tensor  # [N] int

    @property
    def is_valid(self):
        return torch.isfinite(self.t)

    def to_world(self, v):
        return frame_to_world(self.sh_n, self.sh_s, self.sh_t, v)

    def to_local(self, v):
        return frame_to_local(self.sh_n, self.sh_s, self.sh_t, v)

    @staticmethod
    def make(t, p, d, medium_index):
        s, tt = coordinate_system(d)
        return MediumInteraction(t=t, p=p, sh_n=d, sh_s=s, sh_t=tt, medium_index=medium_index)
