"""Sensors (counterpart of mitsuba_tpu/render/sensors.py): the perspective
camera (with its inverse, ``project``) and the radiancemeter.

``sample_ray`` makes one camera ray per lane from a film-plane sample in
[0,1]^2 (u right, v down: film row 0 is the top of the image). A sensor
looks along +z of its to_world frame.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.frame import normalize
from .records import Ray


@dataclass
class PerspectiveCamera:
    """Pinhole camera; tan_half_fov_x is the tangent of half the field of
    view along the film's x axis."""

    to_world_m: torch.Tensor      # [4,4]
    tan_half_fov_x: torch.Tensor  # [] float32
    aspect: float                 # width / height

    def sample_ray(self, pos_sample, ap_sample=None):
        x = (1.0 - 2.0 * pos_sample[..., 0]) * self.tan_half_fov_x
        y = (1.0 - 2.0 * pos_sample[..., 1]) * self.tan_half_fov_x / self.aspect
        d_cam = normalize(torch.stack([x, y, torch.ones_like(x)], dim=-1))
        R = self.to_world_m[:3, :3]
        o = self.to_world_m[:3, 3].expand(d_cam.shape)
        # d = d_cam @ R.T, written out so the summation order is fixed
        d = d_cam[..., 0:1] * R[:, 0] + d_cam[..., 1:2] * R[:, 1] + d_cam[..., 2:3] * R[:, 2]
        return Ray.make(o, d)

    def project(self, p):
        """World points [N, 3] -> (film uv [N, 2] in [0, 1)^2, valid [N]):
        the inverse of sample_ray, differentiable in p (the projective
        gradients' curve map)."""
        R = self.to_world_m[:3, :3]
        q = p - self.to_world_m[:3, 3]
        # q @ R (camera frame; R is orthonormal), written out
        pc = q[..., 0:1] * R[0] + q[..., 1:2] * R[1] + q[..., 2:3] * R[2]
        z = pc[..., 2]
        valid = z > 1e-6
        zs = torch.where(valid, z, 1.0)
        u = 0.5 * (1.0 - pc[..., 0] / (zs * self.tan_half_fov_x))
        v = 0.5 * (1.0 - pc[..., 1] * self.aspect / (zs * self.tan_half_fov_x))
        valid = valid & (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
        return torch.stack([u, v], dim=-1), valid

    @property
    def position(self):
        return self.to_world_m[:3, 3]


@dataclass
class RadiancemeterSensor:
    """A single-direction radiance probe: every film sample shares one ray
    origin and direction. ``wavelength`` (<= 0: unset) pins all four of
    each lane's wavelengths in the spectral variants, with pdf 1
    (render_api.wavefront_for); in the mono and rgb variants it changes
    nothing, as in the reference."""

    to_world_m: torch.Tensor   # [4,4]
    wavelength: torch.Tensor   # []
    aspect: float = 1.0

    def sample_ray(self, pos_sample, ap_sample=None):
        n = pos_sample.shape[0]
        o = self.to_world_m[:3, 3].expand(n, 3)
        d = self.to_world_m[:3, 2].expand(n, 3)
        return Ray.make(o, d)
