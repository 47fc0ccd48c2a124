"""Sensors (counterpart of mitsuba_tpu/render/sensors.py): the perspective
camera (with its inverse, ``project``), the thin-lens and orthographic
cameras, the radiancemeter, the irradiancemeter, the distant sensor (the
fork's top-of-atmosphere view) and the batch of several sensors side by
side on one film.

``sample_ray`` makes one camera ray per lane from a film-plane sample in
[0,1]^2 (u right, v down: film row 0 is the top of the image). A sensor
looks along +z of its to_world frame.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import warp
from ..core.frame import coordinate_system, normalize
from .records import Ray


def _to_world(v, R):
    """v @ R.T (a camera-frame vector in the world), written out so the
    summation order is fixed."""
    return v[..., 0:1] * R[:, 0] + v[..., 1:2] * R[:, 1] + v[..., 2:3] * R[:, 2]


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


@dataclass
class ThinLensCamera:
    """Perspective camera with a thin lens of `aperture_radius`, focused at
    `focus_distance` along its axis: rays leave a point of the lens disk
    (the aperture sample) toward the film sample's point on the focal
    plane."""

    to_world_m: torch.Tensor        # [4,4]
    tan_half_fov_x: torch.Tensor    # []
    aperture_radius: torch.Tensor   # []
    focus_distance: torch.Tensor    # []
    aspect: float

    def sample_ray(self, pos_sample, ap_sample=None):
        x = (1.0 - 2.0 * pos_sample[..., 0]) * self.tan_half_fov_x
        y = (1.0 - 2.0 * pos_sample[..., 1]) * self.tan_half_fov_x / self.aspect
        p_focus = torch.stack([x, y, torch.ones_like(x)], dim=-1) * self.focus_distance
        lens = warp.square_to_uniform_disk_concentric(ap_sample) * self.aperture_radius
        o_cam = torch.stack([lens[..., 0], lens[..., 1], torch.zeros_like(x)], dim=-1)
        R = self.to_world_m[:3, :3]
        return Ray.make(_to_world(o_cam, R) + self.to_world_m[:3, 3],
                        _to_world(normalize(p_focus - o_cam), R))


@dataclass
class OrthographicCamera:
    """Parallel rays along the frame's +z from the film's [-1, 1] x
    [-1/aspect, 1/aspect] square in its z = 0 plane."""

    to_world_m: torch.Tensor   # [4,4]
    aspect: float

    def sample_ray(self, pos_sample, ap_sample=None):
        x = 1.0 - 2.0 * pos_sample[..., 0]
        y = (1.0 - 2.0 * pos_sample[..., 1]) / self.aspect
        R = self.to_world_m[:3, :3]
        o = _to_world(torch.stack([x, y, torch.zeros_like(x)], dim=-1), R) + self.to_world_m[:3, 3]
        return Ray.make(o, R[:, 2].expand(o.shape))


@dataclass
class IrradiancemeterSensor:
    """Irradiance at the frame's origin: ray directions cosine-distributed
    about its +z, drawn from the film sample."""

    to_world_m: torch.Tensor   # [4,4]
    aspect: float = 1.0

    def sample_ray(self, pos_sample, ap_sample=None):
        d = _to_world(warp.square_to_cosine_hemisphere(pos_sample), self.to_world_m[:3, :3])
        return Ray.make(self.to_world_m[:3, 3].expand(d.shape), d)


@dataclass
class DistantSensor:
    """Radiance arriving along -`direction` from far away: parallel rays
    along `direction` that start 2 scene_radius before a fixed `target`
    (has_target), or else before a point of the disk of scene_radius about
    scene_center drawn from the film sample. ``wavelength`` pins the
    spectral variants' wavelengths as the radiancemeter's does."""

    direction: torch.Tensor     # [3] unit, toward the scene
    target: torch.Tensor        # [3]
    scene_center: torch.Tensor  # [3]
    scene_radius: torch.Tensor  # []
    wavelength: torch.Tensor    # []
    has_target: bool = False
    aspect: float = 1.0

    def sample_ray(self, pos_sample, ap_sample=None):
        n = pos_sample.shape[0]
        d = normalize(self.direction.expand(n, 3))
        if self.has_target:
            return Ray.make(self.target.expand(n, 3) - d * (2.0 * self.scene_radius), d)
        s, t = coordinate_system(d)
        disk = warp.square_to_uniform_disk_concentric(pos_sample) * self.scene_radius
        p = self.scene_center.expand(n, 3) + disk[..., 0:1] * s + disk[..., 1:2] * t
        return Ray.make(p - d * (2.0 * self.scene_radius), d)


@dataclass
class BatchSensor:
    """Several sensors side by side on one film: the film's column band i
    is sensor i, its x remapped to [0, 1) (render_test splits it back into
    views)."""

    sensors: tuple

    def sample_ray(self, pos_sample, ap_sample=None):
        n = len(self.sensors)
        x = pos_sample[..., 0] * n
        idx = torch.clamp(x.to(torch.int32), 0, n - 1)
        pos_local = torch.stack([x - idx.to(torch.float32), pos_sample[..., 1]], dim=-1)
        ray = None
        for i, sensor in enumerate(self.sensors):
            r = sensor.sample_ray(pos_local, ap_sample)
            if ray is None:
                ray = r
                continue
            m = (idx == i)[..., None]
            ray = Ray(o=torch.where(m, r.o, ray.o), d=torch.where(m, r.d, ray.d), maxt=ray.maxt)
        return ray
