"""Emitters (counterpart of mitsuba_tpu/render/emitters.py): the area
light, the constant environment, the directional sun and the point light
(one, or many fused into one ``PointEmitterArray``).

As in the reference: sample_direction(ref_p, u2, geom, emitter_index,
n_channels, wavelengths) returns (DirectionSample, weight) with weight =
radiance / pdf ([N, C]), pdf_direction is a solid-angle density, and
eval(si, n_channels, wavelengths) is the radiance of a ray that hits the
emitter; `wavelengths` [N, 4] are the lanes' wavelengths in the spectral
variants, None elsewhere. A delta emitter
(the sun, a point light) is never hit: its samples have pdf 1 and ``delta`` set, and MIS
gives them weight 1.

An area light samples its shape's triangles by area (an inverse-cdf lookup
with searchsorted(side="right")), then a uniform point in the triangle. The
cdf is derived from the triangle table on the host, in numpy, the way the
JAX package's loader derives it, so both packages hold the same bits.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..core import warp
from ..core.frame import dot, normalize
from ..core.math import INV_FOUR_PI
from .records import DirectionSample
from .textures import to_channels


def area_cdf(geometry, shape_index):
    """(triangle ids, unnormalized area cdf) of one shape's triangles. The
    cdf is a detached sampling table: no gradient flows through it."""
    tri_shape = geometry.tri_shape.cpu().numpy()
    e1 = geometry.tri_e1.detach().cpu().numpy()
    e2 = geometry.tri_e2.detach().cpu().numpy()
    tri_idx = np.nonzero(tri_shape == shape_index)[0].astype(np.int32)
    areas = 0.5 * np.linalg.norm(np.cross(e1[tri_idx], e2[tri_idx]), axis=-1)
    return tri_idx, np.cumsum(areas).astype(np.float32)


@dataclass
class AreaEmitter:
    """Diffuse area light attached to a triangle shape."""

    radiance: object            # texture
    shape_index: int
    tri_index: torch.Tensor     # [K] int64 triangle ids in the scene Geometry
    tri_cdf: torch.Tensor       # [K] area cdf (unnormalized, ends at total area)
    total_area: torch.Tensor    # [] float32

    is_environment = False
    is_delta = False

    @staticmethod
    def attach(radiance, shape_index, geometry):
        tri_idx, cdf = area_cdf(geometry, shape_index)
        dev = geometry.tri_e1.device
        return AreaEmitter(
            radiance=radiance,
            shape_index=shape_index,
            tri_index=torch.from_numpy(tri_idx.astype(np.int64)).to(dev),
            tri_cdf=torch.from_numpy(cdf).to(dev),
            total_area=torch.tensor(cdf[-1] if len(cdf) else 0.0, dtype=torch.float32, device=dev),
        )

    def parameters_changed(self, geometry):
        """Re-derive the area cdf after the shape's vertices moved."""
        fresh = AreaEmitter.attach(self.radiance, self.shape_index, geometry)
        return dataclasses.replace(
            self, tri_cdf=fresh.tri_cdf, total_area=fresh.total_area
        )

    def eval(self, si, n_channels, wavelengths=None):
        """Radiance toward si.wi; the front face only."""
        front = si.wi[..., 2] > 0
        return torch.where(front[..., None], self.radiance.eval(si.uv, n_channels, wavelengths),
                           0.0)

    def sample_direction(self, ref_p, u2, geom, emitter_index, n_channels, wavelengths=None):
        n_lanes = ref_p.shape[0]
        scaled = u2[..., 0] * self.total_area
        K = self.tri_cdf.shape[0]
        k = torch.clamp(torch.searchsorted(self.tri_cdf, scaled, right=True), 0, K - 1)
        tri = self.tri_index[k]
        v0, e1, e2, ng = geom.tri_v0[tri], geom.tri_e1[tri], geom.tri_e2[tri], geom.tri_ng[tri]
        cdf_lo = torch.cat([torch.zeros_like(self.tri_cdf[:1]), self.tri_cdf[:-1]])
        lo = cdf_lo[k]
        seg = torch.clamp(self.tri_cdf[k] - lo, min=1e-20)
        # reuse u0 within the chosen triangle
        u0r = torch.clamp((scaled - lo) / seg, 0.0, 1.0)
        bary = warp.square_to_uniform_triangle(torch.stack([u0r, u2[..., 1]], dim=-1))
        p = v0 + bary[..., 0:1] * e1 + bary[..., 1:2] * e2

        to_p = p - ref_p
        dist2 = dot(to_p, to_p)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
        d = to_p / dist[..., None]
        cos_e = -dot(d, ng)
        # solid-angle pdf = dist^2 / (cos_e * A)
        valid = cos_e > 1e-6
        pdf = torch.where(
            valid, dist2 / torch.where(valid, cos_e * self.total_area, 1.0), 0.0
        )
        val = self.radiance.eval(bary, n_channels, wavelengths)
        pos = pdf > 0
        weight = torch.where(
            pos[..., None], val / torch.where(pos, pdf, 1.0)[..., None], 0.0
        )
        ds = DirectionSample(
            p=p, n=ng, d=d, dist=dist, pdf=pdf,
            delta=torch.zeros(n_lanes, dtype=torch.bool, device=p.device),
            emitter_index=torch.full((n_lanes,), emitter_index, dtype=torch.int32, device=p.device),
            uv=bary,
        )
        return ds, weight

    def pdf_direction(self, ref_p, si):
        """Solid-angle pdf of having sampled si.p on this emitter from ref_p."""
        to_p = si.p - ref_p
        dist2 = dot(to_p, to_p)
        ok = dist2 > 1e-18
        d = to_p * torch.rsqrt(torch.where(ok, dist2, 1.0))[..., None]
        cos_e = -dot(d, si.n)
        valid = ok & (cos_e > 1e-6)
        return torch.where(
            valid, dist2 / torch.where(valid, cos_e * self.total_area, 1.0), 0.0
        )


@dataclass
class ConstantEmitter:
    """Uniform environment radiance. Its direction samples lie on a sphere
    of twice the scene's bounding radius (at least 1) around the reference
    point."""

    radiance: object            # texture
    scene_radius: torch.Tensor  # [] the scene's bounding-sphere radius

    is_environment = True
    is_delta = False

    def eval_escaped(self, d, n_channels, wavelengths=None):
        return self.radiance.eval(
            torch.zeros(d.shape[0], 2, dtype=torch.float32, device=d.device), n_channels,
            wavelengths)

    def sample_direction(self, ref_p, u2, geom, emitter_index, n_channels, wavelengths=None):
        n_lanes, dev = ref_p.shape[0], ref_p.device
        d = warp.square_to_uniform_sphere(u2)
        pdf = torch.full((n_lanes,), INV_FOUR_PI, dtype=torch.float32, device=dev)
        dist = torch.full((n_lanes,), 2.0, dtype=torch.float32, device=dev) * torch.clamp(
            self.scene_radius, min=1.0)
        uv = torch.zeros(n_lanes, 2, dtype=torch.float32, device=dev)
        weight = self.radiance.eval(uv, n_channels, wavelengths) / pdf[..., None]
        ds = DirectionSample(
            p=ref_p + d * dist[..., None], n=-d, d=d, dist=dist, pdf=pdf,
            delta=torch.zeros(n_lanes, dtype=torch.bool, device=dev),
            emitter_index=torch.full((n_lanes,), emitter_index, dtype=torch.int32, device=dev),
            uv=uv,
        )
        return ds, weight

    def pdf_direction_escaped(self, d):
        return torch.full(d.shape[:-1], INV_FOUR_PI, dtype=torch.float32, device=d.device)

    def parameters_changed(self, geometry):
        return self


@dataclass
class DirectionalEmitter:
    """A distant directional emitter (the sun): irradiance arriving along
    `direction`, the direction in which the light propagates. Its samples
    lie at twice the scene's bounding radius (at least 1) from the
    reference point, toward the light."""

    irradiance: object          # texture
    direction: torch.Tensor     # [3] unit propagation direction (world)
    scene_radius: torch.Tensor  # []

    is_environment = False
    is_delta = True

    def eval(self, si, n_channels, wavelengths=None):
        return torch.zeros(si.p.shape[:-1] + (n_channels,), dtype=torch.float32,
                           device=si.p.device)

    def sample_direction(self, ref_p, u2, geom, emitter_index, n_channels, wavelengths=None):
        n_lanes, dev = ref_p.shape[0], ref_p.device
        d = -normalize(self.direction.expand(ref_p.shape))
        dist = torch.full((n_lanes,), 2.0, dtype=torch.float32, device=dev) * torch.clamp(
            self.scene_radius, min=1.0)
        uv = torch.zeros(n_lanes, 2, dtype=torch.float32, device=dev)
        ds = DirectionSample(
            p=ref_p + d * dist[..., None], n=-d, d=d, dist=dist,
            pdf=torch.ones(n_lanes, dtype=torch.float32, device=dev),
            delta=torch.ones(n_lanes, dtype=torch.bool, device=dev),
            emitter_index=torch.full((n_lanes,), emitter_index, dtype=torch.int32, device=dev),
            uv=uv,
        )
        return ds, self.irradiance.eval(uv, n_channels, wavelengths)

    def pdf_direction(self, ref_p, si):
        return torch.zeros(ref_p.shape[:-1], dtype=torch.float32, device=ref_p.device)

    def parameters_changed(self, geometry):
        return self


def _delta_sample(p, ref_p, d, dist, emitter_index, uv=None):
    """The DirectionSample of a delta position (pdf 1, ``delta`` set)."""
    n_lanes, dev = ref_p.shape[0], ref_p.device
    return DirectionSample(
        p=p, n=-d, d=d, dist=dist, pdf=torch.ones(n_lanes, dtype=torch.float32, device=dev),
        delta=torch.ones(n_lanes, dtype=torch.bool, device=dev),
        emitter_index=torch.full((n_lanes,), emitter_index, dtype=torch.int32, device=dev),
        uv=torch.zeros(n_lanes, 2, dtype=torch.float32, device=dev) if uv is None else uv,
    )


def _toward(pos, ref_p):
    """(dist^2, dist, unit direction) from each ref_p to pos."""
    to_p = pos - ref_p
    dist2 = dot(to_p, to_p)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
    return dist2, dist, to_p / dist[..., None]


@dataclass
class PointEmitter:
    """Isotropic point light of radiant intensity `intensity` at
    `position`."""

    intensity: object           # texture
    position: torch.Tensor      # [3]

    is_environment = False
    is_delta = True

    def eval(self, si, n_channels, wavelengths=None):
        return torch.zeros(si.p.shape[:-1] + (n_channels,), dtype=torch.float32,
                           device=si.p.device)

    def sample_direction(self, ref_p, u2, geom, emitter_index, n_channels, wavelengths=None):
        dist2, dist, d = _toward(self.position, ref_p)
        uv = torch.zeros(ref_p.shape[0], 2, dtype=torch.float32, device=ref_p.device)
        weight = self.intensity.eval(uv, n_channels, wavelengths) / dist2[..., None]
        return _delta_sample(self.position.expand(ref_p.shape), ref_p, d, dist,
                             emitter_index), weight

    def eval_sample_value(self, ds, n_channels, wavelengths=None):
        return self.intensity.eval(ds.uv, n_channels, wavelengths)

    def pdf_direction(self, ref_p, si):
        return torch.zeros(ref_p.shape[:-1], dtype=torch.float32, device=ref_p.device)

    def parameters_changed(self, geometry):
        return self


@dataclass
class PointEmitterArray:
    """Many point lights fused into one emitter: the light is drawn by an
    inverse cdf over the lights' luminances (detached), the intensities
    [K, Ct] stay one parameter. A lane's light index rides in its sample's
    uv[..., 0]."""

    values: torch.Tensor        # [K, Ct] rgb (Ct 3) or mono (Ct 1) intensities
    positions: torch.Tensor     # [K, 3]

    is_environment = False
    is_delta = True

    def eval(self, si, n_channels, wavelengths=None):
        return torch.zeros(si.p.shape[:-1] + (n_channels,), dtype=torch.float32,
                           device=si.p.device)

    def _sel_cdf(self):
        from ..core import spectrum as spec

        v = self.values.detach()
        lum = spec.luminance(v) if v.shape[-1] == 3 else v[..., 0]
        cdf = torch.cumsum(torch.clamp(lum, min=1e-12), dim=0)
        return cdf / cdf[-1]

    def sample_direction(self, ref_p, u2, geom, emitter_index, n_channels, wavelengths=None):
        K = self.positions.shape[0]
        cdf = self._sel_cdf()
        k = torch.clamp(torch.searchsorted(cdf, u2[..., 0].contiguous(), right=True), 0, K - 1)
        cdf_lo = torch.cat([torch.zeros_like(cdf[:1]), cdf[:-1]])
        pk = torch.clamp(cdf[k] - cdf_lo[k], min=1e-12)
        pos = self.positions[k]
        dist2, dist, d = _toward(pos, ref_p)
        val = to_channels(self.values[k], n_channels, wavelengths, True)
        uv = torch.stack([k.to(torch.float32), torch.zeros_like(dist)], dim=-1)
        return _delta_sample(pos, ref_p, d, dist, emitter_index, uv), val / (dist2 * pk)[..., None]

    def eval_sample_value(self, ds, n_channels, wavelengths=None):
        """The intensity of the light recorded in ds.uv[..., 0], attached
        (the PRB replay's recompute)."""
        k = ds.uv[..., 0].to(torch.int64)
        return to_channels(self.values[k], n_channels, wavelengths, True)

    def pdf_direction(self, ref_p, si):
        return torch.zeros(ref_p.shape[:-1], dtype=torch.float32, device=ref_p.device)

    def parameters_changed(self, geometry):
        return self
