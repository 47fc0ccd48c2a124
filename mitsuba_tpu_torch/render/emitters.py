"""Emitters (counterpart of mitsuba_tpu/render/emitters.py): the area
light (on triangles; on an analytic sphere, ``SphereAreaEmitter``; many
constant ones fused into one ``AreaEmitterArray``; the collimated
``DirectionalAreaEmitter``), the constant and envmap environments, the
directional sun, the point light (one, or many fused into one
``PointEmitterArray``), the spot light and the projector.

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
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import warp
from ..core.frame import coordinate_system, dot, normalize
from ..core.math import INV_FOUR_PI, safe_sqrt
from .records import DirectionSample
from .textures import gather_texels, to_channels


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

    @classmethod
    def attach(cls, radiance, shape_index, geometry):
        tri_idx, cdf = area_cdf(geometry, shape_index)
        dev = geometry.tri_e1.device
        return cls(
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


def _zeros_eval(si, n_channels):
    return torch.zeros(si.p.shape[:-1] + (n_channels,), dtype=torch.float32, device=si.p.device)


def _zero_pdf(ref_p):
    return torch.zeros(ref_p.shape[:-1], dtype=torch.float32, device=ref_p.device)


def _world_to_local(d, R):
    """d @ R (R's transpose applied to d), written out."""
    return d[..., 0:1] * R[0] + d[..., 1:2] * R[1] + d[..., 2:3] * R[2]


def _local_to_world(d, R):
    """d @ R.T, written out."""
    return d[..., 0:1] * R[:, 0] + d[..., 1:2] * R[:, 1] + d[..., 2:3] * R[:, 2]


@dataclass
class SpotEmitter:
    """Spot light: `intensity` at `position` along `direction`, full inside
    the beam width, falling off linearly to 0 at the cutoff angle."""

    intensity: object           # texture
    position: torch.Tensor      # [3]
    direction: torch.Tensor     # [3] propagation direction
    cos_cutoff: torch.Tensor    # []
    cos_beam_width: torch.Tensor  # []

    is_environment = False
    is_delta = True

    def eval(self, si, n_channels, wavelengths=None):
        return _zeros_eval(si, n_channels)

    def sample_direction(self, ref_p, u2, geom, emitter_index, n_channels, wavelengths=None):
        dist2, dist, d = _toward(self.position, ref_p)
        cos_a = dot(-d, normalize(self.direction.expand(ref_p.shape)))
        falloff = torch.clamp((cos_a - self.cos_cutoff)
                              / torch.clamp(self.cos_beam_width - self.cos_cutoff, min=1e-6),
                              0.0, 1.0)
        uv = torch.zeros(ref_p.shape[0], 2, dtype=torch.float32, device=ref_p.device)
        val = self.intensity.eval(uv, n_channels, wavelengths)
        weight = val * (falloff / torch.clamp(dist2, min=1e-20))[..., None]
        return _delta_sample(self.position.expand(ref_p.shape), ref_p, d, dist,
                             emitter_index), weight

    def pdf_direction(self, ref_p, si):
        return _zero_pdf(ref_p)

    def parameters_changed(self, geometry):
        return self


@dataclass
class ProjectorEmitter:
    """A point source at `position` projecting the texture `irradiance`
    (times `scale`) through a perspective frustum of horizontal half-angle
    tan_half_fov_x; a direction outside the frustum gets nothing."""

    irradiance: object          # texture: the projected image
    scale: torch.Tensor         # []
    position: torch.Tensor      # [3]
    to_world_r: torch.Tensor    # [3, 3] world <- projector frame
    tan_half_fov_x: torch.Tensor  # []
    aspect: float = 1.0

    is_environment = False
    is_delta = True

    def eval(self, si, n_channels, wavelengths=None):
        return _zeros_eval(si, n_channels)

    def sample_direction(self, ref_p, u2, geom, emitter_index, n_channels, wavelengths=None):
        dist2, dist, d = _toward(self.position, ref_p)
        # the projection direction (projector -> ref) in the projector's frame
        v = _world_to_local(-d, self.to_world_r)
        z = v[..., 2]
        zc = torch.clamp(z, min=1e-6)
        tx = self.tan_half_fov_x
        u = 0.5 * (1.0 - v[..., 0] / zc / tx)
        w = 0.5 * (1.0 - v[..., 1] / zc / (tx / self.aspect))
        on_film = (z > 1e-6) & (u >= 0) & (u < 1) & (w >= 0) & (w < 1)
        val = self.irradiance.eval(torch.stack([u, 1.0 - w], dim=-1), n_channels,
                                   wavelengths) * self.scale
        weight = torch.where(on_film[..., None],
                             val / torch.clamp(dist2, min=1e-20)[..., None], 0.0)
        return _delta_sample(self.position.expand(ref_p.shape), ref_p, d, dist,
                             emitter_index), weight

    def pdf_direction(self, ref_p, si):
        return _zero_pdf(ref_p)

    def parameters_changed(self, geometry):
        return self


def build_envmap_tables(data):
    """(row cdf [H], conditional cdf [H, W]) of a latitude-longitude map
    [H, W, C]: each texel's channel sum times the sine of its row's polar
    angle, summed along the row, then the rows' totals summed; in numpy,
    as the JAX package builds them, detached."""
    data = np.asarray(data, np.float32)
    h = data.shape[0]
    sin_theta = np.sin((np.arange(h) + 0.5) / h * np.pi)
    cond_cdf = np.cumsum(data.sum(-1) * sin_theta[:, None], axis=1)
    return np.cumsum(cond_cdf[:, -1]), cond_cdf


def _lower_bound_rows(table, rows, x):
    """For each lane, the count of entries of table[rows] (a nondecreasing
    row of [H, W]) below x: a binary search of fixed depth, one gather an
    iteration, so no [N, W] comparison is made."""
    w = table.shape[1]
    lo = torch.zeros_like(rows)
    hi = torch.full_like(rows, w)
    for _ in range(w.bit_length()):
        mid = (lo + hi) // 2
        below = (table[rows, torch.clamp(mid, max=w - 1)] < x) & (mid < hi)
        lo = torch.where(below, mid + 1, lo)
        hi = torch.where(below, hi, mid)
    return lo


@dataclass
class EnvmapEmitter:
    """Latitude-longitude environment map (``data`` [H, W, C], a
    differentiable parameter, times `scale`; +y up, the map's u along
    atan2(-x, z)), sampled by its detached row and column cdfs: a texel by
    its luminance times the sine of its row, then a point uniform in it."""

    data: torch.Tensor          # [H, W, C]
    row_cdf: torch.Tensor       # [H]
    cond_cdf: torch.Tensor      # [H, W]
    scale: torch.Tensor         # []
    scene_radius: torch.Tensor  # []
    to_world_rot: torch.Tensor  # [3, 3]

    is_environment = True
    is_delta = False

    def _texel(self, d_world):
        """(row, column, polar angle) of each world direction's texel."""
        d = _world_to_local(d_world, self.to_world_rot)
        theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
        phi = torch.atan2(-d[..., 0], d[..., 2])
        h, w = self.data.shape[0], self.data.shape[1]
        x = torch.clamp(((phi / (2 * math.pi) + 0.5) * w).to(torch.int64), 0, w - 1)
        y = torch.clamp((theta / math.pi * h).to(torch.int64), 0, h - 1)
        return y, x, theta

    def eval_escaped(self, d, n_channels, wavelengths=None):
        y, x, _ = self._texel(d)
        return to_channels(gather_texels(self.data, y, x) * self.scale, n_channels, wavelengths)

    def pdf_direction_escaped(self, d_world):
        """The solid-angle density of the sampling below: a texel's mass
        spread uniformly over it in (u, v),
        h w lum sin(theta_c) / (2 pi^2 total sin(theta))."""
        y, x, theta = self._texel(d_world)
        h, w = self.data.shape[0], self.data.shape[1]
        texel = gather_texels(self.data, y, x)
        lum = texel[..., 0]
        for c in range(1, texel.shape[-1]):
            lum = lum + texel[..., c]
        theta_c = (y.to(torch.float32) + 0.5) / h * math.pi
        total = torch.clamp(self.row_cdf[-1], min=1e-20)
        return (h * w) * lum * torch.sin(theta_c) / (
            2.0 * math.pi ** 2 * total * torch.clamp(torch.sin(theta), min=1e-6))

    def sample_direction(self, ref_p, u2, geom, emitter_index, n_channels, wavelengths=None):
        n_lanes, dev = ref_p.shape[0], ref_p.device
        h, w = self.data.shape[0], self.data.shape[1]
        uy = u2[..., 0] * self.row_cdf[-1]
        y = torch.clamp(torch.searchsorted(self.row_cdf, uy.contiguous(), right=True), 0, h - 1)
        lo_y = torch.where(y > 0, self.row_cdf[torch.clamp(y - 1, min=0)], 0.0)
        fy = torch.clamp((uy - lo_y) / torch.clamp(self.row_cdf[y] - lo_y, min=1e-20),
                         0.0, 1.0 - 1e-6)
        ux = u2[..., 1] * self.cond_cdf[y, -1]
        x = torch.clamp(_lower_bound_rows(self.cond_cdf, y, ux), 0, w - 1)
        lo_x = torch.where(x > 0, self.cond_cdf[y, torch.clamp(x - 1, min=0)], 0.0)
        fx = torch.clamp((ux - lo_x) / torch.clamp(self.cond_cdf[y, x] - lo_x, min=1e-20),
                         0.0, 1.0 - 1e-6)
        theta = (y.to(torch.float32) + fy) / h * math.pi
        phi = ((x.to(torch.float32) + fx) / w - 0.5) * 2 * math.pi
        sin_t = torch.sin(theta)
        d_local = torch.stack([-sin_t * torch.sin(phi), torch.cos(theta),
                               sin_t * torch.cos(phi)], dim=-1)
        d = _local_to_world(d_local, self.to_world_rot)
        pdf = self.pdf_direction_escaped(d)
        dist = torch.full((n_lanes,), 2.0, dtype=torch.float32, device=dev) * torch.clamp(
            self.scene_radius, min=1.0)
        val = self.eval_escaped(d, n_channels, wavelengths)
        weight = torch.where((pdf > 0)[..., None],
                             val / torch.clamp(pdf, min=1e-20)[..., None], 0.0)
        ds = DirectionSample(
            p=ref_p + d * dist[..., None], n=-d, d=d, dist=dist, pdf=pdf,
            delta=torch.zeros(n_lanes, dtype=torch.bool, device=dev),
            emitter_index=torch.full((n_lanes,), emitter_index, dtype=torch.int32, device=dev),
            uv=torch.zeros(n_lanes, 2, dtype=torch.float32, device=dev),
        )
        return ds, weight

    def parameters_changed(self, geometry):
        return self


@dataclass
class SphereAreaEmitter:
    """Diffuse area light on an analytic sphere, sampled uniformly in the
    cone the sphere subtends (every sample hits it). The sphere is read
    from the geometry at each use (``needs_geometry``), so that a moved
    sphere's light moves with it."""

    radiance: object            # texture
    sphere_index: int
    shape_index: int

    is_environment = False
    is_delta = False
    needs_geometry = True

    def eval(self, si, n_channels, wavelengths=None):
        front = si.wi[..., 2] > 0
        return torch.where(front[..., None], self.radiance.eval(si.uv, n_channels, wavelengths),
                           0.0)

    def _cone(self, ref_p, geom):
        center = geom.sph_center[self.sphere_index]
        radius = geom.sph_radius[self.sphere_index]
        dc = center - ref_p
        L2 = dot(dc, dc)
        L = safe_sqrt(torch.clamp(L2, min=1e-20))
        sin2_max = torch.clamp((radius / torch.clamp(L, min=1e-12)) ** 2, 0.0, 1.0 - 1e-7)
        cos_max = safe_sqrt(1.0 - sin2_max)
        solid = (2.0 * math.pi) * torch.clamp(1.0 - cos_max, min=1e-12)
        return center, radius, dc, L2, dc / L[..., None], L > radius * 1.0001, cos_max, solid

    def sample_direction(self, ref_p, u2, geom, emitter_index, n_channels, wavelengths=None):
        n_lanes, dev = ref_p.shape[0], ref_p.device
        center, radius, dc, L2, dh, outside, cos_max, solid = self._cone(ref_p, geom)
        cos_t = 1.0 - u2[..., 0] * (1.0 - cos_max)
        sin_t = safe_sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = (2.0 * math.pi) * u2[..., 1]
        e1, e2 = coordinate_system(dh)
        d = cos_t[..., None] * dh + sin_t[..., None] * (torch.cos(phi)[..., None] * e1
                                                        + torch.sin(phi)[..., None] * e2)
        # the near intersection along d
        b = dot(d, dc)
        dist = b - safe_sqrt(torch.clamp(b * b - (L2 - radius ** 2), min=0.0))
        p = ref_p + dist[..., None] * d
        n = normalize(p - center)
        from .shapes import sphere_uv

        uv = sphere_uv(n)
        val = self.radiance.eval(uv, n_channels, wavelengths)
        ds = DirectionSample(
            p=p, n=n, d=d, dist=dist, pdf=torch.where(outside, 1.0 / solid, 0.0),
            delta=torch.zeros(n_lanes, dtype=torch.bool, device=dev),
            emitter_index=torch.full((n_lanes,), emitter_index, dtype=torch.int32, device=dev),
            uv=uv,
        )
        return ds, torch.where(outside[..., None], val * solid[..., None], 0.0)

    def pdf_direction(self, ref_p, si, geom):
        """The cone pdf of a direction from ref_p that hits the sphere."""
        *_, outside, _, solid = self._cone(ref_p, geom)
        return torch.where(outside, 1.0 / solid, 0.0)

    def parameters_changed(self, geometry):
        return self


def fused_area_tables(values, tri_index, tri_light, geometry):
    """(tri_cdf [T] normalized to 1, area_pdf [K], total_power) of fused
    constant area lights: triangle t of light k is drawn with probability
    area_t lum_k / Z, lum_k the mean of light k's rgb (at least 1e-12), so
    a point's area pdf is lum_k / Z. In numpy from the geometry's
    triangles, each light's areas through its float32 area cdf, as the JAX
    package's loader builds them; detached."""
    e1 = geometry.tri_e1.detach().cpu().numpy()[tri_index]
    e2 = geometry.tri_e2.detach().cpu().numpy()[tri_index]
    raw = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    lums = np.maximum(np.asarray(values, np.float32).mean(-1), 1e-12)
    w = np.zeros(tri_index.shape[0], np.float64)
    for k in range(lums.shape[0]):
        sel = tri_light == k
        cdf = np.cumsum(raw[sel]).astype(np.float32)
        w[sel] = np.diff(np.concatenate([[0.0], cdf])) * float(lums[k])
    Z = max(float(w.sum()), 1e-30)
    return (np.cumsum(w) / Z).astype(np.float32), (lums / Z).astype(np.float32), np.pi * Z


@dataclass
class AreaEmitterArray:
    """Many diffuse area lights of constant radiance fused into one
    emitter: a triangle is drawn from one cdf over the union of their
    triangles, weighted by area times the light's luminance (uniform
    within a light, power-weighted between them), and the radiance table
    [K, 3] stays one parameter. A lane's light rides in its sample's
    uv[..., 0]."""

    values: torch.Tensor          # [K, 3] radiance rows
    tri_index: torch.Tensor       # [T] int64 triangle ids in the geometry
    tri_light: torch.Tensor       # [T] int64 light of each triangle
    tri_cdf: torch.Tensor         # [T] selection cdf, normalized (detached)
    area_pdf: torch.Tensor        # [K] area pdf lum_k / Z (detached)
    shape_to_light: torch.Tensor  # [n_shapes] int64 light of each shape, -1 none
    total_power: float = 1.0      # pi Z

    is_environment = False
    is_delta = False

    def _rows(self, k, n_channels, wavelengths):
        return to_channels(self.values[k], n_channels, wavelengths, True)

    def _light_of(self, si):
        k = self.shape_to_light[torch.clamp(si.shape_index, min=0).to(torch.int64)]
        return torch.where(si.shape_index >= 0, k, -1)

    def eval(self, si, n_channels, wavelengths=None):
        k = self._light_of(si)
        front = (si.wi[..., 2] > 0) & (k >= 0)
        return torch.where(front[..., None],
                           self._rows(torch.clamp(k, min=0), n_channels, wavelengths), 0.0)

    def sample_point(self, u2, geom):
        """(point, geometric normal, light, area pdf) of area samples u2."""
        u = u2[..., 0].contiguous()
        T = self.tri_cdf.shape[0]
        t = torch.clamp(torch.searchsorted(self.tri_cdf, u, right=True), 0, T - 1)
        tri = self.tri_index[t]
        cdf_lo = torch.cat([torch.zeros_like(self.tri_cdf[:1]), self.tri_cdf[:-1]])
        lo = cdf_lo[t]
        u0r = torch.clamp((u - lo) / torch.clamp(self.tri_cdf[t] - lo, min=1e-20), 0.0, 1.0)
        bary = warp.square_to_uniform_triangle(torch.stack([u0r, u2[..., 1]], dim=-1))
        p = geom.tri_v0[tri] + bary[..., 0:1] * geom.tri_e1[tri] + bary[..., 1:2] * geom.tri_e2[tri]
        k = self.tri_light[t]
        return p, geom.tri_ng[tri], k, self.area_pdf[k]

    def sample_direction(self, ref_p, u2, geom, emitter_index, n_channels, wavelengths=None):
        n_lanes = ref_p.shape[0]
        p, ng, k, p_area = self.sample_point(u2, geom)
        to_p = p - ref_p
        dist2 = dot(to_p, to_p)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
        d = to_p / dist[..., None]
        cos_e = -dot(d, ng)
        valid = cos_e > 1e-6
        pdf = torch.where(valid, dist2 * p_area / torch.where(valid, cos_e, 1.0), 0.0)
        val = self._rows(k, n_channels, wavelengths)
        pos = pdf > 0
        weight = torch.where(pos[..., None], val / torch.where(pos, pdf, 1.0)[..., None], 0.0)
        ds = DirectionSample(
            p=p, n=ng, d=d, dist=dist, pdf=pdf,
            delta=torch.zeros(n_lanes, dtype=torch.bool, device=p.device),
            emitter_index=torch.full((n_lanes,), emitter_index, dtype=torch.int32, device=p.device),
            uv=torch.stack([k.to(torch.float32), torch.zeros_like(dist)], dim=-1),
        )
        return ds, weight

    def eval_sample_value(self, ds, n_channels, wavelengths=None):
        """The radiance of the light recorded in ds.uv[..., 0], attached."""
        return self._rows(ds.uv[..., 0].to(torch.int64), n_channels, wavelengths)

    def pdf_direction(self, ref_p, si):
        """The solid-angle pdf of a hit on one of the fused lights (the
        selection within the group included)."""
        k = self._light_of(si)
        p_area = self.area_pdf[torch.clamp(k, min=0)]
        to_p = si.p - ref_p
        dist2 = dot(to_p, to_p)
        ok = (dist2 > 1e-18) & (k >= 0)
        d = to_p * torch.rsqrt(torch.where(ok, dist2, 1.0))[..., None]
        cos_e = -dot(d, si.n)
        valid = ok & (cos_e > 1e-6)
        return torch.where(valid, dist2 * p_area / torch.where(valid, cos_e, 1.0), 0.0)

    def parameters_changed(self, geometry):
        """Re-derive the selection tables after the triangles moved."""
        cdf, area_pdf, power = fused_area_tables(
            self.values.detach().cpu().numpy(), self.tri_index.cpu().numpy(),
            self.tri_light.cpu().numpy(), geometry)
        dev = self.tri_cdf.device
        return dataclasses.replace(self, tri_cdf=torch.from_numpy(cdf).to(dev),
                                   area_pdf=torch.from_numpy(area_pdf).to(dev),
                                   total_power=power)


@dataclass
class DirectionalAreaEmitter(AreaEmitter):
    """A collimated panel: a triangle shape emitting `radiance` along its
    normal only. Delta in both position and direction, it is neither
    sampled from a point nor hit by a path: the particle tracer carries its
    light (integrators/ptracer.py)."""

    is_delta = True
    is_directional_area = True

    def eval(self, si, n_channels, wavelengths=None):
        return _zeros_eval(si, n_channels)

    def sample_direction(self, ref_p, u2, geom, emitter_index, n_channels, wavelengths=None):
        n_lanes, dev = ref_p.shape[0], ref_p.device
        zero = torch.zeros(n_lanes, dtype=torch.float32, device=dev)
        ds = DirectionSample(
            p=ref_p, n=torch.zeros_like(ref_p), d=torch.zeros_like(ref_p), dist=zero, pdf=zero,
            delta=torch.ones(n_lanes, dtype=torch.bool, device=dev),
            emitter_index=torch.full((n_lanes,), emitter_index, dtype=torch.int32, device=dev),
            uv=torch.zeros(n_lanes, 2, dtype=torch.float32, device=dev),
        )
        return ds, torch.zeros(n_lanes, n_channels, dtype=torch.float32, device=dev)

    def pdf_direction(self, ref_p, si):
        return _zero_pdf(ref_p)
