"""The AOV, Stokes and moment integrators (counterpart of
mitsuba_tpu/integrators/aov.py)."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AOVIntegrator:
    """Geometric values of the first hit (depth, normals, position, uv,
    albedo, indices), from the reference's ``name:type`` comma list: the
    values are packed into the image in order, padded with zeros or cut to
    the variant's channel count. They are signed, so the film keeps their
    negative values (``signed_output``)."""

    aovs: str = "dd.y:depth"
    signed_output = True

    def _channels(self):
        return [item.strip().split(":")[-1] for item in self.aovs.split(",")]

    def sample(self, scene, rng, ray, active, wavelengths=None):
        si = scene.ray_intersect(ray, active)
        valid = si.is_valid
        nc = scene.n_channels
        values = []
        for kind in self._channels():
            if kind == "depth":
                values.append(torch.where(valid, si.t, 0.0)[..., None])
            elif kind in ("sh_normal", "normals", "nn"):
                values.append(torch.where(valid[..., None], si.sh_n, 0.0))
            elif kind == "geo_normal":
                values.append(torch.where(valid[..., None], si.n, 0.0))
            elif kind in ("position", "p"):
                values.append(torch.where(valid[..., None], si.p, 0.0))
            elif kind == "uv":
                values.append(torch.where(valid[..., None], si.uv, 0.0))
            elif kind == "albedo":
                # the diffuse reflectance: eval toward +n times pi
                wo_up = torch.zeros_like(si.p)
                wo_up[..., 2] = 1.0
                alb, _ = scene.bsdf_eval_pdf(si, wo_up, valid, wavelengths)
                values.append(torch.where(valid[..., None], alb * math.pi, 0.0))
            elif kind in ("shape_index", "prim_index"):
                values.append(getattr(si, kind).to(torch.float32)[..., None])
            else:
                raise ValueError(f"unknown AOV type {kind!r}")
        out = torch.cat(values, dim=-1)
        if out.shape[-1] < nc:
            out = torch.nn.functional.pad(out, (0, nc - out.shape[-1]))
        return out[..., :nc], {"n_rays": active.sum()}


@dataclass(frozen=True)
class StokesIntegrator:
    """The Stokes components of the nested integrator's radiance: in a
    polarized variant the nested integrator already gives Stokes vectors
    [N, C, 4], which pass through to the Stokes-major film. Outside one it
    raises ValueError when it renders."""

    nested: object

    def sample(self, scene, rng, ray, active, wavelengths=None):
        if not scene.polarized:
            raise ValueError("the stokes integrator requires a polarized variant")
        return self.nested.sample(scene, rng, ray, active, wavelengths)


@dataclass(frozen=True)
class MomentIntegrator:
    """The second moment of the nested integrator's samples: each sample's
    square, so that the film's mean is E[X^2]."""

    nested: object

    def sample(self, scene, rng, ray, active, wavelengths=None):
        L, aux = self.nested.sample(scene, rng, ray, active, wavelengths)
        return L * L, aux
