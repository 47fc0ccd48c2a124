"""Direct illumination with emitter and BSDF sampling under MIS, and the
distance to the first hit (counterpart of mitsuba_tpu/integrators/direct.py).

Both draw their random numbers as the JAX package's do, so each lane takes
the same samples: per emitter sample two next_2d (the emitter's pick, the
direction's two numbers), then per BSDF sample two next_2d (the lobe, the
direction's two numbers).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..render.records import spawn_ray
from .path import mis_weight


@dataclass(frozen=True)
class DirectIntegrator:
    """One bounce of light: emitter hits seen directly, then
    emitter_samples NEE samples and bsdf_samples BSDF samples of the first
    hit, each MIS-weighted against the other strategy's pdf (a Dirac
    emitter or lobe takes weight 1)."""

    emitter_samples: int = 1
    bsdf_samples: int = 1

    def sample(self, scene, rng, ray, active, wavelengths=None):
        """Radiance [N, C] and {"n_rays": closest hits, shadow rays and
        BSDF-sample rays cast}."""
        n, nc = ray.o.shape[0], scene.n_channels
        si = scene.ray_intersect(ray, active)
        L = torch.zeros(n, nc, dtype=torch.float32, device=ray.o.device)
        escaped = active & ~si.is_valid
        L = L + torch.where(escaped[..., None], scene.eval_environment(ray.d, wavelengths), 0.0)
        hit = active & si.is_valid
        L = L + torch.where(hit[..., None], scene.eval_emitter_hit(si, wavelengths), 0.0)
        n_hit = hit.sum()
        n_rays = active.sum()

        for _ in range(self.emitter_samples):
            u0, ux, rng = rng.next_2d()
            uy, _, rng = rng.next_2d()
            ds, em_weight = scene.sample_emitter_direction(
                si.p, u0, torch.stack([ux, uy], dim=-1), hit, test_visibility=True, ref_n=si.n,
                wavelengths=wavelengths)
            bsdf_val, bsdf_pdf = scene.bsdf_eval_pdf(si, si.to_local(ds.d), hit, wavelengths)
            w = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
            L = L + torch.where(hit[..., None],
                                bsdf_val * em_weight * (w / self.emitter_samples)[..., None], 0.0)
            n_rays = n_rays + n_hit

        for _ in range(self.bsdf_samples):
            u_lobe, ux, rng = rng.next_2d()
            uy, _, rng = rng.next_2d()
            bs, bsdf_weight = scene.bsdf_sample(si, u_lobe, torch.stack([ux, uy], dim=-1), hit,
                                                wavelengths)
            ray2 = spawn_ray(si.p, si.n, si.to_world(bs.wo))
            si2 = scene.ray_intersect(ray2, hit)
            esc2 = hit & ~si2.is_valid
            em_val2 = torch.where(esc2[..., None], scene.eval_environment(ray2.d, wavelengths),
                                  scene.eval_emitter_hit(si2, wavelengths))
            pdf_em = torch.where(esc2, scene.pdf_emitter_direction_escaped(ray2.d),
                                 scene.pdf_emitter_direction_hit(si.p, si2))
            w = torch.where(bs.delta, 1.0, mis_weight(bs.pdf, pdf_em))
            L = L + torch.where((hit & (bs.pdf > 0))[..., None],
                                bsdf_weight * em_val2 * (w / self.bsdf_samples)[..., None], 0.0)
            n_rays = n_rays + n_hit
        return L, {"n_rays": n_rays}


@dataclass(frozen=True)
class DepthIntegrator:
    """The distance to the first hit, 0 where the ray escapes, in every
    channel."""

    def sample(self, scene, rng, ray, active, wavelengths=None):
        si = scene.ray_intersect(ray, active)
        d = torch.where(si.is_valid, si.t, 0.0)
        return d[..., None].expand(d.shape + (scene.n_channels,)), {"n_rays": active.sum()}
