"""BSDFs: the smooth Lambertian and the null BSDF of medium boundaries
(counterpart of mitsuba_tpu/render/bsdfs.py).

As in the reference, eval(si, wo, n_channels) returns f(wi, wo) *
|cos_theta_o| [N, C], and sample() returns (BSDFSample, weight) with weight =
eval / pdf. Neither has a polarized form: Scene.bsdf_eval_pdf_pol and
bsdf_sample_pol make the Lambertian a depolarizer and the null BSDF a
polarization-preserving pass-through. The other BSDF plugins are not yet
ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import warp
from ..core.math import INV_PI
from .records import BSDFSample


@dataclass
class DiffuseBSDF:
    reflectance: object   # texture
    flags_smooth = True

    def eval(self, si, wo, n_channels):
        cos_i = si.wi[..., 2]
        cos_o = wo[..., 2]
        valid = (cos_i > 0) & (cos_o > 0)
        refl = self.reflectance.eval(si.uv, n_channels)
        val = refl * (INV_PI * torch.clamp(cos_o, min=0.0))[..., None]
        return torch.where(valid[..., None], val, 0.0)

    def pdf(self, si, wo):
        valid = (si.wi[..., 2] > 0) & (wo[..., 2] > 0)
        return torch.where(valid, warp.square_to_cosine_hemisphere_pdf(wo), 0.0)

    def sample(self, u_lobe, u2, si, n_channels):
        wo = warp.square_to_cosine_hemisphere(u2)
        pdf = warp.square_to_cosine_hemisphere_pdf(wo)
        valid = si.wi[..., 2] > 0
        refl = self.reflectance.eval(si.uv, n_channels)
        weight = torch.where(valid[..., None], refl, 0.0)
        bs = BSDFSample(
            wo=wo,
            pdf=torch.where(valid, pdf, 0.0),
            eta=torch.ones_like(pdf),
            delta=torch.zeros_like(valid),
        )
        return bs, weight


@dataclass
class NullBSDF:
    """A perfect transmitter: the boundary of a medium. It has no smooth
    lobe (eval and pdf are 0); sampling passes the ray on unchanged, a
    Dirac event of weight 1."""

    flags_smooth = False

    def eval(self, si, wo, n_channels):
        return torch.zeros(wo.shape[:-1] + (n_channels,), dtype=torch.float32, device=wo.device)

    def pdf(self, si, wo):
        return torch.zeros(wo.shape[:-1], dtype=torch.float32, device=wo.device)

    def sample(self, u_lobe, u2, si, n_channels):
        n, dev = si.wi.shape[0], si.wi.device
        bs = BSDFSample(
            wo=-si.wi,
            pdf=torch.ones(n, dtype=torch.float32, device=dev),
            eta=torch.ones(n, dtype=torch.float32, device=dev),
            delta=torch.ones(n, dtype=torch.bool, device=dev),
        )
        return bs, torch.ones(n, n_channels, dtype=torch.float32, device=dev)
