"""BSDFs: the smooth Lambertian, the null BSDF of medium boundaries and
the GGX rough dielectric, the ocean interface of the atmosphere-ocean
integrators (counterpart of mitsuba_tpu/render/bsdfs.py).

As in the reference, eval(si, wo, n_channels) returns f(wi, wo) *
|cos_theta_o| [N, C], and sample() returns (BSDFSample, weight) with weight =
eval / pdf. The rough dielectric has a polarized form (eval_pdf_mueller,
sample_pol: local-frame Mueller matrices [N, C, 4, 4]); for the others,
Scene.bsdf_eval_pdf_pol and bsdf_sample_pol make the Lambertian a
depolarizer and the null BSDF a polarization-preserving pass-through. The
other BSDF plugins (the smooth and thin dielectrics, the conductors, the
polarizer and retarder among them) are not yet ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import warp
from ..core.frame import cross, dot, normalize
from ..core.math import INV_PI
from . import microfacet as mf
from . import mueller as mu
from .fresnel import fresnel
from .records import BSDFSample


def rotate_specular_mueller_m(M, wo_hat, wi_hat, m_normal):
    """A specular Mueller matrix M [N, C, 4, 4] whose reference vector is
    the s-axis (perpendicular to the plane of incidence about the
    microfacet normal m_normal) re-expressed in the implicit local Stokes
    bases: light arrives along -wo_hat and leaves along wi_hat (local
    frame)."""
    s_axis_in = cross(m_normal, -wo_hat)
    s_axis_out = cross(m_normal, wi_hat)
    collinear = torch.sum(s_axis_in * s_axis_in, dim=-1, keepdim=True) < 1e-16
    fallback = torch.zeros_like(wo_hat)
    fallback[..., 0] = 1.0
    s_axis_in = torch.where(collinear, fallback,
                            normalize(torch.where(collinear, fallback, s_axis_in)))
    s_axis_out = torch.where(collinear, fallback,
                             normalize(torch.where(collinear, fallback, s_axis_out)))
    return mu.rotate_mueller_basis(
        M,
        -wo_hat[..., None, :], s_axis_in[..., None, :], mu.stokes_basis(-wo_hat)[..., None, :],
        wi_hat[..., None, :], s_axis_out[..., None, :], mu.stokes_basis(wi_hat)[..., None, :],
    )


@dataclass
class DiffuseBSDF:
    reflectance: object   # texture
    flags_smooth = True
    flags_transmission = False

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
    flags_transmission = True

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


@dataclass
class RoughDielectricBSDF:
    """GGX rough dielectric with reflection and transmission (Walter et al.
    2007). As in the JAX package, eval uses Smith G = G1(wi) G1(wo) (the
    fork's plugin sets G = 1 there), so that a sample's weight is eval/pdf.
    On the back side (cos_theta_i < 0) the half vector takes the inverse
    relative IOR and is flipped into the upper hemisphere."""

    eta: torch.Tensor             # [] relative IOR, inside over outside
    alpha: torch.Tensor           # [] GGX roughness
    specular_reflectance: object  # texture
    specular_transmittance: object

    flags_smooth = True
    flags_transmission = True
    is_refractive_interface = True

    def _half_vector(self, wi, wo, reflect_mask):
        eta = torch.where(wi[..., 2] > 0, self.eta, 1.0 / self.eta)
        m = normalize(wi + wo * torch.where(reflect_mask, 1.0, eta)[..., None])
        return torch.where(m[..., 2:3] < 0, -m, m), eta

    def _valid(self, wi, wo, m):
        cos_i, cos_o = wi[..., 2], wo[..., 2]
        return ((torch.abs(cos_i) > 1e-6) & (dot(wi, m) * cos_i > 0)
                & (dot(wo, m) * cos_o > 0))

    def eval(self, si, wo, n_channels):
        wi = si.wi
        cos_i = wi[..., 2]
        cos_o = wo[..., 2]
        reflect_m = cos_i * cos_o > 0
        m, eta = self._half_vector(wi, wo, reflect_m)
        inv_eta = 1.0 / eta
        valid = self._valid(wi, wo, m)
        d = mf.ggx_d(m, self.alpha, self.alpha)
        g = (mf.smith_g1_ggx(torch.where(cos_i[..., None] > 0, wi, -wi), m, self.alpha, self.alpha)
             * mf.smith_g1_ggx(torch.where(cos_o[..., None] > 0, wo, -wo), m, self.alpha,
                               self.alpha))
        wim = dot(wi, m)
        wom = dot(wo, m)
        f, _, _, _ = fresnel(wim, self.eta)
        # invalid lanes divide by 1: their value is dropped, and a division
        # by 0 there would make the gradient of the scalar parameters NaN
        cos_i_ok = torch.where(valid, cos_i, 1.0)
        # reflection: F D G / (4 |cos_i|)
        val_r = f * d * g / (4.0 * torch.abs(cos_i_ok))
        # transmission (Walter eq. 21, with the radiance scale 1 / eta^2)
        denom = (wim + eta * wom) ** 2
        val_t = torch.abs((inv_eta ** 2) * (1.0 - f) * d * g * eta * eta * wim * wom
                          / (cos_i_ok * torch.clamp(denom, min=1e-12)))
        val = torch.where(valid, torch.where(reflect_m, val_r, val_t), 0.0)
        refl = self.specular_reflectance.eval(si.uv, n_channels)
        trans = self.specular_transmittance.eval(si.uv, n_channels)
        return val[..., None] * torch.where(reflect_m[..., None], refl, trans)

    def pdf(self, si, wo):
        wi = si.wi
        cos_i = wi[..., 2]
        reflect_m = cos_i * wo[..., 2] > 0
        m, eta = self._half_vector(wi, wo, reflect_m)
        valid = self._valid(wi, wo, m)
        wim = dot(wi, m)
        wom = dot(wo, m)
        dwh_dwo = torch.where(
            reflect_m,
            1.0 / torch.clamp(4.0 * torch.abs(wom), min=1e-12),
            (eta * eta * torch.abs(wom)) / torch.clamp((wim + eta * wom) ** 2, min=1e-12),
        )
        wi_up = torch.where(cos_i[..., None] > 0, wi, -wi)
        pdf_m = mf.ggx_pdf_visible(wi_up, m, self.alpha, self.alpha)
        f, _, _, _ = fresnel(wim, self.eta)
        lobe = torch.where(reflect_m, f, 1.0 - f)
        return torch.where(valid, pdf_m * lobe * dwh_dwo, 0.0)

    def _sample_m(self, u2, wi):
        """A visible normal from wi's side, aligned with wi's hemisphere,
        and the Fresnel terms at it."""
        cos_i = wi[..., 2]
        wi_up = torch.where(cos_i[..., None] > 0, wi, -wi)
        m = mf.ggx_sample_vndf(wi_up, u2[..., 0], u2[..., 1], self.alpha, self.alpha)
        m = torch.where(cos_i[..., None] > 0, m, -m)
        wim = dot(wi, m)
        return m, wim, fresnel(wim, self.eta)

    def sample(self, u_lobe, u2, si, n_channels):
        wi = si.wi
        cos_i = wi[..., 2]
        m, wim, (f, cos_theta_t, eta_it, eta_ti) = self._sample_m(u2, wi)
        pick_reflect = u_lobe <= f
        wo_r = 2.0 * wim[..., None] * m - wi
        # refraction about m
        wo_t = eta_ti[..., None] * (-wi) + (eta_ti * wim + cos_theta_t)[..., None] * m
        wo = torch.where(pick_reflect[..., None], wo_r, wo_t)
        # drop samples whose micro and macro hemispheres disagree (grazing
        # microfacets that send a reflection below the horizon): the pdf
        # would count them as transmissions
        agree = (wim * cos_i > 0) & (dot(wo, m) * wo[..., 2] > 0)
        pdf = torch.where(agree, self.pdf(si, wo), 0.0)
        val = self.eval(si, wo, n_channels)
        ok = agree & (pdf > 1e-10)
        weight = torch.where(ok[..., None], val / torch.clamp(pdf, min=1e-10)[..., None], 0.0)
        bs = BSDFSample(wo=wo, pdf=pdf, eta=torch.where(pick_reflect, 1.0, eta_it),
                        delta=torch.zeros_like(pick_reflect))
        return bs, weight

    def sample_pol(self, u_lobe, u2, si, n_channels):
        """The sampled direction weighted by the Mueller matrix:
        eval_pdf_mueller / pdf there."""
        bs, _ = self.sample(u_lobe, u2, si, n_channels)
        M, pdf = self.eval_pdf_mueller(si, bs.wo, n_channels)
        ok = (pdf > 1e-10)[..., None, None, None]
        return bs, torch.where(ok, M / torch.clamp(pdf, min=1e-10)[..., None, None, None], 0.0)

    def sample_transmission(self, u2, wi):
        """The transmission lobe alone, the atmosphere-ocean integrators'
        refracted NEE proposal: (wo, pdf), the pdf without the lobe's
        Fresnel factor (0 under total internal reflection)."""
        cos_i = wi[..., 2]
        m, wim, (_, cos_theta_t, _, eta_ti) = self._sample_m(u2, wi)
        wo = eta_ti[..., None] * (-wi) + (eta_ti * wim + cos_theta_t)[..., None] * m
        wom = dot(wo, m)
        eta = torch.where(cos_i > 0, self.eta, 1.0 / self.eta)
        dwh_dwo = (eta * eta * torch.abs(wom)) / torch.clamp((wim + eta * wom) ** 2, min=1e-12)
        up = cos_i[..., None] > 0
        pdf_m = mf.ggx_pdf_visible(torch.where(up, wi, -wi), torch.where(up, m, -m),
                                   self.alpha, self.alpha)
        return wo, torch.where(cos_theta_t == 0.0, 0.0, pdf_m * dwh_dwo)

    def eval_pdf_mueller(self, si, wo, n_channels):
        """(local-frame Mueller weight [N, C, 4, 4], pdf): the Fresnel
        Mueller matrix of reflection or transmission about the microfacet
        normal, normalised to M00 = 1 and scaled by eval's value."""
        wi = si.wi
        reflect_m = wi[..., 2] * wo[..., 2] > 0
        m, _ = self._half_vector(wi, wo, reflect_m)
        val = self.eval(si, wo, n_channels)
        pdf = self.pdf(si, wo)
        cos_o_hat = dot(wo, m)[..., None]
        R = mu.specular_reflection(cos_o_hat, self.eta)
        T = mu.specular_transmission(cos_o_hat, self.eta)
        M = torch.where(reflect_m[..., None, None, None], R, T)
        M = M.expand(M.shape[:-3] + (n_channels, 4, 4))
        m00 = M[..., 0:1, 0:1]
        big = torch.abs(m00) > 1e-12
        M = torch.where(big, M / torch.where(big, m00, 1.0), 0.0)
        M = rotate_specular_mueller_m(M, wo, wi, m)
        return torch.nan_to_num(M * val[..., None, None]), pdf
