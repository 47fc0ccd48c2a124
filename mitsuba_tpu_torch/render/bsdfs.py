"""BSDF plugins (counterpart of mitsuba_tpu/render/bsdfs.py): the smooth
Lambertian; the null BSDF of medium boundaries; the smooth and thin
dielectrics; the smooth and GGX rough conductors; the GGX rough
dielectric; the rough and polarized plastics; the ideal linear polarizer,
circular polarizer and linear retarder; and the two-sided, mask and blend
wrappers.

As in the reference, eval(si, wo, n_channels) returns f(wi, wo) *
|cos_theta_o| [N, C], and sample() returns (BSDFSample, weight) with weight =
eval / pdf; a Dirac lobe (the smooth dielectrics and conductor, the
polarization optics, a mask's pass-through) has eval = pdf = 0 and its
sampled weight carries the whole factor. The polarized forms are local-frame
Mueller matrices [N, C, 4, 4]: sample_pol (the smooth dielectric and
conductor, the rough dielectric, pplastic and the polarization optics) and
eval_pdf_mueller (the rough dielectric and pplastic). Scene.bsdf_eval_pdf_pol
and bsdf_sample_pol make every other BSDF a depolarizer, and the null BSDF a
polarization-preserving pass-through.

A wrapper's flags_smooth is its nested BSDF's, and Scene.bsdf_eval_pdf
evaluates only BSDFs with smooth flags: a Dirac BSDF adds nothing to NEE and
no attached term to a PRB replay.

Not yet ported, and refused by the loader: ``normalmap`` and ``bumpmap``
(they wait for the bitmap textures), ``plastic`` (the smooth plastic of the
principled family), ``principled``, ``principledthin``, ``measured``,
``measured_polarized`` and ``hair``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..core import warp
from ..core.frame import cross, dot, normalize, reflect
from ..core.math import INV_PI
from . import microfacet as mf
from . import mueller as mu
from .fresnel import fresnel, fresnel_conductor
from .records import BSDFSample


def _unit_z(like):
    """(0, 0, 1) in the shape of the vectors `like` [..., 3]."""
    z = torch.zeros_like(like)
    z[..., 2] = 1.0
    return z


def _flip_z(v):
    return torch.stack([v[..., 0], v[..., 1], -v[..., 2]], dim=-1)


def _invalid_sample(n, device):
    """A sample that no lane takes: wo = +z, pdf 0."""
    return BSDFSample(
        wo=_unit_z(torch.zeros(n, 3, dtype=torch.float32, device=device)),
        pdf=torch.zeros(n, dtype=torch.float32, device=device),
        eta=torch.ones(n, dtype=torch.float32, device=device),
        delta=torch.zeros(n, dtype=torch.bool, device=device),
    )


def _pass_through(si):
    """The Dirac sample wo = -wi of pdf 1: the transmission of the null
    BSDF and of the polarization optics."""
    n, dev = si.wi.shape[0], si.wi.device
    return BSDFSample(
        wo=-si.wi,
        pdf=torch.ones(n, dtype=torch.float32, device=dev),
        eta=torch.ones(n, dtype=torch.float32, device=dev),
        delta=torch.ones(n, dtype=torch.bool, device=dev),
    )


def rotate_specular_mueller(M, wo_hat, wi_hat):
    """rotate_specular_mueller_m about the geometric normal +z: a Dirac
    lobe's Mueller matrix M [N, C, 4, 4], whose reference vector is the
    s-axis, in the implicit local Stokes bases."""
    return rotate_specular_mueller_m(M, wo_hat, wi_hat, _unit_z(wo_hat))


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


class _Dirac:
    """A BSDF made of Dirac lobes only: eval and pdf are 0 everywhere."""

    flags_smooth = False

    def eval(self, si, wo, n_channels, wavelengths=None):
        return torch.zeros(wo.shape[:-1] + (n_channels,), dtype=torch.float32, device=wo.device)

    def pdf(self, si, wo):
        return torch.zeros(wo.shape[:-1], dtype=torch.float32, device=wo.device)


@dataclass
class DiffuseBSDF:
    reflectance: object   # texture
    flags_smooth = True
    flags_transmission = False

    def eval(self, si, wo, n_channels, wavelengths=None):
        cos_i = si.wi[..., 2]
        cos_o = wo[..., 2]
        valid = (cos_i > 0) & (cos_o > 0)
        refl = self.reflectance.eval(si.uv, n_channels, wavelengths)
        val = refl * (INV_PI * torch.clamp(cos_o, min=0.0))[..., None]
        return torch.where(valid[..., None], val, 0.0)

    def pdf(self, si, wo):
        valid = (si.wi[..., 2] > 0) & (wo[..., 2] > 0)
        return torch.where(valid, warp.square_to_cosine_hemisphere_pdf(wo), 0.0)

    def sample(self, u_lobe, u2, si, n_channels, wavelengths=None):
        wo = warp.square_to_cosine_hemisphere(u2)
        pdf = warp.square_to_cosine_hemisphere_pdf(wo)
        valid = si.wi[..., 2] > 0
        refl = self.reflectance.eval(si.uv, n_channels, wavelengths)
        weight = torch.where(valid[..., None], refl, 0.0)
        bs = BSDFSample(
            wo=wo,
            pdf=torch.where(valid, pdf, 0.0),
            eta=torch.ones_like(pdf),
            delta=torch.zeros_like(valid),
        )
        return bs, weight


@dataclass
class NullBSDF(_Dirac):
    """A perfect transmitter: the boundary of a medium. It has no smooth
    lobe; sampling passes the ray on unchanged, a Dirac event of weight 1."""

    flags_transmission = True

    def sample(self, u_lobe, u2, si, n_channels, wavelengths=None):
        return _pass_through(si), torch.ones(si.wi.shape[0], n_channels, dtype=torch.float32,
                                             device=si.wi.device)


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

    def eval(self, si, wo, n_channels, wavelengths=None):
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
        refl = self.specular_reflectance.eval(si.uv, n_channels, wavelengths)
        trans = self.specular_transmittance.eval(si.uv, n_channels, wavelengths)
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

    def sample(self, u_lobe, u2, si, n_channels, wavelengths=None):
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
        val = self.eval(si, wo, n_channels, wavelengths)
        ok = agree & (pdf > 1e-10)
        weight = torch.where(ok[..., None], val / torch.clamp(pdf, min=1e-10)[..., None], 0.0)
        bs = BSDFSample(wo=wo, pdf=pdf, eta=torch.where(pick_reflect, 1.0, eta_it),
                        delta=torch.zeros_like(pick_reflect))
        return bs, weight

    def sample_pol(self, u_lobe, u2, si, n_channels, wavelengths=None):
        """The sampled direction weighted by the Mueller matrix:
        eval_pdf_mueller / pdf there."""
        bs, _ = self.sample(u_lobe, u2, si, n_channels, wavelengths)
        M, pdf = self.eval_pdf_mueller(si, bs.wo, n_channels, wavelengths)
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

    def eval_pdf_mueller(self, si, wo, n_channels, wavelengths=None):
        """(local-frame Mueller weight [N, C, 4, 4], pdf): the Fresnel
        Mueller matrix of reflection or transmission about the microfacet
        normal, normalised to M00 = 1 and scaled by eval's value."""
        wi = si.wi
        reflect_m = wi[..., 2] * wo[..., 2] > 0
        m, _ = self._half_vector(wi, wo, reflect_m)
        val = self.eval(si, wo, n_channels, wavelengths)
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


@dataclass
class SmoothDielectricBSDF(_Dirac):
    """Smooth dielectric: Fresnel-chosen reflection and refraction, two
    Dirac lobes; refraction scales radiance by eta_ti^2."""

    eta: torch.Tensor             # [] relative IOR, inside over outside
    specular_reflectance: object  # texture
    specular_transmittance: object

    flags_transmission = True

    def sample(self, u_lobe, u2, si, n_channels, wavelengths=None):
        cos_i = si.wi[..., 2]
        f, cos_theta_t, eta_it, eta_ti = fresnel(cos_i, self.eta)
        pick_reflect = u_lobe <= f
        wo_t = torch.stack([-eta_ti * si.wi[..., 0], -eta_ti * si.wi[..., 1], cos_theta_t], dim=-1)
        wo = torch.where(pick_reflect[..., None], reflect(si.wi), wo_t)
        refl = self.specular_reflectance.eval(si.uv, n_channels, wavelengths)
        trans = self.specular_transmittance.eval(si.uv, n_channels, wavelengths)
        weight = torch.where(pick_reflect[..., None], refl, trans * (eta_ti * eta_ti)[..., None])
        bs = BSDFSample(wo=wo, pdf=torch.where(pick_reflect, f, 1.0 - f),
                        eta=torch.where(pick_reflect, 1.0, eta_it),
                        delta=torch.ones_like(pick_reflect))
        return bs, weight

    def sample_pol(self, u_lobe, u2, si, n_channels, wavelengths=None):
        """The sampled lobe's Fresnel Mueller matrix over its pdf, rotated
        into the local implicit bases: light arrives along -bs.wo and
        leaves along si.wi."""
        bs, _ = self.sample(u_lobe, u2, si, n_channels, wavelengths)
        cos_o = bs.wo[..., 2:3]
        pick_reflect = bs.eta == 1.0
        M = torch.where(pick_reflect[..., None, None, None],
                        mu.specular_reflection(cos_o, self.eta),
                        mu.specular_transmission(cos_o, self.eta))
        M = M.expand(M.shape[:-3] + (n_channels, 4, 4))
        M = M / torch.clamp(bs.pdf, min=1e-8)[..., None, None, None]
        M = rotate_specular_mueller(M, bs.wo, si.wi)
        scalar = torch.where(pick_reflect[..., None],
                             self.specular_reflectance.eval(si.uv, n_channels, wavelengths),
                             self.specular_transmittance.eval(si.uv, n_channels, wavelengths))
        return bs, M * scalar[..., None, None]


@dataclass
class ThinDielectricBSDF(_Dirac):
    """A thin dielectric slab: reflection with R' = 2R / (1 + R), which
    sums the slab's internal bounces, or straight transmission."""

    eta: torch.Tensor
    specular_reflectance: object
    specular_transmittance: object

    flags_transmission = True

    def sample(self, u_lobe, u2, si, n_channels, wavelengths=None):
        f, _, _, _ = fresnel(torch.abs(si.wi[..., 2]), self.eta)
        f = torch.where(f < 1.0, 2.0 * f / (1.0 + f), 1.0)
        pick_reflect = u_lobe <= f
        wo = torch.where(pick_reflect[..., None], reflect(si.wi), -si.wi)
        weight = torch.where(pick_reflect[..., None],
                             self.specular_reflectance.eval(si.uv, n_channels, wavelengths),
                             self.specular_transmittance.eval(si.uv, n_channels, wavelengths))
        pdf = torch.where(pick_reflect, f, 1.0 - f)
        bs = BSDFSample(wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
                        delta=torch.ones_like(pick_reflect))
        return bs, weight


@dataclass
class SmoothConductorBSDF(_Dirac):
    """Smooth conductor: a Dirac mirror weighted by the Fresnel reflectance
    of the complex index eta - i k (one value per channel)."""

    eta: torch.Tensor             # [C] or [1], real part of the IOR
    k: torch.Tensor               # [C] or [1], extinction
    specular_reflectance: object

    flags_transmission = False

    def sample(self, u_lobe, u2, si, n_channels, wavelengths=None):
        cos_i = si.wi[..., 2]
        valid = cos_i > 0
        f = fresnel_conductor(cos_i[..., None], self.eta, self.k)
        f = f.expand(f.shape[:-1] + (n_channels,))
        refl = self.specular_reflectance.eval(si.uv, n_channels, wavelengths)
        bs = BSDFSample(wo=reflect(si.wi), pdf=torch.where(valid, 1.0, 0.0),
                        eta=torch.ones_like(cos_i), delta=torch.ones_like(valid))
        return bs, torch.where(valid[..., None], f * refl, 0.0)

    def sample_pol(self, u_lobe, u2, si, n_channels, wavelengths=None):
        """The mirror's Mueller matrix, from the complex Fresnel amplitudes
        of eta - i k in complex64."""
        bs, _ = self.sample(u_lobe, u2, si, n_channels, wavelengths)
        eta_c = torch.complex(self.eta, -self.k)
        R = mu.specular_reflection(bs.wo[..., 2:3], eta_c)
        R = rotate_specular_mueller(R.expand(R.shape[:-3] + (n_channels, 4, 4)), bs.wo, si.wi)
        valid = si.wi[..., 2] > 0
        refl = self.specular_reflectance.eval(si.uv, n_channels, wavelengths)
        return bs, torch.where(valid[..., None, None, None], R * refl[..., None, None], 0.0)


@dataclass
class RoughConductorBSDF:
    """GGX microfacet conductor, sampled from the visible normals. It has
    no polarized eval: the polarized dispatch depolarizes it."""

    eta: torch.Tensor
    k: torch.Tensor
    alpha_u: torch.Tensor
    alpha_v: torch.Tensor
    specular_reflectance: object

    flags_smooth = True
    flags_transmission = False

    @staticmethod
    def _half(wi, wo, valid):
        """The half vector, NaN-safe: masked lanes (where wi + wo can
        vanish, as at wo = -wi) take +z before the normalisation, so that
        no gradient of the unselected branch leaks NaN through the where."""
        return normalize(torch.where(valid[..., None], wi + wo, _unit_z(wi)))

    def eval(self, si, wo, n_channels, wavelengths=None):
        # f cos_o = D G F / (4 cos_i cos_o) * cos_o = D G F / (4 cos_i)
        cos_i = si.wi[..., 2]
        valid = (cos_i > 0) & (wo[..., 2] > 0)
        h = self._half(si.wi, wo, valid)
        d = mf.ggx_d(h, self.alpha_u, self.alpha_v)
        g = mf.ggx_g(si.wi, wo, h, self.alpha_u, self.alpha_v)
        f = fresnel_conductor(dot(si.wi, h)[..., None], self.eta, self.k)
        f = f.expand(f.shape[:-1] + (n_channels,))
        spec = (d * g / torch.clamp(4.0 * cos_i, min=1e-9))[..., None] * f
        refl = self.specular_reflectance.eval(si.uv, n_channels, wavelengths)
        return torch.where(valid[..., None], spec, 0.0) * refl

    def pdf(self, si, wo):
        valid = (si.wi[..., 2] > 0) & (wo[..., 2] > 0)
        h = self._half(si.wi, wo, valid)
        pdf_h = mf.ggx_pdf_visible(si.wi, h, self.alpha_u, self.alpha_v)
        jac = 1.0 / torch.clamp(4.0 * torch.abs(dot(wo, h)), min=1e-9)
        return torch.where(valid, pdf_h * jac, 0.0)

    def sample(self, u_lobe, u2, si, n_channels, wavelengths=None):
        m = mf.ggx_sample_vndf(si.wi, u2[..., 0], u2[..., 1], self.alpha_u, self.alpha_v)
        wo = 2.0 * dot(si.wi, m, keepdims=True) * m - si.wi
        pdf = self.pdf(si, wo)
        val = self.eval(si, wo, n_channels, wavelengths)
        weight = torch.where((pdf > 0)[..., None], val / torch.clamp(pdf, min=1e-20)[..., None],
                             0.0)
        bs = BSDFSample(wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
                        delta=torch.zeros(pdf.shape, dtype=torch.bool, device=pdf.device))
        return bs, weight


@dataclass
class TwoSidedBSDF:
    """Two-sided adapter: a back-side hit sees the nested BSDF through the
    mirrored frame (wi and wo with z negated)."""

    nested: object

    flags_transmission = False

    @property
    def flags_smooth(self):
        return self.nested.flags_smooth

    def _flip(self, si):
        flip = si.wi[..., 2] < 0
        wi = torch.where(flip[..., None], _flip_z(si.wi), si.wi)
        return dataclasses.replace(si, wi=wi), flip

    def eval(self, si, wo, n_channels, wavelengths=None):
        si2, flip = self._flip(si)
        return self.nested.eval(si2, torch.where(flip[..., None], _flip_z(wo), wo), n_channels,
                                wavelengths)

    def pdf(self, si, wo):
        si2, flip = self._flip(si)
        return self.nested.pdf(si2, torch.where(flip[..., None], _flip_z(wo), wo))

    def sample(self, u_lobe, u2, si, n_channels, wavelengths=None):
        si2, flip = self._flip(si)
        bs, weight = self.nested.sample(u_lobe, u2, si2, n_channels, wavelengths)
        wo = torch.where(flip[..., None], _flip_z(bs.wo), bs.wo)
        return dataclasses.replace(bs, wo=wo), weight


@dataclass
class MaskBSDF:
    """Opacity mask: with probability 1 - opacity the ray passes straight
    through (a Dirac lobe of weight 1); otherwise the nested BSDF scatters
    it, its lobe chosen by u_lobe rescaled to [0, 1]."""

    nested: object
    opacity: object   # texture

    flags_transmission = True

    @property
    def flags_smooth(self):
        return self.nested.flags_smooth

    def eval(self, si, wo, n_channels, wavelengths=None):
        return (self.nested.eval(si, wo, n_channels, wavelengths)
                * self.opacity.eval(si.uv, n_channels, wavelengths))

    def pdf(self, si, wo):
        return self.nested.pdf(si, wo) * torch.mean(self.opacity.eval(si.uv, 1), dim=-1)

    def sample(self, u_lobe, u2, si, n_channels, wavelengths=None):
        op_s = torch.mean(self.opacity.eval(si.uv, n_channels, wavelengths), dim=-1)
        pass_through = u_lobe >= op_s
        u_nested = torch.clamp(u_lobe / torch.clamp(op_s, min=1e-6), 0.0, 1.0)
        bs_n, w_n = self.nested.sample(u_nested, u2, si, n_channels, wavelengths)
        bs = BSDFSample(
            wo=torch.where(pass_through[..., None], -si.wi, bs_n.wo),
            pdf=torch.where(pass_through, 1.0 - op_s, bs_n.pdf * op_s),
            eta=torch.where(pass_through, 1.0, bs_n.eta),
            delta=pass_through | bs_n.delta,
        )
        return bs, torch.where(pass_through[..., None], 1.0, w_n)


@dataclass
class BlendBSDF:
    """Convex combination (1 - w) a + w b by a weight texture. A sample
    draws from both children (u_lobe rescaled for each) and keeps b's with
    probability w; its pdf and value are the mixture's."""

    bsdf_a: object
    bsdf_b: object
    weight: object    # texture: the weight of bsdf_b

    flags_smooth = True
    flags_transmission = False

    def _w(self, si):
        return torch.mean(self.weight.eval(si.uv, 1), dim=-1)

    def eval(self, si, wo, n_channels, wavelengths=None):
        w = self._w(si)[..., None]
        return ((1 - w) * self.bsdf_a.eval(si, wo, n_channels, wavelengths)
                + w * self.bsdf_b.eval(si, wo, n_channels, wavelengths))

    def pdf(self, si, wo):
        w = self._w(si)
        return (1 - w) * self.bsdf_a.pdf(si, wo) + w * self.bsdf_b.pdf(si, wo)

    def sample(self, u_lobe, u2, si, n_channels, wavelengths=None):
        w = self._w(si)
        pick_b = u_lobe < w
        u_a = torch.clamp((u_lobe - w) / torch.clamp(1 - w, min=1e-6), 0.0, 1.0)
        u_b = torch.clamp(u_lobe / torch.clamp(w, min=1e-6), 0.0, 1.0)
        bs_a, _ = self.bsdf_a.sample(u_a, u2, si, n_channels, wavelengths)
        bs_b, _ = self.bsdf_b.sample(u_b, u2, si, n_channels, wavelengths)
        wo = torch.where(pick_b[..., None], bs_b.wo, bs_a.wo)
        pdf = self.pdf(si, wo)
        val = self.eval(si, wo, n_channels, wavelengths)
        weight = torch.where((pdf > 1e-10)[..., None],
                             val / torch.clamp(pdf, min=1e-10)[..., None], 0.0)
        bs = BSDFSample(wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
                        delta=torch.zeros(pdf.shape, dtype=torch.bool, device=pdf.device))
        return bs, weight


@dataclass
class PolarizerBSDF(_Dirac):
    """Ideal linear polarizer: a Dirac transmission (wo = -wi) through a
    linear polarizer rotated by theta; unpolarized variants see 0.5 times
    the transmittance."""

    theta: torch.Tensor        # the transmission axis's angle, radians
    transmittance: object

    flags_transmission = True

    def sample(self, u_lobe, u2, si, n_channels, wavelengths=None):
        return _pass_through(si), 0.5 * self.transmittance.eval(si.uv, n_channels, wavelengths)

    def sample_pol(self, u_lobe, u2, si, n_channels, wavelengths=None):
        M = mu.rotated_element(self.theta, mu.linear_polarizer(torch.ones_like(self.theta)))
        t = self.transmittance.eval(si.uv, n_channels, wavelengths)
        return _pass_through(si), M * t[..., None, None]


@dataclass
class CircularPolarizerBSDF(_Dirac):
    """Ideal circular polarizer: a Dirac transmission passing right- (or
    left-) circularly polarized light."""

    transmittance: object
    left: bool = False

    flags_transmission = True

    def sample(self, u_lobe, u2, si, n_channels, wavelengths=None):
        return _pass_through(si), 0.5 * self.transmittance.eval(si.uv, n_channels, wavelengths)

    def sample_pol(self, u_lobe, u2, si, n_channels, wavelengths=None):
        M = mu.circular_polarizer(1.0, left=self.left).to(si.wi.device)
        t = self.transmittance.eval(si.uv, n_channels, wavelengths)
        return _pass_through(si), M * t[..., None, None]


@dataclass
class RetarderBSDF(_Dirac):
    """Ideal linear retarder (a wave plate): a Dirac transmission through
    a retarder of phase delta_phase rotated by theta."""

    theta: torch.Tensor
    delta_phase: torch.Tensor   # radians; pi / 2 is a quarter wave
    transmittance: object

    flags_transmission = True

    def sample(self, u_lobe, u2, si, n_channels, wavelengths=None):
        return _pass_through(si), self.transmittance.eval(si.uv, n_channels, wavelengths)

    def sample_pol(self, u_lobe, u2, si, n_channels, wavelengths=None):
        M = mu.rotated_element(self.theta, mu.linear_retarder(self.delta_phase))
        t = self.transmittance.eval(si.uv, n_channels, wavelengths)
        return _pass_through(si), M * t[..., None, None]


@dataclass
class RoughPlasticBSDF:
    """Rough plastic: a GGX specular coat over a Lambertian base, without
    the reference's nonlinear internal-reflection term. The specular lobe
    is sampled with the Fresnel reflectance at wi clipped to [0.15, 0.9]."""

    eta: torch.Tensor
    alpha: torch.Tensor
    diffuse_reflectance: object
    specular_reflectance: object

    flags_smooth = True
    flags_transmission = False

    def _spec_prob(self, si):
        f_i, _, _, _ = fresnel(si.wi[..., 2], self.eta)
        return torch.clamp(f_i, 0.15, 0.9)

    def _lobes(self, si, wo, n_channels, wavelengths=None):
        """(specular, diffuse) [N, C] values of the two lobes, f * cos_o,
        before the lanes below either horizon are masked."""
        cos_i, cos_o = si.wi[..., 2], wo[..., 2]
        h = normalize(si.wi + wo)
        d = mf.ggx_d(h, self.alpha, self.alpha)
        g = mf.ggx_g(si.wi, wo, h, self.alpha, self.alpha)
        f_h, _, _, _ = fresnel(dot(si.wi, h), self.eta)
        spec = ((f_h * d * g / torch.clamp(4.0 * cos_i, min=1e-9))[..., None]
                * self.specular_reflectance.eval(si.uv, n_channels, wavelengths))
        f_i, _, _, _ = fresnel(cos_i, self.eta)
        f_o, _, _, _ = fresnel(cos_o, self.eta)
        diff = self.diffuse_reflectance.eval(si.uv, n_channels, wavelengths) * (
            (1.0 - f_i) * (1.0 - f_o) * (1.0 / (self.eta ** 2)) * INV_PI
            * torch.clamp(cos_o, min=0.0))[..., None]
        return spec, diff

    def eval(self, si, wo, n_channels, wavelengths=None):
        valid = (si.wi[..., 2] > 0) & (wo[..., 2] > 0)
        spec, diff = self._lobes(si, wo, n_channels, wavelengths)
        return torch.where(valid[..., None], spec + diff, 0.0)

    def pdf(self, si, wo):
        valid = (si.wi[..., 2] > 0) & (wo[..., 2] > 0)
        prob = self._spec_prob(si)
        h = normalize(si.wi + wo)
        pdf_spec = mf.ggx_pdf_visible(si.wi, h, self.alpha, self.alpha) / torch.clamp(
            4.0 * torch.abs(dot(wo, h)), min=1e-9)
        pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo)
        return torch.where(valid, prob * pdf_spec + (1 - prob) * pdf_diff, 0.0)

    def sample(self, u_lobe, u2, si, n_channels, wavelengths=None):
        pick_spec = u_lobe < self._spec_prob(si)
        m = mf.ggx_sample_vndf(si.wi, u2[..., 0], u2[..., 1], self.alpha, self.alpha)
        wo_spec = 2.0 * dot(si.wi, m, keepdims=True) * m - si.wi
        wo = torch.where(pick_spec[..., None], wo_spec, warp.square_to_cosine_hemisphere(u2))
        pdf = self.pdf(si, wo)
        val = self.eval(si, wo, n_channels, wavelengths)
        weight = torch.where((pdf > 1e-12)[..., None],
                             val / torch.clamp(pdf, min=1e-12)[..., None], 0.0)
        bs = BSDFSample(wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
                        delta=torch.zeros(pdf.shape, dtype=torch.bool, device=pdf.device))
        return bs, weight


@dataclass
class PPlasticBSDF(RoughPlasticBSDF):
    """Polarized plastic: roughplastic's lobes, the specular one with the
    polarized Fresnel Mueller matrix about the half vector and the diffuse
    one an ideal depolarizer; its unpolarized values are roughplastic's."""

    def eval_pdf_mueller(self, si, wo, n_channels, wavelengths=None):
        """(local-frame Mueller weight [N, C, 4, 4], pdf): the Fresnel
        reflection matrix about h normalised to M00 = 1 and scaled by the
        specular value, plus the depolarized diffuse value."""
        valid = ((si.wi[..., 2] > 0) & (wo[..., 2] > 0))[..., None]
        spec, diff = self._lobes(si, wo, n_channels, wavelengths)
        spec = torch.where(valid, spec, 0.0)
        diff = torch.where(valid, diff, 0.0)
        pdf = self.pdf(si, wo)
        h = normalize(si.wi + wo)
        R = mu.specular_reflection(dot(wo, h)[..., None], self.eta)
        R = R.expand(R.shape[:-3] + (n_channels, 4, 4))
        m00 = R[..., 0:1, 0:1]
        big = torch.abs(m00) > 1e-12
        R = torch.where(big, R / torch.where(big, m00, 1.0), 0.0)
        R = rotate_specular_mueller_m(R, wo, si.wi, h)
        M = (R * spec[..., None, None]
             + mu.depolarizer(1.0).to(wo.device) * diff[..., None, None])
        return torch.nan_to_num(M), pdf

    def sample_pol(self, u_lobe, u2, si, n_channels, wavelengths=None):
        bs, _ = self.sample(u_lobe, u2, si, n_channels, wavelengths)
        M, pdf = self.eval_pdf_mueller(si, bs.wo, n_channels, wavelengths)
        ok = (pdf > 1e-12)[..., None, None, None]
        return bs, torch.where(ok, M / torch.clamp(pdf, min=1e-12)[..., None, None, None], 0.0)
