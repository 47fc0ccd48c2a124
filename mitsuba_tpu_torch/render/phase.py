"""Phase functions (counterpart of mitsuba_tpu/render/phase.py): isotropic,
Henyey-Greenstein, Rayleigh and the SGGX microflake phase, and the rotation
of a phase matrix into the Stokes bases of the medium frame.

Conventions, as in the reference: a medium interaction's shading frame is
Frame(ray.d) and the incident direction is (0, 0, -1) in local space;
sample() returns a local direction wo, a weight [N, C] and a pdf, and the
integrator maps wo to the world with mei.to_world. For HG the scattering
angle has cos(theta) = dot(wi, wo) = -wo.z. A phase with a polarized form
also has eval_pdf_mueller(mei, wo, n_channels) -> ([N, C, 4, 4] in the
local implicit Stokes bases, pdf); the others depolarize
(Scene.phase_eval_pdf_pol).

Not yet ported: the tabulated (unpolarized) phase.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import warp
from ..core.frame import coordinate_system, cross, dot, normalize
from ..core.math import INV_FOUR_PI
from . import mueller as mu


def rotate_phase_mueller(M, wo_hat, wi_hat):
    """A phase matrix in the scattering-plane basis, rotated to the implicit
    local Stokes bases of -wo_hat (in) and wi_hat (out): its reference
    vector lies in the scattering plane, so collinear directions give NaN,
    which is zeroed. M [N, C, 4, 4]; light arrives along -wo_hat and leaves
    along +wi_hat, both [N, 3]."""
    x_hat = cross(-wo_hat, wi_hat)
    p_axis_in = normalize(cross(x_hat, -wo_hat))
    p_axis_out = normalize(cross(x_hat, wi_hat))
    out = mu.rotate_mueller_basis(
        M,
        -wo_hat[..., None, :], p_axis_in[..., None, :], mu.stokes_basis(-wo_hat)[..., None, :],
        wi_hat[..., None, :], p_axis_out[..., None, :], mu.stokes_basis(wi_hat)[..., None, :],
    )
    return torch.nan_to_num(out)


def local_wi(wo):
    """The local incident direction (0, 0, -1), shaped like wo."""
    wi = torch.zeros_like(wo)
    wi[..., 2] = -1.0
    return wi


def _ones(wo, n_channels):
    return torch.ones(wo.shape[:-1] + (n_channels,), dtype=torch.float32, device=wo.device)


@dataclass
class IsotropicPhase:
    def sample(self, mei, u1, u2, n_channels):
        wo = warp.square_to_uniform_sphere(u2)
        pdf = torch.full(wo.shape[:-1], INV_FOUR_PI, dtype=torch.float32, device=wo.device)
        return wo, _ones(wo, n_channels), pdf

    def eval_pdf(self, mei, wo, n_channels):
        pdf = torch.full(wo.shape[:-1], INV_FOUR_PI, dtype=torch.float32, device=wo.device)
        return pdf[..., None].expand(pdf.shape + (n_channels,)), pdf


@dataclass
class HGPhase:
    """Henyey-Greenstein; g > 0 scatters forward (the pdf peaks at wo along
    the propagation direction, +z local)."""

    g: torch.Tensor   # []

    def sample(self, mei, u1, u2, n_channels):
        wo = warp.square_to_hg(u2, self.g)
        return wo, _ones(wo, n_channels), warp.square_to_hg_pdf(wo, self.g)

    def eval_pdf(self, mei, wo, n_channels):
        pdf = warp.square_to_hg_pdf(wo, self.g)
        return pdf[..., None].expand(pdf.shape + (n_channels,)), pdf


@dataclass
class RayleighPhase:
    """Rayleigh scattering with the depolarization factor rho. Directions
    are sampled from the rho = 0 shape, with the weight phase / pdf; the
    polarized form is mueller.rayleigh_scatter."""

    rho: torch.Tensor   # []

    def _phase_value(self, cos_theta):
        # 3/(16 pi) r1 (r2 + cos^2), M00 of rayleigh_scatter; integrates to 1
        rho = self.rho
        r1 = (1.0 - rho) / (1.0 + rho / 2.0)
        r2 = (1.0 + rho) / (1.0 - rho)
        return (3.0 / (16.0 * math.pi)) * r1 * (r2 + cos_theta * cos_theta)

    def sample(self, mei, u1, u2, n_channels):
        wo = warp.square_to_rayleigh(u2)
        pdf = warp.square_to_rayleigh_pdf(wo)
        w = (self._phase_value(wo[..., 2]) / torch.clamp(pdf, min=1e-12))[..., None]
        return wo, w.expand(w.shape[:-1] + (n_channels,)), pdf

    def eval_pdf(self, mei, wo, n_channels):
        val = self._phase_value(wo[..., 2])
        pdf = warp.square_to_rayleigh_pdf(wo)
        return val[..., None].expand(val.shape + (n_channels,)), pdf

    def eval_pdf_mueller(self, mei, wo, n_channels):
        """The Mueller matrix in the local implicit bases; cos(theta) =
        -dot(wo, wi) = wo.z with wi = (0, 0, -1)."""
        cos_theta = wo[..., 2]
        sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta ** 2, min=0.0))
        M = mu.rayleigh_scatter(cos_theta, sin_theta, self.rho)
        M = M[..., None, :, :].expand(M.shape[:-2] + (n_channels, 4, 4))
        M = rotate_phase_mueller(M, wo, local_wi(wo))
        return M, warp.square_to_rayleigh_pdf(wo)


def _sggx_det(s6):
    xx, yy, zz, xy, xz, yz = s6.unbind(-1)
    return torch.abs(
        xx * yy * zz - xx * yz * yz - yy * xz * xz - zz * xy * xy + 2.0 * xy * xz * yz
    )


def sggx_ndf_pdf(wm, s6):
    """SGGX normal distribution D(wm); s6 [N, 6] = [Sxx, Syy, Szz, Sxy,
    Sxz, Syz] in the basis of wm."""
    xx, yy, zz, xy, xz, yz = s6.unbind(-1)
    det_s = _sggx_det(s6)
    wx, wy, wz = wm.unbind(-1)
    den = (
        wx * wx * (yy * zz - yz * yz)
        + wy * wy * (xx * zz - xz * xz)
        + wz * wz * (xx * yy - xy * xy)
        + 2.0 * (
            wx * wy * (xz * yz - zz * xy)
            + wx * wz * (xy * yz - yy * xz)
            + wy * wz * (xy * xz - xx * yz)
        )
    )
    return det_s * torch.sqrt(det_s) / (math.pi * torch.clamp(den, min=1e-20) ** 2)


def sggx_projected_area(wi, s6):
    """sigma(wi) = sqrt(wi^T S wi)."""
    wx, wy, wz = wi.unbind(-1)
    sigma2 = (
        wx * wx * s6[..., 0] + wy * wy * s6[..., 1] + wz * wz * s6[..., 2]
        + 2.0 * (wx * wy * s6[..., 3] + wx * wz * s6[..., 4] + wy * wz * s6[..., 5])
    )
    return torch.sqrt(torch.clamp(sigma2, min=0.0))


def _sggx_quad(u, v, s6):
    """u^T S v for the symmetric S packed as s6."""
    xx, yy, zz, xy, xz, yz = s6.unbind(-1)
    sv0 = xx * v[..., 0] + xy * v[..., 1] + xz * v[..., 2]
    sv1 = xy * v[..., 0] + yy * v[..., 1] + yz * v[..., 2]
    sv2 = xz * v[..., 0] + yz * v[..., 1] + zz * v[..., 2]
    return u[..., 0] * sv0 + u[..., 1] * sv1 + u[..., 2] * sv2


def sggx_sample_normal(wi, u2, s6):
    """A normal wm [N, 3] from the SGGX visible-normal distribution seen
    from wi, in world coordinates."""
    x_a, y_a = coordinate_system(wi)
    s_jj = _sggx_quad(y_a, y_a, s6)
    s_ii = _sggx_quad(wi, wi, s6)
    s_kj = _sggx_quad(x_a, y_a, s6)
    s_ki = _sggx_quad(x_a, wi, s6)
    s_ji = _sggx_quad(y_a, wi, s6)
    det_s = _sggx_det(s6)
    inv_sqrt_s_ii = torch.rsqrt(torch.clamp(s_ii, min=1e-20))
    tmp = torch.sqrt(torch.clamp(s_jj * s_ii - s_ji * s_ji, min=1e-20))
    m_k_x = torch.sqrt(det_s) / tmp
    m_j_x = -inv_sqrt_s_ii * (s_ki * s_ji - s_kj * s_ii) / tmp
    m_j_y = inv_sqrt_s_ii * tmp
    u, v, w = warp.square_to_cosine_hemisphere(u2).unbind(-1)
    n_x = u * m_k_x + v * m_j_x + w * inv_sqrt_s_ii * s_ki
    n_y = v * m_j_y + w * inv_sqrt_s_ii * s_ji
    n_z = w * inv_sqrt_s_ii * s_ii
    return normalize(n_x[..., None] * x_a + n_y[..., None] * y_a + n_z[..., None] * wi)


@dataclass
class SGGXPhase:
    """SGGX microflake phase (specular microflakes: a visible normal is
    sampled and the direction mirrored; the value equals the pdf). The
    medium's sigma_t is scaled by the projected area sigma(wi) at each
    collision (Scene.medium_coefficients)."""

    S: object   # 6-channel volume [Sxx, Syy, Szz, Sxy, Sxz, Syz]
    is_microflake = True

    def _s6(self, mei):
        return self.S.eval(mei.p, 6)

    def sample(self, mei, u1, u2, n_channels):
        s6 = self._s6(mei)
        wi = -mei.sh_n      # local wi = (0, 0, -1) in Frame(ray.d)
        wm = sggx_sample_normal(wi, u2, s6)
        pa = torch.clamp(sggx_projected_area(wi, s6), min=1e-12)
        pdf = 0.25 * sggx_ndf_pdf(wm, s6) / pa
        wo_w = 2.0 * dot(wi, wm, keepdims=True) * wm - wi
        wo = mei.to_local(normalize(wo_w))
        return wo, _ones(wo, n_channels), pdf

    def eval_pdf(self, mei, wo, n_channels):
        s6 = self._s6(mei)
        wi = -mei.sh_n
        wo_w = mei.to_world(wo)
        h = normalize(wo_w + wi)
        pa = torch.clamp(sggx_projected_area(wi, s6), min=1e-12)
        pdf = 0.25 * sggx_ndf_pdf(h, s6) / pa
        # a degenerate half vector (wo == -wi) has density 0
        hw = wo_w + wi
        pdf = torch.where(dot(hw, hw) < 1e-12, 0.0, pdf)
        return pdf[..., None].expand(pdf.shape + (n_channels,)), pdf
