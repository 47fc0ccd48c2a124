"""Mueller/Stokes calculus (counterpart of mitsuba_tpu/render/mueller.py).

Conventions, as in the reference:
  * a Stokes vector is meaningful only with its basis vector, orthogonal to
    the propagation direction; the polarization ellipse is observed from
    the sensor side, looking back along the beam;
  * stokes_basis(forward) = coordinate_system(forward)[0];
  * rotator(theta) rotates the reference frame counter-clockwise when
    facing the beam.

Stokes vectors are [..., 4] and Mueller matrices [..., 4, 4]; every
generator broadcasts over the leading wavefront and channel axes. ``@``
composes right to left, like the reference's ``M2 * M1``.
"""
from __future__ import annotations

import math

import torch

from ..core.frame import coordinate_system, cross, dot, normalize
from .fresnel import fresnel_polarized


def _f32(x, like=None):
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _mm(rows):
    """Stack a 4x4 of broadcastable scalars into [..., 4, 4]."""
    flat = torch.broadcast_tensors(*[_f32(e) for r in rows for e in r])
    return torch.stack(flat, dim=-1).reshape(flat[0].shape + (4, 4))


def _const(entries, value=1.0):
    """A [4, 4] matrix with the given {(i, j): v} entries, times value."""
    m = torch.zeros(4, 4, dtype=torch.float32)
    for (i, j), v in entries.items():
        m[i, j] = v
    return m * value


def depolarizer(value=1.0):
    """[..., 4, 4] with only (0, 0) = value."""
    o = _f32(value)
    z = torch.zeros_like(o)
    return _mm([[o, z, z, z], [z, z, z, z], [z, z, z, z], [z, z, z, z]])


def absorber(value):
    v = _f32(value)
    return v[..., None, None] * torch.eye(4, dtype=torch.float32, device=v.device)


def linear_polarizer(value=1.0):
    a = _f32(value) * 0.5
    z = torch.zeros_like(a)
    return _mm([[a, a, z, z], [a, a, z, z], [z, z, z, z], [z, z, z, z]])


def linear_retarder(phase):
    phase = _f32(phase)
    s, c = torch.sin(phase), torch.cos(phase)
    o, z = torch.ones_like(s), torch.zeros_like(s)
    return _mm([[o, z, z, z], [z, o, z, z], [z, z, c, s], [z, z, -s, c]])


def right_circular_polarizer():
    return _const({(0, 0): 0.5, (0, 3): 0.5, (3, 0): 0.5, (3, 3): 0.5})


def left_circular_polarizer():
    return _const({(0, 0): 0.5, (0, 3): -0.5, (3, 0): -0.5, (3, 3): 0.5})


def circular_polarizer(value=1.0, left=False):
    """Ideal circular polarizer transmitting right- (or left-) circularly
    polarized light."""
    s = -0.5 if left else 0.5
    return _const({(0, 0): 0.5, (0, 3): s, (3, 0): s, (3, 3): 0.5}, value)


def diattenuator(x, y):
    x, y = torch.broadcast_tensors(_f32(x), _f32(y))
    a = 0.5 * (x + y)
    b = 0.5 * (x - y)
    c = torch.sqrt(torch.clamp(x * y, min=0.0))
    z = torch.zeros_like(a)
    return _mm([[a, b, z, z], [b, a, z, z], [z, z, c, z], [z, z, z, c]])


def rotator(theta):
    """Rotates the Stokes reference frame counter-clockwise by theta
    (sensor-side view)."""
    theta = _f32(theta)
    s, c = torch.sin(2.0 * theta), torch.cos(2.0 * theta)
    o, z = torch.ones_like(s), torch.zeros_like(s)
    return _mm([[o, z, z, z], [z, c, s, z], [z, -s, c, z], [z, z, z, o]])


def rotated_element(theta, M):
    """R^T M R: the element M rotated by theta."""
    R = rotator(theta).to(M.device)
    return R.transpose(-1, -2) @ M @ R


def specular_reflection(cos_theta_i, eta):
    """Mueller matrix of specular reflection at an interface of (possibly
    complex) relative IOR eta."""
    a_s, a_p, _, _, _ = fresnel_polarized(cos_theta_i, eta)

    # the phase delay arg(a_p) - arg(a_s), through the sincos of the difference
    prod = a_p * a_s.conj()
    mag = torch.abs(prod)
    cos_delta = torch.where(mag > 0, prod.real / torch.clamp(mag, min=1e-20), 0.0)
    sin_delta = torch.where(mag > 0, prod.imag / torch.clamp(mag, min=1e-20), 0.0)

    r_s = torch.abs(a_s) ** 2
    r_p = torch.abs(a_p) ** 2
    a = 0.5 * (r_s + r_p)
    b = 0.5 * (r_s - r_p)
    c = torch.sqrt(torch.clamp(r_s * r_p, min=0.0))
    sin_delta = torch.where(c == 0.0, 0.0, sin_delta)
    cos_delta = torch.where(c == 0.0, 0.0, cos_delta)
    z = torch.zeros_like(a)
    return _mm([
        [a, b, z, z],
        [b, a, z, z],
        [z, z, c * cos_delta, -c * sin_delta],
        [z, z, c * sin_delta, c * cos_delta],
    ])


def specular_transmission(cos_theta_i, eta):
    """Mueller matrix of specular transmission through a real dielectric
    interface, with the radiance factor -eta_it cos_theta_t / cos_theta_i."""
    cos_theta_i = _f32(cos_theta_i)
    a_s, a_p, cos_theta_t, eta_it, eta_ti = fresnel_polarized(cos_theta_i, eta)
    eta_it_r = eta_it.real
    eta_ti_r = eta_ti.real

    ok = torch.abs(cos_theta_i) > 1e-8
    factor = -eta_it_r * torch.where(ok, cos_theta_t / torch.where(ok, cos_theta_i, 1.0), 0.0)

    a_s_r = 1.0 + a_s.real
    a_p_r = (1.0 + a_p.real) * eta_ti_r
    t_s = a_s_r * a_s_r
    t_p = a_p_r * a_p_r
    a = 0.5 * factor * (t_s + t_p)
    b = 0.5 * factor * (t_s - t_p)
    c = factor * torch.sqrt(torch.clamp(t_s * t_p, min=0.0))
    z = torch.zeros_like(a)
    return _mm([[a, b, z, z], [b, a, z, z], [z, z, c, z], [z, z, z, c]])


def mie_scatter(s1, s2, ns):
    """Mueller matrix from the complex Mie amplitudes S1 and S2, normalized
    by ns."""
    n1 = s1.real ** 2 + s1.imag ** 2
    n2 = s2.real ** 2 + s2.imag ** 2
    s11 = 0.5 * (n1 + n2)
    s12 = 0.5 * (n1 - n2)
    prod = s1 * s2.conj()
    s33 = prod.real
    s34 = prod.imag
    z = torch.zeros_like(s11)
    m = _mm([[s11, s12, z, z], [s12, s11, z, z], [z, z, s33, s34], [z, z, -s34, s33]])
    return m / _f32(ns, m)[..., None, None]


def rayleigh_scatter(cos_theta, sin_theta, rho):
    """Polarized Rayleigh Mueller matrix with depolarization factor rho."""
    rho = _f32(rho, cos_theta)
    r1 = (1.0 - rho) / (1.0 + rho / 2.0)
    r2 = (1.0 + rho) / (1.0 - rho)
    r3 = (1.0 - 2.0 * rho) / (1.0 - rho)

    a = r2 + cos_theta * cos_theta
    b = 1.0 + cos_theta * cos_theta
    c = -(sin_theta * sin_theta)
    d = 2.0 * cos_theta
    z = torch.zeros_like(a)
    pref = (3.0 / (16.0 * math.pi)) * r1
    m = _mm([[a, c, z, z], [c, b, z, z], [z, z, d, z], [z, z, z, d * r3]])
    return pref[..., None, None] * m if pref.ndim else pref * m


def stokes_basis(forward):
    """Implicit reference basis of a Stokes vector travelling along forward."""
    return coordinate_system(forward)[0]


def unit_angle(a, b):
    """Numerically stable angle between unit vectors."""
    dot_ab = dot(a, b)
    d = torch.sqrt(torch.sum((b - a) ** 2, dim=-1))
    s = torch.sqrt(torch.sum((b + a) ** 2, dim=-1))
    return torch.where(dot_ab >= 0, 2.0 * torch.asin(torch.clamp(0.5 * d, -1.0, 1.0)),
                       math.pi - 2.0 * torch.asin(torch.clamp(0.5 * s, -1.0, 1.0)))


def rotate_stokes_basis(forward, basis_current, basis_target):
    """Mueller matrix realigning two collinear Stokes bases, built directly
    from (cos 2theta, sin 2theta) by dot and cross products: the same as
    rotator(unit_angle(...)), with a finite derivative where the bases are
    (anti)parallel (the angle form's arcsin has an infinite one there)."""
    a = normalize(basis_current)
    b = normalize(basis_target)
    c = dot(a, b)                          # cos theta
    s = dot(forward, cross(a, b))          # sin theta, signed about forward
    c2 = c * c - s * s                     # cos 2theta
    s2 = 2.0 * s * c                       # sin 2theta
    o, z = torch.ones_like(c2), torch.zeros_like(c2)
    return _mm([[o, z, z, z], [z, c2, s2, z], [z, -s2, c2, z], [z, z, z, o]])


def rotate_mueller_basis(M, in_forward, in_basis_current, in_basis_target,
                         out_forward, out_basis_current, out_basis_target):
    """M re-expressed in new input and output Stokes bases: R_out M R_in^T."""
    R_in = rotate_stokes_basis(in_forward, in_basis_current, in_basis_target)
    R_out = rotate_stokes_basis(out_forward, out_basis_current, out_basis_target)
    return R_out @ M @ R_in.transpose(-1, -2)


def rotate_mueller_basis_collinear(M, forward, basis_current, basis_target):
    """The same rotation on both sides: R M R^T."""
    R = rotate_stokes_basis(forward, basis_current, basis_target)
    return R @ M @ R.transpose(-1, -2)


def to_world_mueller(M, in_forward_local, out_forward_local, s, t, n):
    """A local-frame Mueller matrix in the world's implicit bases. M acts
    from stokes_basis(in_forward_local) to stokes_basis(out_forward_local),
    both along the propagation of light in the frame (s, t, n) [N, 3];
    the result acts between the implicit world bases of the same
    directions. M may carry a channel axis: [N, C, 4, 4]."""
    def tw(v):
        return v[..., 0:1] * s + v[..., 1:2] * t + v[..., 2:3] * n

    in_fwd_w = tw(in_forward_local)
    out_fwd_w = tw(out_forward_local)
    R_in = rotate_stokes_basis(in_fwd_w, tw(stokes_basis(in_forward_local)),
                               stokes_basis(in_fwd_w))
    R_out = rotate_stokes_basis(out_fwd_w, tw(stokes_basis(out_forward_local)),
                                stokes_basis(out_fwd_w))
    if M.ndim == R_in.ndim + 1:
        # the rotations depend on the directions only: broadcast over C
        R_in = R_in[..., None, :, :]
        R_out = R_out[..., None, :, :]
    return R_out @ M @ R_in.transpose(-1, -2)
