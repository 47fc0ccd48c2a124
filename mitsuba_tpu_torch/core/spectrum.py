"""Spectral and colour handling (counterpart of mitsuba_tpu/core/spectrum.py).

The spectral variants carry C = 4 wavelengths per lane: one hero
wavelength drawn uniformly over [360, 830] nm and three more at equal
spacing modulo the range. Stored rgb data becomes a spectrum through the
Jakob-Hanika 2019 sigmoid-polynomial model, its coefficients fetched
trilinearly from the sRGB table in data/srgb64.coeff; emitters scale that
model by the D65 illuminant. A lane's spectral radiance becomes XYZ by a
Monte-Carlo estimate against the CIE 1931 matching functions, then
linear sRGB.

The tables (CIE 1931 and D65 at 5 nm, the rgb2spec coefficients) are the
package's own copies under data/, read with numpy once and kept as
tensors on each device they are used on.
"""
from __future__ import annotations

import os

import numpy as np
import torch

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")

CIE_MIN = 360.0
CIE_MAX = 830.0

# CIE Y integral over [360, 830] (the normalization of luminance)
CIE_Y_INTEGRAL = 106.7502593994140625

_CIE_NP = np.load(os.path.join(_DATA_DIR, "cie1931.npy"))               # [3, 95] float32
_D65_RAW = np.load(os.path.join(_DATA_DIR, "d65.npy"))                  # [95] float32
# D65 normalized to 1 at 560 nm, held in float32 as the JAX package holds it
_D65_NP = np.asarray(_D65_RAW / np.interp(560.0, np.arange(360, 831, 5), _D65_RAW), np.float32)
# D65 scaled so that integrating L(wl) ybar(wl) / CIE_Y_INTEGRAL gives Y = 1:
# an rgb (1, 1, 1) emitter then has unit luminance
_D65_Y = float(np.trapezoid(_D65_NP * _CIE_NP[1], dx=5.0) / CIE_Y_INTEGRAL)

# sRGB (D65) <-> XYZ
_XYZ_TO_SRGB = ((3.240479, -1.537150, -0.498535),
                (-0.969256, 1.875991, 0.041556),
                (0.055648, -0.204043, 1.057311))
_SRGB_TO_XYZ = ((0.412453, 0.357580, 0.180423),
                (0.212671, 0.715160, 0.072169),
                (0.019334, 0.119193, 0.950227))
_LUMINANCE = (0.212671, 0.715160, 0.072169)

_TABLES = {}        # (name, device) -> tensor
_RGB2SPEC_NP = None


def _table(name, device):
    key = (name, str(device))
    if key not in _TABLES:
        if name == "cie":
            arr = _CIE_NP
        elif name == "d65":
            arr = _D65_NP
        elif name in ("xyz_to_srgb", "srgb_to_xyz", "luminance"):
            arr = np.asarray({"xyz_to_srgb": _XYZ_TO_SRGB, "srgb_to_xyz": _SRGB_TO_XYZ,
                              "luminance": _LUMINANCE}[name], np.float32)
        else:
            scale, data, _ = _rgb2spec_np()
            arr = scale if name == "rgb2spec_scale" else data.reshape(-1, 3)
        _TABLES[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return _TABLES[key]


def _rgb2spec_np():
    """(scale [res], coefficients [3, res, res, res, 3], res) of the sRGB
    table, parsed once (the rgb2spec file: 'SPEC', res, scale, data)."""
    global _RGB2SPEC_NP
    if _RGB2SPEC_NP is None:
        with open(os.path.join(_DATA_DIR, "srgb64.coeff"), "rb") as f:
            buf = f.read()
        if buf[:4] != b"SPEC":
            raise ValueError("srgb64.coeff is not an rgb2spec table")
        res = int(np.frombuffer(buf, np.uint32, 1, 4)[0])
        scale = np.frombuffer(buf, np.float32, res, 8).copy()
        data = np.frombuffer(buf, np.float32, 3 * res ** 3 * 3, 8 + 4 * res)
        _RGB2SPEC_NP = (scale, data.reshape(3, res, res, res, 3).copy(), res)
    return _RGB2SPEC_NP


def _cie_interp(tbl, wl):
    """Linear interpolation of a [..., 95] table over [360, 830] nm at 5 nm
    steps, 0 outside the range: [..., *wl.shape]."""
    t = (wl - CIE_MIN) / 5.0
    i = torch.clamp(torch.floor(t).to(torch.int64), 0, 93)
    f = torch.clamp(t - i, 0.0, 1.0)
    v = tbl[..., i] * (1.0 - f) + tbl[..., i + 1] * f
    inside = (wl >= CIE_MIN) & (wl <= CIE_MAX)
    return torch.where(inside, v, 0.0)


def cie1931_xyz(wl):
    """The CIE 1931 matching functions x, y, z at wl [nm] -> [..., 3]."""
    return torch.movedim(_cie_interp(_table("cie", wl.device), wl), 0, -1)


def cie1931_y(wl):
    return _cie_interp(_table("cie", wl.device)[1], wl)


def xyz_to_srgb(xyz):
    return xyz @ _table("xyz_to_srgb", xyz.device).T


def srgb_to_xyz(rgb):
    return rgb @ _table("srgb_to_xyz", rgb.device).T


def luminance(rgb):
    return rgb @ _table("luminance", rgb.device)


# -- wavelength sampling -----------------------------------------------------

def sample_visible_wavelength(u):
    """wl with a pdf close to the CIE luminous efficiency (the reference's
    sample_rgb_spectrum): 538 - atanh(0.8569 - 1.8275 u) / 0.0072."""
    return 538.0 - torch.atanh(0.8569106254698279 - 1.8275019724092267 * u) / 0.0072


def pdf_visible_wavelength(wl):
    x = torch.cosh(0.0072 * (wl - 538.0))
    pdf = 0.003939804229326285 / (x * x)
    return torch.where((wl >= CIE_MIN) & (wl <= CIE_MAX), pdf, 0.0)


def sample_uniform_wavelength(u):
    return CIE_MIN + u * (CIE_MAX - CIE_MIN)


def pdf_uniform_wavelength(wl):
    return torch.where((wl >= CIE_MIN) & (wl <= CIE_MAX), 1.0 / (CIE_MAX - CIE_MIN), 0.0)


def sample_wavelengths_hero(u, n=4, lo=CIE_MIN, hi=CIE_MAX):
    """Hero-wavelength sampling: one uniform u [...] -> n wavelengths
    [..., n], equally spaced modulo the range. u + k/n lies in [0, 2), where
    the remainder is exact. lo + t (hi - lo) is rounded once, as the fused
    multiply-add of the JAX package's compiled renders rounds it (in float64
    the product is exact and the sum rounds at most once more, below the
    float32 result's last place)."""
    k = torch.arange(n, dtype=torch.float32, device=u.device) / n
    t = torch.remainder(u[..., None] + k, 1.0)
    return (lo + t.double() * (hi - lo)).float()


# -- rgb upsampling ----------------------------------------------------------

def _sqrt_rn(x):
    """The correctly rounded float32 square root (PyTorch's vectorized CPU
    sqrt may miss it by one place; float64 then float32 rounds right)."""
    return torch.sqrt(x.double()).float()


def srgb_model_eval(coeff, wl):
    """The sigmoid-polynomial reflectance f(wl) = sigmoid(c0 wl^2 + c1 wl +
    c2); c2 = +-inf encodes the monochromatic 0 and 1."""
    v = (coeff[..., 0] * wl + coeff[..., 1]) * wl + coeff[..., 2]
    out = torch.maximum(torch.zeros_like(v), 0.5 + 0.5 * v / torch.sqrt(1.0 + v * v))
    lim = torch.where(torch.sign(v) > 0, 1.0, 0.0)
    return torch.where(torch.isinf(v), lim, out)


def srgb_to_spectral_coeff(rgb):
    """rgb [..., 3] -> model coefficients [..., 3]: a trilinear fetch from
    the table (the reference's rgb2spec_fetch), or the analytic solution
    where the three components are equal."""
    _, _, res = _rgb2spec_np()
    dev = rgb.device
    scale = _table("rgb2spec_scale", dev)
    flat = _table("rgb2spec_data", dev)
    rgb = torch.clamp(rgb, 0.0, 1.0)
    i = torch.argmax(rgb, dim=-1)
    z = torch.gather(rgb, -1, i[..., None])[..., 0]
    # a true division (a Python number over a tensor is a reciprocal and
    # a product in PyTorch), with no host-to-device copy of the numerator
    sc = torch.full_like(z, float(res - 1)) / torch.clamp(z, min=1e-10)
    x = torch.gather(rgb, -1, ((i + 1) % 3)[..., None])[..., 0] * sc
    y = torch.gather(rgb, -1, ((i + 2) % 3)[..., None])[..., 0] * sc
    # float -> int truncates toward 0, as astype(int32) does on these
    # non-negative values
    xi = torch.clamp(x.to(torch.int64), 0, res - 2)
    yi = torch.clamp(y.to(torch.int64), 0, res - 2)
    zi = torch.clamp(torch.searchsorted(scale, z.contiguous(), right=True) - 1, 0, res - 2)
    x1 = x - xi
    y1 = y - yi
    z1 = (z - scale[zi]) / torch.clamp(scale[zi + 1] - scale[zi], min=1e-20)
    base = ((i * res + zi) * res + yi) * res + xi

    def w(a, b):
        return (a if b else 1.0 - a)[..., None]

    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                out = out + flat[base + (dz * res + dy) * res + dx] * (
                    w(z1, dz) * w(y1, dy) * w(x1, dx))

    # the monochromatic case, solved analytically
    mono = (rgb[..., 0] == rgb[..., 1]) & (rgb[..., 1] == rgb[..., 2])
    v = rgb[..., 0]
    r = torch.where(v <= 0.0, -float("inf"),
                    torch.where(v >= 1.0, float("inf"),
                                (v - 0.5) / _sqrt_rn(torch.clamp(v * (1.0 - v), min=1e-20))))
    zero = torch.zeros_like(r)
    mono_c = torch.stack([zero, zero, r], dim=-1)
    return torch.where(mono[..., None], mono_c, out)


def rgb_reflectance_eval(rgb, wl):
    """The spectral reflectance whose sRGB projection under D65 is rgb:
    rgb [..., 3] broadcast against wl [...]."""
    return srgb_model_eval(srgb_to_spectral_coeff(rgb), wl)


def blackbody_radiance(wl_nm, temperature):
    """Planck's law, W / (m^2 sr nm)."""
    h = 6.62607015e-34
    c = 2.99792458e8
    kb = 1.380649e-23
    lam = wl_nm * 1e-9
    # true divisions by float32 constants made on lam's device (no copy)
    hc = torch.full_like(lam, h * c)
    num = torch.full_like(lam, 2 * h * c * c)
    p = num / (lam ** 5 * (torch.exp(hc / (lam * kb * temperature)) - 1.0))
    return p * 1e-9


def d65_eval(wl):
    """The CIE standard illuminant D65 (5 nm table), 1 at 560 nm."""
    return _cie_interp(_table("d65", wl.device), wl)


def rgb_emission_eval(rgb, wl):
    """Emitted rgb -> spectral radiance: the rgb scaled so that its largest
    component is 0.5, upsampled, times D65 (luminance-normalized) and the
    scale: rgb [..., 3] broadcast against wl [...]."""
    factor = torch.amax(rgb, dim=-1, keepdim=True) * 2.0
    norm = rgb / torch.clamp(factor, min=1e-20)
    model = rgb_reflectance_eval(torch.where(factor > 0, norm, 0.0), wl)
    d65 = d65_eval(wl) / _D65_Y
    f = factor[..., 0] if factor.shape[-1] == 1 and model.ndim == factor.ndim - 1 else factor
    return model * d65 * f


def spectrum_to_xyz(values, wavelengths, pdf):
    """Monte-Carlo XYZ of spectral samples: the mean over the wavelength
    axis of xyz(wl) * value / pdf, over the Y integral. values,
    wavelengths, pdf: [..., W] -> [..., 3]."""
    xyz_w = cie1931_xyz(wavelengths)
    w = torch.where(pdf > 0, 1.0 / torch.clamp(pdf, min=1e-20), 0.0)
    contrib = xyz_w * (values * w)[..., None]
    return torch.mean(contrib, dim=-2) / CIE_Y_INTEGRAL
