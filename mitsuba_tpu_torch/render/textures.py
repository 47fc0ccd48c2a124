"""Textures and spectra (counterpart of mitsuba_tpu/render/textures.py).

A texture evaluates to an [N, C] spectrum at the surface uv, C being the
variant's channel count: an rgb value is kept in rgb variants and becomes
its luminance in mono ones; a scalar is repeated. In the spectral variants
(C = 4) it is evaluated at each lane's sampled wavelengths [N, 4]: an rgb
reflectance through the rgb2spec model, an emitted rgb (``emissive``)
through the model times D65. The spectra (``singleton``, ``d65``,
``blackbody``, ``regular``, ``irregular``) are their value, scale or mean
outside the spectral variants. The ``checkerboard`` tiles two constant
colours over uv; the ``bitmap`` filters an [H, W, C] image bilinearly (row
0 at the top, v = 1). The volume and mesh attribute textures are not yet
ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import spectrum as spec


def to_channels(v, n_channels, wavelengths=None, is_emission=False):
    """A stored rgb [..., 3] or scalar [..., 1] value -> [..., n_channels];
    spectral (n_channels 4): [N, 4] at the wavelengths [N, 4]."""
    if n_channels == 3:
        return v if v.shape[-1] == 3 else v[..., -1:].repeat_interleave(3, dim=-1)
    if n_channels == 1:
        return spec.luminance(v)[..., None] if v.shape[-1] == 3 else v
    if wavelengths is None:
        raise ValueError("a spectral evaluation needs the lanes' wavelengths")
    if v.shape[-1] == 1:
        return v.expand(v.shape[:-1] + (wavelengths.shape[-1],))
    if is_emission:
        return spec.rgb_emission_eval(v[..., None, :], wavelengths)
    return spec.rgb_reflectance_eval(v[..., None, :], wavelengths)


def gather_texels(data, y, x):
    """data[y, x] of an image [H, W, C] at per-lane texel indices, as one
    index_select of its rows: the backward is an index_add_ (atomics on
    the card, in no fixed order), where an advanced index's backward sorts
    the lanes by texel and sums each texel's run serially, which a bright
    texel hit by millions of lanes makes slow."""
    return torch.index_select(data.reshape(-1, data.shape[-1]), 0, y * data.shape[1] + x)


def _uniform(value, uv, n_channels):
    """A value [1] (or []) broadcast to [N, n_channels]."""
    return value.reshape(-1)[-1:].expand(uv.shape[0], n_channels)


@dataclass
class ConstantTexture:
    """Uniform value: an rgb triple, or one scalar. ``emissive`` selects the
    unbounded D65-based upsampling of emitted radiance in the spectral
    variants."""

    value: torch.Tensor   # [3] rgb or [1] scalar
    emissive: bool = False

    def eval(self, uv, n_channels, wavelengths=None):
        out = to_channels(self.value, n_channels, wavelengths, self.emissive)
        return out.expand(uv.shape[0], n_channels)

    def mean(self):
        return torch.mean(self.value)


@dataclass
class CheckerboardTexture:
    """Two colours in a 2 x 2 tiling of the unit uv square, after
    uv * uv_scale + uv_offset (the texture's ``to_uv``)."""

    color0: torch.Tensor     # [3] or [1]
    color1: torch.Tensor
    uv_scale: torch.Tensor   # [2]
    uv_offset: torch.Tensor  # [2]

    def eval(self, uv, n_channels, wavelengths=None):
        st = uv * self.uv_scale + self.uv_offset
        odd = (torch.floor(st[..., 0]).to(torch.int32)
               ^ torch.floor(st[..., 1]).to(torch.int32)) & 1
        c0 = to_channels(self.color0, n_channels, wavelengths).expand(uv.shape[0], n_channels)
        c1 = to_channels(self.color1, n_channels, wavelengths).expand(uv.shape[0], n_channels)
        return torch.where((odd == 0)[..., None], c0, c1)

    def mean(self):
        return 0.5 * (torch.mean(self.color0) + torch.mean(self.color1))


@dataclass
class BitmapTexture:
    """An image [H, W, C] (C 3 or 1), bilinearly filtered at uv with v
    flipped (image row 0 is v = 1), its edge texels repeated outside."""

    data: torch.Tensor

    def eval(self, uv, n_channels, wavelengths=None):
        h, w = self.data.shape[0], self.data.shape[1]
        x = uv[..., 0] * w - 0.5
        y = (1.0 - uv[..., 1]) * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
        y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
        x1i = torch.clamp(x0i + 1, 0, w - 1)
        y1i = torch.clamp(y0i + 1, 0, h - 1)
        d = self.data
        v = (gather_texels(d, y0i, x0i) * ((1 - fx) * (1 - fy))[..., None]
             + gather_texels(d, y0i, x1i) * (fx * (1 - fy))[..., None]
             + gather_texels(d, y1i, x0i) * ((1 - fx) * fy)[..., None]
             + gather_texels(d, y1i, x1i) * (fx * fy)[..., None])
        return to_channels(v, n_channels, wavelengths)

    def mean(self):
        return torch.mean(self.data)


@dataclass
class SingletonSpectrum:
    """A value at one wavelength only: in the spectral variants, nonzero
    on the channels within 1 nm of it."""

    value: torch.Tensor       # [] or [1]
    wavelength: torch.Tensor  # [] or [1]

    def eval(self, uv, n_channels, wavelengths=None):
        if wavelengths is None:
            return _uniform(self.value, uv, n_channels)
        match = torch.abs(wavelengths - self.wavelength) < 1.0
        return torch.where(match, self.value, 0.0)

    def mean(self):
        return torch.mean(self.value)


@dataclass
class D65Spectrum:
    """The D65 illuminant times `scale`."""

    scale: torch.Tensor

    def eval(self, uv, n_channels, wavelengths=None):
        if wavelengths is None:
            return _uniform(self.scale, uv, n_channels)
        return spec.d65_eval(wavelengths) * self.scale

    def mean(self):
        return torch.mean(self.scale)


@dataclass
class BlackbodySpectrum:
    """Planck's law at `temperature` [K], times `scale`."""

    temperature: torch.Tensor
    scale: torch.Tensor

    def eval(self, uv, n_channels, wavelengths=None):
        if wavelengths is None:
            return _uniform(self.scale, uv, n_channels)
        return spec.blackbody_radiance(wavelengths, self.temperature) * self.scale

    def mean(self):
        return torch.mean(self.scale)


@dataclass
class RegularSpectrum:
    """K values at regular steps over [wl_min, wl_max], interpolated
    linearly; 0 outside the range; their mean outside the spectral
    variants."""

    values: torch.Tensor   # [K]
    wl_min: torch.Tensor
    wl_max: torch.Tensor

    def eval(self, uv, n_channels, wavelengths=None):
        if wavelengths is None:
            return torch.mean(self.values).expand(uv.shape[0], n_channels)
        k = self.values.shape[0]
        t = (wavelengths - self.wl_min) / (self.wl_max - self.wl_min) * (k - 1)
        i = torch.clamp(torch.floor(t).to(torch.int64), 0, k - 2)
        f = torch.clamp(t - i, 0.0, 1.0)
        val = self.values[i] * (1 - f) + self.values[i + 1] * f
        return torch.where((t >= 0) & (t <= k - 1), val, 0.0)

    def mean(self):
        return torch.mean(self.values)


@dataclass
class IrregularSpectrum:
    """Values at increasing wavelengths, interpolated linearly; 0 outside
    their range; their mean outside the spectral variants."""

    wavelengths_nodes: torch.Tensor   # [K]
    values: torch.Tensor              # [K]

    def eval(self, uv, n_channels, wavelengths=None):
        if wavelengths is None:
            return torch.mean(self.values).expand(uv.shape[0], n_channels)
        nodes = self.wavelengths_nodes
        i = torch.clamp(torch.searchsorted(nodes, wavelengths.contiguous(), right=True) - 1,
                        0, nodes.shape[0] - 2)
        x0, x1 = nodes[i], nodes[i + 1]
        f = torch.clamp((wavelengths - x0) / torch.clamp(x1 - x0, min=1e-9), 0.0, 1.0)
        val = self.values[i] * (1 - f) + self.values[i + 1] * f
        return torch.where((wavelengths >= nodes[0]) & (wavelengths <= nodes[-1]), val, 0.0)

    def mean(self):
        return torch.mean(self.values)
