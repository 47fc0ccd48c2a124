"""Textures and spectra with constant values (counterpart of
mitsuba_tpu/render/textures.py).

A texture evaluates to an [N, C] spectrum at the surface uv, C being the
variant's channel count: an rgb value is kept in rgb variants and becomes
its luminance in mono ones; a scalar is repeated. In the spectral variants
(C = 4) it is evaluated at each lane's sampled wavelengths [N, 4]: an rgb
reflectance through the rgb2spec model, an emitted rgb (``emissive``)
through the model times D65. The spectra (``singleton``, ``d65``,
``blackbody``, ``regular``, ``irregular``) are their value, scale or mean
outside the spectral variants. The bitmap, checkerboard, volume and mesh
attribute textures are not yet ported.
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
