"""Textures, constant values only (counterpart of
mitsuba_tpu/render/textures.py).

A texture evaluates to an [N, C] spectrum at the surface uv, C being the
variant's channel count: an rgb value is kept in rgb variants and becomes
its luminance in mono ones; a scalar is repeated. The bitmap, checkerboard,
volume and spectral textures are not yet ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

# the luminance weights of linear sRGB primaries (the reference's
# core/spectrum.py luminance)
_LUMINANCE = (0.212671, 0.715160, 0.072169)


def to_channels(v, n_channels):
    """A stored rgb [3] or scalar [1] value -> [n_channels]."""
    if n_channels == 3:
        return v if v.shape[-1] == 3 else v[..., -1:].repeat(3)
    if n_channels != 1:
        raise NotImplementedError(f"{n_channels} channels (the spectral variants) are not yet ported")
    if v.shape[-1] == 3:
        w = torch.tensor(_LUMINANCE, dtype=torch.float32, device=v.device)
        return (v @ w)[..., None]
    return v


@dataclass
class ConstantTexture:
    """Uniform value: an rgb triple, or one scalar."""

    value: torch.Tensor   # [3] rgb or [1] scalar

    def eval(self, uv, n_channels):
        return to_channels(self.value, n_channels).expand(uv.shape[0], n_channels)
