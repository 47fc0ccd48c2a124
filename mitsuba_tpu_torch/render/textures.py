"""Textures, constant RGB only (counterpart of mitsuba_tpu/render/textures.py).

A texture evaluates to an [N, 3] RGB value at the surface uv. The bitmap,
checkerboard, volume and spectral textures are not yet ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class ConstantTexture:
    """Uniform value: an rgb triple, or one scalar repeated on 3 channels."""

    value: torch.Tensor   # [3] rgb or [1] scalar

    def eval(self, uv):
        v = self.value if self.value.shape[-1] == 3 else self.value[-1:].repeat(3)
        return v.expand(uv.shape[0], 3)
