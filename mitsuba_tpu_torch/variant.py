"""Variant selection (counterpart of mitsuba_tpu/variant.py).

A variant fixes the channel layout of every spectrum the renderer carries:
``mono`` (C=1), ``rgb`` (C=3) or ``spectral`` (C=4 wavelengths sampled per
lane), and, with ``polarized``, the Stokes axis (radiance [..., C, 4],
throughput Mueller [..., C, 4, 4]).
"""
from __future__ import annotations

from dataclasses import dataclass

# reference variant names -> (color mode, polarized)
_ALIASES = {
    "scalar_rgb": ("rgb", False),
    "scalar_mono": ("mono", False),
    "scalar_spectral": ("spectral", False),
    "scalar_spectral_polarized": ("spectral", True),
    "llvm_rgb": ("rgb", False),
    "llvm_ad_rgb": ("rgb", False),
    "llvm_ad_mono": ("mono", False),
    "llvm_mono": ("mono", False),
    "llvm_spectral": ("spectral", False),
    "llvm_ad_spectral": ("spectral", False),
    "llvm_ad_mono_polarized": ("mono", True),
    "llvm_ad_spectral_polarized": ("spectral", True),
    "cuda_ad_rgb": ("rgb", False),
    "mono": ("mono", False),
    "rgb": ("rgb", False),
    "spectral": ("spectral", False),
    "mono_polarized": ("mono", True),
    "rgb_polarized": ("rgb", True),
    "spectral_polarized": ("spectral", True),
}


@dataclass(frozen=True)
class Variant:
    color_mode: str = "rgb"      # 'mono' | 'rgb' | 'spectral'
    polarized: bool = False

    @property
    def n_channels(self) -> int:
        return {"mono": 1, "rgb": 3, "spectral": 4}[self.color_mode]

    @property
    def is_spectral(self) -> bool:
        return self.color_mode == "spectral"

    @property
    def name(self) -> str:
        return f"{self.color_mode}{'_polarized' if self.polarized else ''}"


_current = Variant()


def set_variant(*names: str) -> None:
    """Select the active variant (mirrors mi.set_variant); the first
    recognised name wins."""
    global _current
    for name in names:
        if name in _ALIASES:
            _current = Variant(*_ALIASES[name])
            return
    raise ValueError(f"unknown variant(s) {names!r}; known: {sorted(_ALIASES)}")


def variant() -> str:
    return _current.name


def variants():
    return sorted(_ALIASES)


def current_variant() -> Variant:
    return _current
