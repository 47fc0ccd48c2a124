"""Variant selection (counterpart of mitsuba_tpu/variant.py).

A variant fixes the channel layout of every spectrum the renderer carries:
``mono`` (C=1) or ``rgb`` (C=3), and, with ``polarized``, the Stokes axis
(radiance [..., C, 4], throughput Mueller [..., C, 4, 4]). The reference
names of the spectral variants are recognised and refused with
``NotImplementedError``, so a caller learns the difference between "not
ported yet" and "misspelled".
"""
from __future__ import annotations

from dataclasses import dataclass

# reference variant names -> (color mode, polarized)
_ALIASES = {
    "scalar_rgb": ("rgb", False),
    "scalar_mono": ("mono", False),
    "llvm_rgb": ("rgb", False),
    "llvm_ad_rgb": ("rgb", False),
    "llvm_ad_mono": ("mono", False),
    "llvm_mono": ("mono", False),
    "llvm_ad_mono_polarized": ("mono", True),
    "cuda_ad_rgb": ("rgb", False),
    "mono": ("mono", False),
    "rgb": ("rgb", False),
    "mono_polarized": ("mono", True),
    "rgb_polarized": ("rgb", True),
}

# reference names of the spectral variants, which are not ported
_SPECTRAL_NAMES = (
    "scalar_spectral", "scalar_spectral_polarized", "llvm_spectral",
    "llvm_ad_spectral", "llvm_ad_spectral_polarized", "spectral",
    "spectral_polarized",
)


@dataclass(frozen=True)
class Variant:
    color_mode: str = "rgb"      # 'mono' | 'rgb'
    polarized: bool = False

    @property
    def n_channels(self) -> int:
        return {"mono": 1, "rgb": 3}[self.color_mode]

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
        if name in _SPECTRAL_NAMES:
            raise NotImplementedError(f"variant {name!r} is not yet ported")
    raise ValueError(f"unknown variant(s) {names!r}; known: {sorted(_ALIASES)}")


def variant() -> str:
    return _current.name


def variants():
    return sorted(_ALIASES)


def current_variant() -> Variant:
    return _current
