"""Variant selection, RGB only (counterpart of mitsuba_tpu/variant.py).

A variant fixes the channel layout of every spectrum the renderer carries.
This package implements the RGB variant; the reference names of the other
variants are recognised and refused with ``NotImplementedError``, so a
caller learns the difference between "not ported yet" and "misspelled".
"""
from __future__ import annotations

from dataclasses import dataclass

# reference variant names that resolve to the RGB variant
_RGB_NAMES = ("rgb", "scalar_rgb", "llvm_rgb", "llvm_ad_rgb", "cuda_ad_rgb")

# reference names of variants that exist but are not ported
_OTHER_NAMES = (
    "scalar_mono", "scalar_spectral", "scalar_spectral_polarized",
    "llvm_ad_mono", "llvm_mono", "llvm_spectral", "llvm_ad_spectral",
    "llvm_ad_mono_polarized", "llvm_ad_spectral_polarized",
    "mono", "spectral", "mono_polarized", "rgb_polarized", "spectral_polarized",
)


@dataclass(frozen=True)
class Variant:
    color_mode: str = "rgb"
    polarized: bool = False

    @property
    def n_channels(self) -> int:
        return 3

    @property
    def name(self) -> str:
        return self.color_mode


_current = Variant()


def set_variant(*names: str) -> None:
    """Select the active variant (mirrors mi.set_variant); the first
    recognised name wins."""
    global _current
    for name in names:
        if name in _RGB_NAMES:
            _current = Variant()
            return
        if name in _OTHER_NAMES:
            raise NotImplementedError(f"variant {name!r} is not yet ported")
    raise ValueError(f"unknown variant(s) {names!r}; known: {sorted(_RGB_NAMES)}")


def variant() -> str:
    return _current.name


def variants():
    return sorted(_RGB_NAMES)


def current_variant() -> Variant:
    return _current
