"""Core math, RNG, frames, transforms and warps."""
