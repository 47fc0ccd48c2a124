"""Utilities that need no device: the adding-doubling slab solver."""
