"""Spectrum algebra of the integrators (counterpart of
mitsuba_tpu/render/spectrum_ops.py), RGB only.

The reference lets one integrator serve the unpolarized ([N, C] weights
and radiance) and the polarized (Mueller throughput, Stokes radiance)
variants through a pair of ops objects. Only the unpolarized one is
ported: ``get_ops(polarized=True)`` raises.
"""
from __future__ import annotations

import torch


class ScalarOps:
    """Unpolarized: weights and radiance are [N, C]."""

    polarized = False

    @staticmethod
    def one(n, nc, device):
        return torch.ones(n, nc, dtype=torch.float32, device=device)

    @staticmethod
    def zero_radiance(n, nc, device):
        return torch.zeros(n, nc, dtype=torch.float32, device=device)

    @staticmethod
    def mul_scalar(beta, s):
        """Throughput times a per-channel weight [N, C]."""
        return beta * s

    @staticmethod
    def apply(beta, M):
        """Throughput after an event of weight M."""
        return beta * M

    @staticmethod
    def emit(beta, value):
        """Radiance of emission `value` [N, C] through beta."""
        return beta * value

    @staticmethod
    def contrib_nee(beta, M_nee, value):
        """beta o M_nee o emission: an NEE contribution."""
        return beta * M_nee * value

    @staticmethod
    def intensity_beta(beta):
        """Intensity of the throughput, for Russian roulette."""
        return beta

    @staticmethod
    def where_beta(mask, a, b):
        return torch.where(mask[..., None], a, b)

    @staticmethod
    def where_rad(mask, a, b):
        return torch.where(mask[..., None], a, b)


def get_ops(polarized: bool):
    if polarized:
        raise NotImplementedError("polarized spectrum algebra (MuellerOps) is not yet ported")
    return ScalarOps
