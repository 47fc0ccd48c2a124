"""Spectrum algebra of the integrators (counterpart of
mitsuba_tpu/render/spectrum_ops.py).

One integrator serves the unpolarized variants ([N, C] weights and
radiance) and the polarized ones ([N, C, 4, 4] Mueller throughput, [N, C, 4]
Stokes radiance) through a pair of ops objects. As in the reference, the
throughput right-multiplies each new event (beta = beta @ M) and an NEE
contribution is beta @ M_nee @ s_emit.
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


class MuellerOps:
    """Polarized: throughput [N, C, 4, 4] Mueller, radiance [N, C, 4] Stokes."""

    polarized = True

    @staticmethod
    def one(n, nc, device):
        return torch.eye(4, dtype=torch.float32, device=device).expand(n, nc, 4, 4)

    @staticmethod
    def zero_radiance(n, nc, device):
        return torch.zeros(n, nc, 4, dtype=torch.float32, device=device)

    @staticmethod
    def mul_scalar(beta, s):
        return beta * s[..., None, None]

    @staticmethod
    def apply(beta, M):
        return beta @ M

    @staticmethod
    def emit(beta, value):
        """Unpolarized emission: the Stokes vector [value, 0, 0, 0] through
        beta is beta's first column times value."""
        return beta[..., :, 0] * value[..., None]

    @staticmethod
    def contrib_nee(beta, M_nee, value):
        return (beta @ M_nee)[..., :, 0] * value[..., None]

    @staticmethod
    def intensity_beta(beta):
        return beta[..., 0, 0]

    @staticmethod
    def where_beta(mask, a, b):
        return torch.where(mask[..., None, None, None], a, b)

    @staticmethod
    def where_rad(mask, a, b):
        return torch.where(mask[..., None, None], a, b)


def get_ops(polarized: bool):
    return MuellerOps if polarized else ScalarOps


def depolarizer_weight(value):
    """[N, C] -> [N, C, 4, 4]: the ideal depolarizer of weight value."""
    m = torch.zeros(value.shape + (4, 4), dtype=torch.float32, device=value.device)
    m[..., 0, 0] = value
    return m


def identity_weight(value):
    """[N, C] -> value * I4, a polarization-preserving attenuation."""
    return value[..., None, None] * torch.eye(4, dtype=torch.float32, device=value.device)
