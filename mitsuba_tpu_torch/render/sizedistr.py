"""Particle size distributions (counterpart of mitsuba_tpu/render/sizedistr.py).

Each distribution holds Gauss-Legendre nodes and weights over [min_radius,
max_radius] and a normalization constant computed by quadrature;
``parameters_changed`` recomputes it after a write to a parameter (a, b,
mean_radius, std, exponent).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..core.quad import gauss_legendre_interval

SIZEDISTR_TYPES = ("monodisperse", "gamma", "lognormal", "powerlaw")


def _gauss(min_radius, max_radius, n, device):
    nodes, weights = gauss_legendre_interval(n, float(min_radius), float(max_radius))
    return torch.from_numpy(nodes).to(device), torch.from_numpy(weights).to(device)


def _normalize(nodes, weights, eval_fn):
    return 1.0 / torch.sum(weights * eval_fn(nodes))


def _scalar(v, device):
    return torch.tensor(float(v), dtype=torch.float32, device=device)


@dataclass
class MonodisperseSizeDistr:
    """A single radius."""

    radius: torch.Tensor

    def eval_gauss_all(self):
        one = torch.ones(1, dtype=torch.float32, device=self.radius.device)
        return self.radius.reshape(1), one, one

    def parameters_changed(self):
        return self


class _QuadratureDistr:
    """The common part of the distributions with a density n(r): the
    normalization over the Gauss nodes and their evaluation."""

    def eval(self, r):
        return self.normalization * self.eval_unnormalized(r)

    def eval_gauss_all(self):
        """(radii, quadrature weights, normalized density at the radii)."""
        return self.gauss_nodes, self.gauss_weights, self.eval(self.gauss_nodes)

    def parameters_changed(self):
        return dataclasses.replace(
            self, normalization=_normalize(self.gauss_nodes, self.gauss_weights,
                                           self.eval_unnormalized))


@dataclass
class GammaSizeDistr(_QuadratureDistr):
    """n(r) = C r^((1-3b)/b) exp(-r/(a b))."""

    a: torch.Tensor
    b: torch.Tensor
    normalization: torch.Tensor
    gauss_nodes: torch.Tensor
    gauss_weights: torch.Tensor

    @staticmethod
    def create(a, b, min_radius, max_radius, n_gauss, device):
        nodes, weights = _gauss(min_radius, max_radius, n_gauss, device)
        return GammaSizeDistr(
            a=_scalar(a, device), b=_scalar(b, device), normalization=_scalar(1.0, device),
            gauss_nodes=nodes, gauss_weights=weights,
        ).parameters_changed()

    def eval_unnormalized(self, r):
        return torch.pow(r, (1.0 - 3.0 * self.b) / self.b) * torch.exp(-r / (self.a * self.b))


@dataclass
class LogNormalSizeDistr(_QuadratureDistr):
    """n(r) = C exp(-(ln r - ln r_m)^2 / (2 ln^2 sigma)) / r."""

    mean_radius: torch.Tensor
    std: torch.Tensor
    normalization: torch.Tensor
    gauss_nodes: torch.Tensor
    gauss_weights: torch.Tensor

    @staticmethod
    def create(mean_radius, std, min_radius, max_radius, n_gauss, device):
        nodes, weights = _gauss(min_radius, max_radius, n_gauss, device)
        return LogNormalSizeDistr(
            mean_radius=_scalar(mean_radius, device), std=_scalar(std, device),
            normalization=_scalar(1.0, device), gauss_nodes=nodes, gauss_weights=weights,
        ).parameters_changed()

    def eval_unnormalized(self, r):
        a = torch.log(r) - torch.log(self.mean_radius)
        c = 1.0 / (2.0 * torch.log(self.std) ** 2)
        return torch.exp(-a * a * c) / r


@dataclass
class PowerLawSizeDistr(_QuadratureDistr):
    """n(r) = C r^-e."""

    exponent: torch.Tensor
    normalization: torch.Tensor
    gauss_nodes: torch.Tensor
    gauss_weights: torch.Tensor

    @staticmethod
    def create(exponent, min_radius, max_radius, n_gauss, device):
        nodes, weights = _gauss(min_radius, max_radius, n_gauss, device)
        return PowerLawSizeDistr(
            exponent=_scalar(exponent, device), normalization=_scalar(1.0, device),
            gauss_nodes=nodes, gauss_weights=weights,
        ).parameters_changed()

    def eval_unnormalized(self, r):
        return torch.pow(r, -self.exponent)


def parse_sizedistr(spec, device, param_paths=None, prefix=None, path_root=None):
    """A size distribution from its dict (monodisperse, gamma, lognormal,
    powerlaw); registers its parameters when param_paths is given."""
    if spec is None:
        spec = {"type": "monodisperse"}
    t = spec["type"]
    min_r = float(spec.get("min_radius", 500.0))
    max_r = float(spec.get("max_radius", 5000.0))
    g = int(spec.get("gauss_points", 100))

    def reg(key):
        if param_paths is not None and prefix is not None:
            param_paths.append((f"{prefix}.{key}", path_root + (key,)))

    if t == "monodisperse":
        reg("radius")
        return MonodisperseSizeDistr(radius=_scalar(spec.get("radius", min_r), device))
    if t == "gamma":
        reg("a")
        reg("b")
        return GammaSizeDistr.create(spec.get("a", 1000.0), spec.get("b", 0.25),
                                     min_r, max_r, g, device)
    if t == "lognormal":
        reg("mean_radius")
        reg("std")
        return LogNormalSizeDistr.create(spec.get("mean_radius", 1000.0),
                                         spec.get("std", 100.0), min_r, max_r, g, device)
    if t == "powerlaw":
        reg("exponent")
        return PowerLawSizeDistr.create(spec.get("exponent", 3.0), min_r, max_r, g, device)
    raise ValueError(f"unknown size distribution type {t!r}")
