"""1D distributions sampled through their cdf tables (counterpart of
mitsuba_tpu/core/distr.py, the piecewise-linear irregular one that the
tabulated polarized phase samples cos(theta) with).

The JAX package's choice between a compare-all and a scan lowering of
searchsorted is a TPU matter; torch.searchsorted gives the same indices.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def _searchsorted(cdf, u):
    """Index of the first cdf entry > u, clipped to the table."""
    return torch.clamp(torch.searchsorted(cdf, u, right=True), 0, cdf.shape[0] - 1)


@dataclass(frozen=True)
class IrregularContinuousDistribution:
    """Piecewise-linear density on an irregular grid of nodes."""

    nodes: torch.Tensor     # [n] increasing x positions
    pdf: torch.Tensor       # [n] unnormalized density
    cdf: torch.Tensor       # [n-1]
    integral: torch.Tensor  # []

    @staticmethod
    def create(nodes, pdf):
        seg = 0.5 * (pdf[:-1] + pdf[1:]) * (nodes[1:] - nodes[:-1])
        cdf = torch.cumsum(seg, dim=0)
        return IrregularContinuousDistribution(nodes, pdf, cdf, cdf[-1])

    def eval_pdf(self, x):
        n = self.nodes.shape[0]
        i = torch.clamp(torch.searchsorted(self.nodes, x.contiguous(), right=True) - 1, 0, n - 2)
        x0 = self.nodes[i]
        x1 = self.nodes[i + 1]
        f = torch.clamp((x - x0) / torch.clamp(x1 - x0, min=1e-20), 0.0, 1.0)
        val = self.pdf[i] * (1 - f) + self.pdf[i + 1] * f
        inside = (x >= self.nodes[0]) & (x <= self.nodes[-1])
        return torch.where(inside, val, 0.0)

    def eval_pdf_normalized(self, x):
        return self.eval_pdf(x) / self.integral

    def sample(self, u):
        scaled = u * self.integral
        i = _searchsorted(self.cdf, scaled.contiguous())
        c_lo = torch.where(i > 0, self.cdf[torch.clamp(i - 1, min=0)], 0.0)
        rem = scaled - c_lo
        last = self.nodes.shape[0] - 1
        x0 = self.nodes[i]
        x1 = self.nodes[torch.clamp(i + 1, max=last)]
        w = torch.clamp(x1 - x0, min=1e-20)
        p0 = self.pdf[i]
        p1 = self.pdf[torch.clamp(i + 1, max=last)]
        slope = (p1 - p0) / w
        lin = rem / torch.clamp(p0, min=1e-20)
        disc = torch.clamp(p0 * p0 + 2.0 * slope * rem, min=0.0)
        flat = torch.abs(slope) < 1e-12
        quad = (torch.sqrt(disc) - p0) / torch.where(flat, 1.0, slope)
        t = torch.where(flat, lin, quad)
        return x0 + torch.minimum(torch.clamp(t, min=0.0), w)
