"""The polarized phase functions: mie, tabphase_polarized and blendphase
(counterpart of mitsuba_tpu/render/phase_polarized.py).

As in the reference, ``{'type': 'mie'}`` is solved when the scene is
loaded, over the size distribution's quadrature, and baked into a
tabulated polarized phase (TabPhasePolarized), which is what the
integrators read. The solve runs on the scene's device: complex64 is a
type of the card (the reference pins its bake to the host only because the
TPU has no complex type).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.distr import IrregularContinuousDistribution
from ..core.math import INV_TWO_PI, TWO_PI
from . import mueller as mu
from .mie import mie, mie_nmax
from .phase import local_wi, rotate_phase_mueller
from .sizedistr import SIZEDISTR_TYPES, parse_sizedistr
from .spectrum_ops import depolarizer_weight


def eval_mie_distribution(mu_cos, wavelength, size_distr, ior_med, ior_sph, nmax):
    """The Mueller phase matrix averaged over a size distribution by
    Gauss-Legendre quadrature,

        M(mu) = sum_i w_i n(r_i) Cs_i M_i(mu) / sum_i w_i n(r_i) Cs_i,

    at the scattering-angle cosines mu_cos [K] (+1 forward). Returns (M
    [K, 4, 4] in the scattering-plane basis, Cs_avg [], Ct_avg [])."""
    radii, weights, sdf = size_distr.eval_gauss_all()          # [G]
    s1, s2, ns, cs, ct = mie(wavelength, mu_cos[:, None], radii[None, :],
                             ior_med, ior_sph, nmax, device=mu_cos.device)   # [K, G]
    M = mu.mie_scatter(s1, s2, ns)                             # [K, G, 4, 4]
    w = (weights * sdf)[None, :]
    cs_w = w * cs
    Cs_avg = torch.sum(cs_w, dim=1)                            # [K], equal entries
    M_avg = torch.sum(cs_w[..., None, None] * M, dim=1) / Cs_avg[..., None, None]
    Ct_avg = torch.sum(w * ct, dim=1)
    return M_avg, Cs_avg[0], Ct_avg[0]


def _mueller_from_tables(m11, m12, m33, m34):
    z = torch.zeros_like(m11)
    return torch.stack([
        torch.stack([m11, m12, z, z], dim=-1),
        torch.stack([m12, m11, z, z], dim=-1),
        torch.stack([z, z, m33, m34], dim=-1),
        torch.stack([z, z, -m34, m33], dim=-1),
    ], dim=-2)


@dataclass
class TabPhasePolarized:
    """Tabulated polarized phase of spherically symmetric particles: the
    tables M11, M12, M33 and M34 over an irregular cos(theta) grid make the
    Mueller matrix, cos(theta) is sampled from M11 by its inverse cdf, and
    the four tables are scene parameters. cos(theta) = +1 is forward
    scattering: wo.z = +cos(theta) in the medium frame (wi = (0, 0, -1))."""

    nodes: torch.Tensor   # [K] cos(theta), ascending
    m11: torch.Tensor     # [K] unnormalized phase
    m12: torch.Tensor
    m33: torch.Tensor
    m34: torch.Tensor

    def _distr(self):
        return IrregularContinuousDistribution.create(self.nodes, self.m11)

    def _interp(self, table, x):
        n = self.nodes.shape[0]
        i = torch.clamp(torch.searchsorted(self.nodes, x.contiguous(), right=True) - 1, 0, n - 2)
        x0 = self.nodes[i]
        x1 = self.nodes[i + 1]
        f = torch.clamp((x - x0) / torch.clamp(x1 - x0, min=1e-9), 0.0, 1.0)
        return table[i] * (1 - f) + table[i + 1] * f

    # -- unpolarized interface --------------------------------------------
    def sample(self, mei, u1, u2, n_channels):
        d = self._distr()
        cos_theta = d.sample(u2[..., 1])
        pdf = d.eval_pdf_normalized(cos_theta) * INV_TWO_PI
        sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta ** 2, min=0.0))
        phi = TWO_PI * u2[..., 0]
        wo = torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta],
                         dim=-1)
        return wo, torch.ones(wo.shape[:-1] + (n_channels,), dtype=torch.float32,
                              device=wo.device), pdf

    def eval_pdf(self, mei, wo, n_channels):
        pdf = self._distr().eval_pdf_normalized(wo[..., 2]) * INV_TWO_PI
        return pdf[..., None].expand(pdf.shape + (n_channels,)), pdf

    # -- polarized interface ----------------------------------------------
    def eval_pdf_mueller(self, mei, wo, n_channels):
        d = self._distr()
        cos_theta = wo[..., 2]
        norm = INV_TWO_PI / d.integral
        M = _mueller_from_tables(*(self._interp(t, cos_theta) * norm
                                   for t in (self.m11, self.m12, self.m33, self.m34)))
        M = M[..., None, :, :].expand(M.shape[:-2] + (n_channels, 4, 4))
        M = rotate_phase_mueller(M, wo, local_wi(wo))
        pdf = self._interp(self.m11, cos_theta) / d.integral * INV_TWO_PI
        return M, pdf


@dataclass
class MiePhase:
    """Lorenz-Mie phase over a size distribution: evaluated directly for
    tests, baked (``bake``) for rendering."""

    size_distr: object
    ior_med: complex
    ior_sph: complex
    wavelength: torch.Tensor     # [] in the radii's units
    nmax: int

    def eval_mueller_mu(self, mu_cos):
        """[K] cosines -> ([K, 4, 4] scattering-plane Mueller, Cs_avg, Ct_avg)."""
        return eval_mie_distribution(mu_cos, self.wavelength, self.size_distr,
                                     self.ior_med, self.ior_sph, self.nmax)

    def bake(self, n_nodes=256):
        """The Mie series solved on n_nodes cosines evenly spaced over
        [-1, 1], on the device of the size distribution, and baked into a
        TabPhasePolarized."""
        dev = self.wavelength.device
        nodes = torch.from_numpy(np.linspace(-1.0, 1.0, n_nodes).astype(np.float32)).to(dev)
        M, _, _ = self.eval_mueller_mu(nodes)
        return TabPhasePolarized(nodes=nodes, m11=M[:, 0, 0].contiguous(),
                                 m12=M[:, 0, 1].contiguous(), m33=M[:, 2, 2].contiguous(),
                                 m34=M[:, 2, 3].contiguous())


@dataclass
class BlendPhase:
    """The convex combination (1 - weight) phase_a + weight phase_b."""

    phase_a: object
    phase_b: object
    weight: torch.Tensor   # [] weight of phase_b

    def sample(self, mei, u1, u2, n_channels):
        wo_a, _, _ = self.phase_a.sample(mei, u1, u2, n_channels)
        wo_b, _, _ = self.phase_b.sample(mei, u1, u2, n_channels)
        wo = torch.where((u1 < self.weight)[..., None], wo_b, wo_a)
        val, pdf = self.eval_pdf(mei, wo, n_channels)
        return wo, val / torch.clamp(pdf, min=1e-12)[..., None], pdf

    def eval_pdf(self, mei, wo, n_channels):
        va, pa = self.phase_a.eval_pdf(mei, wo, n_channels)
        vb, pb = self.phase_b.eval_pdf(mei, wo, n_channels)
        w = self.weight
        return (1 - w) * va + w * vb, (1 - w) * pa + w * pb

    def eval_pdf_mueller(self, mei, wo, n_channels):
        Ma, pa = phase_eval_pdf_mueller(self.phase_a, mei, wo, n_channels)
        Mb, pb = phase_eval_pdf_mueller(self.phase_b, mei, wo, n_channels)
        w = self.weight
        return (1 - w) * Ma + w * Mb, (1 - w) * pa + w * pb


def phase_eval_pdf_mueller(phase, mei, wo, n_channels):
    """A phase's Mueller matrix [N, C, 4, 4] in the local implicit bases,
    and its pdf; a phase without a polarized form depolarizes."""
    if hasattr(phase, "eval_pdf_mueller"):
        return phase.eval_pdf_mueller(mei, wo, n_channels)
    v, p = phase.eval_pdf(mei, wo, n_channels)
    return depolarizer_weight(v), p


def _table(v):
    if isinstance(v, str):
        v = [float(x) for x in v.split(",")]
    return np.asarray(v if v is not None else [1.0, 1.0], np.float32)


def parse_polarized_phase(spec, param_paths, phase_prefix, phase_path_root, device, parse_phase):
    """A mie, tabphase_polarized or blendphase instance from its dict;
    `parse_phase` parses the nested phases of a blend."""
    t = spec["type"]
    tables = ("m11", "m12", "m33", "m34")
    if t == "tabphase_polarized":
        vals = {k: _table(spec.get(k, spec.get(f"values_{k}"))) for k in tables}
        knodes = spec.get("nodes")
        if knodes is None:
            knodes = np.linspace(-1.0, 1.0, vals["m11"].shape[0])
        for k in tables:
            param_paths.append((f"{phase_prefix}.{k}", phase_path_root + (k,)))

        def dev(x):
            return torch.from_numpy(np.asarray(x, np.float32)).to(device)

        return TabPhasePolarized(nodes=dev(knodes), **{k: dev(vals[k]) for k in tables})
    if t == "mie":
        sd_spec = spec.get("size_distr", spec.get("sizedistr"))
        if sd_spec is None:
            for v in spec.values():
                if isinstance(v, dict) and v.get("type") in SIZEDISTR_TYPES:
                    sd_spec = v
                    break
        sd = parse_sizedistr(sd_spec, device)
        wl = float(spec.get("wavelength", 550.0))
        ior_med = complex(spec.get("ior_med", 1.0))
        ior_sph = complex(spec.get("ior_sph", 1.33))
        radii = sd.eval_gauss_all()[0].cpu().numpy()
        # the series length from the largest size parameter
        y_max = 2 * np.pi * float(radii.max()) / wl * max(abs(ior_med), abs(ior_sph))
        nmax = int(spec.get("nmax", -1))
        if nmax <= 0:
            nmax = mie_nmax(y_max)
        mp = MiePhase(size_distr=sd, ior_med=ior_med, ior_sph=ior_sph,
                      wavelength=torch.tensor(wl, dtype=torch.float32, device=device),
                      nmax=nmax)
        baked = mp.bake(int(spec.get("bake_nodes", 256)))
        for k in tables:
            param_paths.append((f"{phase_prefix}.{k}", phase_path_root + (k,)))
        return baked
    if t == "blendphase":
        nested = [v for v in spec.values() if isinstance(v, dict) and v.get("type") in (
            "isotropic", "hg", "rayleigh", "mie", "tabphase", "tabphase_polarized")]
        if len(nested) != 2:
            raise ValueError("blendphase needs exactly two nested phases")
        pa = parse_phase(nested[0], param_paths, phase_prefix + ".a",
                         phase_path_root + ("phase_a",), device)
        pb = parse_phase(nested[1], param_paths, phase_prefix + ".b",
                         phase_path_root + ("phase_b",), device)
        return BlendPhase(phase_a=pa, phase_b=pb, weight=torch.tensor(
            float(spec.get("weight", 0.5)), dtype=torch.float32, device=device))
    raise ValueError(f"unknown polarized phase type {t!r}")
