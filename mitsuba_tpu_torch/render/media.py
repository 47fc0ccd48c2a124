"""Participating media (counterpart of mitsuba_tpu/render/media.py):
homogeneous and gridded (heterogeneous) media and the loader of their
dicts.

A medium answers, for points p [N, 3]:
  * get_majorant(p) [N] and get_majorant_spectrum(p) [N, C], the free-flight
    majorant (per channel for the spectral tracking of the integrator);
  * get_scattering_coefficients(p) -> (sigma_s, sigma_n, sigma_t), each
    [N, C], with sigma_n = majorant - sigma_t, the null density.
Free-flight sampling (delta and ratio tracking) lives in
integrators/volpath.py, as in the reference.

``TwoStateMedium`` holds a medium's current state and an older one, the
pair that recursive control variates evaluate together (the fork's
medium.h sample_interaction_twostates / transmittance_eval_pdf_old hooks):
every query answers from the current state, the ``*_old`` ones from the
old state. ``TwoStateMedium.wrap(m)`` is the reference's default (old ==
current).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .phase import HGPhase, IsotropicPhase, RayleighPhase, SGGXPhase
from .phase_polarized import parse_polarized_phase
from .volumes import parse_volume

PHASE_TYPES = ("isotropic", "hg", "sggx", "rayleigh", "mie", "tabphase_polarized", "blendphase")
# phase types of the reference that are not ported; a medium's unnamed
# phase child of one of these types is still recognised, and refused
UNPORTED_PHASE_TYPES = ("tabphase",)
MEDIUM_TYPES = ("homogeneous", "heterogeneous")


def intersect_aabb(ray, bbox_min, bbox_max):
    """Slab test of rays against a box: (mint, maxt, valid), mint >= 0."""
    tiny = torch.where(ray.d >= 0, 1e-12, -1e-12)
    inv_d = 1.0 / torch.where(torch.abs(ray.d) < 1e-12, tiny, ray.d)
    t0 = (bbox_min - ray.o) * inv_d
    t1 = (bbox_max - ray.o) * inv_d
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    valid = tmax >= torch.clamp(tmin, min=0.0)
    return torch.clamp(tmin, min=0.0), tmax, valid


def _unbounded(ray):
    n, dev = ray.o.shape[0], ray.o.device
    return (torch.zeros(n, dtype=torch.float32, device=dev),
            torch.full((n,), float("inf"), dtype=torch.float32, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev))


@dataclass
class HomogeneousMedium:
    sigma_t: object          # volume [C]
    albedo: object           # volume [C]
    scale: torch.Tensor      # []
    phase_index: int
    is_homogeneous = True

    def get_majorant(self, p, n_channels):
        return torch.amax(self.sigma_t.eval(p, n_channels) * self.scale, dim=-1)

    def get_majorant_spectrum(self, p, n_channels):
        """Per channel, sigma_t itself: hero-channel tracking is analog in
        its own channel, and the exp(-(maj_j - maj_h) dt) ratios carry the
        other channels exactly."""
        return self.sigma_t.eval(p, n_channels) * self.scale

    def get_scattering_coefficients(self, p, n_channels):
        st = self.sigma_t.eval(p, n_channels) * self.scale
        ss = st * self.albedo.eval(p, n_channels)
        sn = torch.clamp(torch.amax(st, dim=-1, keepdim=True) - st, min=0.0)
        return ss, sn, st

    def intersect_aabb(self, ray):
        return _unbounded(ray)

    def parameters_changed(self):
        return self


@dataclass
class HeterogeneousMedium:
    """A gridded medium with the constant majorant scale * max(sigma_t)
    (with a relative margin of 1e-4, as the reference)."""

    sigma_t: object          # usually a GridVolume [D, H, W, 1]
    albedo: object           # volume
    scale: torch.Tensor      # []
    max_density: torch.Tensor  # [] scale * max(sigma_t) * 1.0001
    phase_index: int
    is_homogeneous = False

    def get_majorant(self, p, n_channels):
        return self.max_density.expand(p.shape[:-1])

    def get_majorant_spectrum(self, p, n_channels):
        return self.max_density.expand(p.shape[:-1] + (n_channels,))

    def get_scattering_coefficients(self, p, n_channels):
        st = self.sigma_t.eval(p, n_channels) * self.scale
        ss = st * self.albedo.eval(p, n_channels)
        sn = torch.clamp(self.max_density - st, min=0.0)
        return ss, sn, st

    def intersect_aabb(self, ray):
        if not hasattr(self.sigma_t, "bbox_min"):
            return _unbounded(ray)
        return intersect_aabb(ray, self.sigma_t.bbox_min, self.sigma_t.bbox_max)

    def parameters_changed(self):
        """The majorant re-derived after a write to sigma_t or scale."""
        return dataclasses.replace(
            self, max_density=self.scale * self.sigma_t.max() * 1.0001)


def transmittance_eval_pdf(mi_t, si_t, mint, combined_extinction):
    """Transmittance and free-flight pdf of a sampled medium interaction,
    both [.., C]: the pdf of a scattering (mi_t <= si_t) carries the
    extinction, that of leaving the medium does not."""
    t = (torch.minimum(mi_t, si_t) - mint)[..., None]
    tr = torch.exp(-t * combined_extinction)
    pdf = torch.where((si_t < mi_t)[..., None], tr, tr * combined_extinction)
    return tr, pdf


@dataclass
class TwoStateMedium:
    """A medium with a current and an old parameter state."""

    current: object
    old: object

    @property
    def is_homogeneous(self):
        return self.current.is_homogeneous

    @property
    def phase_index(self):
        return self.current.phase_index

    def get_majorant(self, p, n_channels):
        return self.current.get_majorant(p, n_channels)

    def get_majorant_spectrum(self, p, n_channels):
        return self.current.get_majorant_spectrum(p, n_channels)

    def get_scattering_coefficients(self, p, n_channels):
        return self.current.get_scattering_coefficients(p, n_channels)

    def intersect_aabb(self, ray):
        return self.current.intersect_aabb(ray)

    def parameters_changed(self):
        return dataclasses.replace(self, current=self.current.parameters_changed())

    def get_scattering_coefficients_old(self, p, n_channels):
        return self.old.get_scattering_coefficients(p, n_channels)

    def transmittance_eval_pdf(self, mi_t, si_t, mint, p, n_channels):
        _, _, st = self.current.get_scattering_coefficients(p, n_channels)
        return transmittance_eval_pdf(mi_t, si_t, mint, st)

    def transmittance_eval_pdf_old(self, mi_t, si_t, mint, p, n_channels):
        _, _, st = self.old.get_scattering_coefficients(p, n_channels)
        return transmittance_eval_pdf(mi_t, si_t, mint, st)

    @staticmethod
    def wrap(medium, old=None):
        return TwoStateMedium(current=medium, old=medium if old is None else old)


def parse_phase(spec, param_paths, phase_prefix, phase_path_root, device):
    """A phase instance from its dict (isotropic when None); registers its
    parameters. Other types raise NotImplementedError."""
    if spec is None:
        spec = {"type": "isotropic"}
    t = spec["type"]
    if t == "isotropic":
        return IsotropicPhase()
    if t == "hg":
        param_paths.append((f"{phase_prefix}.g", phase_path_root + ("g",)))
        return HGPhase(g=torch.tensor(float(spec.get("g", 0.8)), dtype=torch.float32, device=device))
    if t == "sggx":
        vol, leaf = parse_volume(spec.get("S", [1.0, 1.0, 1.0, 0.0, 0.0, 0.0]), device)
        param_paths.append((f"{phase_prefix}.S.{leaf}", phase_path_root + ("S", leaf)))
        return SGGXPhase(S=vol)
    if t == "rayleigh":
        rho = float(spec.get("depolarization", spec.get("rho", 0.0)))
        return RayleighPhase(rho=torch.tensor(rho, dtype=torch.float32, device=device))
    if t in ("mie", "tabphase_polarized", "blendphase"):
        return parse_polarized_phase(spec, param_paths, phase_prefix, phase_path_root, device,
                                     parse_phase)
    raise NotImplementedError(f"phase function type {t!r} is not yet ported")


def parse_medium(spec, name, phase_list, param_paths, medium_index, device):
    """A medium from its dict; its phase function is appended to
    phase_list and its parameters to param_paths."""
    t = spec["type"]
    if t not in MEDIUM_TYPES:
        raise NotImplementedError(f"medium type {t!r} is not yet ported")
    phase_spec = spec.get("phase")
    if phase_spec is None:
        for v in spec.values():
            if isinstance(v, dict) and v.get("type") in PHASE_TYPES + UNPORTED_PHASE_TYPES:
                phase_spec = v
                break
    phase_index = len(phase_list)
    phase_list.append(parse_phase(phase_spec, param_paths, f"{name}.phase_function",
                                  ("phases", phase_index), device))

    scale = torch.tensor(float(spec.get("scale", 1.0)), dtype=torch.float32, device=device)
    st, st_leaf = parse_volume(spec.get("sigma_t", 1.0), device)
    al, al_leaf = parse_volume(spec.get("albedo", 0.75), device)
    root = ("media", medium_index)
    if t == "homogeneous":
        # the reference's key names for a homogeneous medium's constants
        param_paths.append((f"{name}.sigma_t.value.value", root + ("sigma_t", st_leaf)))
        param_paths.append((f"{name}.albedo.value.value", root + ("albedo", al_leaf)))
        param_paths.append((f"{name}.scale", root + ("scale",)))
        return HomogeneousMedium(sigma_t=st, albedo=al, scale=scale, phase_index=phase_index)
    param_paths.append((f"{name}.sigma_t.{st_leaf}", root + ("sigma_t", st_leaf)))
    param_paths.append((f"{name}.albedo.{al_leaf}", root + ("albedo", al_leaf)))
    param_paths.append((f"{name}.scale", root + ("scale",)))
    return HeterogeneousMedium(
        sigma_t=st, albedo=al, scale=scale, max_density=scale * st.max() * 1.0001,
        phase_index=phase_index,
    )
