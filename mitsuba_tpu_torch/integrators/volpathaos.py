"""Atmosphere-ocean volumetric path tracer (counterpart of
mitsuba_tpu/integrators/volpathaos.py).

volpath specialised to one directional emitter above the scene and at most
one refractive interface (the ocean surface, aligned with the world x-y
plane). What differs from volpath:

  * NEE through the refractive interface: while a refractive BSDF lies
    between the vertex and the sun, NEE samples that BSDF's transmission
    lobe with wi = the sun's direction and aims the shadow ray at -wo, the
    direction that refracts into the sun, dividing by its pdf (proposals of
    pdf <= 1e-7 are dropped);
  * each lane remembers that interface (``refr``, a BSDF index or -1): it
    is set when a non-null scatter crosses a refractive surface and
    cleared when a later one crosses back;
  * the shadow walk crosses null surfaces, and at the one refractive
    surface multiplies the transmittance by the BSDF's eval toward the sun
    and bends onto the sun's direction; media take ratio tracking;
  * NEE takes plain weights (the emitter is Dirac: no MIS), and surface
    NEE only on the reflection side (si.wi.z > 0).

Every loop draws the JAX package's numbers in its order: one more 2D draw
per segment than volpath (the refraction proposal), drawn whether a lane
uses it or not. A shadow walk that stops early skips the draws of its
remaining crossings, as volpath's estimate_transmittance does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..render.records import spawn_ray
from .volpath import VolPathIntegrator, _any, nee_eval, track_segment_ratio


def _refractive_nee_direction(scene, refr_idx, emitter_d, u2, active):
    """The direction that refracts into emitter_d at each lane's interface
    (whose frame is the world's: normal +z). Returns (d_nee [N, 3],
    1/pdf [N], valid [N])."""
    n = emitter_d.shape[0]
    d_out = emitter_d
    inv_pdf = torch.ones(n, dtype=torch.float32, device=emitter_d.device)
    valid = torch.ones(n, dtype=torch.bool, device=emitter_d.device)
    for i, b in enumerate(scene.bsdfs):
        if not getattr(b, "is_refractive_interface", False):
            continue
        m = (refr_idx == i) & active
        wo, pdf = b.sample_transmission(u2, emitter_d)
        ok = pdf > 1e-7
        d_out = torch.where(m[..., None], -wo, d_out)
        inv_pdf = torch.where(m, torch.where(ok, 1.0 / torch.clamp(pdf, min=1e-7), 0.0), inv_pdf)
        valid = torch.where(m, ok, valid)
    return d_out, inv_pdf, valid


def estimate_transmittance_aos(scene, p0, d0, emitter_d, dist, medium0, channel, rng, active,
                               ops, max_crossings=6, steps_per_segment=32, wavelengths=None):
    """The atmosphere-ocean shadow walk from p0 along d0: ratio tracking
    through media and null surfaces, and at the refractive surface the
    BSDF's eval toward emitter_d and a turn onto it. Polarized, the
    transmittance is the Mueller chain M_1 @ M_2 @ ... in walk order.
    Walks that need more than max_crossings surfaces get 0. Returns (T,
    rng)."""
    n = p0.shape[0]
    nc = scene.n_channels
    T = ops.one(n, nc, p0.device)
    p, d, medium, alive = p0, d0, medium0, active
    remaining = dist * (1.0 - 1e-3)
    for k in range(max_crossings):
        if not _any(alive):
            rng = rng.skip(2 * steps_per_segment * (max_crossings - k))
            break
        ray = spawn_ray(p, d, d, maxt=remaining)
        si = scene.ray_intersect(ray, alive)
        t_surf = torch.where(si.is_valid, si.t, float("inf"))
        seg_len = torch.minimum(t_surf, remaining)
        T_seg, rng = track_segment_ratio(scene, ray.o, d, seg_len, medium, channel, rng, alive,
                                         steps_per_segment)
        T = ops.mul_scalar(T, torch.where(alive[..., None], T_seg, 1.0))

        hit_surface = alive & si.is_valid & (t_surf < remaining)
        is_null = scene.is_null_bsdf(si)
        cross_null = hit_surface & is_null
        cross_refr = hit_surface & ~is_null
        # the refractive surface: its eval toward the emitter, then on
        # along the emitter's direction
        wo_em = si.to_local(emitter_d)
        if ops.polarized:
            M_refr, _ = scene.bsdf_eval_pdf_pol(si, wo_em, cross_refr, wavelengths)
            T = torch.where(cross_refr[..., None, None, None], T @ M_refr, T)
        else:
            v_refr, _ = scene.bsdf_eval_pdf(si, wo_em, cross_refr, wavelengths)
            T = torch.where(cross_refr[..., None], T * v_refr, T)
        new_d = torch.where(cross_refr[..., None], emitter_d, d)
        medium = torch.where(hit_surface, scene.medium_transition(si, new_d, medium), medium)
        adv = torch.where(hit_surface, t_surf, 0.0)
        p = p + (adv + 1e-4)[..., None] * d
        d = new_d
        remaining = remaining - adv
        alive = (cross_null | cross_refr) & (torch.amax(ops.intensity_beta(T), dim=-1) > 0)
    zero_T = ops.mul_scalar(T, torch.zeros(n, nc, dtype=torch.float32, device=p0.device))
    T = ops.where_beta(alive, zero_T, T)         # crossings left over: 0
    return ops.where_beta(active, T, zero_T), rng


def refractive_bsdf_mask(scene, b_idx):
    """Lanes whose BSDF index is that of a refractive interface (the BSDFs
    that _refractive_nee_direction proposes through)."""
    out = torch.zeros(b_idx.shape, dtype=torch.bool, device=b_idx.device)
    for i, b in enumerate(scene.bsdfs):
        if getattr(b, "is_refractive_interface", False):
            out = out | (b_idx == i)
    return out


def next_refr(scene, si, ray_d, new_d, scatter_surf, refr):
    """Each lane's refractive-interface memory after its bounce: set at a
    non-null scatter that refracts through a refractive BSDF, cleared at
    the next one that crosses back (the ray's z keeps its sign)."""
    refracted = scatter_surf & (ray_d[..., 2] * new_d[..., 2] > 0)
    b_idx = scene.bsdf_index_at(si)
    set_refr = refracted & refractive_bsdf_mask(scene, b_idx) & (refr < 0)
    unset_refr = refracted & (refr >= 0)
    return torch.where(set_refr, b_idx, torch.where(unset_refr, -1, refr))


@dataclass
class AOSNee:
    """The detached setup of one segment's atmosphere-ocean NEE, which the
    primal and the PRB replay share."""

    nee_surf: torch.Tensor    # [N] surface NEE (reflection side)
    nee_active: torch.Tensor  # [N] lanes that take NEE
    ref_p: torch.Tensor       # [N, 3]
    ds: object                # the emitter's DirectionSample
    em_weight: torch.Tensor   # [N, C] emitter weight over the proposal's pdf
    d_nee: torch.Tensor       # [N, 3] the shadow ray's first direction
    nee_medium: torch.Tensor  # [N]
    p_nee: torch.Tensor       # [N, 3]
    walk_dist: torch.Tensor   # [N]


def aos_nee_setup(scene, s, ev, u0, u2a, u2r):
    """The NEE of a segment up to its shadow walk: the emitter sample and,
    where the lane remembers a refractive interface, the refraction
    proposal (drawn from u2r)."""
    si, p_med = ev["si"], ev["p_med"]
    scatter_med, scatter_surf = ev["scatter_med"], ev["scatter_surf"]
    nee_surf = scatter_surf & (si.wi[..., 2] > 0)
    nee_active = scatter_med | nee_surf
    ref_p = torch.where(scatter_med[..., None], p_med, si.p)
    ds, em_weight = scene.sample_emitter_direction(ref_p, u0, u2a, nee_active,
                                                   test_visibility=False,
                                                   wavelengths=s["wavelengths"])
    has_refr = nee_active & (s["refr"] >= 0)
    d_refr, inv_pdf_refr, refr_ok = _refractive_nee_direction(scene, s["refr"], ds.d, u2r,
                                                              has_refr)
    d_nee = torch.where(has_refr[..., None], d_refr, ds.d)
    em_weight = torch.where(has_refr[..., None], em_weight * inv_pdf_refr[..., None], em_weight)
    nee_active = nee_active & (refr_ok | ~has_refr)
    nee_medium = torch.where(scatter_surf, scene.medium_transition(si, d_nee, s["medium"]),
                             s["medium"])
    side = torch.sign(torch.sum(si.n * d_nee, dim=-1))
    p_nee = torch.where(scatter_surf[..., None], si.p + side[..., None] * 1e-4 * si.n, p_med)
    # a bent path: walk far
    walk_dist = torch.where(has_refr, 4.0 * torch.clamp(scene.bbox_radius, min=1.0), ds.dist)
    return AOSNee(nee_surf=nee_surf, nee_active=nee_active, ref_p=ref_p, ds=ds,
                  em_weight=em_weight, d_nee=d_nee, nee_medium=nee_medium, p_nee=p_nee,
                  walk_dist=walk_dist)


def aos_nee_contrib(ops, beta, f, T, em_weight, nee_active):
    """beta f T s_emit (Dirac emitter: no MIS), 0 off NEE."""
    if ops.polarized:
        c = (beta @ f @ T)[..., :, 0] * em_weight[..., None]
        return torch.where(nee_active[..., None, None], c, 0.0)
    return torch.where(nee_active[..., None], beta * f * T * em_weight, 0.0)


@dataclass(frozen=True)
class VolPathAOSIntegrator(VolPathIntegrator):
    """volpathaos, and the primal of prb_volpathaos: volpath's segment
    with one more draw, the atmosphere-ocean NEE, and the
    refractive-interface memory. Takes the volpath defaults of its
    tracking budgets."""

    def _regen_extra(self, n, scene):
        """The refractive-interface memory, reset when a lane restarts."""
        return {"refr": torch.full((n,), -1, dtype=torch.int64, device=scene.device)}

    def _draws(self, rng):
        u0, u2a_x, rng = rng.next_2d()
        u2a_y, u_lobe, rng = rng.next_2d()
        u2b_x, u2b_y, rng = rng.next_2d()
        u2r_x, u2r_y, rng = rng.next_2d()
        u_rr, _, rng = rng.next_2d()
        return (u0, torch.stack([u2a_x, u2a_y], dim=-1), u_lobe,
                torch.stack([u2b_x, u2b_y], dim=-1), torch.stack([u2r_x, u2r_y], dim=-1),
                u_rr, rng)

    def _nee(self, scene, ops, s, ev, beta, u0, u2a, u2r, rng):
        nee = aos_nee_setup(scene, s, ev, u0, u2a, u2r)
        T_nee, rng = estimate_transmittance_aos(
            scene, nee.p_nee, nee.d_nee, nee.ds.d, nee.walk_dist, nee.nee_medium, s["channel"],
            rng, nee.nee_active, ops, max_crossings=self.nee_crossings,
            steps_per_segment=self.nee_steps, wavelengths=s["wavelengths"])
        f_nee, _ = nee_eval(scene, ops, ev, nee.d_nee, nee.nee_surf, s["wavelengths"])
        return (aos_nee_contrib(ops, beta, f_nee, T_nee, nee.em_weight, nee.nee_active),
                nee.nee_active, nee.ref_p, rng)

    def _advance_extra(self, scene, si, s, new_d, scatter_surf):
        return {"refr": next_refr(scene, si, s["ray_d"], new_d, scatter_surf, s["refr"])}
