"""Atmosphere-ocean path-replay backpropagation: prb_volpathaos
(counterpart of mitsuba_tpu/ad/prb_volpathaos.py).

The replay of ad/prbvolpath.py over the atmosphere-ocean primal
(integrators/volpathaos.py), which it replays bit-exactly: the segment's
extra draw for the refraction proposal, the proposal itself and the bent
shadow walk. The NEE term differs from volpath's:

  C_nee   the attached phase or BSDF value x attached emitter irradiance x
          the attached shadow walk (ratio-tracked sigma_n, and the
          refractive crossing's BSDF eval attached), while the refraction
          proposal's pdf stays in the detached emitter ratio

and the other terms (w_seg, Le, w_dir) are prbvolpath's, the w_dir one per
event. It runs in the unpolarized variants ([N, C] radiance) and in the
polarized ones ([N, C, 4] Stokes, [N, C, 4, 4] Mueller chains) through
the spectrum ops, as the primal does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..integrators.volpathaos import (
    VolPathAOSIntegrator,
    aos_nee_contrib,
    aos_nee_setup,
    estimate_transmittance_aos,
)
from ..integrators.volpath import nee_eval
from .prbvolpath import VolumeReplay


@dataclass(frozen=True)
class PRBVolpathAOSIntegrator(VolumeReplay, VolPathAOSIntegrator):
    """Detached-sampling atmosphere-ocean PRB. The primal is
    VolPathAOSIntegrator.sample."""

    dir_floor = 1e-12

    def _replay_nee(self, scene_d, sc, ops, s, ev, beta, u0, u2a, u2r, rng):
        nee = aos_nee_setup(scene_d, s, ev, u0, u2a, u2r)
        with torch.enable_grad():
            T_a, rng = estimate_transmittance_aos(
                sc, nee.p_nee, nee.d_nee, nee.ds.d, nee.walk_dist, nee.nee_medium, s["channel"],
                rng, nee.nee_active, ops, max_crossings=self.nee_crossings,
                steps_per_segment=self.nee_steps, wavelengths=s["wavelengths"])
            f_a, _ = nee_eval(sc, ops, ev, nee.d_nee, nee.nee_surf, s["wavelengths"])
            C_det = aos_nee_contrib(ops, beta, f_a.detach(), T_a.detach(), nee.em_weight,
                                    nee.nee_active)
            # the emitter's irradiance attached; the proposal's pdf and the
            # rest of the weight are a detached ratio
            em_val_d = scene_d.eval_emitter_sample(nee.ds, s["wavelengths"])
            em_ratio = torch.where(em_val_d > 1e-20,
                                   nee.em_weight / torch.clamp(em_val_d, min=1e-20), 0.0)
            C_att = aos_nee_contrib(ops, beta, f_a, T_a,
                                    sc.eval_emitter_sample(nee.ds, s["wavelengths"]) * em_ratio,
                                    nee.nee_active)
        return C_det, C_att, nee.nee_active, nee.ref_p, rng
