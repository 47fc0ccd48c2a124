"""Polarized volumetric path-replay backpropagation: prb_polarized
(counterpart of mitsuba_tpu/ad/prb_polarized.py).

The replay of ad/prbvolpath.py with Mueller algebra:

  * the throughput beta is a Mueller chain [N, C, 4, 4] (beta' = beta @ M)
    and the remaining radiance L keeps the full Stokes vector [N, C, 4]
    between segments: the scalar tracking and Russian-roulette weights
    preserve polarization, so their attached ratios act exactly on every
    Stokes component (the reference plugin zeroes Q, U and V at every loop
    top, which loses e.g. dQ/d(albedo); the JAX package keeps them);
  * the incoming adjoint dL is a Stokes vector per lane, rotated back from
    the sensor frame by the PRB pass node (ad/render_ad.py);
  * the terms of a segment:

      w_seg   scalar tracking ratios        dL . L_start . (w_att / w_det)
      Le      unpolarized emission through the detached Mueller chain
      C_nee   the attached Mueller phase or BSDF value (with the primal's
              basis rotations) x attached emitter radiance x attached
              ratio-tracked transmittance, through the detached chain
      w_dir   the intensity ratio of the attached Mueller eval at the
              sampled direction over the detached pdf, per event (dividing
              by the whole chain's intensity would amplify the remaining-L
              noise by 1/beta), applied to the whole remaining Stokes
              vector: exact for parameters that scale the intensity (HG g,
              albedo), approximate for those that reshape a Mueller
              phase's polarization, as in the reference.

Gradients reach medium, phase, emitter and reflectance parameters; not
shapes, nor perfectly specular parameters (detached sampling), as in the
reference.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..integrators.volpath import VolPathIntegrator
from .prbvolpath import VolumeReplay


@dataclass(frozen=True)
class PRBPolarizedVolpathIntegrator(VolumeReplay, VolPathIntegrator):
    """Detached-sampling polarized volumetric PRB (the *_polarized
    variants). The primal is the polarized VolPathIntegrator.sample."""

    dir_floor = 1e-12
