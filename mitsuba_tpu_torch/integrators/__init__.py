"""Integrator construction from a scene-dict spec (counterpart of
mitsuba_tpu/integrators/__init__.py): ``path``, ``prb``, ``prb_basic``,
``volpath``, ``volpathmis``, ``prbvolpath`` (alias ``prb_unpolarized``),
``prb_polarized``, ``volpathaos``, ``prb_volpathaos``, ``direct``,
``depth``, ``aov``, ``stokes``, ``moment``, ``ptracer``,
``direct_projective`` and ``prb_projective``. Any other type raises
``NotImplementedError``: it is not yet ported.

``volpathmis`` with ``use_spectral_mis: False`` is ``volpath``; in a
polarized variant it raises ValueError when it renders. The projective
integrators (ad/projective.py) wrap a base: ``direct`` for
``direct_projective``, ``prb`` for ``prb_projective``, or, in a polarized
variant, ``prb_polarized``, where ``direct_projective`` raises
ValueError.

``stokes`` and ``moment`` wrap the integrator of their child dict (the
last child that has a ``type``), by default ``volpath`` at the wrapper's
``max_depth``; ``stokes`` raises ValueError when it renders outside a
polarized variant, as the reference's does.

As in the reference, in a polarized variant ``path`` is ``volpath`` (the
volumetric integrator carries the Mueller transport of surface scenes
too), and ``prb``, ``prb_basic`` and ``prbvolpath`` are the Mueller replay
``prb_polarized``, which an unpolarized variant refuses with a
``ValueError``. The volumetric PRB integrators take only ``max_depth``,
``rr_depth`` and ``hide_emitters`` from the spec, as the reference's do.

``regenerate`` (path regeneration: one lane per pixel, a finished path
restarts on its pixel's next sample) is taken by every integrator here,
in every ported variant: the forward ones render with the regenerative
loop, and the PRB ones also replay it in their backward pass; in the
spectral variants the surface ``path``, ``prb`` and ``prb_basic`` render
their plain passes instead, as in the reference
(render_api.regenerates)."""
from __future__ import annotations

from ..variant import current_variant

TYPES = ("path", "prb", "prb_basic", "volpath", "volpathmis", "prbvolpath", "prb_unpolarized",
         "prb_polarized", "volpathaos", "prb_volpathaos", "direct", "depth", "aov", "stokes",
         "moment", "ptracer", "direct_projective", "prb_projective")


def make_integrator(spec):
    if not isinstance(spec, dict):
        raise ValueError("integrator spec must be a dict")
    t = spec.get("type", "path")
    if t not in TYPES:
        raise NotImplementedError(f"integrator {t!r} is not yet ported")
    regenerate = bool(spec.get("regenerate", False))
    polarized = current_variant().polarized
    if polarized and t == "path":
        t = "volpath"
    if polarized and t in ("prb", "prb_basic", "prbvolpath"):
        t = "prb_polarized"
    if t == "prb_polarized" and not polarized:
        raise ValueError("prb_polarized requires a *_polarized variant")
    if t == "direct":
        from .direct import DirectIntegrator

        return DirectIntegrator(emitter_samples=int(spec.get("emitter_samples", 1)),
                                bsdf_samples=int(spec.get("bsdf_samples", 1)))
    if t == "depth":
        from .direct import DepthIntegrator

        return DepthIntegrator()
    if t == "aov":
        from .aov import AOVIntegrator

        return AOVIntegrator(aovs=str(spec.get("aovs", "dd.y:depth")))
    if t in ("stokes", "moment"):
        from .aov import MomentIntegrator, StokesIntegrator

        nested = None
        for v in spec.values():
            if isinstance(v, dict) and "type" in v:
                nested = make_integrator(v)
        if nested is None:
            nested = make_integrator({"type": "volpath",
                                      "max_depth": int(spec.get("max_depth", 8))})
        return (StokesIntegrator if t == "stokes" else MomentIntegrator)(nested=nested)
    kw = dict(
        max_depth=int(spec.get("max_depth", 8)),
        rr_depth=int(spec.get("rr_depth", 5)),
        hide_emitters=bool(spec.get("hide_emitters", False)),
        regenerate=regenerate,
    )
    if t == "ptracer":
        from .ptracer import PTracerIntegrator

        return PTracerIntegrator(max_depth=kw["max_depth"], rr_depth=kw["rr_depth"])
    if t == "volpathmis":
        base = {k: kw[k] for k in ("max_depth", "rr_depth", "hide_emitters")}
        if not bool(spec.get("use_spectral_mis", True)):
            from .volpath import VolPathIntegrator

            return VolPathIntegrator(**base)
        from .volpathmis import VolPathMisIntegrator

        return VolPathMisIntegrator(**base)
    if t in ("direct_projective", "prb_projective"):
        return _projective(t, spec, {k: kw[k] for k in ("max_depth", "rr_depth", "hide_emitters")},
                           polarized)
    if t == "volpath":
        from .volpath import VolPathIntegrator

        return VolPathIntegrator(
            **kw,
            max_segments=int(spec.get("max_segments", 0)),
            track_steps=int(spec.get("track_steps", 32)),
            nee_crossings=int(spec.get("nee_crossings", 4)),
            nee_steps=int(spec.get("nee_steps", 32)),
        )
    if t == "volpathaos":
        from .volpathaos import VolPathAOSIntegrator

        return VolPathAOSIntegrator(**kw)
    if t in ("prbvolpath", "prb_unpolarized"):
        from ..ad.prbvolpath import PRBVolpathIntegrator

        return PRBVolpathIntegrator(**kw)
    if t == "prb_polarized":
        from ..ad.prb_polarized import PRBPolarizedVolpathIntegrator

        return PRBPolarizedVolpathIntegrator(**kw)
    if t == "prb_volpathaos":
        from ..ad.prb_volpathaos import PRBVolpathAOSIntegrator

        return PRBVolpathAOSIntegrator(**kw)
    kw["defer_nee"] = bool(spec.get("defer_nee", True))
    if t == "path":
        from .path import PathIntegrator

        return PathIntegrator(**kw)
    from ..ad.prb import PRBIntegrator

    # prb_basic is the pure BSDF-sampling estimator: no NEE, no MIS
    return PRBIntegrator(**kw, use_nee=(t == "prb"))


def _projective(t, spec, kw, polarized):
    """A ProjectiveIntegrator over its base (see the module docstring)."""
    from ..ad.projective import ProjectiveIntegrator

    if polarized:
        if t == "direct_projective":
            raise ValueError("direct_projective is unpolarized; use prb_projective in the "
                             "*_polarized variants")
        from ..ad.prb_polarized import PRBPolarizedVolpathIntegrator

        base = PRBPolarizedVolpathIntegrator(**kw)
    elif t == "direct_projective":
        from .direct import DirectIntegrator

        base = DirectIntegrator()
    else:
        from ..ad.prb import PRBIntegrator

        base = PRBIntegrator(**kw)
    return ProjectiveIntegrator(base=base, sppp=int(spec.get("sppp", 4)),
                                sppi=int(spec.get("sppi", 4)),
                                boundary_depth=int(spec.get("boundary_depth", 0)))
