"""Integrator construction from a scene-dict spec (counterpart of
mitsuba_tpu/integrators/__init__.py): ``path``, ``prb``, ``prb_basic`` and
``volpath``. Any other type raises ``NotImplementedError``: it is not yet
ported. ``regenerate`` is taken by ``path`` and ``volpath`` (forward
renders); the PRB integrators refuse it until their regenerative backward
replay is ported.

In a polarized variant, ``path`` is ``volpath`` (as in the reference, the
volumetric integrator carries the Mueller transport of surface scenes
too); the polarized PRB integrators and polarized path regeneration are
not yet ported."""
from __future__ import annotations

from ..variant import current_variant


def make_integrator(spec):
    if not isinstance(spec, dict):
        raise ValueError("integrator spec must be a dict")
    t = spec.get("type", "path")
    if t not in ("path", "prb", "prb_basic", "volpath"):
        raise NotImplementedError(f"integrator {t!r} is not yet ported")
    regenerate = bool(spec.get("regenerate", False))
    if current_variant().polarized:
        if t != "path" and t != "volpath":
            raise NotImplementedError(
                f"{t!r} in a polarized variant (the reference's prb_polarized) is not yet ported")
        if regenerate:
            raise NotImplementedError(
                "regenerate in a polarized variant (the Stokes rotation at each path's "
                "flush) is not yet ported; it is queued after the polarized forward slice")
        t = "volpath"
    kw = dict(
        max_depth=int(spec.get("max_depth", 8)),
        rr_depth=int(spec.get("rr_depth", 5)),
        hide_emitters=bool(spec.get("hide_emitters", False)),
    )
    if t == "volpath":
        from .volpath import VolPathIntegrator

        return VolPathIntegrator(
            **kw,
            max_segments=int(spec.get("max_segments", 0)),
            track_steps=int(spec.get("track_steps", 32)),
            nee_crossings=int(spec.get("nee_crossings", 4)),
            nee_steps=int(spec.get("nee_steps", 32)),
            regenerate=regenerate,
        )
    kw["defer_nee"] = bool(spec.get("defer_nee", True))
    if t == "path":
        from .path import PathIntegrator

        return PathIntegrator(**kw, regenerate=regenerate)
    if regenerate:
        raise NotImplementedError(
            "regenerate with a PRB integrator (its regenerative backward replay) "
            "is not yet ported")
    from ..ad.prb import PRBIntegrator

    # prb_basic is the pure BSDF-sampling estimator: no NEE, no MIS
    return PRBIntegrator(**kw, use_nee=(t == "prb"))
