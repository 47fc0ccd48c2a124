"""Integrator construction from a scene-dict spec (counterpart of
mitsuba_tpu/integrators/__init__.py): ``path``, ``prb`` and ``prb_basic``.
Any other type raises ``NotImplementedError``: it is not yet ported."""
from __future__ import annotations


def make_integrator(spec):
    if not isinstance(spec, dict):
        raise ValueError("integrator spec must be a dict")
    t = spec.get("type", "path")
    if t not in ("path", "prb", "prb_basic"):
        raise NotImplementedError(f"integrator {t!r} is not yet ported")
    if spec.get("regenerate", False):
        raise NotImplementedError("path regeneration is not yet ported")
    kw = dict(
        max_depth=int(spec.get("max_depth", 8)),
        rr_depth=int(spec.get("rr_depth", 5)),
        hide_emitters=bool(spec.get("hide_emitters", False)),
        defer_nee=bool(spec.get("defer_nee", True)),
    )
    if t == "path":
        from .path import PathIntegrator

        return PathIntegrator(**kw)
    from ..ad.prb import PRBIntegrator

    # prb_basic is the pure BSDF-sampling estimator: no NEE, no MIS
    return PRBIntegrator(**kw, use_nee=(t == "prb"))
