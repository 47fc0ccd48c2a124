"""Integrator construction from a scene-dict spec (counterpart of
mitsuba_tpu/integrators/__init__.py): the ``path`` integrator only."""
from __future__ import annotations


def make_integrator(spec):
    if not isinstance(spec, dict):
        raise ValueError("integrator spec must be a dict")
    t = spec.get("type", "path")
    if t != "path":
        raise NotImplementedError(f"integrator {t!r} is not yet ported")
    if spec.get("regenerate", False):
        raise NotImplementedError("path regeneration is not yet ported")
    from .path import PathIntegrator

    return PathIntegrator(
        max_depth=int(spec.get("max_depth", 8)),
        rr_depth=int(spec.get("rr_depth", 5)),
        hide_emitters=bool(spec.get("hide_emitters", False)),
        defer_nee=bool(spec.get("defer_nee", True)),
    )
