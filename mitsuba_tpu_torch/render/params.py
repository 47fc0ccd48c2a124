"""SceneParameters / traverse: the dict-like view of a scene's parameters
(counterpart of mitsuba_tpu/render/params.py).

Keys are the reference's dotted names (``white.reflectance.value``,
``light.emitter.radiance.value``, ``floor.vertex_positions``,
``ball.center``, ``sky.data``, ...), so a
dict made from the JAX package's ``mi.traverse(scene)`` carries across:
``traverse(scene).update({key: np.ndarray})``.

``update()`` returns a new scene (also kept as ``.scene``) and leaves the
old one as it was. After a vertex write it re-derives the triangle tables
(Geometry.refresh) and the area emitters' cdfs from them; after a write to
a medium, its majorant (the reference's parameters_changed).

The meshes share one vertex buffer, where the reference gives each mesh
its own. A ``<shape>.vertex_positions`` write therefore rebuilds the
buffer from its values, detached, and the rows written in this update:
those keep their values' graphs, and no update carries the graph of an
earlier one. A shape written in an earlier update keeps its value and
loses its graph, so an optimisation loop writes every shape it
differentiates in the update before each render (writing one shape once
and then another in a loop that calls backward works).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _is_slice(step):
    return isinstance(step, tuple) and step and step[0] == "slice"


def _tree_get(obj, path):
    for step in path:
        if _is_slice(step):
            obj = obj[step[1]:step[2]]
        elif isinstance(step, int):
            obj = obj[step]
        else:
            obj = getattr(obj, step)
    return obj


def _tree_set(obj, path, value):
    """Copy-on-write deep set along an attribute/index path; a step
    ('slice', start, stop) writes a row range of a tensor leaf."""
    step, rest = path[0], path[1:]
    if _is_slice(step):
        out = obj.clone()
        out[step[1]:step[2]] = value
        return out
    if isinstance(step, int):
        lst = list(obj)
        lst[step] = _tree_set(obj[step], rest, value) if rest else value
        return tuple(lst)
    new = _tree_set(getattr(obj, step), rest, value) if rest else value
    return dataclasses.replace(obj, **{step: new})


class SceneParameters:
    """Dict-like view over the scene's parameters, with pending writes that
    update() applies."""

    def __init__(self, scene):
        self._scene = scene
        self._paths = dict(scene.param_paths)
        self._pending = {}

    @property
    def scene(self):
        return self._scene

    def keys(self):
        return self._paths.keys()

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def __contains__(self, key):
        return key in self._paths

    def __iter__(self):
        return iter(self._paths)

    def __len__(self):
        return len(self._paths)

    def __getitem__(self, key):
        if key in self._pending:
            return self._pending[key]
        return _tree_get(self._scene, self._paths[key])

    def __setitem__(self, key, value):
        if key not in self._paths:
            raise KeyError(key)
        if (torch.is_tensor(value) and value.requires_grad
                and self._paths[key][:2] in (("geometry", "sph_center"),
                                             ("geometry", "sph_radius"))):
            raise NotImplementedError(
                f"the gradient of {key!r} (an analytic sphere's projective boundary terms) is "
                "not yet ported; write the value without requires_grad to move the sphere")
        if torch.is_tensor(value):
            self._pending[key] = value.to(torch.float32)
        else:
            self._pending[key] = torch.tensor(np.asarray(value, np.float32))

    def update(self, values=None):
        """Apply pending writes (after those in `values`, a dict of key ->
        value) and return the updated scene."""
        if values is not None:
            for k, v in values.items():
                if k in self._paths:
                    self[k] = v
        scene = self._scene
        geometry_touched = False
        media_touched = set()
        rows = {}            # shared buffer's path -> [(row slice, value)] written now
        for key, value in self._pending.items():
            path = self._paths[key]
            old = _tree_get(scene, path)
            value = value.to(old.device).expand(old.shape).clone(memory_format=torch.contiguous_format)
            if _is_slice(path[-1]):
                rows.setdefault(path[:-1], []).append((path[-1], value))
            else:
                scene = _tree_set(scene, path, value)
            geometry_touched |= path[0] == "geometry"
            if path[0] == "media":
                media_touched.add(path[:2])
        self._pending.clear()
        for root, written in rows.items():
            buf = _tree_get(scene, root).detach().clone()
            for (_, lo, hi), value in written:
                buf[lo:hi] = value
            scene = _tree_set(scene, root, buf)
        for root in sorted(media_touched):
            # a medium re-derives its majorant from its new coefficients
            scene = _tree_set(scene, root, _tree_get(scene, root).parameters_changed())
        if geometry_touched:
            geometry = scene.geometry.refresh()
            scene = dataclasses.replace(
                scene,
                geometry=geometry,
                emitters=tuple(em.parameters_changed(geometry) for em in scene.emitters),
            )
        self._scene = scene
        return scene


def traverse(scene):
    """The SceneParameters view of a scene (mirrors mi.traverse)."""
    return SceneParameters(scene)
