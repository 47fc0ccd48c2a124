"""Scene-dict loader for the Cornell-box and mesh vocabulary (counterpart
of mitsuba_tpu/render/scene_loader.py).

Accepted plugin types: ``scene``; the ``path``, ``prb``, ``prb_basic``,
``volpath``, ``volpathmis``, ``prbvolpath`` (``prb_unpolarized``),
``prb_polarized``, ``volpathaos``, ``prb_volpathaos``, ``direct``,
``depth``, ``aov``, ``stokes``, ``moment``, ``ptracer``,
``direct_projective`` and ``prb_projective`` integrators; the ``perspective`` and ``radiancemeter``
(with an optional ``wavelength``) sensors with an ``independent`` sampler
and an ``hdrfilm`` (or a ``specfilm``, whose nested spectra are its
channels' sensor response functions) with a ``gaussian``, ``box`` or
``tent`` filter; the
``diffuse``, ``null``, ``dielectric``, ``thindielectric``, ``roughdielectric``,
``conductor``, ``roughconductor`` (a ``material`` preset or ``eta`` and
``k``), ``roughplastic``, ``pplastic``, ``polarizer``, ``circular``,
``retarder``, ``twosided``, ``mask`` and ``blendbsdf`` BSDFs with ``rgb``,
scalar or spectrum (``uniform``, ``singleton``, ``d65``, ``blackbody``,
``regular``, ``irregular``) textures (``normalmap``, ``bumpmap``, ``plastic`` and the
principled, measured and hair BSDFs raise ``NotImplementedError``);
``rectangle``, ``cube``, ``obj``, ``ply`` and
raw-array ``mesh`` shapes, with an ``interior`` and ``exterior`` medium;
``homogeneous`` and ``heterogeneous`` media (``constvolume``/``gridvolume``
fields, the ``isotropic``, ``hg``, ``sggx``, ``rayleigh``, ``mie`` (with a
``monodisperse``, ``gamma``, ``lognormal`` or ``powerlaw`` size
distribution), ``tabphase_polarized`` and ``blendphase`` phase functions);
``area`` emitters, the ``constant`` environment emitter, the
``directional`` sun and ``point`` lights (more than four with a constant
intensity are fused into one ``PointEmitterArray``, as in the JAX
package; ``fuse_point_lights`` True or False at the root of the dict
forces it either way); ``ref`` to a named BSDF or medium. Any other type
raises ``NotImplementedError``: it is not yet ported (``serialized`` and
``blender`` meshes among them).

The scene takes the channel count and polarization of the current variant
(``set_variant``): ``mono`` scenes carry one channel, ``rgb`` three,
``spectral`` four wavelengths a lane.

An ``obj`` or ``ply`` ``filename`` is an absolute path or one relative to
the working directory: the reference's file-resolver search path is not
yet ported.

The scene is built on the host in numpy, with the same operations as the
JAX package's loader, then moved to its device once.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import native
from ..core.transform import Transform, build_transform
from . import bsdfs as B
from ..variant import current_variant
from .emitters import (AreaEmitter, ConstantEmitter, DirectionalEmitter, PointEmitter,
                       PointEmitterArray)
from .film import Film, srf_norms
from .media import MEDIUM_TYPES, parse_medium
from .scene import Scene
from .sensors import PerspectiveCamera, RadiancemeterSensor
from . import shapes as SH
from . import textures as TX
from .textures import ConstantTexture

SHAPE_TYPES = ("rectangle", "cube", "obj", "ply", "mesh")
BSDF_TYPES = ("diffuse", "null", "roughdielectric", "dielectric", "thindielectric", "conductor",
              "roughconductor", "roughplastic", "pplastic", "polarizer", "circular", "retarder",
              "twosided", "mask", "blendbsdf")
# the reference's other BSDF plugins, refused with a NotImplementedError
BSDF_TYPES_NOT_PORTED = ("normalmap", "bumpmap", "plastic", "principled", "principledthin",
                         "principled_thin", "measured", "measured_polarized", "hair")
ALL_BSDF_TYPES = BSDF_TYPES + BSDF_TYPES_NOT_PORTED
# the reference's environment and delta emitters; "constant",
# "directional" and "point" are ported
EMITTER_TYPES = ("constant", "point", "directional", "envmap", "spot", "projector")
SENSOR_TYPES = ("perspective", "radiancemeter")
FILM_KEYS_NOT_PORTED = ("crop_offset_x", "crop_offset_y", "crop_width", "crop_height")


def resolve_device(device=None):
    """The device a scene lives on: the card unless the caller names
    another. Without a card, only an explicit non-CUDA device is accepted;
    nothing falls back to the CPU quietly."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mitsuba_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return device


def _not_ported(what):
    return NotImplementedError(f"{what} is not yet ported")


def load_mesh_file(kind, filename, to_world):
    """An ``obj`` or ``ply`` file through the native loaders, in world space:
    positions by to_world, normals by its inverse transpose, renormalized."""
    filename = os.fspath(filename)
    if not os.path.isfile(filename):
        raise FileNotFoundError(f"{kind} shape: no file {filename!r}")
    m = native.load_obj(filename) if kind == "obj" else native.load_ply(filename)
    mm = np.asarray(to_world.m)
    V = m["vertices"]
    out = {"vertices": (mm[:3, :3] @ V.T + mm[:3, 3:4]).T.astype(np.float32),
           "faces": m["faces"]}
    if "normals" in m:
        Nw = (np.asarray(to_world.inv)[:3, :3].T @ m["normals"].T).T
        Nw /= np.maximum(np.linalg.norm(Nw, axis=-1, keepdims=True), 1e-12)
        out["normals"] = Nw.astype(np.float32)
    if "uvs" in m:
        out["uvs"] = m["uvs"]
    return out


def raw_mesh(spec, to_world):
    """A ``mesh`` shape from arrays in the dict (vertex_positions, faces,
    optional uvs and normals), in world space."""
    V = np.asarray(spec["vertex_positions"], np.float32).reshape(-1, 3)
    F = np.asarray(spec["faces"], np.int32).reshape(-1, 3)
    mm = np.asarray(to_world.m)
    m = {"vertices": (mm[:3, :3] @ V.T + mm[:3, 3:4]).T.astype(np.float32), "faces": F}
    if "uvs" in spec or "vertex_texcoords" in spec:
        m["uvs"] = np.asarray(spec.get("uvs", spec.get("vertex_texcoords")), np.float32).reshape(-1, 2)
    if "normals" in spec or "vertex_normals" in spec:
        nrm = np.asarray(spec.get("normals", spec.get("vertex_normals")), np.float32).reshape(-1, 3)
        m["normals"] = (np.linalg.inv(mm[:3, :3]).T @ nrm.T).T.astype(np.float32)
    return m


def _floats(v):
    """A list of numbers, or a string of them separated by commas or
    spaces, as float32."""
    if isinstance(v, str):
        v = [x for x in v.replace(",", " ").split() if x]
    return np.asarray(v, np.float32).reshape(-1)


def parse_texture(spec, device, default=1.0, emissive=False):
    """(texture, name of its parameter leaf) from a float, a list, an rgb
    dict or a spectrum dict (``uniform``, ``singleton``, ``d65``,
    ``blackbody``, ``regular``, ``irregular``). `emissive` marks the rgb
    values of emitters, which the spectral variants upsample with D65."""
    if spec is None:
        spec = default

    def t32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    if isinstance(spec, (int, float)):
        value = np.asarray([float(spec)], np.float32)
    elif isinstance(spec, (list, tuple, np.ndarray)):
        value = np.asarray(spec, np.float32)
        if value.ndim != 1:
            raise _not_ported("a bitmap texture")
    elif spec.get("type") in ("rgb", "srgb"):
        value = np.asarray(spec["color"] if "color" in spec else spec["value"], np.float32)
    elif spec.get("type") == "uniform":
        return ConstantTexture(value=t32([spec.get("value", 1.0)])), "value"
    elif spec.get("type") == "singleton":
        return TX.SingletonSpectrum(value=t32(spec.get("value", 1.0)),
                                    wavelength=t32(spec.get("wavelength", 550.0))), "value"
    elif spec.get("type") == "d65":
        return TX.D65Spectrum(scale=t32(spec.get("scale", 1.0))), "scale"
    elif spec.get("type") == "blackbody":
        return TX.BlackbodySpectrum(temperature=t32(spec.get("temperature", 6504.0)),
                                    scale=t32(spec.get("scale", 1.0))), "scale"
    elif spec.get("type") == "regular":
        return TX.RegularSpectrum(
            values=t32(_floats(spec["values"])),
            wl_min=t32(spec.get("wavelength_min", spec.get("lambda_min", 360.0))),
            wl_max=t32(spec.get("wavelength_max", spec.get("lambda_max", 830.0)))), "values"
    elif spec.get("type") == "irregular":
        return TX.IrregularSpectrum(wavelengths_nodes=t32(_floats(spec["wavelengths"])),
                                    values=t32(_floats(spec["values"]))), "values"
    else:
        raise _not_ported(f"texture type {spec.get('type')!r}")
    return ConstantTexture(value=torch.from_numpy(value).to(device), emissive=emissive), "value"


_IOR_PRESETS = {"bk7": 1.5046, "water": 1.3330, "diamond": 2.419, "air": 1.000277}


def _ior(v, default=1.5046):
    """An index of refraction: a number, or a preset's name."""
    if v is None:
        return default
    if isinstance(v, str):
        return _IOR_PRESETS[v.lower()]
    return float(v)


# spectrally averaged (eta, k) of common conductors, as the JAX package's
# scene loader keeps them
_CONDUCTOR_PRESETS = {
    "Au": ([0.143, 0.375, 1.442], [3.983, 2.386, 1.603]),
    "Ag": ([0.156, 0.144, 0.135], [3.60, 3.13, 2.38]),
    "Al": ([1.345, 0.965, 0.617], [7.47, 6.40, 5.30]),
    "Cu": ([0.20, 0.924, 1.102], [3.91, 2.45, 2.14]),
    "none": ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0]),
}


def _nested_bsdf_spec(spec, t):
    """The one nested BSDF of a wrapper (twosided, mask): its ``bsdf``
    child, or else its first child of a BSDF type."""
    nested = spec.get("bsdf")
    if nested is None:
        nested = next((v for v in spec.values()
                       if isinstance(v, dict) and v.get("type") in ALL_BSDF_TYPES), None)
    if nested is None:
        raise ValueError(f"{t!r} needs a nested BSDF (add a 'bsdf' child)")
    return nested


def _parse_nested(spec, name, paths, device, attr):
    """A wrapper's child BSDF, parsed under the wrapper's `name`; its
    parameter paths reach it through the wrapper's field `attr`."""
    local = []
    inst = parse_bsdf(spec, name, local, device)
    paths.extend((key, (attr,) + sub) for key, sub in local)
    return inst


def _scalar(v, device):
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def _iors(spec, int_default):
    """The relative IOR int_ior / ext_ior (numbers or presets' names)."""
    return _ior(spec.get("int_ior"), int_default) / _ior(spec.get("ext_ior"), 1.000277)


def parse_bsdf(spec, name, paths, device):
    """A BSDF instance from its dict; appends its (key, path) pairs to
    `paths`, with the JAX package's keys."""
    t = spec["type"]
    if t in BSDF_TYPES_NOT_PORTED:
        raise _not_ported(f"BSDF type {t!r}")
    if t not in BSDF_TYPES:
        raise ValueError(f"unknown bsdf type {t!r}")
    if t == "null":
        return B.NullBSDF()
    if t == "diffuse":
        tex, leaf = parse_texture(spec.get("reflectance", 0.5), device)
        paths.append((f"{name}.reflectance.{leaf}", ("reflectance", leaf)))
        return B.DiffuseBSDF(reflectance=tex)
    if t == "twosided":
        return B.TwoSidedBSDF(
            nested=_parse_nested(_nested_bsdf_spec(spec, t), name, paths, device, "nested"))
    if t == "mask":
        nested = _parse_nested(_nested_bsdf_spec(spec, t), name, paths, device, "nested")
        op, leaf = parse_texture(spec.get("opacity", 0.5), device)
        paths.append((f"{name}.opacity.{leaf}", ("opacity", leaf)))
        return B.MaskBSDF(nested=nested, opacity=op)
    if t == "blendbsdf":
        nested = [v for v in spec.values()
                  if isinstance(v, dict) and v.get("type") in ALL_BSDF_TYPES]
        if len(nested) != 2:
            raise ValueError("blendbsdf needs exactly two nested BSDFs")
        w, leaf = parse_texture(spec.get("weight", 0.5), device)
        paths.append((f"{name}.weight.{leaf}", ("weight", leaf)))
        return B.BlendBSDF(
            bsdf_a=_parse_nested(nested[0], name + ".a", paths, device, "bsdf_a"),
            bsdf_b=_parse_nested(nested[1], name + ".b", paths, device, "bsdf_b"),
            weight=w,
        )
    if t in ("polarizer", "circular", "retarder"):
        tr, _ = parse_texture(spec.get("transmittance", 1.0), device)
        if t == "circular":
            return B.CircularPolarizerBSDF(transmittance=tr,
                                           left=bool(spec.get("left_handed", False)))
        # theta (and the retarder's delta) in degrees, stored in radians
        paths.append((f"{name}.theta", ("theta",)))
        theta = _scalar(np.deg2rad(float(spec.get("theta", 0.0))), device)
        if t == "polarizer":
            return B.PolarizerBSDF(theta=theta, transmittance=tr)
        return B.RetarderBSDF(theta=theta,
                              delta_phase=_scalar(np.deg2rad(float(spec.get("delta", 90.0))),
                                                  device),
                              transmittance=tr)
    if t in ("roughplastic", "pplastic"):
        dr, leaf = parse_texture(spec.get("diffuse_reflectance", 0.5), device)
        paths.append((f"{name}.diffuse_reflectance.{leaf}", ("diffuse_reflectance", leaf)))
        sr, _ = parse_texture(spec.get("specular_reflectance", 1.0), device)
        cls = B.PPlasticBSDF if t == "pplastic" else B.RoughPlasticBSDF
        return cls(eta=_scalar(_iors(spec, 1.49), device),
                   alpha=_scalar(spec.get("alpha", 0.06 if t == "pplastic" else 0.1), device),
                   diffuse_reflectance=dr, specular_reflectance=sr)
    if t in ("conductor", "roughconductor"):
        if "eta" in spec:
            eta = np.asarray(spec["eta"], np.float32)
            k = np.asarray(spec.get("k", 1.0), np.float32)
        else:
            eta, k = (np.asarray(x, np.float32)
                      for x in _CONDUCTOR_PRESETS[spec.get("material", "none")])
        if eta.ndim == 1 and eta.shape[0] == 3 and current_variant().n_channels != 3:
            eta, k = eta.mean(keepdims=True), k.mean(keepdims=True)
        eta, k = torch.from_numpy(eta).to(device), torch.from_numpy(k).to(device)
        sr, _ = parse_texture(spec.get("specular_reflectance", 1.0), device)
        if t == "conductor":
            return B.SmoothConductorBSDF(eta=eta, k=k, specular_reflectance=sr)
        alpha = float(spec.get("alpha", 0.1))
        # as in the JAX package, <name>.alpha is alpha_u alone
        paths.append((f"{name}.alpha", ("alpha_u",)))
        return B.RoughConductorBSDF(
            eta=eta, k=k, alpha_u=_scalar(spec.get("alpha_u", alpha), device),
            alpha_v=_scalar(spec.get("alpha_v", alpha), device), specular_reflectance=sr)
    # the dielectrics
    sr, _ = parse_texture(spec.get("specular_reflectance", 1.0), device)
    st, _ = parse_texture(spec.get("specular_transmittance", 1.0), device)
    if t == "roughdielectric":
        eta = float(spec["eta"]) if "eta" in spec else _iors(spec, 1.5046)
        alpha = spec.get("alpha", 0.1)
        if isinstance(alpha, dict):
            alpha = float(alpha.get("value", 0.1))
        paths.append((f"{name}.eta", ("eta",)))
        paths.append((f"{name}.alpha.value", ("alpha",)))
        return B.RoughDielectricBSDF(eta=_scalar(eta, device), alpha=_scalar(alpha, device),
                                     specular_reflectance=sr, specular_transmittance=st)
    cls = B.SmoothDielectricBSDF if t == "dielectric" else B.ThinDielectricBSDF
    return cls(eta=_scalar(_iors(spec, 1.5046), device), specular_reflectance=sr,
               specular_transmittance=st)


def parse_sensor(spec, device):
    t = spec["type"]
    if t not in SENSOR_TYPES:
        raise _not_ported(f"sensor type {t!r}")
    film_spec = spec.get("film", {})
    if film_spec.get("type", "hdrfilm") not in ("hdrfilm", "specfilm"):
        raise _not_ported(f"film type {film_spec.get('type')!r}")
    if any(k in film_spec for k in FILM_KEYS_NOT_PORTED):
        raise _not_ported("a film crop window")
    w = int(film_spec.get("width", 768))
    h = int(film_spec.get("height", 576))
    rfilter = film_spec.get("rfilter", {"type": "gaussian"})
    srfs = ()
    if film_spec.get("type") == "specfilm":
        # the nested spectra are the channels' sensor response functions
        srfs = tuple(parse_texture(v, device)[0] for v in film_spec.values()
                     if isinstance(v, dict)
                     and v.get("type") in ("regular", "irregular", "uniform", "d65"))
        if not srfs:
            raise ValueError("specfilm needs at least one nested spectrum (SRF)")
    film = Film(width=w, height=h,
                rfilter=rfilter["type"] if isinstance(rfilter, dict) else str(rfilter),
                srfs=srfs, srf_norms=srf_norms(srfs, device))
    sampler_spec = spec.get("sampler", {})
    if sampler_spec.get("type", "independent") != "independent":
        raise _not_ported(f"sampler type {sampler_spec.get('type')!r}")
    spp = int(sampler_spec.get("sample_count", 16))
    to_world = build_transform(spec.get("to_world", Transform.identity()))
    aspect = w / h
    to_world_m = torch.from_numpy(np.asarray(to_world.m, np.float32)).to(device)
    if t == "radiancemeter":
        wl = float(spec.get("wavelength", -1.0))
        return RadiancemeterSensor(
            to_world_m=to_world_m, aspect=aspect,
            wavelength=torch.tensor(wl, dtype=torch.float32, device=device)), film, spp
    fov = float(spec.get("fov", 45.0))
    fov_axis = spec.get("fov_axis", "x")
    tan_half = np.tan(np.deg2rad(fov) / 2)
    # the stored fov is along x; tan_y = tan_x / aspect
    if fov_axis == "y" or (fov_axis == "smaller" and aspect >= 1.0) or (
        fov_axis == "larger" and aspect < 1.0
    ):
        tan_half = tan_half * aspect
    cam = PerspectiveCamera(
        to_world_m=to_world_m,
        tan_half_fov_x=torch.tensor(float(tan_half), dtype=torch.float32, device=device),
        aspect=aspect,
    )
    return cam, film, spp


INTEGRATOR_TYPES = ("path", "prb", "prb_basic", "volpath", "volpathmis", "prbvolpath",
                    "prb_unpolarized", "prb_polarized", "volpathaos", "prb_volpathaos", "ptracer",
                    "direct_projective", "prb_projective")


def load_dict(d, device=None, intersector="smem"):
    """Build a Scene from a reference-style nested dict, on `device` (the
    card unless the caller names another).

    `intersector` picks the closest-hit kernel of a triangle-table scene:
    "smem" (K1, the default, as in the JAX package) or "mma" (K3, every
    determinant from one matrix product on the tensor cores). This is the
    JAX package's MI_TPU_MXU_INTERSECT switch made an explicit argument,
    not a new feature; "mma" on a scene above MAX_MXU_TRIS (512) triangles,
    or one that takes the BVH path, raises ValueError."""
    from ..integrators import make_integrator

    device = resolve_device(device)
    d = dict(d)
    if d.pop("type", "scene") != "scene":
        raise ValueError("the root of a scene dict must have type 'scene'")
    fuse_point_lights = d.pop("fuse_point_lights", None)   # None: fuse more than four

    named_bsdfs = {}      # id -> index
    bsdf_list = []
    sensor = film = None
    spp = 16
    integrator_spec = {"type": "path"}
    tri_meshes = []
    shape_records = []    # per shape: dict(name, bsdf, emitter, interior, exterior)
    emitter_specs = []    # (shape index, emitter spec, shape name)
    env_specs = []        # (name, spec) of top-level emitters
    media_list = []
    media_names = {}      # id -> medium index
    phase_list = []
    param_paths = []      # (key, full path tuple)

    def register_bsdf(spec, name):
        local_paths = []
        inst = parse_bsdf(spec, name, local_paths, device)
        idx = len(bsdf_list)
        bsdf_list.append(inst)
        for key, sub in local_paths:
            param_paths.append((key, ("bsdfs", idx) + sub))
        return idx

    def resolve_bsdf(spec, shape_name):
        if spec is None:
            return register_bsdf({"type": "diffuse"}, f"{shape_name}.bsdf")
        if spec.get("type") == "ref":
            if spec["id"] not in named_bsdfs:
                raise ValueError(f"unresolved bsdf ref {spec['id']!r}")
            return named_bsdfs[spec["id"]]
        return register_bsdf(spec, f"{shape_name}.bsdf")

    def register_medium(spec, name):
        idx = len(media_list)
        media_list.append(parse_medium(spec, name, phase_list, param_paths, idx, device))
        return idx

    def resolve_medium(spec, owner_name):
        """A shape's interior or exterior: a ref to a named medium (-1 if
        none has that name, as in the reference), an inline medium dict, or
        None (-1, vacuum)."""
        if spec is None:
            return -1
        if spec.get("type") == "ref":
            return media_names.get(spec["id"], -1)
        return register_medium(spec, owner_name)

    # pass 1: named top-level BSDFs, so that refs resolve
    for name, spec in d.items():
        if isinstance(spec, dict) and spec.get("type") in ALL_BSDF_TYPES:
            named_bsdfs[name] = register_bsdf(spec, name)

    # pass 2: named top-level media, which shapes may refer to
    for name, spec in d.items():
        if isinstance(spec, dict) and spec.get("type") in MEDIUM_TYPES:
            media_names[name] = register_medium(spec, name)

    # pass 3: everything else
    for name, spec in d.items():
        if not isinstance(spec, dict):
            continue
        t = spec.get("type")
        if t in ALL_BSDF_TYPES or t in MEDIUM_TYPES:
            continue
        if name == "integrator" or t in INTEGRATOR_TYPES:
            integrator_spec = spec
        elif t in SENSOR_TYPES:
            sensor, film, spp = parse_sensor(spec, device)
        elif t in EMITTER_TYPES:
            if t not in ("constant", "directional", "point"):
                raise _not_ported(f"emitter type {t!r}")
            env_specs.append((name, spec))
        elif t in SHAPE_TYPES:
            to_world = build_transform(spec.get("to_world", Transform.identity()))
            if t == "rectangle":
                m = SH.make_rectangle(to_world)
            elif t == "cube":
                m = SH.make_cube(to_world)
            elif t in ("obj", "ply"):
                m = load_mesh_file(t, spec["filename"], to_world)
            else:
                m = raw_mesh(spec, to_world)
            m["shape_index"] = len(shape_records)
            tri_meshes.append(m)
            if "emitter" in spec:
                emitter_specs.append((len(shape_records), spec["emitter"], name))
            shape_records.append({
                "name": name, "bsdf": resolve_bsdf(spec.get("bsdf"), name), "emitter": -1,
                "interior": resolve_medium(spec.get("interior"), f"{name}.interior_medium"),
                "exterior": resolve_medium(spec.get("exterior"), f"{name}.exterior_medium"),
            })
        else:
            raise _not_ported(f"scene entry {name!r} of plugin type {t!r}")

    if sensor is None:
        raise _not_ported("a scene without a perspective or radiancemeter sensor")

    geometry = SH.build_geometry(tri_meshes, device, intersector)
    for mesh, (v_start, v_count) in zip(tri_meshes, geometry.mesh_vertex_slices):
        sname = shape_records[mesh["shape_index"]]["name"]
        param_paths.append(
            (f"{sname}.vertex_positions",
             ("geometry", "vertices", ("slice", v_start, v_start + v_count)))
        )

    # the bounding box of the real triangles and its sphere's radius
    real = geometry.tri_shape.cpu().numpy() >= 0
    if real.any():
        v0 = geometry.tri_v0.detach().cpu().numpy()
        pts = np.concatenate([v0, v0 + geometry.tri_e1.detach().cpu().numpy(),
                              v0 + geometry.tri_e2.detach().cpu().numpy()], 0)
        pts = pts[np.concatenate([real] * 3)]
        bbox_min, bbox_max = pts.min(0), pts.max(0)
    else:
        bbox_min, bbox_max = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)
    radius = 0.5 * float(np.linalg.norm(bbox_max - bbox_min)) or 1.0

    emitters = []
    for shape_index, em_spec, shape_name in emitter_specs:
        if em_spec.get("type") != "area":
            raise _not_ported(f"emitter type {em_spec.get('type')!r}")
        tex, leaf = parse_texture(em_spec.get("radiance", 1.0), device, emissive=True)
        e_idx = len(emitters)
        emitters.append(AreaEmitter.attach(tex, shape_index, geometry))
        param_paths.append(
            (f"{shape_name}.emitter.radiance.{leaf}", ("emitters", e_idx, "radiance", leaf))
        )
        shape_records[shape_index]["emitter"] = e_idx
    env_emitter = -1
    scene_radius = torch.tensor(radius, dtype=torch.float32, device=device)
    env_specs = _fuse_point_lights(env_specs, fuse_point_lights, emitters, param_paths, device)
    for name, spec in env_specs:
        e_idx = len(emitters)
        if spec["type"] == "point":
            tex, leaf = parse_texture(spec.get("intensity", 1.0), device, emissive=True)
            emitters.append(PointEmitter(intensity=tex, position=_point_position(spec, device)))
            param_paths.append((f"{name}.intensity.{leaf}", ("emitters", e_idx, "intensity", leaf)))
            continue
        if spec["type"] == "directional":
            tex, leaf = parse_texture(spec.get("irradiance", 1.0), device, emissive=True)
            dirn = np.asarray(spec.get("direction", [0, 0, -1]), np.float32)
            emitters.append(DirectionalEmitter(
                irradiance=tex, scene_radius=scene_radius,
                direction=torch.from_numpy(dirn / np.linalg.norm(dirn)).to(device)))
            param_paths.append((f"{name}.irradiance.{leaf}", ("emitters", e_idx, "irradiance", leaf)))
            continue
        tex, leaf = parse_texture(spec.get("radiance", 1.0), device, emissive=True)
        env_emitter = e_idx
        emitters.append(ConstantEmitter(radiance=tex, scene_radius=scene_radius))
        param_paths.append((f"{name}.radiance.{leaf}", ("emitters", e_idx, "radiance", leaf)))

    if not bsdf_list:
        bsdf_list.append(B.DiffuseBSDF(reflectance=parse_texture(0.5, device)[0]))
    n_shapes = max(len(shape_records), 1)
    shape_bsdf = np.zeros(n_shapes, np.int64)
    shape_emitter = np.full(n_shapes, -1, np.int64)
    shape_int_med = np.full(n_shapes, -1, np.int64)
    shape_ext_med = np.full(n_shapes, -1, np.int64)
    for i, rec in enumerate(shape_records):
        shape_bsdf[i] = rec["bsdf"]
        shape_emitter[i] = rec["emitter"]
        shape_int_med[i] = rec["interior"]
        shape_ext_med[i] = rec["exterior"]

    def dev(x, dtype=None):
        return torch.from_numpy(np.asarray(x, dtype)).to(device)

    var = current_variant()
    return Scene(
        geometry=geometry,
        bsdfs=tuple(bsdf_list),
        emitters=tuple(emitters),
        sensors=(sensor,),
        integrator=make_integrator(integrator_spec),
        film=film,
        shape_bsdf=dev(shape_bsdf),
        shape_emitter=dev(shape_emitter),
        spp=spp,
        device=device,
        param_paths=tuple(param_paths),
        media=tuple(media_list),
        phases=tuple(phase_list),
        shape_interior_medium=dev(shape_int_med),
        shape_exterior_medium=dev(shape_ext_med),
        bbox_min=dev(bbox_min, np.float32),
        bbox_max=dev(bbox_max, np.float32),
        medium_phase=dev([m.phase_index for m in media_list], np.int64),
        env_emitter=env_emitter,
        n_channels=var.n_channels,
        polarized=var.polarized,
    )


def _point_position(spec, device):
    """A point light's position: the translation of its to_world, else
    `position` (the origin by default)."""
    p = spec.get("position", [0, 0, 0])
    if "to_world" in spec:
        p = np.asarray(build_transform(spec["to_world"]).m)[:3, 3]
    return torch.from_numpy(np.asarray(p, np.float32)).to(device)


def _bakeable_intensity(spec):
    """The rgb intensity [3] of a point light with a constant one, else
    None."""
    i = spec.get("intensity", 1.0)
    if isinstance(i, (int, float)):
        return [float(i)] * 3
    if isinstance(i, (list, tuple)) and len(i) in (1, 3):
        v = [float(x) for x in i]
        return v * 3 if len(v) == 1 else v
    if isinstance(i, dict) and i.get("type") in ("rgb", "uniform"):
        v = i.get("value", 1.0)
        return [float(v)] * 3 if isinstance(v, (int, float)) else [float(x) for x in v]
    return None


def _fuse_point_lights(env_specs, fuse, emitters, param_paths, device):
    """Append one PointEmitterArray of the point lights with a constant
    intensity to `emitters` when there are more than four of them (or any,
    when `fuse` is True; none when it is False), as the JAX package's
    loader does; returns the entries left to load one by one."""
    group = [(name, spec, _bakeable_intensity(spec)) for name, spec in env_specs
             if spec["type"] == "point" and _bakeable_intensity(spec) is not None]
    if not (len(group) > 4 if fuse is None else (fuse and group)):
        return env_specs
    names = {name for name, _, _ in group}
    e_idx = len(emitters)
    emitters.append(PointEmitterArray(
        values=torch.from_numpy(np.asarray([v for _, _, v in group], np.float32)).to(device),
        positions=torch.stack([_point_position(spec, device) for _, spec, _ in group])))
    param_paths.append(("point_lights.values", ("emitters", e_idx, "values")))
    return [(name, spec) for name, spec in env_specs if name not in names]


def cornell_box():
    """The canonical Cornell box scene dict (mirrors mi.cornell_box)."""
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 8},
        "sensor": {
            "type": "perspective",
            "fov_axis": "smaller",
            "near_clip": 0.001,
            "far_clip": 100.0,
            "focus_distance": 1000,
            "fov": 39.3077,
            "to_world": [
                {"type": "look_at", "origin": [0, 0, 3.90], "target": [0, 0, 0], "up": [0, 1, 0]}
            ],
            "sampler": {"type": "independent", "sample_count": 64},
            "film": {
                "type": "hdrfilm",
                "width": 256,
                "height": 256,
                "rfilter": {"type": "gaussian"},
                "pixel_format": "rgb",
                "component_format": "float32",
            },
        },
        "white": {"type": "diffuse", "reflectance": {"type": "rgb", "value": [0.885809, 0.698859, 0.666422]}},
        "green": {"type": "diffuse", "reflectance": {"type": "rgb", "value": [0.105421, 0.37798, 0.076425]}},
        "red": {"type": "diffuse", "reflectance": {"type": "rgb", "value": [0.570068, 0.0430135, 0.0443706]}},
        "light": {
            "type": "rectangle",
            "to_world": [
                {"type": "scale", "value": [0.23, 0.19, 0.19]},
                {"type": "rotate", "axis": [1, 0, 0], "angle": 90},
                {"type": "translate", "value": [0.0, 0.99, 0.01]},
            ],
            "bsdf": {"type": "ref", "id": "white"},
            "emitter": {"type": "area", "radiance": {"type": "rgb", "value": [18.387, 13.9873, 6.75357]}},
        },
        "floor": {
            "type": "rectangle",
            "to_world": [
                {"type": "rotate", "axis": [1, 0, 0], "angle": -90},
                {"type": "translate", "value": [0.0, -1.0, 0.0]},
            ],
            "bsdf": {"type": "ref", "id": "white"},
        },
        "ceiling": {
            "type": "rectangle",
            "to_world": [
                {"type": "rotate", "axis": [1, 0, 0], "angle": 90},
                {"type": "translate", "value": [0.0, 1.0, 0.0]},
            ],
            "bsdf": {"type": "ref", "id": "white"},
        },
        "back": {
            "type": "rectangle",
            "to_world": [{"type": "translate", "value": [0.0, 0.0, -1.0]}],
            "bsdf": {"type": "ref", "id": "white"},
        },
        "green-wall": {
            "type": "rectangle",
            "to_world": [
                {"type": "rotate", "axis": [0, 1, 0], "angle": -90},
                {"type": "translate", "value": [1.0, 0.0, 0.0]},
            ],
            "bsdf": {"type": "ref", "id": "green"},
        },
        "red-wall": {
            "type": "rectangle",
            "to_world": [
                {"type": "rotate", "axis": [0, 1, 0], "angle": 90},
                {"type": "translate", "value": [-1.0, 0.0, 0.0]},
            ],
            "bsdf": {"type": "ref", "id": "red"},
        },
        "small-box": {
            "type": "cube",
            "to_world": [
                {"type": "scale", "value": 0.3},
                {"type": "rotate", "axis": [0, 1, 0], "angle": -17},
                {"type": "translate", "value": [0.335, -0.7, 0.38]},
            ],
            "bsdf": {"type": "ref", "id": "white"},
        },
        "large-box": {
            "type": "cube",
            "to_world": [
                {"type": "scale", "value": [0.3, 0.61, 0.3]},
                {"type": "rotate", "axis": [0, 1, 0], "angle": 18.25},
                {"type": "translate", "value": [-0.33, -0.4, -0.28]},
            ],
            "bsdf": {"type": "ref", "id": "white"},
        },
    }


def materials_scene(res=256, spp=64, integrator=None):
    """The Cornell box in other materials: the large box a rough conductor
    (gold, alpha 0.2), the small box smooth glass (bk7), the back wall a
    two-sided rough plastic (diffuse reflectance 0.6, alpha 0.1), the
    floor a blend of the white diffuse (0.7) and smooth silver (0.3), the
    green wall a mask of opacity 0.8 over the green diffuse; a res x res
    film at spp, `integrator` (a spec dict) or the cbox's path tracer."""
    d = cornell_box()
    film = d["sensor"]["film"]
    film["width"] = film["height"] = res
    d["sensor"]["sampler"]["sample_count"] = spp
    d["large-box"]["bsdf"] = {"type": "roughconductor", "material": "Au", "alpha": 0.2}
    d["small-box"]["bsdf"] = {"type": "dielectric", "int_ior": "bk7"}
    d["back"]["bsdf"] = {"type": "twosided", "bsdf": {
        "type": "roughplastic", "diffuse_reflectance": 0.6, "alpha": 0.1}}
    d["floor"]["bsdf"] = {"type": "blendbsdf", "weight": 0.3,
                          "diffuse": dict(d["white"]),
                          "metal": {"type": "conductor", "material": "Ag"}}
    d["green-wall"]["bsdf"] = {"type": "mask", "opacity": 0.8, "bsdf": dict(d["green"])}
    if integrator is not None:
        d["integrator"] = integrator
    return d


def polarimeter_scene(res=256, spp=64, integrator=None):
    """What a polarization camera sees of materials_scene with a polarized
    plastic back wall (diffuse reflectance 0.3, alpha 0.08) and a smooth
    gold large box, through two filter sheets at z = 2.5 between the camera
    (z = 3.9) and the box, each covering half the view: a linear polarizer
    (theta 30 degrees) over x in [-1, 0] and a quarter-wave retarder (theta
    45 degrees) over x in [0, 1]. For the polarized variants; by default
    the stokes integrator over volpath at max_depth 8."""
    d = materials_scene(res, spp)
    d["back"]["bsdf"] = {"type": "pplastic", "diffuse_reflectance": 0.3, "alpha": 0.08}
    d["large-box"]["bsdf"] = {"type": "conductor", "material": "Au"}
    for name, x, bsdf in (("polarizer-sheet", -0.5, {"type": "polarizer", "theta": 30.0}),
                          ("retarder-sheet", 0.5, {"type": "retarder", "theta": 45.0})):
        d[name] = {"type": "rectangle", "bsdf": bsdf,
                   "to_world": [{"type": "scale", "value": [0.5, 1, 1]},
                                {"type": "translate", "value": [x, 0, 2.5]}]}
    d["integrator"] = integrator or {"type": "stokes",
                                     "integrator": {"type": "volpath", "max_depth": 8}}
    return d


def spherified_cube(k=130):
    """(v0, e1, e2) [12 k^2, 3] float32 of a sphere tessellated as a
    spherified cube (a copy of the JAX package's scripts/bench_bvh.py)."""
    verts, faces = [], []
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            base = len(verts)
            for i in range(k + 1):
                for j in range(k + 1):
                    uv = [-1 + 2 * i / k, -1 + 2 * j / k]
                    p = [0.0, 0.0, 0.0]
                    p[axis] = sgn
                    p[(axis + 1) % 3] = uv[0]
                    p[(axis + 2) % 3] = uv[1]
                    p = np.asarray(p)
                    verts.append(p / np.linalg.norm(p))
                    if i < k and j < k:
                        a = base + i * (k + 1) + j
                        b, c, d = a + 1, a + (k + 1), a + (k + 1) + 1
                        faces.append([a, b, d])
                        faces.append([a, d, c])
    V = np.asarray(verts, np.float32)
    F = np.asarray(faces, np.int32)
    v0 = V[F[:, 0]]
    return v0, V[F[:, 1]] - v0, V[F[:, 2]] - v0


def mesh_scene(obj_path, k=130, res=256):
    """The large-mesh scene of the JAX package's scripts/bench_mesh.py: the
    Cornell box without its small box, holding a spherified-cube sphere of
    12 k^2 triangles (202,800 at k=130), written as an OBJ file at
    `obj_path`, scaled by 0.35 and moved to (0.2, -0.1, 0.2). Returns the
    scene dict; the film is res x res."""
    v0, e1, e2 = spherified_cube(k)
    verts = np.concatenate([v0, v0 + e1, v0 + e2], axis=0) * 0.35
    n = v0.shape[0]
    faces = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], -1)
    with open(obj_path, "w") as f:
        for p in verts:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for a, b, c in faces + 1:
            f.write(f"f {a} {b} {c}\n")
    d = cornell_box()
    d["sensor"]["film"]["width"] = res
    d["sensor"]["film"]["height"] = res
    del d["small-box"]
    d["mesh"] = {
        "type": "obj",
        "filename": str(obj_path),
        "to_world": {"type": "translate", "value": [0.2, -0.1, 0.2]},
        "bsdf": {"type": "diffuse", "reflectance": {"type": "rgb", "value": [0.6, 0.55, 0.5]}},
    }
    return d


def het_vol_scene(res=96, spp=16, max_depth=12, steps=16, regenerate=False):
    """bench.py's heterogeneous-medium scene (BASELINE config 3, the
    het_vol_fwd_mrays cell): a 32^3 grid of sigma_t in [0.3, 2.5) made from
    numpy's default_rng(3), albedo 0.9 and an HG phase (g 0.5), inside a
    null cube of half-size 1.2 under a constant white environment; volpath
    with `steps` delta-tracking and NEE ratio-tracking steps, a box filter."""
    grid = (0.3 + 2.2 * np.random.default_rng(3).random((32, 32, 32, 1))).astype(np.float32)
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": max_depth, "track_steps": steps,
                       "nee_steps": steps, "regenerate": regenerate},
        "sensor": _vol_sensor(res, spp),
        "light": {"type": "constant", "radiance": {"type": "rgb", "value": [1.0, 1.0, 1.0]}},
        "cloud": {
            "type": "cube",
            "to_world": [{"type": "scale", "value": [1.2, 1.2, 1.2]}],
            "bsdf": {"type": "null"},
            "interior": {
                "type": "heterogeneous",
                "sigma_t": {"type": "gridvolume", "data": grid,
                            "bbox_min": [-1, -1, -1], "bbox_max": [1, 1, 1]},
                "albedo": 0.9,
                "phase": {"type": "hg", "g": 0.5},
            },
        },
    }


def vol32_scene(res=128, spp=16, max_depth=32, steps=16, regenerate=False):
    """bench.py's deep-volume scene (the vol32_regen_speedup cell): a
    homogeneous slab (sigma_t 4, albedo 0.95, HG g 0.6) in the same null
    cube and environment as het_vol_scene, volpath at max_depth 32."""
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": max_depth, "track_steps": steps,
                       "nee_steps": steps, "regenerate": regenerate},
        "sensor": _vol_sensor(res, spp),
        "light": {"type": "constant", "radiance": {"type": "rgb", "value": [1.0, 1.0, 1.0]}},
        "slab": {
            "type": "cube",
            "to_world": [{"type": "scale", "value": [1.2, 1.2, 1.2]}],
            "bsdf": {"type": "null"},
            "interior": {
                "type": "homogeneous",
                "sigma_t": [4.0, 4.0, 4.0],
                "albedo": [0.95, 0.95, 0.95],
                "phase": {"type": "hg", "g": 0.6},
            },
        },
    }


def _vol_sensor(res, spp):
    return {
        "type": "perspective", "fov": 45,
        "to_world": [{"type": "look_at", "origin": [0, 0, 4], "target": [0, 0, 0],
                      "up": [0, 1, 0]}],
        "film": {"type": "hdrfilm", "width": res, "height": res, "rfilter": {"type": "box"}},
        "sampler": {"type": "independent", "sample_count": spp},
    }


def atmo_scene(res=64, spp=64, max_depth=8):
    """bench.py's polarized atmosphere (BASELINE config 4, the
    atmo_msamples cell), for the mono_polarized variant: a directional sun
    (irradiance 10, propagating along (0.3, 0, -1)) over a null slab (a cube
    scaled 50 x 50 x 1) holding a homogeneous medium (sigma_t 0.1, albedo
    0.95) whose phase blends Rayleigh (depolarization 0.03, weight 0.6) with
    a Mie aerosol (550 nm, n 1.33, gamma size distribution a 600 nm, b 0.3,
    radii 200-1500 nm over 24 Gauss points, baked on 128 cosines); a
    radiancemeter at (-60, 0, 0) looking along +x, pinned to 550 nm, with a
    res x res box film; volpath at max_depth."""
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": max_depth},
        "sun": {"type": "directional", "direction": [0.3, 0, -1], "irradiance": 10.0},
        "slab": {
            "type": "cube",
            "to_world": [{"type": "scale", "value": [50.0, 50.0, 1.0]}],
            "bsdf": {"type": "null"},
            "interior": {"type": "ref", "id": "atmo"},
        },
        "atmo": {
            "type": "homogeneous", "sigma_t": 0.1, "albedo": 0.95,
            "phase": {
                "type": "blendphase", "weight": 0.4,
                "rayleigh_part": {"type": "rayleigh", "depolarization": 0.03},
                "aerosol": {
                    "type": "mie", "wavelength": 550.0, "ior_sph": 1.33,
                    "size_distr": {
                        "type": "gamma", "a": 600.0, "b": 0.3,
                        "min_radius": 200.0, "max_radius": 1500.0,
                        "gauss_points": 24,
                    },
                    "bake_nodes": 128,
                },
            },
        },
        "sensor": {
            "type": "radiancemeter", "wavelength": 550.0,
            "to_world": [{"type": "look_at", "origin": [-60.0, 0.0, 0.0],
                          "target": [1, 0, 0], "up": [0, 0, 1]}],
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp},
        },
    }


def aos_scene(res=32, max_depth=4, integrator="prb_volpathaos"):
    """bench.py's atmosphere-ocean retrieval scene (BASELINE config 5, the
    aos cell), for the mono_polarized variant: a rough-dielectric ocean
    surface (int_ior 1.33, ext_ior 1, alpha 0.2) over a diffuse sea floor
    (reflectance 0.5) 2 below, a directional sun (irradiance 5, propagating
    along (-0.3, 0, -0.954)), a Rayleigh atmosphere (sigma_t 0.2, albedo
    0.8) in a null slab 0.8 thick centred at z = 1, and a radiancemeter at
    (0, 0, 4) looking down with a res x res box film; `integrator`
    (bench.py: prb_volpathaos) at max_depth. bench.py renders it with
    render_1 at 64 spp and differentiates the sum for the atmosphere's
    sigma_t."""
    return {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": max_depth},
        "ocean_surface": {
            "type": "rectangle",
            "to_world": [{"type": "scale", "value": [1000.0, 1000.0, 1.0]}],
            "bsdf": {"type": "roughdielectric", "int_ior": 1.33, "ext_ior": 1.0, "alpha": 0.2},
        },
        "sea_floor": {
            "type": "rectangle",
            "to_world": [
                {"type": "scale", "value": [1000.0, 1000.0, 1.0]},
                {"type": "translate", "value": [0.0, 0.0, -2.0]},
            ],
            "bsdf": {"type": "diffuse", "reflectance": 0.5},
        },
        "sun": {"type": "directional", "direction": [-0.3, 0, -0.954], "irradiance": 5.0},
        "atmo_medium": {"type": "homogeneous", "phase": {"type": "rayleigh"},
                        "albedo": 0.8, "sigma_t": 0.2},
        "atmo": {
            "type": "cube", "bsdf": {"type": "null"},
            "to_world": [
                {"type": "scale", "value": [1000.0, 1000.0, 0.4]},
                {"type": "translate", "value": [0.0, 0.0, 1.0]},
            ],
            "interior": {"type": "ref", "id": "atmo_medium"},
        },
        "sensor": {
            "type": "radiancemeter",
            "to_world": [{"type": "look_at", "origin": [0, 0, 4], "target": [0, 0, 0],
                          "up": [0, 1, 0]}],
            "film": {"type": "hdrfilm", "rfilter": {"type": "box"}, "width": res, "height": res},
        },
    }
