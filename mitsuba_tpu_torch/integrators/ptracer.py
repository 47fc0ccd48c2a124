"""Adjoint particle tracer: light paths splatted onto the sensor
(counterpart of mitsuba_tpu/integrators/ptracer.py).

N particles start on the emitters, bounce through the scene with the same
struct-of-arrays bounce loop as the path tracer, and at every vertex
connect to the pinhole camera: a scatter into the film. The JAX package's
``segment_sum`` over pixel ids is ``index_add_`` on a flat film here; on
the card that is atomics, so the order of a pixel's sums is not fixed and
the image is the same up to the rounding of those sums.

Camera-connection weight for a pinhole perspective sensor: a vertex at p
with path weight alpha contributes to the pixel holding its projection

    V_j += alpha * f(w_i -> w_cam) * visibility / (d^2 * A_pix * cos^3 theta)

with f the BSDF value toward the camera (cosine included), theta the
angle to the camera's axis and A_pix the pixel's footprint on the z = 1
image plane. The particle weights divide by the emitters' position and
direction pdfs; area lights emit cosine-weighted, point lights uniformly
over the sphere, a fused group of area lights (AreaEmitterArray) from its
power-weighted triangle cdf, a collimated panel (DirectionalAreaEmitter)
exactly along its normal; the environments, the sun and the sphere lights
emit no particles (as in the JAX package: the environment's and the
sun's light reaches the camera through the surfaces the particles hit).
A spot light emits as a point light of its intensity, as in the JAX
package; a projector's particles are not yet ported. Each particle draws 3 next_2d at its start and 2 a
bounce, in the JAX package's order, so every lane takes its numbers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import warp
from ..core.frame import coordinate_system, dot, normalize
from ..render.emitters import AreaEmitterArray, ProjectorEmitter
from ..render.records import Ray, spawn_ray


def _sample_emitter_ray(scene, u_sel, u_pos, u_dir, wavelengths=None):
    """Each particle's start: (position [N, 3], direction, the emitter's
    normal there (the direction for a point light), weight [N, C], and for
    the depth-0 emitter-to-camera connection the radiance at the start and
    1 / pdf of its position (0 for a point light)), with the uniform
    emitter selection's factor."""
    n, nc, dev = u_sel.shape[0], scene.n_channels, u_sel.device
    E = scene.n_emitters
    sel = torch.clamp((u_sel * E).to(torch.int32), 0, max(E - 1, 0))
    z = torch.zeros(n, 3, dtype=torch.float32, device=dev)
    z[:, 2] = 1.0
    p, d, n_emit = torch.zeros_like(z), z, z
    weight = torch.zeros(n, nc, dtype=torch.float32, device=dev)
    rad0 = torch.zeros_like(weight)
    inv_ppos = torch.zeros(n, dtype=torch.float32, device=dev)
    geom = scene.geometry
    for i, em in enumerate(scene.emitters):
        m = sel == i
        m3 = m[..., None]
        if isinstance(em, AreaEmitterArray):    # fused area lights
            p_i, ng, light, p_area = em.sample_point(u_pos, geom)
            p_area = torch.clamp(p_area, min=1e-20)
            rad = em._rows(light, nc, wavelengths)
            local = warp.square_to_cosine_hemisphere(u_dir)
            s_ax, t_ax = coordinate_system(ng)
            d_i = local[..., 0:1] * s_ax + local[..., 1:2] * t_ax + local[..., 2:3] * ng
            p = torch.where(m3, p_i, p)
            d = torch.where(m3, d_i, d)
            n_emit = torch.where(m3, ng, n_emit)
            # Le pi / pdf_pos (the cosine direction pdf cancels cos / pi)
            weight = torch.where(m3, rad * (math.pi / p_area)[..., None], weight)
            rad0 = torch.where(m3, rad, rad0)
            inv_ppos = torch.where(m, 1.0 / p_area, inv_ppos)
        elif hasattr(em, "tri_index"):          # area light
            scaled = u_pos[..., 0] * em.total_area
            K = em.tri_cdf.shape[0]
            k = torch.clamp(torch.searchsorted(em.tri_cdf, scaled.contiguous(), right=True), 0,
                            K - 1)
            tri = em.tri_index[k]
            cdf_lo = torch.cat([torch.zeros_like(em.tri_cdf[:1]), em.tri_cdf[:-1]])
            lo = cdf_lo[k]
            seg = torch.clamp(em.tri_cdf[k] - lo, min=1e-20)
            u0r = torch.clamp((scaled - lo) / seg, 0.0, 1.0)
            bary = warp.square_to_uniform_triangle(torch.stack([u0r, u_pos[..., 1]], dim=-1))
            ng = geom.tri_ng[tri]
            p_i = geom.tri_v0[tri] + bary[..., 0:1] * geom.tri_e1[tri] \
                + bary[..., 1:2] * geom.tri_e2[tri]
            rad = em.radiance.eval(bary, nc, wavelengths)
            p = torch.where(m3, p_i, p)
            n_emit = torch.where(m3, ng, n_emit)
            if getattr(em, "is_directional_area", False):
                # a collimated panel emits along its normal: Le * A, and no
                # depth-0 connection
                d = torch.where(m3, ng, d)
                weight = torch.where(m3, rad * em.total_area, weight)
                continue
            # cosine-weighted emission around the normal: Le * A * pi
            local = warp.square_to_cosine_hemisphere(u_dir)
            s_ax, t_ax = coordinate_system(ng)
            d_i = local[..., 0:1] * s_ax + local[..., 1:2] * t_ax + local[..., 2:3] * ng
            d = torch.where(m3, d_i, d)
            weight = torch.where(m3, rad * (em.total_area * math.pi), weight)
            rad0 = torch.where(m3, rad, rad0)
            inv_ppos = torch.where(m, em.total_area, inv_ppos)
        elif isinstance(em, ProjectorEmitter):
            raise NotImplementedError("particles from a projector are not yet ported")
        elif hasattr(em, "position"):           # point light (a spot: its intensity)
            d_i = warp.square_to_uniform_sphere(u_dir)
            inten = em.intensity.eval(torch.zeros(n, 2, dtype=torch.float32, device=dev), nc,
                                      wavelengths)
            p = torch.where(m3, em.position.expand(n, 3), p)
            d = torch.where(m3, d_i, d)
            n_emit = torch.where(m3, d_i, n_emit)
            weight = torch.where(m3, inten * (4.0 * math.pi), weight)
    return p, d, n_emit, weight * E, rad0, inv_ppos * E


def connect_to_camera(film, sensor, p, f_val, active):
    """Project the vertices p onto the film: (pixel id [N] int64, the
    contribution [N, C] (0 where not `valid`), valid). f_val is the BSDF or
    emission value toward the camera, cosine included."""
    cam_o = sensor.to_world_m[:3, 3]
    R = sensor.to_world_m[:3, :3]
    to_cam = cam_o - p
    dist2 = dot(to_cam, to_cam)
    # the vertex in the camera's frame: (p - cam_o) @ R, written out
    q = p - cam_o
    v_cam = q[..., 0:1] * R[0] + q[..., 1:2] * R[1] + q[..., 2:3] * R[2]
    z = v_cam[..., 2]
    in_front = z > 1e-6
    x_ndc = v_cam[..., 0] / torch.clamp(z, min=1e-6)
    y_ndc = v_cam[..., 1] / torch.clamp(z, min=1e-6)
    tx = sensor.tan_half_fov_x
    ty = tx / sensor.aspect
    u = 0.5 * (1.0 - x_ndc / tx)
    v = 0.5 * (1.0 - y_ndc / ty)
    on_film = (u >= 0) & (u < 1) & (v >= 0) & (v < 1) & in_front
    px = torch.clamp((u * film.width).to(torch.int64), 0, film.width - 1)
    py = torch.clamp((v * film.height).to(torch.int64), 0, film.height - 1)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
    cos_cam = z / dist
    a_pix = (2 * tx / film.width) * (2 * ty / film.height)
    w_cam = 1.0 / torch.clamp(dist2 * a_pix * cos_cam ** 3, min=1e-12)
    valid = active & on_film
    return py * film.width + px, torch.where(valid[..., None], f_val * w_cam[..., None], 0.0), valid


def _visible(scene, p, n, cam_o, active):
    """Whether the segment from p (leaving the surface along n) to the
    camera is unoccluded, by one closest-hit query."""
    to_cam = normalize(cam_o.expand(p.shape) - p)
    dist_cam = torch.sqrt(dot(cam_o - p, cam_o - p))
    si_occ = scene.ray_intersect(spawn_ray(p, n, to_cam), active)
    return ~(si_occ.is_valid & (si_occ.t < dist_cam * (1 - 1e-3))), to_cam


@dataclass(frozen=True)
class PTracerIntegrator:
    """Forward (adjoint) particle tracer. Not a per-lane radiance sampler:
    render() routes to trace_particles when it sees is_ptracer."""

    max_depth: int = 8
    rr_depth: int = 5

    is_ptracer = True

    def trace_particles(self, scene, rng, n_particles, sensor_idx=0):
        """(the flat film's sums [H * W, C] of n_particles particles (the
        image is this / n_particles), {"n_rays": closest hits cast}). The
        bounce loop stops once no particle is alive: the draws it skips
        reach nothing."""
        film = scene.film
        sensor = scene.sensors[sensor_idx]
        cam_o = sensor.to_world_m[:3, 3]
        nc = scene.n_channels
        u_sel, u_p0, rng = rng.next_2d()
        u_p1, u_d0, rng = rng.next_2d()
        u_d1, _, rng = rng.next_2d()
        p0, d0, n_emit, alpha, rad0, inv_ppos = _sample_emitter_ray(
            scene, u_sel, torch.stack([u_p0, u_p1], dim=-1), torch.stack([u_d0, u_d1], dim=-1))
        image = torch.zeros(film.width * film.height, nc, dtype=torch.float32,
                            device=p0.device)

        # depth 0: each particle's own emission point seen by the camera
        sel_m = inv_ppos > 0
        vis, to_cam = _visible(scene, p0, n_emit, cam_o, sel_m)
        cos_e = torch.clamp(dot(n_emit, to_cam), min=0.0)
        pix, contrib, _ = connect_to_camera(film, sensor, p0, rad0 * (cos_e * inv_ppos)[..., None],
                                            sel_m & vis & (cos_e > 0))
        image.index_add_(0, pix, contrib)
        n_rays = sel_m.sum()

        ray_o, ray_d = spawn_ray(p0, n_emit, d0).o, d0
        active = torch.amax(alpha, dim=-1) > 0
        for depth in range(max(self.max_depth - 1, 1)):
            if not bool(active.any()):
                break
            u_lobe, u2x, rng = rng.next_2d()
            u2y, u_rr, rng = rng.next_2d()
            si = scene.ray_intersect(Ray.make(ray_o, ray_d), active)
            hit = active & si.is_valid

            # connect this vertex to the camera (importance transport)
            vis, to_cam = _visible(scene, si.p, si.n, cam_o, hit)
            f_cam, _ = scene.bsdf_eval_pdf(si, si.to_local(to_cam), hit)
            pix, contrib, _ = connect_to_camera(film, sensor, si.p, alpha * f_cam, hit & vis)
            image.index_add_(0, pix, contrib)
            n_rays = n_rays + active.sum() + hit.sum()

            # bounce, then Russian roulette
            bs, bw = scene.bsdf_sample(si, u_lobe, torch.stack([u2x, u2y], dim=-1), hit)
            wo_world = si.to_world(bs.wo)
            nray = spawn_ray(si.p, si.n, wo_world)
            alpha = torch.where(hit[..., None], alpha * bw, alpha)
            alive = hit & (bs.pdf > 0) & (torch.amax(alpha, dim=-1) > 0)
            if depth + 1 >= self.rr_depth:
                q = torch.clamp(torch.amax(alpha, dim=-1), max=0.95)
                alpha = torch.where(alive[..., None], alpha / torch.clamp(q, min=1e-6)[..., None],
                                    alpha)
                alive = alive & (u_rr < q)
            ray_o, ray_d, active = nray.o, wo_world, alive
        return image, {"n_rays": n_rays}
