"""Projective (visibility and boundary) gradients of moving meshes
(counterpart of mitsuba_tpu/ad/projective.py, its mesh parts).

The rendered image depends on a shape's vertices discontinuously where
one surface starts to hide another. Detached path sampling sees the
smooth (interior) part of the gradient only; these passes add the Dirac
part as image-space curve integrals

    dI/dtheta = oint_curves  W_pix  dL  (v_pi . n_hat)  dsigma

over (1) the silhouettes the camera sees, (2) the shadow curves of point
and directional lights (blocker edges projected from the light onto the
receivers) and (3) the jumps of the incident radiance behind a silhouette
seen from a path vertex at depth k (reflected silhouettes and the soft
shadows of area lights), with the curve velocity v_pi = d pi / d theta
from autograd through the vertex buffer and the sensor projection. Each
pass samples points on mesh edges (by length, on the edges that are
silhouettes from the viewpoint), classifies the two sides of the curve
with probe rays 0.05 pixel (or 5e-3 rad) to either side, takes the
radiance jump dL from a one-sample radiance estimate on each side, and
returns the vertex cotangent of phi(vertices) = sum k (n_hat . pi(x)),
with k the lane's detached weight: ``torch.autograd.grad`` of that sum.
The curve's tangent d pi / dt is a forward-mode derivative
(``torch.func.jvp``).

``projective_render`` is the differentiable render of the
``direct_projective`` and ``prb_projective`` integrators
(``ProjectiveIntegrator``): one ``torch.autograd.Function`` whose forward
is the primal image, and whose backward adds (a) the interior term: the
tape of the direct integrator, or the PRB node of ad/render_ad.py (whose
replay detaches geometry) plus a tape pass through ``path`` (``volpath``
in the polarized variants) for the vertex term: that tape pass runs K1's
backward (ops/intersect.py:hit_vjp) inside a render; and (b) the three
boundary passes for the vertex buffer. Every ray of every pass is a
closest-hit query through the scene's kernel (K1 on a triangle table).

In the polarized variants the primary silhouette contracts the full
sensor-frame Stokes jump with the [H, W, 4, C] adjoint; the shadow and
indirect passes contract the I channel (exact for diffuse receivers, as
in the JAX package).

Random numbers are the JAX package's: each pass keys its lanes by
(seed ^ a per-pass salt, lane), so every lane takes its numbers. The
sphere silhouettes and the shadows of spot and projector lights wait for
those plugins.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..core.frame import cross, dot
from ..core.rng import MASK32, RNG
from ..render.records import Ray, spawn_ray
from .prb import attach_scene, detach_scene, grad_leaves, vjp_into

EPS_PX = 0.05       # the primary and shadow probes' offset, in pixels
EPS_RAD = 5e-3      # the indirect probes' offset, in radians


def _norm(v):
    return torch.sqrt(dot(v, v))


def _unit(v):
    return v / torch.clamp(_norm(v), min=1e-12)[..., None]


def _lanes_rng(seed, salt, n, device):
    return RNG((int(seed) ^ salt) & MASK32, torch.arange(n, dtype=torch.int64, device=device))


# ---------------------------------------------------------------------------
# silhouette edge sampling
# ---------------------------------------------------------------------------

def silhouette_weights(geom, viewpoint=None, direction=None):
    """(weight [E], va [E, 3], vb [E, 3]): each edge's length where it is a
    silhouette seen from `viewpoint` (or along `direction`, for a distant
    light), 0 elsewhere; an open edge always is one."""
    va = geom.vertices[geom.edge_v[:, 0]]
    vb = geom.vertices[geom.edge_v[:, 1]]
    T = geom.tri_ng.shape[0]
    n0 = geom.tri_ng[torch.clamp(geom.edge_f[:, 0], 0, T - 1)]
    n1 = geom.tri_ng[torch.clamp(geom.edge_f[:, 1], 0, T - 1)]
    mid = 0.5 * (va + vb)
    to_view = -direction.expand(mid.shape) if direction is not None else viewpoint - mid
    s0 = dot(n0, to_view) > 0
    s1 = dot(n1, to_view) > 0
    sil = (geom.edge_shape >= 0) & ((geom.edge_f[:, 1] < 0) | (s0 != s1))
    return torch.where(sil, _norm(vb - va), 0.0), va, vb


def sample_silhouette_points(geom, w, u_edge, u_t):
    """Points on the edges drawn by the weights w (edge by w, then a
    uniform position t along it): (edge index, t, x, the edge vector, the
    weights' sum, the edge's length). The density over scene arc length is
    1 / sum(w)."""
    cdf = torch.cumsum(w, dim=0)
    W_total = cdf[-1]
    idx = torch.clamp(torch.searchsorted(cdf, (u_edge * W_total).contiguous(), right=True), 0,
                      w.shape[0] - 1)
    va = geom.vertices[geom.edge_v[idx, 0]]
    vb = geom.vertices[geom.edge_v[idx, 1]]
    x = (1.0 - u_t[:, None]) * va + u_t[:, None] * vb
    tan3 = vb - va
    return idx, u_t, x, tan3, W_total, _norm(tan3)


def silhouette_ends(geom, e_idx, to_view):
    """(a, b) [N]: the endpoints of the edges e_idx as vertices of the
    triangle seen at the silhouette from along to_view [N, 3] (the first
    triangle of an open edge). Of an edge's two triangles, the one seen is
    the one that hides the other: the other's centroid lies across its
    plane from the viewpoint, whichever way the normals point. On a mesh
    that splits its vertices at the edge (a flat cube, normal or uv
    seams), the edge's cotangent goes to that triangle's copies of its
    endpoints, the side of the silhouette that the probes see; where the
    vertices are shared both are the same."""
    T = geom.tri_ng.shape[0]
    f0 = torch.clamp(geom.edge_f[e_idx, 0], 0, T - 1)
    f1 = torch.clamp(geom.edge_f[e_idx, 1], 0, T - 1)
    x = geom.vertices[geom.edge_v[e_idx, 0]]
    c1 = geom.tri_v0[f1] + (geom.tri_e1[f1] + geom.tri_e2[f1]) / 3.0
    n0 = geom.tri_ng[f0]
    first_hides = dot(n0, to_view) * dot(n0, c1 - x) < 0
    second = (geom.edge_f[e_idx, 1] >= 0) & ~first_hides
    ends = geom.edge_fv[e_idx, second.to(torch.int64)]
    return ends[:, 0], ends[:, 1]


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _film_wh(film, device):
    return torch.tensor([film.width, film.height], dtype=torch.float32, device=device)


def _project_px(sensor, film, p):
    uv, ok = sensor.project(p)
    return uv * _film_wh(film, p.device), ok


def _perp(v2):
    """An image-space vector rotated by -90 degrees: (x, y) -> (y, -x)."""
    return torch.stack([v2[..., 1], -v2[..., 0]], dim=-1)


def _tangent(f, t):
    """d f / d t at t (one scalar per lane), forward mode."""
    return torch.func.jvp(f, (t,), (torch.ones_like(t),))[1]


def _gather_adjoint(d_img, pi_px, valid):
    """The image adjoint at the pixel holding pi_px (box reconstruction):
    [N, C], or [N, 4, C] for a Stokes image [H, W, 4, C]; 0 off `valid`."""
    H, W = d_img.shape[0], d_img.shape[1]
    px = torch.clamp(torch.floor(pi_px[:, 0]).to(torch.int64), 0, W - 1)
    py = torch.clamp(torch.floor(pi_px[:, 1]).to(torch.int64), 0, H - 1)
    g = d_img[py, px]
    return torch.where(valid.reshape((-1,) + (1,) * (g.ndim - 1)), g, 0.0)


def _bmask(mask, arr):
    return mask.reshape((-1,) + (1,) * (arr.ndim - 1))


def _adj_contract(scene, adj, dL, ray_d):
    """The image adjoint contracted with a radiance jump per lane; in the
    polarized variants the Stokes jump is rotated into the sensor frame
    first and all four components contract."""
    if not scene.polarized:
        return torch.sum(adj * dL, dim=-1)
    from ..render_api import to_sensor_mueller

    dL = to_sensor_mueller(ray_d, dL)               # [N, C, 4]
    return torch.sum(adj * dL.transpose(-1, -2), dim=(-1, -2))


def _adj_I(scene, adj, dL):
    """(adjoint, jump) of the I channel for the receiver-side passes."""
    if not scene.polarized:
        return adj, dL
    return adj[:, 0, :], dL[..., 0]


def _select_si(mask, a, b):
    """b on the lanes of mask, a elsewhere, field by field."""
    return dataclasses.replace(a, **{
        f.name: torch.where(_bmask(mask, getattr(a, f.name)), getattr(b, f.name),
                            getattr(a, f.name))
        for f in dataclasses.fields(a)})


def _radiance(scene, ray, seed, salt, active, depth_limit=None):
    """One-sample radiance estimate of each ray by the scene's integrator
    (the jumps dL); `depth_limit` [N] caps a path tracer's depth per
    lane."""
    rng = _lanes_rng(seed, salt, ray.o.shape[0], ray.o.device)
    kw = {} if depth_limit is None else {"depth_limit": depth_limit}
    L, _ = scene.integrator.sample(scene, rng, ray, active, None, **kw)
    return L


@dataclass
class CurveLanes:
    """One boundary pass's lanes: the curve term of lane i is
    k[i] * (n_hat[i] . curve_fn(vertices)[i]), k 0 where the lane is not
    valid."""

    valid: torch.Tensor
    n_hat: torch.Tensor
    k: torch.Tensor
    curve_fn: object     # vertices [V, 3] -> [N, 2] or [N, 3]
    edge: torch.Tensor   # [N] the lane's edge

    def phi(self, vertices):
        return torch.sum(self.k * dot2(self.n_hat, self.curve_fn(vertices)))

    def vjp(self, vertices):
        """d phi / d vertices [V, 3]."""
        with torch.enable_grad():
            v = vertices.detach().requires_grad_()
            return torch.autograd.grad(self.phi(v), v)[0]


def dot2(a, b):
    """Row dot product over the last axis (2 or 3 wide)."""
    return torch.sum(a * b, dim=-1)


# ---------------------------------------------------------------------------
# the primarily visible silhouettes
# ---------------------------------------------------------------------------

def primary_boundary_lanes(scene, d_img, seed, n_b, sensor_idx=0):
    """The lanes of the primary silhouette pass. For silhouette points x,
    the estimator (pixel units) is
      E[ (d_img . dL) (n_hat . d pi(x) / d theta) |d pi / dt| W_total / (len_e N) ]
    with n_hat the projected edge's image normal toward the background and
    dL = L_fg - L_bg from probe rays EPS_PX pixels to either side."""
    geom, film = scene.geometry, scene.film
    sensor = scene.sensors[sensor_idx]
    vp, verts, dev = sensor.position, geom.vertices, geom.vertices.device

    w, _, _ = silhouette_weights(geom, viewpoint=vp)
    u_edge, u_t, _ = _lanes_rng(seed, 0x51AA77E7, n_b, dev).next_2d()
    e_idx, t, x, _, W_total, len_e = sample_silhouette_points(geom, w, u_edge, u_t)
    valid = (w[e_idx] > 0) & (W_total > 0)

    # visible from the sensor?
    dist = _norm(x - vp)
    d_vx = (x - vp) / torch.clamp(dist, min=1e-12)[:, None]
    valid = valid & ~scene.ray_test(Ray(o=vp.expand(x.shape), d=d_vx, maxt=dist * (1.0 - 1e-3)),
                                    valid)

    a_idx, b_idx = silhouette_ends(geom, e_idx, vp - x)

    def curve(vts, tt=t):
        xx = (1.0 - tt[:, None]) * vts[a_idx] + tt[:, None] * vts[b_idx]
        return _project_px(sensor, film, xx)[0]

    pi_px, ok = _project_px(sensor, film, x)
    valid = valid & ok
    tau = _tangent(lambda tt: curve(verts, tt), t)            # d pi / dt [N, 2]
    tau_n = _norm2(tau)
    valid = valid & (tau_n > 1e-9)
    n_hat = _perp(tau) / torch.clamp(tau_n, min=1e-12)[:, None]

    # probes to both sides classify foreground and background and give dL
    wh = _film_wh(film, dev)
    ap = torch.full((n_b, 2), 0.5, dtype=torch.float32, device=dev)
    ray_p = sensor.sample_ray((pi_px + EPS_PX * n_hat) / wh, ap)
    ray_m = sensor.sample_ray((pi_px - EPS_PX * n_hat) / wh, ap)
    si_p = scene.ray_intersect(ray_p, valid)
    si_m = scene.ray_intersect(ray_m, valid)
    tol = 0.05 * dist
    shp = geom.edge_shape[e_idx]
    match_p = (si_p.shape_index == shp) & (torch.abs(si_p.t - dist) < tol)
    match_m = (si_m.shape_index == shp) & (torch.abs(si_m.t - dist) < tol)
    fg_plus = match_p & ~match_m
    valid = valid & (fg_plus | (match_m & ~match_p))
    n_hat = torch.where(fg_plus[:, None], -n_hat, n_hat)     # toward the background

    L_p = _radiance(scene, ray_p, seed, 0xA11CE001, valid)
    L_m = _radiance(scene, ray_m, seed, 0xB0B00002, valid)
    dL = torch.where(_bmask(fg_plus, L_p), L_p - L_m, L_m - L_p)
    c = _adj_contract(scene, _gather_adjoint(d_img, pi_px, valid), dL, d_vx)
    k = torch.where(valid, c * tau_n * W_total / (torch.clamp(len_e, min=1e-12) * n_b), 0.0)
    return CurveLanes(valid=valid, n_hat=n_hat, k=k, curve_fn=curve, edge=e_idx)


def _norm2(v2):
    return torch.sqrt(dot2(v2, v2))


def primary_boundary_vjp(scene, d_img, seed, n_b, sensor_idx=0):
    """Vertex-buffer cotangent [V, 3] of the primarily visible silhouettes."""
    return primary_boundary_lanes(scene, d_img, seed, n_b, sensor_idx).vjp(scene.geometry.vertices)


# ---------------------------------------------------------------------------
# the shadow curves of point and directional lights
# ---------------------------------------------------------------------------

def _receiver_map(a_idx, b_idx, t, rface, e_pos, e_dir):
    """vts -> the receiver point y [N, 3]: the edge point continued from
    the light through the plane of the receiver triangle rface, all
    differentiable in the vertices."""
    def y_of(vts, tt=t):
        xx = (1.0 - tt[:, None]) * vts[a_idx] + tt[:, None] * vts[b_idx]
        dd = _unit(xx - e_pos) if e_pos is not None else e_dir.expand(xx.shape)
        p0, p1, p2 = vts[rface[:, 0]], vts[rface[:, 1]], vts[rface[:, 2]]
        nr = cross(p1 - p0, p2 - p0)
        denom = dot(dd, nr)
        denom = torch.where(torch.abs(denom) > 1e-12, denom, 1.0)
        return xx + (dot(p0 - xx, nr) / denom)[:, None] * dd
    return y_of


def _shadow_contract(scene, sensor_idx, d_img, si_y, y0, pi_px, tau, em, em_i, e_pos, e_dir,
                     valid, n_b, weight_scale):
    """The shadow pass's tail: orient the image normal toward the shadowed
    side by occlusion tests from probe points on the receiver's plane,
    take the jump dL = f_r E and contract it with the adjoint. Returns
    (valid, n_hat, k)."""
    geom, film = scene.geometry, scene.film
    sensor = scene.sensors[sensor_idx]
    dev = y0.device
    wh = _film_wh(film, dev)
    tau_n = _norm2(tau)
    valid = valid & (tau_n > 1e-9)
    n_hat = _perp(tau) / torch.clamp(tau_n, min=1e-12)[:, None]
    d_yc = sensor.position - y0
    d_yc = d_yc / torch.clamp(_norm(d_yc), min=1e-12)[:, None]
    ap = torch.full((n_b, 2), 0.5, dtype=torch.float32, device=dev)
    ray_pp = sensor.sample_ray((pi_px + EPS_PX * n_hat) / wh, ap)
    ray_pm = sensor.sample_ray((pi_px - EPS_PX * n_hat) / wh, ap)

    def plane_hit(r):
        denom = dot(r.d, si_y.n)
        denom = torch.where(torch.abs(denom) > 1e-9, denom, 1.0)
        return r.o + (dot(y0 - r.o, si_y.n) / denom)[:, None] * r.d

    def shadowed(pt):
        if e_pos is not None:
            dv = e_pos - pt
            rv = _norm(dv)
            dv = dv / torch.clamp(rv, min=1e-12)[:, None]
            return scene.ray_test(spawn_ray(pt, si_y.n, dv, maxt=rv * (1 - 1e-3)), valid)
        far = torch.full((n_b,), 1e6, dtype=torch.float32, device=dev)
        return scene.ray_test(spawn_ray(pt, si_y.n, -e_dir.expand(pt.shape), maxt=far), valid)

    sh_p = shadowed(plane_hit(ray_pp))
    sh_m = shadowed(plane_hit(ray_pm))
    valid = valid & (sh_p != sh_m)
    n_hat = torch.where(sh_p[:, None], n_hat, -n_hat)          # toward the shadow

    ds, e_weight = em.sample_direction(y0, ap, geom, em_i, scene.n_channels, None)
    f_val, _ = scene.bsdf_eval_pdf(dataclasses.replace(si_y, wi=si_y.to_local(d_yc)),
                                   si_y.to_local(ds.d), valid)
    dL = f_val * e_weight                                       # lit - shadowed
    adj = _gather_adjoint(d_img, pi_px, valid)
    if scene.polarized:
        adj = adj[:, 0, :]      # a depolarized (diffuse-receiver) jump: the I row
    k = torch.where(valid, torch.sum(adj * dL, dim=-1) * tau_n * weight_scale, 0.0)
    return valid, n_hat, k


def shadow_boundary_lanes(scene, d_img, seed, n_b, sensor_idx=0):
    """[(emitter index, CurveLanes)] of the shadow pass, one per point or
    directional light: blocker edges that are silhouettes from the light,
    continued from the light past the edge to the receiver y, whose
    motion sweeps the shadow with the jump dL = f_r E. The receiver point
    is re-expressed through its triangle's plane, so the whole map
    vertices -> y -> pi(y) is differentiable."""
    geom, film = scene.geometry, scene.film
    sensor = scene.sensors[sensor_idx]
    verts, cam_p, dev = geom.vertices, sensor.position, geom.vertices.device
    out = []
    for em_i, em in enumerate(scene.emitters):
        e_pos = getattr(em, "position", None)
        e_dir = getattr(em, "direction", None)
        if em.is_environment or (e_pos is None and e_dir is None):
            continue        # area lights: the indirect pass carries their shadows
        w, _, _ = silhouette_weights(geom, viewpoint=e_pos, direction=e_dir)
        u_edge, u_t, _ = _lanes_rng(seed, 0x5ADE0000 + em_i, n_b, dev).next_2d()
        e_idx, t, x, _, W_total, len_e = sample_silhouette_points(geom, w, u_edge, u_t)
        valid = (w[e_idx] > 0) & (W_total > 0)
        a_idx, b_idx = silhouette_ends(
            geom, e_idx, e_pos - x if e_pos is not None else -e_dir.expand(x.shape))

        # the continuation from the light through the edge point, which
        # must see the light
        if e_pos is not None:
            r_xe = _norm(x - e_pos)
            d_cont = (x - e_pos) / torch.clamp(r_xe, min=1e-12)[:, None]
            maxt = r_xe * (1 - 2e-3)
        else:
            d_cont = e_dir.expand(x.shape)
            maxt = torch.full((n_b,), 1e6, dtype=torch.float32, device=dev)
        valid = valid & ~scene.ray_test(Ray(o=x - d_cont * 1e-3, d=-d_cont, maxt=maxt), valid)

        # the receiver: the first hit past the edge, seen from the sensor
        ray_c = Ray.make(x + d_cont * 1e-3, d_cont)
        si_y = scene.ray_intersect(ray_c, valid)
        valid = valid & si_y.is_valid & (si_y.prim_index < geom.n_tris)
        y0 = si_y.p
        d_yc = cam_p - y0
        r_yc = _norm(d_yc)
        d_yc = d_yc / torch.clamp(r_yc, min=1e-12)[:, None]
        valid = valid & ~scene.ray_test(spawn_ray(y0, si_y.n, d_yc, maxt=r_yc * (1 - 1e-3)),
                                        valid)
        pi_px, okp = _project_px(sensor, film, y0)
        valid = valid & okp

        rface = geom.tri_face[torch.clamp(si_y.prim_index, 0, geom.n_tris - 1).to(torch.int64)]
        y_of = _receiver_map(a_idx, b_idx, t, rface, e_pos, e_dir)

        def curve(vts, tt=t, y_of=y_of):
            return _project_px(sensor, film, y_of(vts, tt))[0]

        tau = _tangent(lambda tt, curve=curve: curve(verts, tt), t)
        valid, n_hat, k = _shadow_contract(
            scene, sensor_idx, d_img, si_y, y0, pi_px, tau, em, em_i, e_pos, e_dir, valid, n_b,
            W_total / (torch.clamp(len_e, min=1e-12) * n_b))
        out.append((em_i, CurveLanes(valid=valid, n_hat=n_hat, k=k, curve_fn=curve, edge=e_idx)))
    return out


def shadow_boundary_vjp(scene, d_img, seed, n_b, sensor_idx=0):
    """Vertex-buffer cotangent [V, 3] of the delta lights' shadow curves."""
    verts = scene.geometry.vertices
    total = torch.zeros_like(verts)
    for _, lanes in shadow_boundary_lanes(scene, d_img, seed, n_b, sensor_idx):
        total = total + lanes.vjp(verts)
    return total


# ---------------------------------------------------------------------------
# the indirect (receiver-side, depth >= 2) boundary
# ---------------------------------------------------------------------------

def _prefix_walk(scene, si1, ray0, rng, k_lane, K, valid):
    """A detached BSDF-sampled camera prefix from the primary hit si1 until
    each lane reaches its seed depth k_lane (1: si1 itself), with its
    throughput beta = prod f cos / pdf. Returns (the interaction at y_k,
    the world direction toward the previous vertex, beta [N, C], the lanes
    that reached y_k, rng); depths are capped at K."""
    n, nc, dev = ray0.o.shape[0], scene.n_channels, ray0.o.device
    si_cur, wi_cur = si1, -ray0.d
    beta = torch.ones(n, nc, dtype=torch.float32, device=dev)
    si_out, wi_out, beta_out = si1, wi_cur, beta
    alive = valid & si1.is_valid
    done = k_lane <= 1
    ok_out = alive & done
    for j in range(2, K + 1):
        u_lobe, u2x, rng = rng.next_2d()
        u2y, _, rng = rng.next_2d()
        need = alive & ~done
        si_eval = dataclasses.replace(si_cur, wi=si_cur.to_local(wi_cur))
        bs, bw = scene.bsdf_sample(si_eval, u_lobe, torch.stack([u2x, u2y], dim=-1), need)
        wo_world = si_cur.to_world(bs.wo)
        si_next = scene.ray_intersect(spawn_ray(si_cur.p, si_cur.n, wo_world), need)
        beta = torch.where(need[:, None], beta * bw, beta)
        alive = alive & (done | (si_next.is_valid & (bs.pdf > 0)
                                 & torch.any(beta > 0, dim=-1)))
        si_cur = _select_si(need, si_cur, si_next)
        wi_cur = torch.where(need[:, None], -wo_world, wi_cur)
        hit_k = need & (k_lane == j)
        si_out = _select_si(hit_k, si_out, si_cur)
        wi_out = torch.where(hit_k[:, None], wi_cur, wi_out)
        beta_out = torch.where(hit_k[:, None], beta, beta_out)
        ok_out = ok_out | (hit_k & alive)
        done = done | (k_lane == j)
    return si_out, wi_out, beta_out, ok_out, rng


def _seed_depth(scene):
    """K, the deepest seed vertex of the indirect pass: boundary_depth, or
    min(max_depth - 1, 3) for a path-tracing base; 1 otherwise."""
    from ..integrators.path import PathIntegrator

    base = getattr(scene.integrator, "base", scene.integrator)
    if not isinstance(base, PathIntegrator):
        return 1
    return int(getattr(scene.integrator, "boundary_depth", 0)) or max(
        min(getattr(base, "max_depth", 2) - 1, 3), 1)


def _probe_scene(scene, k_lane):
    """(the scene whose integrator probes the radiance behind an edge, the
    per-lane depth cap or None): the base with one bounce less, capped per
    lane at the primal's remaining depth for a path tracer; a depth-1 path
    tracer for the direct integrator (the only radiance its BSDF branch
    sees behind an edge is emission)."""
    from ..integrators.path import PathIntegrator

    base = getattr(scene.integrator, "base", scene.integrator)
    limit = None
    if isinstance(base, PathIntegrator):
        probe = dataclasses.replace(base, max_depth=max(base.max_depth - 1, 1))
        limit = torch.clamp(base.max_depth - k_lane, min=1)
    elif hasattr(base, "max_depth"):
        probe = dataclasses.replace(base, max_depth=max(base.max_depth - 1, 1))
    else:
        probe = PathIntegrator(max_depth=1, rr_depth=64, hide_emitters=False)
    return dataclasses.replace(scene, integrator=probe), limit


def indirect_pass_lanes(scene, d_img, seed, n_b, sensor_idx, w_edge, salt, K):
    """The lanes of one importance-weighted indirect pass drawing edges by
    `w_edge`. Estimator: a direction-space curve integral on the unit
    sphere at the seed vertex y_k,
      dI/dtheta = E[ adj . (beta_k f cos dL_in) (n_hat . d omega / d theta)
                     |d omega / dl| (W_g len_e / w_e) K WH / n ]."""
    geom, film = scene.geometry, scene.film
    sensor = scene.sensors[sensor_idx]
    verts, dev = geom.vertices, geom.vertices.device
    W, H = film.width, film.height

    # each lane's pixel and seed vertex y_k
    rng = _lanes_rng(seed, salt, n_b, dev)
    u_px, u_edge, rng = rng.next_2d()
    u_t, u_k, rng = rng.next_2d()
    pix = torch.clamp((u_px * W * H).to(torch.int64), max=W * H - 1)
    px = (pix % W).to(torch.float32) + 0.5
    py = (pix // W).to(torch.float32) + 0.5
    pix_c = torch.stack([px, py], dim=-1)
    ray0 = sensor.sample_ray(pix_c / _film_wh(film, dev),
                             torch.full((n_b, 2), 0.5, dtype=torch.float32, device=dev))
    si1 = scene.ray_intersect(ray0, torch.ones(n_b, dtype=torch.bool, device=dev))
    k_lane = torch.clamp((u_k * K).to(torch.int64) + 1, max=K)          # 1..K
    si_y, wi_dir, beta, alive, rng = _prefix_walk(scene, si1, ray0, rng, k_lane, K,
                                                  si1.is_valid)
    valid = si1.is_valid & alive
    y = si_y.p

    # an edge point from the guide, a silhouette seen from y
    e_idx, t, x, _, W_g, _ = sample_silhouette_points(geom, w_edge, u_edge, u_t)
    w_e = w_edge[e_idx]
    valid = valid & (w_e > 0) & (W_g > 0)
    T = geom.tri_ng.shape[0]
    n0 = geom.tri_ng[torch.clamp(geom.edge_f[e_idx, 0], 0, T - 1)]
    n1 = geom.tri_ng[torch.clamp(geom.edge_f[e_idx, 1], 0, T - 1)]
    to_y = y - x
    valid = valid & ((geom.edge_f[e_idx, 1] < 0) | ((dot(n0, to_y) > 0) != (dot(n1, to_y) > 0)))
    r = _norm(x - y)
    valid = valid & (r > 1e-4)
    omega = (x - y) / torch.clamp(r, min=1e-12)[:, None]
    valid = valid & ~scene.ray_test(spawn_ray(y, si_y.n, omega, maxt=r * (1.0 - 1e-3)), valid)

    # the spherical tangent and the curve's normal at omega
    a_idx, b_idx = silhouette_ends(geom, e_idx, to_y)

    def curve(vts, tt=t):
        xx = (1.0 - tt[:, None]) * vts[a_idx] + tt[:, None] * vts[b_idx]
        return _unit(xx - y)

    tau = _tangent(lambda tt: curve(verts, tt), t)
    tau_s = tau - dot(tau, omega)[:, None] * omega
    tau_n = _norm(tau_s)
    valid = valid & (tau_n > 1e-9)
    n_hat = cross(omega, tau_s / torch.clamp(tau_n, min=1e-12)[:, None])

    # probes EPS_RAD to both sides: foreground and background, dL_in
    w_p = omega + EPS_RAD * n_hat
    w_p = w_p / _norm(w_p)[:, None]
    w_m = omega - EPS_RAD * n_hat
    w_m = w_m / _norm(w_m)[:, None]
    ray_p = spawn_ray(y, si_y.n, w_p)
    ray_m = spawn_ray(y, si_y.n, w_m)
    si_p = scene.ray_intersect(ray_p, valid)
    si_m = scene.ray_intersect(ray_m, valid)
    tol = 0.05 * r
    shp = geom.edge_shape[e_idx]
    match_p = (si_p.shape_index == shp) & (torch.abs(si_p.t - r) < tol)
    match_m = (si_m.shape_index == shp) & (torch.abs(si_m.t - r) < tol)
    fg_plus = match_p & ~match_m
    valid = valid & (fg_plus | (match_m & ~match_p))
    n_hat = torch.where(fg_plus[:, None], -n_hat, n_hat)       # toward the background
    # the probes carry the primal's remaining depth from y_k
    s_probe, limit = _probe_scene(scene, k_lane)
    L_p = _radiance(s_probe, ray_p, seed, salt ^ 0x17D10003, valid, limit)
    L_m = _radiance(s_probe, ray_m, seed, salt ^ 0x17D20004, valid, limit)
    dL = torch.where(_bmask(fg_plus, L_p), L_p - L_m, L_m - L_p)

    # the BSDF at y_k (f cos, smooth lobes only)
    si_eval = dataclasses.replace(si_y, wi=si_y.to_local(wi_dir))
    f_val, _ = scene.bsdf_eval_pdf(si_eval, si_y.to_local(omega), valid)
    adj, dL = _adj_I(scene, _gather_adjoint(d_img, pix_c, valid), dL)
    c = torch.sum(adj * beta * f_val * dL, dim=-1)
    k = torch.where(valid, c * tau_n * W_g / (torch.clamp(w_e, min=1e-12) * n_b) * (W * H) * K,
                    0.0)
    return CurveLanes(valid=valid, n_hat=n_hat, k=k, curve_fn=curve, edge=e_idx)


def indirect_boundary_lanes(scene, d_img, seed, n_b, sensor_idx=0):
    """[(weight, CurveLanes)] of the indirect pass: with n_b >= 4096 lanes,
    a pilot quarter draws edges from the static mixture (half the camera
    silhouettes, half all edges by length) and banks each edge's mean
    |curve term|; the rest draws from half the mixture and half that mass
    (two-stage guiding). The cotangent is the weighted sum of the stages'."""
    geom = scene.geometry
    sensor = scene.sensors[sensor_idx]
    w_cam, va, vb = silhouette_weights(geom, viewpoint=sensor.position)
    length = torch.where(geom.edge_shape >= 0, _norm(vb - va), 0.0)
    w_mix = 0.5 * w_cam + 0.5 * length
    K = _seed_depth(scene)
    n_pilot = n_b // 4 if n_b >= 4096 else 0
    n_main = n_b - n_pilot
    if n_pilot == 0:
        return [(1.0, indirect_pass_lanes(scene, d_img, seed, n_main, sensor_idx, w_mix,
                                          0x1D17EC7, K))]
    pilot = indirect_pass_lanes(scene, d_img, seed, n_pilot, sensor_idx, w_mix, 0x1D17EC7, K)
    mass = torch.zeros_like(w_mix).index_add_(
        0, pilot.edge, torch.where(pilot.valid, torch.abs(pilot.k) * n_pilot, 0.0))
    mass_sum = torch.sum(mass)
    w_guided = torch.where(
        mass_sum > 0,
        0.5 * w_mix / torch.clamp(torch.sum(w_mix), min=1e-12)
        + 0.5 * mass / torch.clamp(mass_sum, min=1e-12),
        w_mix)
    main = indirect_pass_lanes(scene, d_img, seed, n_main, sensor_idx, w_guided, 0x6D41DE2, K)
    return [(n_pilot / float(n_b), pilot), (n_main / float(n_b), main)]


def indirect_boundary_vjp(scene, d_img, seed, n_b, sensor_idx=0):
    """Vertex-buffer cotangent [V, 3] of the indirect visibility boundary:
    jumps of the incident radiance across silhouette edges seen from path
    vertices at depth k ~ U{1..K}."""
    verts = scene.geometry.vertices
    total = torch.zeros_like(verts)
    for weight, lanes in indirect_boundary_lanes(scene, d_img, seed, n_b, sensor_idx):
        total = total + weight * lanes.vjp(verts)
    return total


# ---------------------------------------------------------------------------
# the differentiable render
# ---------------------------------------------------------------------------

def _primal_image(scene, seed, spp, sensor_idx):
    """(the image [H, W, C] (polarized: [H, W, 4, C]) of one pass of spp
    samples per pixel by the scene's integrator, its counters)."""
    from ..render.film import accumulate, stokes_major
    from ..render_api import render_lanes

    L, aux = render_lanes(scene, seed, 0, scene.film.n_pixels * spp, 0, spp, spp, sensor_idx)
    aux.pop("film_jitter")      # a weighted filter develops as a box here, as in the JAX package
    return stokes_major(accumulate(scene.film, L, spp) / spp), aux


def _tape_integrator(scene, base):
    """The path tracer whose tape gives a PRB base's vertex term: path, or
    volpath in the polarized variants (its Mueller transport)."""
    from ..integrators.path import PathIntegrator
    from ..integrators.volpath import VolPathIntegrator

    cls = VolPathIntegrator if scene.polarized else PathIntegrator
    return cls(max_depth=getattr(base, "max_depth", 8), rr_depth=getattr(base, "rr_depth", 5),
               hide_emitters=getattr(base, "hide_emitters", False))


def projective_leaves(scene):
    """The inputs of the render node: the scene's tensors that require
    grad, without the triangle tables derived from the vertex buffer (the
    backward re-derives them from the vertices)."""
    g = scene.geometry
    derived = {id(x) for x in (g.tri_v0, g.tri_e1, g.tri_e2, g.tri_ng, g.tri_vn, g.bvh_rows)
               if x is not None}
    return [x for x in grad_leaves(scene) if id(x) not in derived]


class ProjectiveRender(torch.autograd.Function):
    """The primal image, with the interior and boundary gradients for the
    scene tensors given as inputs. `args` holds everything else."""

    @staticmethod
    def forward(ctx, args, *leaves):
        with torch.no_grad():
            img, args["aux"] = _primal_image(args["scene"], args["seed"], args["spp"],
                                             args["sensor_idx"])
        ctx.args, ctx.leaves = args, leaves
        return img

    @staticmethod
    def backward(ctx, d_img):
        a = ctx.args
        grads = projective_backward(a["scene"], ctx.leaves, d_img.detach(), a["seed"], a["spp"],
                                    a["sensor_idx"], a["stats"])
        return (None, *grads)


def projective_backward(scene, leaves, d_img, seed, spp, sensor_idx=0, stats=None):
    """The gradients of sum(d_img * image) for each tensor of `leaves`:
    the interior term, and for the vertex buffer the boundary passes'
    (sppp and sppi boundary samples per pixel)."""
    from ..render.film import accumulate, stokes_major
    from .render_ad import derive_seed_grad, prb_pass

    integ = scene.integrator
    base = integ.base
    verts = scene.geometry.vertices
    vi = next((i for i, x in enumerate(leaves) if x is verts), None)
    grads = [torch.zeros_like(x) for x in leaves]
    with torch.enable_grad():
        if getattr(base, "is_prb", False):
            # the PRB node for everything but geometry (its replay detaches
            # it), then the vertex term from a tape pass through path
            others = [x for i, x in enumerate(leaves) if i != vi]
            if others:
                s_att, att = attach_scene(dataclasses.replace(scene, integrator=base), others)
                L, _ = prb_pass(s_att, seed, derive_seed_grad(seed), 0, spp, spp, sensor_idx,
                                stats=stats)
                img = stokes_major(accumulate(scene.film, L, spp) / spp)
                g_o = [torch.zeros_like(x) for x in att]
                vjp_into(g_o, torch.sum(img * d_img), att)
                for i, g in zip([i for i in range(len(leaves)) if i != vi], g_o):
                    grads[i] += g
            if vi is not None:
                s_v = detach_scene(scene)
                vts = verts.detach().requires_grad_()
                s_v = dataclasses.replace(
                    s_v, integrator=_tape_integrator(scene, base),
                    geometry=dataclasses.replace(s_v.geometry, vertices=vts))
                img, _ = _primal_image(s_v, seed, spp, sensor_idx)
                vjp_into([grads[vi]], torch.sum(img * d_img), [vts])
        else:
            # the tape of the whole render
            s_att, att = attach_scene(scene, leaves)
            img, _ = _primal_image(s_att, seed, spp, sensor_idx)
            vjp_into(grads, torch.sum(img * d_img), att)
    if vi is not None:
        s_b = detach_scene(scene)
        n_pix = scene.film.n_pixels
        with torch.no_grad():
            if integ.sppp > 0:
                grads[vi] += primary_boundary_vjp(s_b, d_img, seed, n_pix * integ.sppp, sensor_idx)
            if integ.sppi > 0:
                grads[vi] += shadow_boundary_vjp(s_b, d_img, seed, n_pix * integ.sppi, sensor_idx)
                grads[vi] += indirect_boundary_vjp(s_b, d_img, seed, n_pix * integ.sppi,
                                                   sensor_idx)
    return grads


def projective_render(scene, seed, spp, sensor_idx=0, stats=None):
    """The image of one pass of spp samples per pixel [H, W, C] (polarized
    [H, W, 4, C]), differentiable in the scene's tensors that require grad,
    vertex buffers included (boundary-aware). `stats` gets the forward's
    n_rays; a PRB base's backward adds its rays to n_rays_grad."""
    check_projective_scene(scene)
    args = dict(scene=scene, seed=int(seed) & MASK32, spp=spp, sensor_idx=sensor_idx,
                stats=stats)
    img = ProjectiveRender.apply(args, *projective_leaves(scene))
    if stats is not None:
        stats.update({k: int(v) for k, v in args["aux"].items()})
    return img


def check_projective_scene(scene):
    """Raise NotImplementedError for what the boundary passes do not cover
    yet: the silhouettes of analytic spheres, the shadow boundaries of spot
    lights and projectors, and a cropped film."""
    from ..render.emitters import ProjectorEmitter, SpotEmitter

    if scene.geometry.n_spheres:
        raise NotImplementedError("the projective terms of an analytic sphere are not yet "
                                  "ported")
    for em in scene.emitters:
        if isinstance(em, (SpotEmitter, ProjectorEmitter)):
            raise NotImplementedError(f"the projective terms of a {type(em).__name__} are not "
                                      "yet ported")
    if scene.film.crop_size is not None or scene.film.crop_offset != (0, 0):
        raise NotImplementedError("a projective integrator over a crop window is not yet "
                                  "ported")


@dataclass(frozen=True)
class ProjectiveIntegrator:
    """Marks a scene for boundary-aware differentiation; the primal
    delegates to `base`. sppp and sppi are the boundary samples per pixel
    of the primary pass and of the shadow and indirect passes;
    boundary_depth is the indirect pass's deepest seed vertex (0: automatic,
    min(base.max_depth - 1, 3))."""

    base: object
    sppp: int = 4
    sppi: int = 4
    boundary_depth: int = 0

    is_projective = True

    def sample(self, scene, rng, ray, active, wavelengths=None):
        return self.base.sample(scene, rng, ray, active, wavelengths)
