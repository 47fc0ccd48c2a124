"""Closest-hit and any-hit queries over the threaded wide-leaf BVH: kernel K2
and its plain version (counterpart of mitsuba_tpu/ops/bvh_sweep.py and of
the XLA traversal mitsuba_tpu/render/bvh.py:bvh_intersect).

``bvh_sweep_intersect`` and ``bvh_sweep_occluded`` launch the hand-written
CUDA kernel ``csrc/bvh_sweep.cu`` (which replaces the TPU kernel
``mitsuba_tpu/ops/bvh_sweep.py:_kernel``) for tensors on the card, and run
``bvh_sweep_reference`` for tensors on the CPU. A tensor on the card never
falls back to the plain version.

Contract: nodes [M, 8] float32 as ``native.build_bvh_wide`` returns them
(box lo | hi, then the skip link and the leaf payload start << 8 | count
stored bitwise as int32); table [T, 9] float32 (v0 | e1 | e2) in leaf
order; rays o, d [N, 3] and maxt [N] float32, maxt <= 0 (or -inf, or NaN)
disabling a lane. Each lane walks the threaded layout without a stack:

    box hit, internal node  -> node + 1
    box hit, leaf           -> test its triangles, then skip
    box missed              -> skip

A box is hit when tmax >= max(tmin, 0) and tmin < best_t, with the slab
test written (lo - o) * inv_d and inv_d = 1 / d guarded at |d| < 1e-12.
A leaf's triangles are tested in ascending order against the running
best_t with a strict t < best_t, so of equal t's the first one found in
the walk wins. A triangle hit needs |det| > 1e-12, barycentrics inside and
0 < t < best_t (the Moller-Trumbore of ops/intersect.py). Returns t [N]
(maxt on a miss, unlike K1), prim [N] int32 (-1 on a miss), u, v [N] (0 on
a miss). The any-hit mode ends a lane's walk at its first hit, so only
prim >= 0 is meaningful there.

``bvh_sweep_intersect`` is differentiable (the JAX package's custom VJP as
a ``torch.autograd.Function``): its backward is ``ops/intersect.py:
mt_vjp`` in plain PyTorch, with cotangents for o and d and for the table
rows of the hit triangles in leaf order, which reach tri_v0, tri_e1 and
tri_e2 through the table's concatenation; none for the nodes or maxt.
``bvh_sweep_occluded`` has no gradient, as in the JAX package.

The kernel reads the table as ``rows = kernel_rows(table)``, [T, 12]
with 16-byte rows; the geometry builds them once (``Geometry.bvh_rows``)
and passes them in, and ``bvh_sweep`` pads the table itself when it is
given none.

The JAX package sorts each batch for its kernel by a coherence key
(``ray_sort_key``, ``maybe_sort_order``: ported here bit for bit). The
port does not: on the card the kernel ran no faster on batches in that
order than in lane order, and the sort cost several times the kernel
(``scripts/torch_bench_bvh.py``, PERF.md). Left out, because the result
does not depend on them either: the TPU kernel's 128-lane triangle
padding, the block-shared node window, row masks and DMA ring.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .intersect import hit_vjp, moller_trumbore

# leaf width of the BVH build: 64, the JAX package's, so that both packages
# build the same nodes and leaf order
MAX_WIDE_LEAF = 64
# the plain walk's cap on steps (one node per lane per step), as in
# mitsuba_tpu/render/bvh.py; the kernel needs none, since a lane's node index
# strictly increases
MAX_STEPS = 4096
# fp32 operations of one slab test, counted from the kernel: 6 subtractions,
# 6 products, 6 min/max of the slab pairs, 4 to reduce them over the axes
# and max(tmin, 0). The 2 compares are not counted.
SLAB_FLOPS = 23
# fp32 operations of one ray-triangle test (as in K1, see chip_smoke.py)
TRI_FLOPS = 46
# leaf lanes tested at once by the plain version, to bound its memory
_LEAF_LANES = 1 << 14


def node_fields(nodes):
    """(lo [M, 3], hi [M, 3], skip [M] int64, payload [M] int32) of a node
    table."""
    skip = nodes[:, 6].contiguous().view(torch.int32).to(torch.int64)
    payload = nodes[:, 7].contiguous().view(torch.int32)
    return nodes[:, 0:3], nodes[:, 3:6], skip, payload


def safe_inv_dir(d):
    """1 / d with |d| < 1e-12 replaced by +-1e-12 (the sign of d, + at 0)."""
    tiny = torch.where(d >= 0, 1e-12, -1e-12)
    return 1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d)


def _leaf_hits(table, o, d, best_t, start, count, anyhit, counts=False):
    """Test leaf lanes against their leaves: (found [L], t, prim, u, v [L],
    and with `counts` (tests, det stops, u stops): the triangles tested and
    of those the ones that stop after det and after u, summed; else None).
    A leaf's rows are tested together; the result is the kernel's ascending
    sweep with a strict t < best_t: the smallest t, the lowest row among
    equal t's (closest hit), or the lowest row that hits (any hit)."""
    width = int(count.max())
    k = torch.arange(width, device=o.device)
    in_leaf = k[None, :] < count[:, None]
    pid = torch.where(in_leaf, start[:, None] + k[None, :], 0)
    t, u, v, hit, det_ok = moller_trumbore(o, d, table[pid])
    hit = hit & in_leaf & (t < best_t[:, None])
    found = hit.any(dim=1)
    if anyhit:
        j = torch.where(hit, k[None, :], width).amin(dim=1)
        tested = torch.where(found, j + 1, count)
    else:
        t_hit = torch.where(hit, t, float("inf"))
        t_min = t_hit.amin(dim=1)
        j = torch.where(hit & (t_hit == t_min[:, None]), k[None, :], width).amin(dim=1)
        tested = count
    work = None
    if counts:
        was_tested = k[None, :] < tested[:, None]
        work = (int(tested.sum()), int((was_tested & ~det_ok).sum()),
                int((was_tested & det_ok & ~((u >= 0.0) & (u <= 1.0))).sum()))
    j = torch.clamp(j, max=width - 1)[:, None]
    return (found, t.gather(1, j)[:, 0], pid.gather(1, j)[:, 0],
            u.gather(1, j)[:, 0], v.gather(1, j)[:, 0], work)


def bvh_sweep_reference(nodes, table, o, d, maxt, anyhit=False, max_steps=MAX_STEPS,
                        stats=None):
    """Plain PyTorch version of K2: every live lane takes one step of the
    walk at a time, in the kernel's operation order, so that the two make
    the same visits and agree bitwise. When `stats` is a dict it receives
    the steps taken, the node visits and triangle tests summed over lanes
    (the work the kernel does on the same rays), of those tests the ones
    that stop after det (|det| <= 1e-12) and after u (u outside [0, 1] or
    NaN), where the kernel stops them, and whether a lane was still walking
    at max_steps."""
    lo, hi, skip, payload = node_fields(nodes)
    inv_d = safe_inv_dir(d)
    best_t = maxt.clone()
    best_p = torch.full_like(maxt, -1, dtype=torch.int32)
    best_u = torch.zeros_like(maxt)
    best_v = torch.zeros_like(maxt)
    lanes = torch.nonzero(maxt > 0)[:, 0]
    node = torch.zeros_like(lanes)
    steps = visits = tests = det_stops = u_stops = 0
    while lanes.numel() and steps < max_steps:
        ro, bt = o[lanes], best_t[lanes]
        t0 = (lo[node] - ro) * inv_d[lanes]
        t1 = (hi[node] - ro) * inv_d[lanes]
        tmin = torch.minimum(t0, t1).amax(dim=1)
        tmax = torch.maximum(t0, t1).amin(dim=1)
        hit_box = (tmax >= torch.clamp(tmin, min=0.0)) & (tmin < bt)
        pay = payload[node]
        nxt = torch.where(hit_box & (pay == 0), node + 1, skip[node])
        leaf = torch.nonzero(hit_box & (pay != 0))[:, 0]
        for c0 in range(0, leaf.numel(), _LEAF_LANES):
            li = leaf[c0:c0 + _LEAF_LANES]
            lane = lanes[li]
            found, t, p, u, v, work = _leaf_hits(
                table, ro[li], d[lane], bt[li], (pay[li] >> 8).to(torch.int64),
                (pay[li] & 0xFF).to(torch.int64), anyhit, counts=stats is not None,
            )
            hit_lane = lane[found]
            best_t[hit_lane] = t[found]
            best_p[hit_lane] = p[found].to(torch.int32)
            best_u[hit_lane] = u[found]
            best_v[hit_lane] = v[found]
            if anyhit:
                nxt[li[found]] = -1
            if work is not None:
                tests, det_stops, u_stops = (a + b for a, b in
                                             zip((tests, det_stops, u_stops), work))
        visits += lanes.numel()
        steps += 1
        live = nxt >= 0
        lanes, node = lanes[live], nxt[live]
    if stats is not None:
        stats.update(steps=steps, node_visits=visits, tri_tests=tests,
                     tri_det_stops=det_stops, tri_u_stops=u_stops,
                     hit_max_steps=bool(lanes.numel()))
    return best_t, best_p, best_u, best_v


# maybe_sort_order's statistic: the keys' mean spread over blocks of
# SORT_BLOCK rays against SORT_SPREAD of their global spread (the JAX
# package's BLOCK and threshold)
SORT_BLOCK = 1024
SORT_SPREAD = 0.08


@functools.cache
def _spread_bits(bits, device):
    """[2^bits] int32: bit b of each value moved to bit 3 b."""
    v = torch.arange(1 << bits, dtype=torch.int32)
    out = torch.zeros_like(v)
    for b in range(bits):
        out |= ((v >> b) & 1) << (3 * b)
    return out.to(device)


def _morton3(x, cells, bits):
    """Morton code of the points x [N, 3], quantized to `cells` cells an
    axis (x already scaled to [0, cells)): bit b of axis 0, 1, 2 goes to bit
    3 b + 2, 3 b + 1, 3 b. The cell is x truncated toward zero and clipped
    to [0, cells - 1], with NaN in cell 0 (the JAX package's saturating
    float-to-int conversion, then its clip)."""
    q = torch.clamp(torch.nan_to_num(x, nan=0.0), 0, cells - 1).to(torch.int64)
    w = torch.tensor([4, 2, 1], dtype=torch.int32, device=x.device)
    return (_spread_bits(bits, x.device)[q] * w).sum(dim=1, dtype=torch.int32)


def ray_sort_key(o, d, lo, hi, maxt=None):
    """int32 coherence sort key of each ray (mitsuba_tpu/ops/bvh_sweep.py:
    ray_sort_key, bit for bit): the Morton code of the origin in the box
    [lo, hi] (6 bits an axis) above the Morton code of the direction (4
    bits an axis). With `maxt`, bit 30 is set on the rays that miss the box
    or are disabled (min(tmax, maxt) >= max(tmin, 0) fails), so that they
    sort to the end. The cull only orders the rays: the walk's own root
    test, not this one, decides which rays miss."""
    ext = torch.clamp(hi - lo, min=1e-6)
    key = (_morton3((o - lo) / ext * 64.0, 64, 6) << 12) | _morton3((d * 0.5 + 0.5) * 16.0, 16, 4)
    if maxt is not None:
        inv = safe_inv_dir(d)
        t0, t1 = (lo - o) * inv, (hi - o) * inv
        tmin = torch.minimum(t0, t1).amax(dim=1)
        tmax = torch.maximum(t0, t1).amin(dim=1)
        miss = ~(torch.minimum(tmax, maxt) >= torch.clamp(tmin, min=0.0))
        key = key | (miss.to(torch.int32) << 30)
    return key


def maybe_sort_order(key):
    """int32 permutation of the rays (mitsuba_tpu/ops/bvh_sweep.py:
    maybe_sort_order): the stable argsort of `key` when the keys' mean
    spread over blocks of SORT_BLOCK rays exceeds SORT_SPREAD of their
    global spread (an incoherent batch), the identity otherwise. The
    decision is read on the host."""
    n = key.shape[0]
    nb = max(n // SORT_BLOCK, 1)
    kb = key[:nb * SORT_BLOCK].reshape(nb, -1)
    spread = (kb.amax(dim=1) - kb.amin(dim=1)).to(torch.float32).mean()
    glob = (key.amax() - key.amin()).to(torch.float32)
    if bool(spread > SORT_SPREAD * torch.clamp(glob, min=1.0)):
        return torch.argsort(key, stable=True).to(torch.int32)
    return torch.arange(n, dtype=torch.int32, device=key.device)


def _check(nodes, table, o, d, maxt, rows=None):
    dev = nodes.device
    named = (("table", table), ("o", o), ("d", d), ("maxt", maxt))
    if rows is not None:
        named += (("rows", rows),)
    for name, x in named:
        if x.device != dev:
            raise ValueError(f"bvh_sweep: {name} is on {x.device}, the nodes on {dev}")
    for name, x in (("nodes", nodes),) + named:
        if x.dtype != torch.float32:
            raise TypeError(f"bvh_sweep: {name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"bvh_sweep: {name} must be contiguous")
    if nodes.ndim != 2 or nodes.shape[1] != 8 or nodes.shape[0] == 0:
        raise ValueError(f"bvh_sweep: nodes must be [M, 8], got {tuple(nodes.shape)}")
    if table.ndim != 2 or table.shape[1] != 9:
        raise ValueError(f"bvh_sweep: table must be [T, 9], got {tuple(table.shape)}")
    if rows is not None and rows.shape != (table.shape[0], 12):
        raise ValueError(f"bvh_sweep: rows must be [T, 12] = [{table.shape[0]}, 12], "
                         f"got {tuple(rows.shape)}")
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or maxt.shape != (n,):
        raise ValueError(
            "bvh_sweep: rays must be o [N,3], d [N,3], maxt [N]; got "
            f"{tuple(o.shape)}, {tuple(d.shape)}, {tuple(maxt.shape)}"
        )
    if n >= 2**31 or nodes.shape[0] >= 2**31:
        raise ValueError("bvh_sweep: more than 2^31 - 1 rays or nodes in one launch")


# -fmad=false: no FMA contraction, so the kernel rounds every product and
# sum as the plain version does (see csrc/bvh_sweep.cu)
BUILD_FLAGS = ("-fmad=false",)


@functools.cache
def _launcher():
    fn = cuda_build.load("bvh_sweep", BUILD_FLAGS).bvh_sweep_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, vp, vp, vp, vp, vp, vp]
    fn.restype = ci
    return fn


def kernel_rows(table):
    """The [T, 9] table as K2 reads it: [T, 12], each row padded with 3
    zeros to 48 bytes (three 16-byte loads)."""
    return torch.nn.functional.pad(table, (0, 3))


def launch_kernel(nodes, rows, o, d, maxt, anyhit):
    """(t, prim, u, v) from one launch of K2 on rows = kernel_rows(table);
    counts the launch in ``bvh_sweep_occluded.launches`` (any hit) or
    ``bvh_sweep_intersect.launches`` (closest hit)."""
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty(n, dtype=torch.float32, device=o.device)
    v = torch.empty(n, dtype=torch.float32, device=o.device)
    if n == 0:
        return t, prim, u, v
    # the warps' shared counter of batch positions taken (zeroed by the
    # launcher)
    counter = torch.empty(1, dtype=torch.int32, device=o.device)
    launch = _launcher()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        rc = launch(
            nodes.data_ptr(), rows.data_ptr(), o.data_ptr(), d.data_ptr(), maxt.data_ptr(),
            n, int(anyhit), counter.data_ptr(), t.data_ptr(), prim.data_ptr(), u.data_ptr(),
            v.data_ptr(), stream,
        )
    (bvh_sweep_occluded if anyhit else bvh_sweep_intersect).launches += 1
    if rc != 0:
        raise RuntimeError(f"bvh_sweep: kernel launch failed with CUDA error {rc}")
    return t, prim, u, v


def bvh_sweep(nodes, table, o, d, maxt, anyhit=False, rows=None):
    """(t, prim, u, v) of each ray over the BVH (see the module docstring).
    On the card this launches K2 on `rows`, the table as
    ``kernel_rows(table)`` made beforehand, or on the table padded here when
    `rows` is None; on the CPU it runs the plain version on the table."""
    _check(nodes, table, o, d, maxt, rows)
    if nodes.device.type == "cpu":
        return bvh_sweep_reference(nodes, table, o, d, maxt, anyhit)
    if nodes.device.type != "cuda":
        raise ValueError(f"bvh_sweep: no kernel for device {nodes.device}")
    rows = kernel_rows(table) if rows is None else rows
    if nodes.data_ptr() % 16 or rows.data_ptr() % 16:
        raise ValueError("bvh_sweep: the nodes and rows must be 16-byte aligned (read as float4)")
    return launch_kernel(nodes, rows, o, d, maxt, anyhit)


class BVHSweepIntersect(torch.autograd.Function):
    """Closest hit over the BVH with the analytic VJP of the planar hit (the
    JAX package's bvh_sweep_intersect custom VJP)."""

    @staticmethod
    def forward(ctx, nodes, table, o, d, maxt, rows):
        t, prim, u, v = bvh_sweep(nodes, table, o, d, maxt, anyhit=False, rows=rows)
        ctx.save_for_backward(table, prim, t, u, v, d)
        ctx.mark_non_differentiable(prim)
        return t, prim, u, v

    @staticmethod
    def backward(ctx, g_t, _g_prim, g_u, g_v):
        table, prim, t, u, v, d = ctx.saved_tensors
        ct_table, ct_o, ct_d = hit_vjp(table, prim, t, u, v, d, g_t, g_u, g_v)
        return None, ct_table, ct_o, ct_d, None, None


def bvh_sweep_intersect(nodes, table, o, d, maxt, rows=None):
    """Differentiable closest hit of each ray: (t, prim, u, v). `rows`, as
    in ``bvh_sweep``, carries no gradient: the cotangent reaches `table`."""
    return BVHSweepIntersect.apply(nodes, table, o, d, maxt, rows)


def bvh_sweep_occluded(nodes, table, o, d, maxt, rows=None):
    """Whether each ray hits anything before its maxt: bool [N], without a
    gradient."""
    return bvh_sweep(nodes, table.detach(), o.detach(), d.detach(), maxt.detach(),
                     anyhit=True, rows=rows)[1] >= 0


bvh_sweep_intersect.launches = 0
bvh_sweep_occluded.launches = 0
