// Binned-SAH BVH builder producing a *threaded* flat layout for stackless
// traversal, one thread per ray.
//
// The port's own copy of the JAX package's native/src/bvh.cpp (its wide-leaf
// entry only), built with the host compiler (ops/cuda_build.py:build_host),
// so that the port's nodes and leaf order equal the JAX package's bitwise.
// The analog of the reference's Embree BVH build / kd-tree construction
// (src/render/scene_embree.inl, kdtree.h): CONSTRUCTION is host-side native
// code; TRAVERSAL is kernel K2 (csrc/bvh_sweep.cu) and its plain PyTorch
// version (ops/bvh_sweep.py).
//
// Threaded layout (DFS order), one node = 8 x f32:
//   [0:3] bbox lo   [3:6] bbox hi
//   [6]   bitcast int: skip index (next node if this subtree is missed/done;
//         -1 = end of traversal)
//   [7]   bitcast int: leaf payload = (prim_start << 8) | count for leaves
//         (count in 1..255), or 0 for internal nodes.
// Traversal rule per lane: if bbox hit -> for internal, next = i + 1;
// for leaf, intersect prims [start, start+count) then next = skip.
// If bbox missed -> next = skip.  Primitives are referenced through a
// reordered index table so leaf prims are contiguous.
#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct AABB {
    float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    void grow(const float *p) {
        for (int k = 0; k < 3; k++) {
            lo[k] = std::min(lo[k], p[k]);
            hi[k] = std::max(hi[k], p[k]);
        }
    }
    void grow(const AABB &b) {
        for (int k = 0; k < 3; k++) {
            lo[k] = std::min(lo[k], b.lo[k]);
            hi[k] = std::max(hi[k], b.hi[k]);
        }
    }
    float area() const {
        float d[3] = {hi[0] - lo[0], hi[1] - lo[1], hi[2] - lo[2]};
        if (d[0] < 0 || d[1] < 0 || d[2] < 0) return 0.f;
        return 2.f * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]);
    }
};

struct Prim {
    AABB box;
    float centroid[3];
    int index;
};

struct BuildNode {
    AABB box;
    int left = -1, right = -1;     // children (build indices)
    int start = 0, count = 0;      // leaf range into prim array
};

constexpr int kBins = 16;

int build_recursive(std::vector<Prim> &prims, int start, int end,
                    std::vector<BuildNode> &nodes, int max_leaf) {
    BuildNode node;
    for (int i = start; i < end; i++) node.box.grow(prims[i].box);
    int n = end - start;
    int my = (int)nodes.size();
    nodes.push_back(node);

    if (n <= max_leaf) {
        nodes[my].start = start;
        nodes[my].count = n;
        return my;
    }

    // centroid bounds
    AABB cb;
    for (int i = start; i < end; i++) cb.grow(prims[i].centroid);
    int axis = 0;
    float ext[3] = {cb.hi[0] - cb.lo[0], cb.hi[1] - cb.lo[1], cb.hi[2] - cb.lo[2]};
    if (ext[1] > ext[0]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int mid;
    if (ext[axis] < 1e-12f) {
        mid = start + n / 2;   // degenerate: median split
    } else {
        // binned SAH
        AABB bin_box[kBins];
        int bin_cnt[kBins] = {0};
        float scale = kBins / ext[axis];
        for (int i = start; i < end; i++) {
            int b = (int)((prims[i].centroid[axis] - cb.lo[axis]) * scale);
            b = std::min(b, kBins - 1);
            bin_box[b].grow(prims[i].box);
            bin_cnt[b]++;
        }
        float right_area[kBins];
        AABB acc;
        int right_count[kBins];
        int rc = 0;
        for (int b = kBins - 1; b >= 1; b--) {
            acc.grow(bin_box[b]);
            rc += bin_cnt[b];
            right_area[b] = acc.area();
            right_count[b] = rc;
        }
        AABB lacc;
        int lc = 0;
        float best_cost = FLT_MAX;
        int best_bin = -1;
        for (int b = 0; b < kBins - 1; b++) {
            lacc.grow(bin_box[b]);
            lc += bin_cnt[b];
            if (lc == 0 || right_count[b + 1] == 0) continue;
            float cost = lacc.area() * lc + right_area[b + 1] * right_count[b + 1];
            if (cost < best_cost) { best_cost = cost; best_bin = b; }
        }
        if (best_bin < 0) {
            mid = start + n / 2;
        } else {
            float split = cb.lo[axis] + (best_bin + 1) * ext[axis] / kBins;
            auto it = std::partition(
                prims.begin() + start, prims.begin() + end,
                [&](const Prim &p) { return p.centroid[axis] < split; });
            mid = (int)(it - prims.begin());
            if (mid == start || mid == end) mid = start + n / 2;
        }
    }

    int l = build_recursive(prims, start, mid, nodes, max_leaf);
    int r = build_recursive(prims, mid, end, nodes, max_leaf);
    nodes[my].left = l;
    nodes[my].right = r;
    return my;
}

// Two-pass flatten: compute DFS order + subtree sizes, then fill skips.
void dfs_order(const std::vector<BuildNode> &nodes, int idx,
               std::vector<int> &order, std::vector<int> &size_of) {
    int my = (int)order.size();
    order.push_back(idx);
    size_of.push_back(1);
    if (nodes[idx].left >= 0) {
        dfs_order(nodes, nodes[idx].left, order, size_of);
        dfs_order(nodes, nodes[idx].right, order, size_of);
    }
    // subtree size = nodes emitted since my
    size_of[my] = (int)order.size() - my;
}

} // namespace

extern "C" {

// tris: [n_tris * 9] (v0 | e1 | e2).  Outputs:
//   nodes:      [n_nodes * 8] threaded-layout floats (see header comment);
//               the leaf payload is (prim_start << 8) | count with count in
//               1..max_leaf (max_leaf up to 255)
//   prim_order: [n_tris] permutation — leaf ranges index into this table
int mtpu_build_bvh_wide(const float *tris, int n_tris, int max_leaf,
                        float **nodes_out, int *n_nodes_out,
                        int **prim_order_out) {
    if (n_tris <= 0 || max_leaf < 1 || max_leaf > 255) return -1;
    std::vector<Prim> prims(n_tris);
    for (int i = 0; i < n_tris; i++) {
        const float *t = tris + i * 9;
        float p0[3] = {t[0], t[1], t[2]};
        float p1[3] = {t[0] + t[3], t[1] + t[4], t[2] + t[5]};
        float p2[3] = {t[0] + t[6], t[1] + t[7], t[2] + t[8]};
        prims[i].box.grow(p0);
        prims[i].box.grow(p1);
        prims[i].box.grow(p2);
        for (int k = 0; k < 3; k++)
            prims[i].centroid[k] = (prims[i].box.lo[k] + prims[i].box.hi[k]) * 0.5f;
        prims[i].index = i;
    }

    std::vector<BuildNode> bnodes;
    bnodes.reserve(2 * n_tris / std::max(max_leaf / 2, 1) + 64);
    build_recursive(prims, 0, n_tris, bnodes, max_leaf);

    std::vector<int> order, size_of;
    order.reserve(bnodes.size());
    dfs_order(bnodes, 0, order, size_of);

    int m = (int)order.size();
    float *flat = (float *)malloc((size_t)m * 8 * sizeof(float));
    for (int fi = 0; fi < m; fi++) {
        const BuildNode &n = bnodes[order[fi]];
        float *dst = flat + (size_t)fi * 8;
        memcpy(dst, n.box.lo, 12);
        memcpy(dst + 3, n.box.hi, 12);
        int32_t skip = fi + size_of[fi];
        if (skip >= m) skip = -1;
        int32_t payload = (n.left < 0) ? ((n.start << 8) | (n.count & 0xFF)) : 0;
        memcpy(dst + 6, &skip, 4);
        memcpy(dst + 7, &payload, 4);
    }

    int *perm = (int *)malloc((size_t)n_tris * sizeof(int));
    for (int i = 0; i < n_tris; i++) perm[i] = prims[i].index;

    *nodes_out = flat;
    *n_nodes_out = m;
    *prim_order_out = perm;
    return 0;
}

} // extern "C"
