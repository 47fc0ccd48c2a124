// Native mesh loaders: Wavefront OBJ and PLY (ascii + binary_little_endian).
//
// The port's own copy of the JAX package's native/src/mesh_io.cpp, built
// with the host compiler (ops/cuda_build.py:build_host). Scene build is
// host-side work where a C++ parser is 10-100x faster than Python line
// splitting for production meshes (the equivalent of the reference's
// src/shapes/{obj,ply}.cpp). Exposed through a minimal C ABI consumed via
// ctypes (mitsuba_tpu_torch/native.py).
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <string>
#include <vector>

namespace {

struct MeshData {
    std::vector<float> vertices;   // [V*3]
    std::vector<int>   faces;      // [F*3]
    std::vector<float> normals;    // [V*3] or empty
    std::vector<float> uvs;        // [V*2] or empty
};

int finish(MeshData &m, float **verts, int *n_verts, int **faces, int *n_faces,
           float **normals, int *has_normals, float **uvs, int *has_uvs) {
    size_t nv = m.vertices.size() / 3;
    size_t nf = m.faces.size() / 3;
    if (nv == 0 || nf == 0) return -2;

    *verts = (float *)malloc(m.vertices.size() * sizeof(float));
    memcpy(*verts, m.vertices.data(), m.vertices.size() * sizeof(float));
    *n_verts = (int)nv;

    *faces = (int *)malloc(m.faces.size() * sizeof(int));
    memcpy(*faces, m.faces.data(), m.faces.size() * sizeof(int));
    *n_faces = (int)nf;

    if (m.normals.size() == m.vertices.size()) {
        *normals = (float *)malloc(m.normals.size() * sizeof(float));
        memcpy(*normals, m.normals.data(), m.normals.size() * sizeof(float));
        *has_normals = 1;
    } else {
        *normals = nullptr;
        *has_normals = 0;
    }
    if (m.uvs.size() == nv * 2) {
        *uvs = (float *)malloc(m.uvs.size() * sizeof(float));
        memcpy(*uvs, m.uvs.data(), m.uvs.size() * sizeof(float));
        *has_uvs = 1;
    } else {
        *uvs = nullptr;
        *has_uvs = 0;
    }
    return 0;
}

} // namespace

extern "C" {

void mtpu_free(void *p) { free(p); }

// ---------------------------------------------------------------------------
// OBJ
// ---------------------------------------------------------------------------
int mtpu_load_obj(const char *path, float **verts, int *n_verts, int **faces,
                  int *n_faces, float **normals, int *has_normals,
                  float **uvs, int *has_uvs) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;

    MeshData m;
    std::vector<float> vn, vt;
    char line[4096];
    while (fgets(line, sizeof(line), f)) {
        if (line[0] == 'v' && line[1] == ' ') {
            float x, y, z;
            if (sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
                m.vertices.push_back(x);
                m.vertices.push_back(y);
                m.vertices.push_back(z);
            }
        } else if (line[0] == 'v' && line[1] == 'n') {
            float x, y, z;
            if (sscanf(line + 3, "%f %f %f", &x, &y, &z) == 3) {
                vn.push_back(x); vn.push_back(y); vn.push_back(z);
            }
        } else if (line[0] == 'v' && line[1] == 't') {
            float u, v;
            if (sscanf(line + 3, "%f %f", &u, &v) == 2) {
                vt.push_back(u); vt.push_back(v);
            }
        } else if (line[0] == 'f' && line[1] == ' ') {
            // parse up to 8 face corners (v, v/t, v//n, v/t/n), fan-triangulate
            int idx[8];
            int count = 0;
            char *p = line + 2;
            int nv_total = (int)(m.vertices.size() / 3);
            while (*p && count < 8) {
                while (*p == ' ' || *p == '\t') p++;
                if (*p == '\n' || *p == '\r' || *p == 0) break;
                long v = strtol(p, &p, 10);
                if (v < 0) v = nv_total + v + 1;
                idx[count++] = (int)(v - 1);
                // skip /t/n part
                while (*p && *p != ' ' && *p != '\t' && *p != '\n') p++;
            }
            for (int k = 1; k + 1 < count; k++) {
                m.faces.push_back(idx[0]);
                m.faces.push_back(idx[k]);
                m.faces.push_back(idx[k + 1]);
            }
        }
    }
    fclose(f);
    if (vn.size() == m.vertices.size()) m.normals = std::move(vn);
    if (vt.size() == (m.vertices.size() / 3) * 2) m.uvs = std::move(vt);
    return finish(m, verts, n_verts, faces, n_faces, normals, has_normals, uvs, has_uvs);
}

// ---------------------------------------------------------------------------
// PLY (ascii + binary_little_endian 1.0; float32/float64 properties)
// ---------------------------------------------------------------------------
int mtpu_load_ply(const char *path, float **verts, int *n_verts, int **faces,
                  int *n_faces, float **normals, int *has_normals,
                  float **uvs, int *has_uvs) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;

    char line[1024];
    bool binary = false;
    long n_vertex = 0, n_face = 0;
    std::vector<std::string> vprops;   // property order of the vertex element
    std::vector<int> vprop_size;       // bytes per property
    std::string cur_elem;
    std::string face_count_type = "uchar", face_index_type = "int";

    auto type_size = [](const std::string &t) -> int {
        if (t == "char" || t == "uchar" || t == "int8" || t == "uint8") return 1;
        if (t == "short" || t == "ushort" || t == "int16" || t == "uint16") return 2;
        if (t == "int" || t == "uint" || t == "int32" || t == "uint32" || t == "float" || t == "float32") return 4;
        if (t == "double" || t == "float64") return 8;
        return 4;
    };

    if (!fgets(line, sizeof(line), f) || strncmp(line, "ply", 3) != 0) {
        fclose(f); return -3;
    }
    while (fgets(line, sizeof(line), f)) {
        char a[64], b[256], c[64], d[64];
        if (sscanf(line, "%63s", a) != 1) continue;
        if (strcmp(a, "format") == 0) {
            sscanf(line, "%*s %255s", b);
            binary = (strncmp(b, "binary_little_endian", 20) == 0);
        } else if (strcmp(a, "element") == 0) {
            long n; sscanf(line, "%*s %63s %ld", c, &n);
            cur_elem = c;
            if (cur_elem == "vertex") n_vertex = n;
            else if (cur_elem == "face") n_face = n;
        } else if (strcmp(a, "property") == 0) {
            sscanf(line, "%*s %63s", c);
            if (strcmp(c, "list") == 0) {
                sscanf(line, "%*s %*s %63s %63s %255s", c, d, b);
                face_count_type = c;
                face_index_type = d;
            } else if (cur_elem == "vertex") {
                sscanf(line, "%*s %63s %255s", c, b);
                vprops.push_back(b);
                vprop_size.push_back(type_size(c));
            }
        } else if (strcmp(a, "end_header") == 0) {
            break;
        }
    }

    int ix = -1, iy = -1, iz = -1, inx = -1, iny = -1, inz = -1, iu = -1, iv = -1;
    for (size_t i = 0; i < vprops.size(); i++) {
        const std::string &p = vprops[i];
        if (p == "x") ix = (int)i; else if (p == "y") iy = (int)i;
        else if (p == "z") iz = (int)i;
        else if (p == "nx") inx = (int)i; else if (p == "ny") iny = (int)i;
        else if (p == "nz") inz = (int)i;
        else if (p == "u" || p == "s" || p == "texture_u") iu = (int)i;
        else if (p == "v" || p == "t" || p == "texture_v") iv = (int)i;
    }
    if (ix < 0 || iy < 0 || iz < 0 || n_vertex <= 0) { fclose(f); return -4; }

    MeshData m;
    m.vertices.resize(n_vertex * 3);
    bool want_n = inx >= 0 && iny >= 0 && inz >= 0;
    bool want_uv = iu >= 0 && iv >= 0;
    if (want_n) m.normals.resize(n_vertex * 3);
    if (want_uv) m.uvs.resize(n_vertex * 2);

    auto read_prop_bin = [&](int size, double *out) -> bool {
        unsigned char buf[8];
        if (fread(buf, 1, size, f) != (size_t)size) return false;
        if (size == 4) { float v; memcpy(&v, buf, 4); *out = v; }
        else if (size == 8) { double v; memcpy(&v, buf, 8); *out = v; }
        else if (size == 1) { *out = buf[0]; }
        else if (size == 2) { uint16_t v; memcpy(&v, buf, 2); *out = v; }
        return true;
    };

    std::vector<double> row(vprops.size());
    for (long i = 0; i < n_vertex; i++) {
        if (binary) {
            for (size_t k = 0; k < vprops.size(); k++)
                if (!read_prop_bin(vprop_size[k], &row[k])) { fclose(f); return -5; }
        } else {
            for (size_t k = 0; k < vprops.size(); k++)
                if (fscanf(f, "%lf", &row[k]) != 1) { fclose(f); return -5; }
        }
        m.vertices[i * 3 + 0] = (float)row[ix];
        m.vertices[i * 3 + 1] = (float)row[iy];
        m.vertices[i * 3 + 2] = (float)row[iz];
        if (want_n) {
            m.normals[i * 3 + 0] = (float)row[inx];
            m.normals[i * 3 + 1] = (float)row[iny];
            m.normals[i * 3 + 2] = (float)row[inz];
        }
        if (want_uv) {
            m.uvs[i * 2 + 0] = (float)row[iu];
            m.uvs[i * 2 + 1] = (float)row[iv];
        }
    }

    int cnt_size = type_size(face_count_type);
    int idx_size = type_size(face_index_type);
    for (long i = 0; i < n_face; i++) {
        long cnt = 0;
        if (binary) {
            double d0;
            if (!read_prop_bin(cnt_size, &d0)) { fclose(f); return -6; }
            cnt = (long)d0;
        } else {
            if (fscanf(f, "%ld", &cnt) != 1) { fclose(f); return -6; }
        }
        std::vector<long> ids(cnt);
        for (long k = 0; k < cnt; k++) {
            if (binary) {
                unsigned char buf[8];
                if (fread(buf, 1, idx_size, f) != (size_t)idx_size) { fclose(f); return -6; }
                if (idx_size == 4) { int32_t v; memcpy(&v, buf, 4); ids[k] = v; }
                else if (idx_size == 2) { uint16_t v; memcpy(&v, buf, 2); ids[k] = v; }
                else { ids[k] = buf[0]; }
            } else {
                if (fscanf(f, "%ld", &ids[k]) != 1) { fclose(f); return -6; }
            }
        }
        for (long k = 1; k + 1 < cnt; k++) {
            m.faces.push_back((int)ids[0]);
            m.faces.push_back((int)ids[k]);
            m.faces.push_back((int)ids[k + 1]);
        }
    }
    fclose(f);
    return finish(m, verts, n_verts, faces, n_faces, normals, has_normals, uvs, has_uvs);
}

} // extern "C"
