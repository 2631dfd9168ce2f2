// deepim_native: the host runtime of deepim_tpu_torch, C++ bound with ctypes
// (deepim_tpu_torch/native.py).
//
// A copy of the reference package's native/src/deepim_native.cpp, entry point
// for entry point and statement for statement (but for the PNG unfilter,
// whose loops are split by filter type), so that each helper gives the
// reference's bits.  It is built with the reference's flags (-O2 -std=c++17
// -fPIC, linked with -lz -lpthread) into deepim_tpu_torch/_build/.  It holds
//   - PLY mesh parsing (ascii + binary_little_endian) and OBJ geometry
//     parsing (v/vt/f, corner dedup, fan triangulation),
//   - vertex normals, area-weighted surface sampling, grid decimation,
//   - PNG decode (zlib inflate + unfilter; 8-bit grey, grey + alpha, RGB,
//     RGBA and 16-bit grey, non-interlaced; anything else is refused),
//   - a threaded file prefetcher with a bounded ring buffer.
//
// Everything returns malloc'd buffers the caller frees via dn_free.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

#include <atomic>
#include <condition_variable>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <zlib.h>

extern "C" {

void dn_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// PLY loading
// ---------------------------------------------------------------------------

struct PlyProp {
  std::string type;       // scalar type, or list count type
  std::string list_type;  // list element type ("" if scalar)
  std::string name;
};

static int type_size(const std::string& t) {
  if (t == "float" || t == "float32" || t == "int" || t == "int32" ||
      t == "uint" || t == "uint32")
    return 4;
  if (t == "double" || t == "float64") return 8;
  if (t == "uchar" || t == "uint8" || t == "char" || t == "int8") return 1;
  if (t == "ushort" || t == "uint16" || t == "short" || t == "int16") return 2;
  return -1;
}

static double read_scalar(const uint8_t* p, const std::string& t) {
  if (t == "float" || t == "float32") { float v; memcpy(&v, p, 4); return v; }
  if (t == "double" || t == "float64") { double v; memcpy(&v, p, 8); return v; }
  if (t == "uchar" || t == "uint8") return *p;
  if (t == "char" || t == "int8") return *(const int8_t*)p;
  if (t == "ushort" || t == "uint16") { uint16_t v; memcpy(&v, p, 2); return v; }
  if (t == "short" || t == "int16") { int16_t v; memcpy(&v, p, 2); return v; }
  if (t == "uint" || t == "uint32") { uint32_t v; memcpy(&v, p, 4); return v; }
  if (t == "int" || t == "int32") { int32_t v; memcpy(&v, p, 4); return v; }
  return 0.0;
}

// Loads a PLY mesh. Returns 0 on success.  Outputs (caller dn_free's):
//   vertices: (num_vertices*3) float32; colors: same (0.7 default);
//   faces: (num_faces*3) int32 (polygons fan-triangulated).
int dn_load_ply(const char* path, float** vertices, float** colors,
                int32_t** faces, int64_t* num_vertices, int64_t* num_faces) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  // Read whole file.
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size);
  if (fread(buf.data(), 1, size, f) != (size_t)size) { fclose(f); return -2; }
  fclose(f);

  // Parse header (ascii lines until end_header).
  size_t pos = 0;
  auto next_line = [&](std::string& line) -> bool {
    if (pos >= buf.size()) return false;
    size_t start = pos;
    while (pos < buf.size() && buf[pos] != '\n') pos++;
    line.assign((const char*)&buf[start], pos - start);
    if (!line.empty() && line.back() == '\r') line.pop_back();
    pos++;  // skip newline
    return true;
  };
  std::string line;
  if (!next_line(line) || line != "ply") return -3;
  std::string fmt;
  struct Element { std::string name; long count; std::vector<PlyProp> props; };
  std::vector<Element> elements;
  while (next_line(line)) {
    if (line == "end_header") break;
    char a[64], b[64], c[64], d[64], e[64];
    if (sscanf(line.c_str(), "format %63s", a) == 1) {
      fmt = a;
    } else if (sscanf(line.c_str(), "element %63s %63s", a, b) == 2) {
      elements.push_back({a, atol(b), {}});
    } else if (sscanf(line.c_str(), "property list %63s %63s %63s", a, b, c) == 3) {
      elements.back().props.push_back({a, b, c});
    } else if (sscanf(line.c_str(), "property %63s %63s", d, e) == 2) {
      elements.back().props.push_back({d, "", e});
    }
  }

  std::vector<float> verts, cols;
  std::vector<int32_t> tris;
  bool has_color = false;

  for (auto& el : elements) {
    bool is_vertex = el.name == "vertex";
    bool is_face = el.name == "face";
    int xi = -1, yi = -1, zi = -1, ri = -1, gi = -1, bi = -1;
    for (size_t i = 0; i < el.props.size(); i++) {
      const auto& n = el.props[i].name;
      if (n == "x") xi = i;
      if (n == "y") yi = i;
      if (n == "z") zi = i;
      if (n == "red") ri = i;
      if (n == "green") gi = i;
      if (n == "blue") bi = i;
    }
    if (is_vertex) {
      verts.reserve(el.count * 3);
      cols.reserve(el.count * 3);
      has_color = ri >= 0;
    }

    if (fmt == "ascii") {
      for (long r = 0; r < el.count; r++) {
        if (!next_line(line)) return -4;
        // tokenize
        std::vector<double> vals;
        std::vector<long> list_vals;
        const char* s = line.c_str();
        char* end;
        if (is_face) {
          long n = strtol(s, &end, 10);
          s = end;
          for (long k = 0; k < n; k++) list_vals.push_back(strtol(s, &end, 10)), s = end;
        } else {
          for (size_t pi = 0; pi < el.props.size(); pi++) {
            vals.push_back(strtod(s, &end));
            s = end;
          }
        }
        if (is_vertex) {
          verts.push_back((float)vals[xi]);
          verts.push_back((float)vals[yi]);
          verts.push_back((float)vals[zi]);
          if (has_color) {
            cols.push_back((float)(vals[ri] / 255.0));
            cols.push_back((float)(vals[gi] / 255.0));
            cols.push_back((float)(vals[bi] / 255.0));
          }
        } else if (is_face) {
          for (size_t k = 1; k + 1 < list_vals.size(); k++) {
            tris.push_back((int32_t)list_vals[0]);
            tris.push_back((int32_t)list_vals[k]);
            tris.push_back((int32_t)list_vals[k + 1]);
          }
        }
      }
    } else if (fmt == "binary_little_endian") {
      for (long r = 0; r < el.count; r++) {
        std::vector<double> vals(el.props.size());
        std::vector<long> list_vals;
        bool got_list = false;
        for (size_t pi = 0; pi < el.props.size(); pi++) {
          const auto& p = el.props[pi];
          if (!p.list_type.empty()) {
            int cs = type_size(p.type);
            if (pos + cs > buf.size()) return -6;
            long n = (long)read_scalar(&buf[pos], p.type);
            pos += cs;
            int es = type_size(p.list_type);
            if (n < 0 || pos + (size_t)n * es > buf.size()) return -6;
            if (!got_list) {
              // Only the FIRST list property holds the vertex indices; a
              // second list (YCB-style per-face float texcoords) must be
              // skipped, not fan-triangulated as bogus faces.
              for (long k = 0; k < n; k++) {
                list_vals.push_back((long)read_scalar(&buf[pos], p.list_type));
                pos += es;
              }
              got_list = true;
            } else {
              pos += (size_t)n * es;
            }
          } else {
            int cs = type_size(p.type);
            if (pos + cs > buf.size()) return -6;
            vals[pi] = read_scalar(&buf[pos], p.type);
            pos += cs;
          }
        }
        if (is_vertex) {
          verts.push_back((float)vals[xi]);
          verts.push_back((float)vals[yi]);
          verts.push_back((float)vals[zi]);
          if (has_color) {
            cols.push_back((float)(vals[ri] / 255.0));
            cols.push_back((float)(vals[gi] / 255.0));
            cols.push_back((float)(vals[bi] / 255.0));
          }
        } else if (is_face) {
          for (size_t k = 1; k + 1 < list_vals.size(); k++) {
            tris.push_back((int32_t)list_vals[0]);
            tris.push_back((int32_t)list_vals[k]);
            tris.push_back((int32_t)list_vals[k + 1]);
          }
        }
      }
    } else {
      return -5;  // big-endian unsupported (not used by LM6d/YCB assets)
    }
  }

  int64_t nv = verts.size() / 3;
  int64_t nf = tris.size() / 3;
  if (!has_color) {
    cols.assign(nv * 3, 0.7f);
  }
  *vertices = (float*)malloc(nv * 3 * sizeof(float));
  *colors = (float*)malloc(nv * 3 * sizeof(float));
  *faces = (int32_t*)malloc(nf * 3 * sizeof(int32_t));
  memcpy(*vertices, verts.data(), nv * 3 * sizeof(float));
  memcpy(*colors, cols.data(), nv * 3 * sizeof(float));
  memcpy(*faces, tris.data(), nf * 3 * sizeof(int32_t));
  *num_vertices = nv;
  *num_faces = nf;
  return 0;
}

// ---------------------------------------------------------------------------
// OBJ loading (geometry fast path; YCB textured.obj scans run to ~1M lines
// and the Python line loop takes seconds).  Parses v/vt/f (+ the Meshlab
// per-vertex-color extension), fan-triangulates polygons, supports
// negative (relative) indices, and deduplicates (position, uv) corner
// pairs so UVs live per output vertex — the same unification the Python
// loader (raster/mesh.py §load_obj) performs.  Material handling stays in
// Python: this returns the first mtllib filename + the count of distinct
// usemtl names so the caller knows whether the single-texture bake is
// valid or the per-face-material Python path is needed.
// ---------------------------------------------------------------------------

// Outputs (caller dn_free's everything):
//   vertices (V*3) f32; colors (V*3) f32 (0.7 default / v-line colors);
//   uvs (V*2) f32 (meaningful iff *has_uv); faces (F*3) i32;
//   mtllib: first "mtllib" filename as a NUL-terminated string or NULL.
//   num_materials: distinct usemtl names seen.
// Returns 0 on success.
int dn_load_obj(const char* path, float** vertices, float** colors,
                float** uvs, int32_t** faces, char** mtllib,
                int64_t* num_vertices, int64_t* num_faces,
                int32_t* has_uv, int32_t* num_materials) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (fread(buf.data(), 1, size, f) != (size_t)size) { fclose(f); return -2; }
  fclose(f);
  buf[size] = '\0';

  std::vector<float> pos;      // raw v records (3 per)
  std::vector<float> vcol;     // optional v-line colors (3 per, parallel)
  std::vector<float> vt;       // raw vt records (2 per)
  std::vector<int64_t> corner_keys;  // flattened (v, t) per face corner
  std::vector<int32_t> face_sizes;
  bool any_vcol = false, any_uv_ref = false;
  std::vector<std::string> mat_names;
  *mtllib = nullptr;

  char* p = buf.data();
  char* end = buf.data() + size;
  while (p < end) {
    // find line end
    char* nl = (char*)memchr(p, '\n', end - p);
    char* line_end = nl ? nl : end;
    // strtok-free manual parse
    if (p + 1 < line_end && p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      char* q = p + 2;
      double a = strtod(q, &q), b = strtod(q, &q), c = strtod(q, &q);
      pos.push_back((float)a); pos.push_back((float)b); pos.push_back((float)c);
      // Meshlab extension: v x y z r g b
      char* q2 = q;
      double r = strtod(q2, &q2);
      if (q2 != q && q2 <= line_end) {
        double g = strtod(q2, &q2), bl = strtod(q2, &q2);
        vcol.push_back((float)r); vcol.push_back((float)g);
        vcol.push_back((float)bl);
        any_vcol = true;
      } else {
        vcol.push_back(0.7f); vcol.push_back(0.7f); vcol.push_back(0.7f);
      }
    } else if (p + 2 < line_end && p[0] == 'v' && p[1] == 't' &&
               (p[2] == ' ' || p[2] == '\t')) {
      char* q = p + 3;
      double u = strtod(q, &q), v = strtod(q, &q);
      vt.push_back((float)u); vt.push_back((float)v);
    } else if (p + 1 < line_end && p[0] == 'f' &&
               (p[1] == ' ' || p[1] == '\t')) {
      char* q = p + 2;
      int corners = 0;
      while (q < line_end) {
        while (q < line_end && (*q == ' ' || *q == '\t')) q++;
        if (q >= line_end || *q == '\r') break;
        char* tok_end = q;
        long vi = strtol(q, &tok_end, 10);
        if (tok_end == q) break;
        q = tok_end;
        long ti = 0;  // 0 = none (1-based below)
        if (q < line_end && *q == '/') {
          q++;
          if (q < line_end && *q != '/') {
            ti = strtol(q, &q, 10);
          }
          if (q < line_end && *q == '/') {  // skip normal index
            q++;
            strtol(q, &q, 10);
          }
        }
        long v_abs = vi > 0 ? vi - 1 : (long)(pos.size() / 3) + vi;
        long t_abs = ti == 0 ? -1
                             : (ti > 0 ? ti - 1 : (long)(vt.size() / 2) + ti);
        if (t_abs >= 0) any_uv_ref = true;
        corner_keys.push_back(((int64_t)v_abs << 32) | (uint32_t)(t_abs + 1));
        corners++;
      }
      face_sizes.push_back(corners);
    } else if (line_end - p > 7 && memcmp(p, "mtllib ", 7) == 0 &&
               *mtllib == nullptr) {
      const char* s = p + 7;
      while (s < line_end && (*s == ' ' || *s == '\t')) s++;
      const char* e = line_end;
      while (e > s && (e[-1] == '\r' || e[-1] == ' ')) e--;
      *mtllib = (char*)malloc(e - s + 1);
      memcpy(*mtllib, s, e - s);
      (*mtllib)[e - s] = '\0';
    } else if (line_end - p > 7 && memcmp(p, "usemtl ", 7) == 0) {
      std::string name(p + 7, line_end - (p + 7));
      while (!name.empty() && (name.back() == '\r' || name.back() == ' '))
        name.pop_back();
      bool seen = false;
      for (const auto& m : mat_names) seen = seen || m == name;
      if (!seen) mat_names.push_back(name);
    }
    p = nl ? nl + 1 : end;
  }

  const bool use_uv = any_uv_ref && !vt.empty();
  // Corner dedup -> unified output vertices.
  std::unordered_map<int64_t, int32_t> corner_map;
  std::vector<float> out_pos, out_col, out_uv;
  std::vector<int32_t> tris;
  size_t ci = 0;
  std::vector<int32_t> poly;  // corner ids of the current face
  for (int32_t fs : face_sizes) {
    poly.clear();
    for (int32_t k = 0; k < fs; k++, ci++) {
      int64_t key = corner_keys[ci];
      long v_abs = (long)(key >> 32);
      long t_abs = (long)(uint32_t)key - 1;
      if (v_abs < 0 || v_abs >= (long)(pos.size() / 3)) return -3;
      int32_t id;
      if (!use_uv) {
        id = (int32_t)v_abs;
      } else {
        auto it = corner_map.find(key);
        if (it != corner_map.end()) {
          id = it->second;
        } else {
          id = (int32_t)(out_pos.size() / 3);
          corner_map.emplace(key, id);
          out_pos.push_back(pos[v_abs * 3]);
          out_pos.push_back(pos[v_abs * 3 + 1]);
          out_pos.push_back(pos[v_abs * 3 + 2]);
          out_col.push_back(vcol[v_abs * 3]);
          out_col.push_back(vcol[v_abs * 3 + 1]);
          out_col.push_back(vcol[v_abs * 3 + 2]);
          if (t_abs >= 0 && t_abs < (long)(vt.size() / 2)) {
            out_uv.push_back(vt[t_abs * 2]);
            out_uv.push_back(vt[t_abs * 2 + 1]);
          } else {
            out_uv.push_back(0.0f);
            out_uv.push_back(0.0f);
          }
        }
      }
      poly.push_back(id);
    }
    for (size_t k = 1; k + 1 < poly.size(); k++) {
      tris.push_back(poly[0]);
      tris.push_back(poly[k]);
      tris.push_back(poly[k + 1]);
    }
  }

  int64_t nv = use_uv ? (int64_t)(out_pos.size() / 3)
                      : (int64_t)(pos.size() / 3);
  int64_t nf = (int64_t)(tris.size() / 3);
  *vertices = (float*)malloc(nv * 3 * sizeof(float));
  *colors = (float*)malloc(nv * 3 * sizeof(float));
  *uvs = (float*)malloc((nv > 0 ? nv : 1) * 2 * sizeof(float));
  *faces = (int32_t*)malloc((nf > 0 ? nf : 1) * 3 * sizeof(int32_t));
  if (use_uv) {
    memcpy(*vertices, out_pos.data(), nv * 3 * sizeof(float));
    memcpy(*colors, out_col.data(), nv * 3 * sizeof(float));
    memcpy(*uvs, out_uv.data(), nv * 2 * sizeof(float));
  } else {
    memcpy(*vertices, pos.data(), nv * 3 * sizeof(float));
    memcpy(*colors, vcol.data(), nv * 3 * sizeof(float));
    memset(*uvs, 0, nv * 2 * sizeof(float));
  }
  if (nf > 0) memcpy(*faces, tris.data(), nf * 3 * sizeof(int32_t));
  *num_vertices = nv;
  *num_faces = nf;
  *has_uv = use_uv ? 1 : 0;
  *num_materials = (int32_t)mat_names.size();
  (void)any_vcol;
  return nv > 0 ? 0 : -4;
}

// ---------------------------------------------------------------------------
// Mesh ops: normals, sampling, decimation
// ---------------------------------------------------------------------------

void dn_vertex_normals(const float* vertices, int64_t nv, const int32_t* faces,
                       int64_t nf, float* out_normals) {
  memset(out_normals, 0, nv * 3 * sizeof(float));
  for (int64_t i = 0; i < nf; i++) {
    const int32_t* fc = &faces[i * 3];
    const float* v0 = &vertices[fc[0] * 3];
    const float* v1 = &vertices[fc[1] * 3];
    const float* v2 = &vertices[fc[2] * 3];
    float e1[3] = {v1[0] - v0[0], v1[1] - v0[1], v1[2] - v0[2]};
    float e2[3] = {v2[0] - v0[0], v2[1] - v0[1], v2[2] - v0[2]};
    float n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                  e1[2] * e2[0] - e1[0] * e2[2],
                  e1[0] * e2[1] - e1[1] * e2[0]};  // area-weighted
    for (int k = 0; k < 3; k++)
      for (int d = 0; d < 3; d++) out_normals[fc[k] * 3 + d] += n[d];
  }
  for (int64_t i = 0; i < nv; i++) {
    float* n = &out_normals[i * 3];
    float len = sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (len > 1e-12f) { n[0] /= len; n[1] /= len; n[2] /= len; }
  }
}

// xorshift RNG (deterministic across platforms)
static inline uint64_t xorshift64(uint64_t* s) {
  uint64_t x = *s;
  x ^= x << 13; x ^= x >> 7; x ^= x << 17;
  return *s = x;
}
static inline double rng01(uint64_t* s) {
  return (double)(xorshift64(s) >> 11) * (1.0 / 9007199254740992.0);
}

void dn_sample_points(const float* vertices, int64_t nv, const int32_t* faces,
                      int64_t nf, int64_t n, uint64_t seed, float* out) {
  (void)nv;
  if (nf <= 0 || n <= 0) {  // no faces: nothing to sample (caller guards)
    if (n > 0) memset(out, 0, (size_t)n * 3 * sizeof(float));
    return;
  }
  std::vector<double> cdf(nf);
  double total = 0.0;
  for (int64_t i = 0; i < nf; i++) {
    const int32_t* fc = &faces[i * 3];
    const float* v0 = &vertices[fc[0] * 3];
    const float* v1 = &vertices[fc[1] * 3];
    const float* v2 = &vertices[fc[2] * 3];
    float e1[3] = {v1[0] - v0[0], v1[1] - v0[1], v1[2] - v0[2]};
    float e2[3] = {v2[0] - v0[0], v2[1] - v0[1], v2[2] - v0[2]};
    float cx = e1[1] * e2[2] - e1[2] * e2[1];
    float cy = e1[2] * e2[0] - e1[0] * e2[2];
    float cz = e1[0] * e2[1] - e1[1] * e2[0];
    total += 0.5 * sqrt((double)cx * cx + (double)cy * cy + (double)cz * cz);
    cdf[i] = total;
  }
  uint64_t s = seed ? seed : 0x9E3779B97F4A7C15ull;
  for (int64_t i = 0; i < n; i++) {
    double u = rng01(&s) * total;
    int64_t lo = 0, hi = nf - 1;
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (cdf[mid] < u) lo = mid + 1; else hi = mid;
    }
    const int32_t* fc = &faces[lo * 3];
    const float* v0 = &vertices[fc[0] * 3];
    const float* v1 = &vertices[fc[1] * 3];
    const float* v2 = &vertices[fc[2] * 3];
    double r1 = rng01(&s), r2 = rng01(&s);
    double sq = sqrt(r1);
    double w0 = 1.0 - sq, w1 = sq * (1.0 - r2), w2 = sq * r2;
    for (int d = 0; d < 3; d++)
      out[i * 3 + d] = (float)(w0 * v0[d] + w1 * v1[d] + w2 * v2[d]);
  }
}

// Vertex-clustering decimation onto a uniform grid (binary-searched
// resolution so the result has <= max_faces faces).  Outputs malloc'd
// arrays; returns 0 on success.
int dn_decimate(const float* vertices, const float* colors, int64_t nv,
                const int32_t* faces, int64_t nf, int64_t max_faces,
                float** out_v, float** out_c, int32_t** out_f,
                int64_t* out_nv, int64_t* out_nf) {
  if (nf <= max_faces) return 1;  // caller keeps original
  float vmin[3] = {1e30f, 1e30f, 1e30f}, vmax[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < nv; i++)
    for (int d = 0; d < 3; d++) {
      vmin[d] = vertices[i * 3 + d] < vmin[d] ? vertices[i * 3 + d] : vmin[d];
      vmax[d] = vertices[i * 3 + d] > vmax[d] ? vertices[i * 3 + d] : vmax[d];
    }
  float extent = 1e-9f;
  for (int d = 0; d < 3; d++)
    extent = vmax[d] - vmin[d] > extent ? vmax[d] - vmin[d] : extent;

  std::vector<float> best_v, best_c;
  std::vector<int32_t> best_f;
  int lo = 4, hi = 512;
  while (lo <= hi) {
    int res = (lo + hi) / 2;
    std::unordered_map<int64_t, int32_t> cell_id;
    std::vector<int32_t> remap(nv);
    std::vector<double> acc_v, acc_c;
    std::vector<int32_t> cnt;
    for (int64_t i = 0; i < nv; i++) {
      int64_t key = 0;
      for (int d = 0; d < 3; d++) {
        int64_t c = (int64_t)((vertices[i * 3 + d] - vmin[d]) / extent *
                              (res - 1e-4));
        key = key * res + c;
      }
      auto it = cell_id.find(key);
      int32_t id;
      if (it == cell_id.end()) {
        id = (int32_t)cnt.size();
        cell_id.emplace(key, id);
        acc_v.resize(acc_v.size() + 3, 0.0);
        acc_c.resize(acc_c.size() + 3, 0.0);
        cnt.push_back(0);
      } else {
        id = it->second;
      }
      remap[i] = id;
      cnt[id]++;
      for (int d = 0; d < 3; d++) {
        acc_v[id * 3 + d] += vertices[i * 3 + d];
        acc_c[id * 3 + d] += colors[i * 3 + d];
      }
    }
    // faces: drop degenerate, dedupe by sorted key
    std::unordered_map<int64_t, char> seen;
    std::vector<int32_t> nfaces;
    int64_t ncell = (int64_t)cnt.size();
    for (int64_t i = 0; i < nf; i++) {
      int32_t a = remap[faces[i * 3]], b = remap[faces[i * 3 + 1]],
              c = remap[faces[i * 3 + 2]];
      if (a == b || b == c || a == c) continue;
      int32_t s0 = a, s1 = b, s2 = c, t;
      if (s0 > s1) { t = s0; s0 = s1; s1 = t; }
      if (s1 > s2) { t = s1; s1 = s2; s2 = t; }
      if (s0 > s1) { t = s0; s0 = s1; s1 = t; }
      int64_t key = ((int64_t)s0 * ncell + s1) * ncell + s2;
      if (seen.count(key)) continue;
      seen.emplace(key, 1);
      nfaces.push_back(a); nfaces.push_back(b); nfaces.push_back(c);
    }
    if ((int64_t)nfaces.size() / 3 <= max_faces) {
      best_v.resize(ncell * 3);
      best_c.resize(ncell * 3);
      for (int64_t i = 0; i < ncell; i++)
        for (int d = 0; d < 3; d++) {
          best_v[i * 3 + d] = (float)(acc_v[i * 3 + d] / cnt[i]);
          best_c[i * 3 + d] = (float)(acc_c[i * 3 + d] / cnt[i]);
        }
      best_f = nfaces;
      lo = res + 1;  // try finer
    } else {
      hi = res - 1;
    }
  }
  if (best_f.empty()) return -1;
  *out_nv = best_v.size() / 3;
  *out_nf = best_f.size() / 3;
  *out_v = (float*)malloc(best_v.size() * sizeof(float));
  *out_c = (float*)malloc(best_c.size() * sizeof(float));
  *out_f = (int32_t*)malloc(best_f.size() * sizeof(int32_t));
  memcpy(*out_v, best_v.data(), best_v.size() * sizeof(float));
  memcpy(*out_c, best_c.data(), best_c.size() * sizeof(float));
  memcpy(*out_f, best_f.data(), best_f.size() * sizeof(int32_t));
  return 0;
}

// ---------------------------------------------------------------------------
// PNG decode (LM6d color/depth/label files): zlib inflate + unfilter.
// Supports 8-bit gray/RGB/RGBA and 16-bit gray, non-interlaced.
// ---------------------------------------------------------------------------

static inline uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | p[3];
}

// Returns 0 on success; out buffer is malloc'd row-major
// (h, w, channels) with native-endian uint8/uint16 samples.
int dn_decode_png(const uint8_t* data, int64_t len, uint8_t** out,
                  int32_t* width, int32_t* height, int32_t* channels,
                  int32_t* bitdepth) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (len < 8 || memcmp(data, sig, 8) != 0) return -1;
  int64_t pos = 8;
  uint32_t w = 0, h = 0;
  int depth = 0, ctype = -1;
  std::vector<uint8_t> idat;
  while (pos + 8 <= len) {
    uint32_t clen = be32(&data[pos]);
    // chunk body + crc must fit the buffer (truncated/corrupt PNGs must
    // fail cleanly, not read out of bounds)
    if ((int64_t)clen > len - 12 - pos) return -2;
    const char* tag = (const char*)&data[pos + 4];
    const uint8_t* body = &data[pos + 8];
    if (memcmp(tag, "IHDR", 4) == 0) {
      if (clen < 13) return -2;
      w = be32(body);
      h = be32(body + 4);
      depth = body[8];
      ctype = body[9];
      if (body[10] != 0 || body[11] != 0 || body[12] != 0) return -2;
    } else if (memcmp(tag, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + clen);
    } else if (memcmp(tag, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + clen;  // len + tag + crc
  }
  int ch = ctype == 0 ? 1 : ctype == 2 ? 3 : ctype == 4 ? 2 : ctype == 6 ? 4 : -1;
  if (ch < 0 || (depth != 8 && depth != 16)) return -3;
  if (depth == 16 && ctype != 0) return -3;  // 16-bit only for gray (depth pngs)

  int bpp = ch * depth / 8;           // bytes per pixel
  size_t stride = (size_t)w * bpp;    // bytes per scanline (post-filter)
  std::vector<uint8_t> raw((stride + 1) * h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return -4;

  uint8_t* img = (uint8_t*)malloc(stride * h);
  // The reference's per-byte loop (a, b, c and a switch for every byte)
  // becomes one loop per filter type with the first `lead` bytes of a row
  // (no left neighbour: a = c = 0) peeled off, and the first row's missing
  // up row read as zeros.  The arithmetic is the reference's, so the bytes
  // are.
  const std::vector<uint8_t> zero_row(stride, 0);
  const size_t lead = (size_t)bpp < stride ? (size_t)bpp : stride;
  for (uint32_t y = 0; y < h; y++) {
    int filter = raw[y * (stride + 1)];
    const uint8_t* src = &raw[y * (stride + 1) + 1];
    uint8_t* dst = &img[y * stride];
    const uint8_t* up = y ? &img[(y - 1) * stride] : zero_row.data();
    switch (filter) {
      case 0:
        memcpy(dst, src, stride);
        break;
      case 1:
        memcpy(dst, src, lead);
        for (size_t x = lead; x < stride; x++) dst[x] = (uint8_t)(src[x] + dst[x - bpp]);
        break;
      case 2:
        for (size_t x = 0; x < stride; x++) dst[x] = (uint8_t)(src[x] + up[x]);
        break;
      case 3:
        for (size_t x = 0; x < lead; x++) dst[x] = (uint8_t)(src[x] + up[x] / 2);
        for (size_t x = lead; x < stride; x++)
          dst[x] = (uint8_t)(src[x] + (dst[x - bpp] + up[x]) / 2);
        break;
      case 4:
        for (size_t x = 0; x < lead; x++) dst[x] = (uint8_t)(src[x] + up[x]);  // a = c = 0
        for (size_t x = lead; x < stride; x++) {
          int a = dst[x - bpp], b = up[x], c = up[x - bpp];
          int p = a + b - c;
          int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          dst[x] = (uint8_t)(src[x] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c)));
        }
        break;
      default: free(img); return -5;
    }
  }
  if (depth == 16) {
    // big-endian -> host-endian uint16
    for (size_t i = 0; i + 1 < stride * h; i += 2) {
      uint8_t hi_b = img[i], lo_b = img[i + 1];
      uint16_t v = (uint16_t)((hi_b << 8) | lo_b);
      memcpy(&img[i], &v, 2);
    }
  }
  *out = img;
  *width = (int32_t)w;
  *height = (int32_t)h;
  *channels = ch;
  *bitdepth = depth;
  return 0;
}

// ---------------------------------------------------------------------------
// Threaded file prefetcher (bounded ring buffer, in-order delivery)
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_produced, cv_space;
  std::unordered_map<int64_t, std::pair<uint8_t*, int64_t>> ready;
  std::atomic<int64_t> next_to_read{0};
  int64_t next_to_deliver = 0;
  size_t capacity;
  bool stop = false;

  void worker() {
    for (;;) {
      int64_t idx = next_to_read.fetch_add(1);
      if (idx >= (int64_t)paths.size()) return;
      FILE* f = fopen(paths[idx].c_str(), "rb");
      uint8_t* buf = nullptr;
      int64_t n = -1;
      if (f) {
        fseek(f, 0, SEEK_END);
        n = ftell(f);
        fseek(f, 0, SEEK_SET);
        buf = (uint8_t*)malloc(n > 0 ? n : 1);
        if (fread(buf, 1, n, f) != (size_t)n) { free(buf); buf = nullptr; n = -1; }
        fclose(f);
      }
      std::unique_lock<std::mutex> lk(mu);
      // Sliding-window admission: an item may enter iff it is within
      // `capacity` of the next delivery index.  A plain size bound can
      // deadlock — the ring fills with later indices while the worker
      // holding the next-needed index waits for space forever.
      cv_space.wait(lk, [&] {
        return stop || idx < next_to_deliver + (int64_t)capacity;
      });
      if (stop) { free(buf); return; }
      ready.emplace(idx, std::make_pair(buf, n));
      cv_produced.notify_all();
    }
  }
};

void* dn_prefetch_create(const char** paths, int64_t n, int32_t num_threads,
                         int32_t capacity) {
  auto* p = new Prefetcher();
  p->paths.assign(paths, paths + n);
  p->capacity = capacity > 0 ? capacity : 8;
  int nt = num_threads > 0 ? num_threads : 4;
  for (int i = 0; i < nt; i++)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// In-order delivery of the next file's bytes; returns file index, or -1 at
// end of the list.  *out is malloc'd (dn_free), *len = -1 on read error.
int64_t dn_prefetch_next(void* handle, uint8_t** out, int64_t* len) {
  auto* p = (Prefetcher*)handle;
  std::unique_lock<std::mutex> lk(p->mu);
  if (p->next_to_deliver >= (int64_t)p->paths.size()) return -1;
  int64_t want = p->next_to_deliver;
  p->cv_produced.wait(lk, [&] { return p->ready.count(want) > 0; });
  auto item = p->ready[want];
  p->ready.erase(want);
  p->next_to_deliver++;
  p->cv_space.notify_all();
  *out = item.first;
  *len = item.second;
  return want;
}

void dn_prefetch_free(void* handle) {
  auto* p = (Prefetcher*)handle;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->stop = true;
    p->next_to_read.store((int64_t)p->paths.size());
    p->cv_space.notify_all();
  }
  for (auto& t : p->workers) t.join();
  for (auto& kv : p->ready) free(kv.second.first);
  delete p;
}

}  // extern "C"
