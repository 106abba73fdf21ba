// Native Wavefront OBJ + MTL loader, a copy of the JAX package's
// native/obj_loader.cpp (the port never imports the JAX package).  Parses
// the same dialect with the exact semantics of the Python fallback in
// evplp_tpu_torch/scene/objloader.py (fan triangulation, per-usemtl
// material runs, per-run (position, texcoord) de-indexing in first-seen
// order, the Assimp Ns/4 shininess fixup, negative/relative indices);
// loaded with ctypes by evplp_tpu_torch/native/obj_native.py.  Pure C++17,
// no dependencies.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libobj.so obj_loader.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Material {
  std::string name;
  float kd[3] = {0.f, 0.f, 0.f};
  float ks[3] = {0.f, 0.f, 0.f};
  float ns = 0.f;
  std::string map_kd, map_ks, map_ns;  // empty = none
};

struct Mesh {
  int material = 0;
  std::vector<float> positions;  // (V, 3) flat
  std::vector<float> texcoords;  // (V, 2) flat
  std::vector<int32_t> indices;  // (T, 3) flat
};

struct ObjData {
  std::vector<Mesh> meshes;
  std::vector<Material> materials;
};

// ---- tokenizer ------------------------------------------------------------
// Mirrors Python str.split(): any run of whitespace separates tokens.

struct Tok {
  const char* p;
  int len;
  std::string str() const { return std::string(p, p + len); }
};

inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\v' || c == '\f' || c == '\r';
}

static int split_line(const char* s, const char* end, Tok* toks, int cap) {
  int n = 0;
  const char* p = s;
  while (p < end) {
    while (p < end && is_space(*p)) ++p;
    if (p >= end) break;
    const char* start = p;
    while (p < end && !is_space(*p)) ++p;
    if (n < cap) toks[n] = {start, int(p - start)};
    ++n;  // count beyond cap so parts[-1] can be found by caller rescan
  }
  return n;
}

inline bool tok_eq(const Tok& t, const char* lit) {
  int n = int(strlen(lit));
  return t.len == n && memcmp(t.p, lit, n) == 0;
}

inline float tok_float(const Tok& t) {
  char buf[64];
  int n = t.len < 63 ? t.len : 63;
  memcpy(buf, t.p, n);
  buf[n] = 0;
  return strtof(buf, nullptr);
}

inline long tok_int(const Tok& t) {
  char buf[64];
  int n = t.len < 63 ? t.len : 63;
  memcpy(buf, t.p, n);
  buf[n] = 0;
  return strtol(buf, nullptr, 10);
}

static bool read_file(const std::string& path, std::string* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(size_t(sz > 0 ? sz : 0));
  size_t got = sz > 0 ? fread(&(*out)[0], 1, size_t(sz), f) : 0;
  out->resize(got);
  fclose(f);
  return true;
}

// Iterate lines: both \n and \r terminate (Python universal newlines).
template <typename Fn>
static void for_lines(const std::string& text, Fn fn) {
  const char* p = text.data();
  const char* end = p + text.size();
  while (p < end) {
    const char* q = p;
    while (q < end && *q != '\n' && *q != '\r') ++q;
    fn(p, q);
    if (q + 1 < end && *q == '\r' && q[1] == '\n') ++q;  // \r\n = one break
    p = q + 1;
  }
}

// ---- MTL ------------------------------------------------------------------
// Matches objloader.parse_mtl: last-token map paths, Ns/4 fixup, duplicate
// newmtl names keep first-insertion order with last-wins content.

static void parse_mtl(const std::string& path, std::vector<Material>* mats) {
  std::string text;
  if (!read_file(path, &text)) return;
  int cur = -1;
  constexpr int kCap = 16;
  Tok toks[kCap];
  for_lines(text, [&](const char* s, const char* e) {
    int n = split_line(s, e, toks, kCap);
    if (n == 0 || toks[0].p[0] == '#') return;
    int nt = n < kCap ? n : kCap;
    if (tok_eq(toks[0], "newmtl")) {
      std::string name = n > 1 ? toks[1].str() : "";
      cur = -1;
      for (size_t i = 0; i < mats->size(); ++i)
        if ((*mats)[i].name == name) { cur = int(i); break; }
      if (cur < 0) {
        cur = int(mats->size());
        mats->emplace_back();
      } else {
        (*mats)[cur] = Material();  // dict overwrite: last wins, slot kept
      }
      (*mats)[cur].name = name;
    } else if (cur < 0) {
      return;
    } else if (tok_eq(toks[0], "Kd")) {
      for (int i = 1; i < nt && i < 4; ++i)
        (*mats)[cur].kd[i - 1] = tok_float(toks[i]);
    } else if (tok_eq(toks[0], "Ks")) {
      for (int i = 1; i < nt && i < 4; ++i)
        (*mats)[cur].ks[i - 1] = tok_float(toks[i]);
    } else if (tok_eq(toks[0], "Ns")) {
      // Assimp divides constant shininess by 4; the reference bakes that
      // in (rtcommon.h:55-64)
      if (n > 1) (*mats)[cur].ns = tok_float(toks[1]) / 4.0f;
    } else if (tok_eq(toks[0], "map_Kd") || tok_eq(toks[0], "map_Ks") ||
               tok_eq(toks[0], "map_Ns")) {
      // Python takes parts[-1] (the last token; the key itself when alone)
      Tok last = toks[(n < kCap ? n : kCap) - 1];
      if (n >= kCap) {  // rescan for the true last token past the cap
        const char* q = e;
        while (q > s && is_space(q[-1])) --q;
        const char* st = q;
        while (st > s && !is_space(st[-1])) --st;
        last = {st, int(q - st)};
      }
      std::string v = last.str();
      if (toks[0].p[4] == 'K' && toks[0].p[5] == 'd')
        (*mats)[cur].map_kd = v;
      else if (toks[0].p[4] == 'K')
        (*mats)[cur].map_ks = v;
      else
        (*mats)[cur].map_ns = v;
    }
  });
}

// ---- OBJ ------------------------------------------------------------------

static std::string dirname_of(const std::string& path) {
  size_t k = path.find_last_of('/');
  if (k == std::string::npos) return ".";
  return path.substr(0, k == 0 ? 1 : k);
}

static ObjData* parse_obj(const char* cpath) {
  std::string text;
  std::string path(cpath);
  if (!read_file(path, &text)) return nullptr;

  auto data = new ObjData();
  data->materials.emplace_back();
  data->materials[0].name = "__default__";
  std::unordered_map<std::string, int> mat_index;

  std::vector<float> positions;  // flat (N, 3)
  std::vector<float> texcoords;  // flat (N, 2)

  struct Corner {
    int32_t vi, ti;
  };
  // one material run = one mesh; faces stored as corner triples
  struct Run {
    int material;
    std::vector<Corner> tris;  // 3 corners per triangle
  };
  std::vector<Run> runs;
  int cur_mat = 0;
  std::vector<Corner> cur;  // current run's corners

  auto flush = [&]() {
    if (!cur.empty()) {
      runs.push_back({cur_mat, std::move(cur)});
      cur.clear();
    }
  };

  std::string base = dirname_of(path);
  constexpr int kCap = 96;
  Tok toks[kCap];
  std::vector<Corner> face;  // scratch

  for_lines(text, [&](const char* s, const char* e) {
    int n = split_line(s, e, toks, kCap);
    if (n == 0 || toks[0].p[0] == '#') return;
    int nt = n < kCap ? n : kCap;
    if (toks[0].len == 1 && toks[0].p[0] == 'v') {
      float c[3] = {0.f, 0.f, 0.f};
      for (int i = 1; i < nt && i < 4; ++i) c[i - 1] = tok_float(toks[i]);
      positions.insert(positions.end(), c, c + 3);
    } else if (tok_eq(toks[0], "vt")) {
      float c[2] = {0.f, 0.f};
      for (int i = 1; i < nt && i < 3; ++i) c[i - 1] = tok_float(toks[i]);
      texcoords.insert(texcoords.end(), c, c + 2);
    } else if (tok_eq(toks[0], "mtllib")) {
      // join remaining tokens with single spaces (objloader.py:107)
      std::string rel;
      for (int i = 1; i < nt; ++i) {
        if (i > 1) rel += ' ';
        rel += toks[i].str();
      }
      std::string mpath =
          (!rel.empty() && rel[0] == '/') ? rel : base + "/" + rel;
      std::vector<Material> mats;
      parse_mtl(mpath, &mats);
      for (auto& m : mats) {
        mat_index[m.name] = int(data->materials.size());
        data->materials.push_back(std::move(m));
      }
    } else if (tok_eq(toks[0], "usemtl")) {
      flush();
      std::string name = n > 1 ? toks[1].str() : "";
      auto it = mat_index.find(name);
      cur_mat = it == mat_index.end() ? 0 : it->second;
    } else if (toks[0].len == 1 && toks[0].p[0] == 'f') {
      face.clear();
      long npos = long(positions.size() / 3);
      long ntex = long(texcoords.size() / 2);
      // giant polygons can exceed the token cap: re-walk the line
      std::vector<Tok> big;
      const Tok* ft = toks + 1;
      int fn = nt - 1;
      if (n >= kCap) {
        const char* q = toks[0].p + toks[0].len;
        while (q < e) {
          while (q < e && is_space(*q)) ++q;
          if (q >= e) break;
          const char* st = q;
          while (q < e && !is_space(*q)) ++q;
          big.push_back({st, int(q - st)});
        }
        ft = big.data();
        fn = int(big.size());
      }
      for (int i = 0; i < fn; ++i) {
        const char* tp = ft[i].p;
        const char* te = tp + ft[i].len;
        // comps[0]
        const char* slash = tp;
        while (slash < te && *slash != '/') ++slash;
        long vi = tok_int({tp, int(slash - tp)});
        vi = vi > 0 ? vi - 1 : npos + vi;
        long ti = -1;
        if (slash < te) {  // has comps[1] (may be empty: v//n)
          const char* t2 = slash + 1;
          const char* s2 = t2;
          while (s2 < te && *s2 != '/') ++s2;
          if (s2 > t2) {
            long t = tok_int({t2, int(s2 - t2)});
            ti = t > 0 ? t - 1 : ntex + t;
          }
        }
        face.push_back({int32_t(vi), int32_t(ti)});
      }
      for (size_t k = 1; k + 1 < face.size(); ++k) {  // fan triangulation
        cur.push_back(face[0]);
        cur.push_back(face[k]);
        cur.push_back(face[k + 1]);
      }
    }
  });
  flush();

  // de-index each run by (vi, ti) pair in first-seen order
  long npos = long(positions.size() / 3);
  long ntex = long(texcoords.size() / 2);
  data->meshes.reserve(runs.size());
  std::unordered_map<uint64_t, int32_t> seen;
  for (auto& run : runs) {
    data->meshes.emplace_back();
    Mesh& m = data->meshes.back();
    m.material = run.material;
    m.indices.reserve(run.tris.size());
    seen.clear();
    seen.reserve(run.tris.size());
    for (const Corner& c : run.tris) {
      uint64_t key =
          (uint64_t(uint32_t(c.vi)) << 32) | uint64_t(uint32_t(c.ti));
      auto it = seen.find(key);
      int32_t idx;
      if (it != seen.end()) {
        idx = it->second;
      } else {
        idx = int32_t(m.positions.size() / 3);
        seen.emplace(key, idx);
        if (c.vi >= 0 && c.vi < npos) {
          const float* p = &positions[size_t(c.vi) * 3];
          m.positions.insert(m.positions.end(), p, p + 3);
        } else {  // malformed index (Python raises); keep parsing
          m.positions.insert(m.positions.end(), {0.f, 0.f, 0.f});
        }
        if (c.ti >= 0 && c.ti < ntex) {
          const float* t = &texcoords[size_t(c.ti) * 2];
          m.texcoords.insert(m.texcoords.end(), t, t + 2);
        } else {
          m.texcoords.insert(m.texcoords.end(), {0.f, 0.f});
        }
      }
      m.indices.push_back(idx);
    }
  }
  return data;
}

static void copy_str(const std::string& s, char* out, int cap) {
  if (!out || cap <= 0) return;
  int n = int(s.size()) < cap - 1 ? int(s.size()) : cap - 1;
  memcpy(out, s.data(), size_t(n));
  out[n] = 0;
}

}  // namespace

extern "C" {

void* evplp_obj_parse(const char* path) { return parse_obj(path); }

void evplp_obj_free(void* h) { delete static_cast<ObjData*>(h); }

int evplp_obj_num_meshes(void* h) {
  return int(static_cast<ObjData*>(h)->meshes.size());
}

int evplp_obj_num_materials(void* h) {
  return int(static_cast<ObjData*>(h)->materials.size());
}

// info[0]=material, info[1]=num_verts, info[2]=num_tris
void evplp_obj_mesh_info(void* h, int i, int32_t* info) {
  const Mesh& m = static_cast<ObjData*>(h)->meshes[size_t(i)];
  info[0] = m.material;
  info[1] = int32_t(m.positions.size() / 3);
  info[2] = int32_t(m.indices.size() / 3);
}

void evplp_obj_mesh_fill(void* h, int i, float* pos, float* tex,
                         int32_t* idx) {
  const Mesh& m = static_cast<ObjData*>(h)->meshes[size_t(i)];
  memcpy(pos, m.positions.data(), m.positions.size() * sizeof(float));
  memcpy(tex, m.texcoords.data(), m.texcoords.size() * sizeof(float));
  memcpy(idx, m.indices.data(), m.indices.size() * sizeof(int32_t));
}

// scalars: kd[3], ks[3], ns  (7 floats)
void evplp_obj_material(void* h, int i, float* scalars, char* name,
                        int name_cap, char* map_kd, char* map_ks,
                        char* map_ns, int map_cap) {
  const Material& m = static_cast<ObjData*>(h)->materials[size_t(i)];
  memcpy(scalars, m.kd, 3 * sizeof(float));
  memcpy(scalars + 3, m.ks, 3 * sizeof(float));
  scalars[6] = m.ns;
  copy_str(m.name, name, name_cap);
  copy_str(m.map_kd, map_kd, map_cap);
  copy_str(m.map_ks, map_ks, map_cap);
  copy_str(m.map_ns, map_ns, map_cap);
}

}  // extern "C"
