// srt_native: native ingest core for sycl_ray_tracer_tpu.
//
// The reference's data loader is C++ (tiny_gltf + nlohmann/json,
// scene.cpp:54-510). This is its native equivalent for this
// framework: GLB container parsing, a minimal JSON DOM, glTF accessor
// decoding, node-hierarchy flattening with baked world transforms and
// normal matrices (transpose(inverse(upper3x3))), scene.cpp:502), and
// reference-rule material classification (scene.cpp:188-254). Exposed
// through a C ABI consumed via ctypes (no pybind11 in this image).
//
// Texture *decoding* stays in Python by design (utils/image_io.py): the
// native side hands back the raw embedded image bytes.
//
// No code is shared with or derived from the reference; JSON parsing
// is a from-scratch recursive-descent parser over the GLB JSON chunk.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <map>
#include <memory>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------- JSON
struct Json {
  enum Type { Null, Bool, Num, Str, Arr, Obj } type = Null;
  bool b = false;
  double num = 0.0;
  std::string str;
  std::vector<Json> arr;
  std::map<std::string, Json> obj;

  bool has(const std::string& k) const { return type == Obj && obj.count(k); }
  const Json& operator[](const std::string& k) const {
    static Json null_json;
    auto it = obj.find(k);
    return it == obj.end() ? null_json : it->second;
  }
  const Json& at(size_t i) const {
    static Json null_json;
    return (type == Arr && i < arr.size()) ? arr[i] : null_json;
  }
  double dnum(double dflt) const { return type == Num ? num : dflt; }
  int inum(int dflt) const { return type == Num ? (int)num : dflt; }
  size_t size() const { return type == Arr ? arr.size() : 0; }
};

struct JsonParser {
  const char* p;
  const char* end;
  bool ok = true;
  int depth = 0;  // container nesting; caps C++-stack recursion

  explicit JsonParser(const char* data, size_t len)
      : p(data), end(data + len) {}

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }
  bool match(char c) {
    skip_ws();
    if (p < end && *p == c) { ++p; return true; }
    return false;
  }
  Json parse() {
    skip_ws();
    if (p >= end) { ok = false; return {}; }
    // a maliciously deep document must fail the parse, not overflow
    // the C++ stack (the caller then falls back to the Python loader)
    if (depth > 512) { ok = false; return {}; }
    switch (*p) {
      case '{': return parse_obj();
      case '[': return parse_arr();
      case '"': return parse_str();
      case 't': case 'f': return parse_bool();
      case 'n': p += 4; return {};
      default: return parse_num();
    }
  }
  Json parse_obj() {
    Json j; j.type = Json::Obj;
    ++depth;
    ++p;  // {
    skip_ws();
    if (match('}')) { --depth; return j; }
    while (ok) {
      skip_ws();
      if (p >= end || *p != '"') { ok = false; break; }
      Json key = parse_str();
      if (!match(':')) { ok = false; break; }
      j.obj.emplace(key.str, parse());
      if (match(',')) continue;
      if (match('}')) break;
      ok = false; break;
    }
    --depth;
    return j;
  }
  Json parse_arr() {
    Json j; j.type = Json::Arr;
    ++depth;
    ++p;  // [
    skip_ws();
    if (match(']')) { --depth; return j; }
    while (ok) {
      j.arr.push_back(parse());
      if (match(',')) continue;
      if (match(']')) break;
      ok = false; break;
    }
    --depth;
    return j;
  }
  Json parse_str() {
    Json j; j.type = Json::Str;
    ++p;  // "
    while (p < end && *p != '"') {
      if (*p == '\\' && p + 1 < end) {
        ++p;
        switch (*p) {
          case 'n': j.str += '\n'; break;
          case 't': j.str += '\t'; break;
          case 'r': j.str += '\r'; break;
          case 'b': j.str += '\b'; break;
          case 'f': j.str += '\f'; break;
          case 'u': {
            if (p + 4 < end) {
              unsigned cp = (unsigned)strtoul(std::string(p + 1, 4).c_str(),
                                              nullptr, 16);
              // BMP-only UTF-8 encode (names/URIs only; fidelity not
              // load-bearing for geometry)
              if (cp < 0x80) j.str += (char)cp;
              else if (cp < 0x800) {
                j.str += (char)(0xC0 | (cp >> 6));
                j.str += (char)(0x80 | (cp & 0x3F));
              } else {
                j.str += (char)(0xE0 | (cp >> 12));
                j.str += (char)(0x80 | ((cp >> 6) & 0x3F));
                j.str += (char)(0x80 | (cp & 0x3F));
              }
              p += 4;
            }
            break;
          }
          default: j.str += *p;
        }
      } else {
        j.str += *p;
      }
      ++p;
    }
    if (p < end) ++p;  // closing "
    return j;
  }
  Json parse_bool() {
    Json j; j.type = Json::Bool;
    if (*p == 't') { j.b = true; p += 4; } else { j.b = false; p += 5; }
    return j;
  }
  Json parse_num() {
    Json j; j.type = Json::Num;
    // bounded copy before strtod: the JSON chunk is NOT NUL-terminated,
    // so strtod on a number truncated at the chunk boundary would read
    // into the BIN chunk (or off the buffer). Every other parse path
    // checks p < end; this one must too.
    char buf[64];
    int n = 0;
    const char* q = p;
    while (q < end && n < 63 &&
           ((*q >= '0' && *q <= '9') || *q == '-' || *q == '+' ||
            *q == '.' || *q == 'e' || *q == 'E')) {
      buf[n++] = *q++;
    }
    buf[n] = 0;
    char* e2 = nullptr;
    j.num = strtod(buf, &e2);
    if (e2 == buf) { ok = false; }
    p += (e2 - buf);
    return j;
  }
};

// ------------------------------------------------------------- algebra
struct Mat4 {
  double m[16];  // row-major
  static Mat4 identity() {
    Mat4 r{};
    for (int i = 0; i < 4; i++) r.m[i * 4 + i] = 1.0;
    return r;
  }
  Mat4 mul(const Mat4& o) const {
    Mat4 r{};
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) {
        double s = 0;
        for (int k = 0; k < 4; k++) s += m[i * 4 + k] * o.m[k * 4 + j];
        r.m[i * 4 + j] = s;
      }
    return r;
  }
};

void invert3x3_transpose(const double a[9], double out[9]) {
  double det = a[0] * (a[4] * a[8] - a[5] * a[7]) -
               a[1] * (a[3] * a[8] - a[5] * a[6]) +
               a[2] * (a[3] * a[7] - a[4] * a[6]);
  double id = det != 0.0 ? 1.0 / det : 0.0;
  double inv[9] = {
      (a[4] * a[8] - a[5] * a[7]) * id, -(a[1] * a[8] - a[2] * a[7]) * id,
      (a[1] * a[5] - a[2] * a[4]) * id, -(a[3] * a[8] - a[5] * a[6]) * id,
      (a[0] * a[8] - a[2] * a[6]) * id, -(a[0] * a[5] - a[2] * a[3]) * id,
      (a[3] * a[7] - a[4] * a[6]) * id, -(a[0] * a[7] - a[1] * a[6]) * id,
      (a[0] * a[4] - a[1] * a[3]) * id};
  // transpose(inverse)
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) out[i * 3 + j] = inv[j * 3 + i];
}

Mat4 local_matrix(const Json& node) {
  if (node.has("matrix")) {
    // glTF stores column-major
    Mat4 r{};
    const Json& a = node["matrix"];
    for (int c = 0; c < 4; c++)
      for (int r_ = 0; r_ < 4; r_++)
        r.m[r_ * 4 + c] = a.at(c * 4 + r_).dnum(r_ == c ? 1 : 0);
    return r;
  }
  Mat4 m = Mat4::identity();
  if (node.has("scale")) {
    const Json& s = node["scale"];
    for (int i = 0; i < 3; i++) m.m[i * 4 + i] = s.at(i).dnum(1.0);
  }
  if (node.has("rotation")) {
    const Json& q = node["rotation"];
    double x = q.at(0).dnum(0), y = q.at(1).dnum(0), z = q.at(2).dnum(0),
           w = q.at(3).dnum(1);
    double r3[9] = {1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                    2 * (x * z + w * y),     2 * (x * y + w * z),
                    1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                    2 * (x * z - w * y),     2 * (y * z + w * x),
                    1 - 2 * (x * x + y * y)};
    Mat4 rm = Mat4::identity();
    // R @ S (scale already in m)
    double s3[9];
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++) s3[i * 3 + j] = m.m[i * 4 + j];
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++) {
        double acc = 0;
        for (int k = 0; k < 3; k++) acc += r3[i * 3 + k] * s3[k * 3 + j];
        rm.m[i * 4 + j] = acc;
      }
    m = rm;
  }
  if (node.has("translation")) {
    const Json& t = node["translation"];
    for (int i = 0; i < 3; i++) m.m[i * 4 + 3] = t.at(i).dnum(0.0);
  }
  return m;
}

// -------------------------------------------------------------- scene
struct Image {
  std::vector<uint8_t> bytes;  // raw embedded PNG/JPEG
};

struct Scene {
  std::vector<float> tri_v, tri_n, tri_uv;
  std::vector<int32_t> tri_mat;
  // materials SoA
  std::vector<int32_t> mtype, tex;
  std::vector<float> albedo, rough, ior, emissive;
  float sky[3] = {0.5f, 0.7f, 1.0f};
  float cam_pos[3] = {0, 0, 0};
  float cam_dir[3] = {0, 0, -1};
  float focal = 2.414213562373095f;
  bool has_camera = false;
  std::vector<Image> images;
  std::string error;
};

struct AccessorView {
  const uint8_t* data = nullptr;
  size_t count = 0;
  int ncomp = 0;
  int ctype = 0;
  size_t stride = 0;
  bool ok = true;  // false when the byte range fell outside the BIN chunk

  double get(size_t i, int c) const {
    if (!data || i >= count) return 0;  // bounds-checked: see accessor()
    const uint8_t* e = data + i * stride;
    switch (ctype) {
      case 5120: return ((const int8_t*)e)[c];
      case 5121: return ((const uint8_t*)e)[c];
      case 5122: return ((const int16_t*)e)[c];
      case 5123: return ((const uint16_t*)e)[c];
      case 5125: return ((const uint32_t*)e)[c];
      case 5126: { float f; memcpy(&f, e + c * 4, 4); return f; }
    }
    return 0;
  }
};

int ncomp_of(const std::string& t) {
  if (t == "SCALAR") return 1;
  if (t == "VEC2") return 2;
  if (t == "VEC3") return 3;
  if (t == "VEC4") return 4;
  if (t == "MAT4") return 16;
  return 1;
}

int comp_size(int ctype) {
  switch (ctype) {
    case 5120: case 5121: return 1;
    case 5122: case 5123: return 2;
    default: return 4;
  }
}

AccessorView accessor(const Json& gltf, const uint8_t* bin, size_t bin_len,
                      int idx) {
  AccessorView v;
  const Json& acc = gltf["accessors"].at(idx);
  v.count = (size_t)acc["count"].dnum(0);
  v.ncomp = ncomp_of(acc["type"].str);
  v.ctype = acc["componentType"].inum(5126);
  if (!acc.has("bufferView")) {
    // spec: zero-filled — but a malformed count must not drive a
    // multi-GB resize downstream (which would throw through the C ABI)
    if (v.count > (size_t)1 << 28) { v.count = 0; v.ok = false; }
    return v;
  }
  const Json& view = gltf["bufferViews"].at(acc["bufferView"].inum(0));
  size_t off = (size_t)view["byteOffset"].dnum(0) +
               (size_t)acc["byteOffset"].dnum(0);
  size_t tight = (size_t)v.ncomp * comp_size(v.ctype);
  v.stride = view.has("byteStride") ? (size_t)view["byteStride"].dnum(tight)
                                    : tight;
  if (v.stride == 0) v.stride = tight;  // malformed; match gltf.py
  // Validate the FULL range the accessor will read (a truncated or
  // malformed .glb must not read out of bounds): the last element
  // starts at off + stride*(count-1) and spans `tight` bytes. Division
  // form — stride*(count-1) on attacker-controlled values can wrap
  // size_t and defeat the check.
  bool fits = v.count > 0 && off <= bin_len && tight <= bin_len - off;
  if (fits && v.count > 1) {
    fits = v.stride <= (bin_len - off - tight) / (v.count - 1);
  }
  if (fits) {
    v.data = bin + off;
  } else {
    v.data = nullptr;
    v.count = 0;
    v.ok = false;
  }
  return v;
}

// material classification, reference rules (scene.cpp:188-254)
void classify_materials(const Json& gltf, Scene* s) {
  size_t m = gltf["materials"].size();
  size_t total = m + 1;  // + default material slot
  s->mtype.assign(total, 0);
  s->tex.assign(total, -1);
  s->albedo.assign(total * 3, 1.0f);
  s->rough.assign(total, 0.0f);
  s->ior.assign(total, 1.5f);
  s->emissive.assign(total * 3, 0.0f);

  for (size_t i = 0; i < m; i++) {
    const Json& mat = gltf["materials"].at(i);
    const Json& pbr = mat["pbrMetallicRoughness"];
    double base[3] = {1, 1, 1};
    if (pbr.has("baseColorFactor"))
      for (int c = 0; c < 3; c++)
        base[c] = pbr["baseColorFactor"].at(c).dnum(1.0);
    const Json& ext = mat["extensions"];

    double emis[3] = {0, 0, 0};
    if (mat.has("emissiveFactor"))
      for (int c = 0; c < 3; c++)
        emis[c] = mat["emissiveFactor"].at(c).dnum(0.0);
    double strength = 0.0;
    if (ext.has("KHR_materials_emissive_strength"))
      strength = ext["KHR_materials_emissive_strength"]["emissiveStrength"]
                     .dnum(1.0);
    for (int c = 0; c < 3; c++)
      s->emissive[i * 3 + c] = (float)(emis[c] * strength);

    int base_tex = -1;
    if (pbr.has("baseColorTexture")) {
      int t = pbr["baseColorTexture"]["index"].inum(-1);
      if (t >= 0) base_tex = gltf["textures"].at(t)["source"].inum(-1);
    }
    double metallic =
        pbr.has("metallicFactor") ? pbr["metallicFactor"].dnum(1.0) : 1.0;

    if (ext.has("KHR_materials_ior") &&
        ext.has("KHR_materials_transmission")) {
      s->mtype[i] = 2;  // dielectric
      s->ior[i] = (float)ext["KHR_materials_ior"]["ior"].dnum(1.5);
      for (int c = 0; c < 3; c++) s->emissive[i * 3 + c] = 0.0f;
    } else if (metallic > 0.01) {
      s->mtype[i] = 1;  // metallic
      for (int c = 0; c < 3; c++) s->albedo[i * 3 + c] = (float)base[c];
      s->tex[i] = base_tex;
      s->rough[i] =
          (float)(pbr.has("roughnessFactor") ? pbr["roughnessFactor"].dnum(1.0)
                                             : 1.0);
    } else {
      s->mtype[i] = 0;  // diffuse
      for (int c = 0; c < 3; c++) s->albedo[i * 3 + c] = (float)base[c];
      s->tex[i] = base_tex;
    }
  }
  // default material slot (deviation: reference asserts, scene.cpp:176).
  // Diffuse; roughness stays 0 like the python table (unused for
  // diffuse).
  size_t d = total - 1;
  s->mtype[d] = 0;
  for (int c = 0; c < 3; c++) s->albedo[d * 3 + c] = 0.8f;
}

void load_node(const Json& gltf, const uint8_t* bin, size_t bin_len,
               int node_idx, const Mat4& parent, const Mat4& scale_m,
               Scene* s, int default_mat, int* camera_node,
               Mat4* camera_world, int depth = 0) {
  // A cyclic or absurdly deep node graph must fail the load (-> clean
  // Python-side error), not overflow the C++ stack.
  if (depth > 256) {
    s->error = "node graph too deep (or cyclic)";
    return;
  }
  if (!s->error.empty()) return;
  const Json& node = gltf["nodes"].at(node_idx);
  Mat4 chain = parent.mul(local_matrix(node));
  Mat4 world = chain.mul(scale_m);

  if (node.has("camera") && *camera_node < 0) {
    *camera_node = node_idx;
    *camera_world = world;
  }

  if (node.has("mesh")) {
    const Json& mesh = gltf["meshes"].at(node["mesh"].inum(0));
    double m3[9], nm[9];
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++) m3[i * 3 + j] = world.m[i * 4 + j];
    invert3x3_transpose(m3, nm);

    const Json& prims = mesh["primitives"];
    for (size_t pi = 0; pi < prims.size(); pi++) {
      const Json& prim = prims.at(pi);
      const Json& attrs = prim["attributes"];
      if (!attrs.has("POSITION")) {
        // gltf.py raises on this; erroring here routes the same file
        // to the Python loader so both paths agree (loader-parity
        // invariant) instead of silently dropping geometry
        s->error = "primitive without POSITION attribute";
        return;
      }
      AccessorView pos = accessor(gltf, bin, bin_len,
                                  attrs["POSITION"].inum(0));
      AccessorView nrm{}, uv{};
      bool has_n = attrs.has("NORMAL");
      bool has_uv = attrs.has("TEXCOORD_0");
      if (has_n) nrm = accessor(gltf, bin, bin_len, attrs["NORMAL"].inum(0));
      if (has_uv)
        uv = accessor(gltf, bin, bin_len, attrs["TEXCOORD_0"].inum(0));

      std::vector<uint32_t> idx;
      AccessorView ia{};
      if (prim.has("indices"))
        ia = accessor(gltf, bin, bin_len, prim["indices"].inum(0));
      if (!pos.ok || !nrm.ok || !uv.ok || !ia.ok) {
        // Malformed/truncated GLB: error out so the caller falls back
        // to the Python loader, which raises cleanly.
        s->error = "accessor byte range exceeds BIN chunk";
        return;
      }
      if (prim.has("indices")) {
        idx.resize(ia.count);
        for (size_t i = 0; i < ia.count; i++)
          idx[i] = (uint32_t)ia.get(i, 0);
      } else {
        idx.resize(pos.count);
        for (size_t i = 0; i < pos.count; i++) idx[i] = (uint32_t)i;
      }
      if (idx.size() % 3 != 0) {
        s->error = "index count not divisible by 3";  // gltf.py parity
        return;
      }
      size_t ntri = idx.size() / 3;
      int mat = prim.has("material") ? prim["material"].inum(default_mat)
                                     : default_mat;

      for (size_t t = 0; t < ntri; t++) {
        double wp[3][3], wn[3][3];
        float wuv[3][2];
        for (int v = 0; v < 3; v++) {
          uint32_t vi = idx[t * 3 + v];
          double p[3] = {pos.get(vi, 0), pos.get(vi, 1), pos.get(vi, 2)};
          for (int c = 0; c < 3; c++)
            wp[v][c] = world.m[c * 4 + 0] * p[0] + world.m[c * 4 + 1] * p[1] +
                       world.m[c * 4 + 2] * p[2] + world.m[c * 4 + 3];
          if (has_n) {
            double n[3] = {nrm.get(vi, 0), nrm.get(vi, 1), nrm.get(vi, 2)};
            for (int c = 0; c < 3; c++)
              wn[v][c] = nm[c * 3 + 0] * n[0] + nm[c * 3 + 1] * n[1] +
                         nm[c * 3 + 2] * n[2];
          }
          wuv[v][0] = has_uv ? (float)uv.get(vi, 0) : 0.0f;
          wuv[v][1] = has_uv ? (float)uv.get(vi, 1) : 0.0f;
        }
        if (!has_n) {
          // geometric normal fallback
          double e1[3], e2[3], g[3];
          for (int c = 0; c < 3; c++) {
            e1[c] = wp[1][c] - wp[0][c];
            e2[c] = wp[2][c] - wp[0][c];
          }
          g[0] = e1[1] * e2[2] - e1[2] * e2[1];
          g[1] = e1[2] * e2[0] - e1[0] * e2[2];
          g[2] = e1[0] * e2[1] - e1[1] * e2[0];
          double len = std::sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
          if (len < 1e-20) len = 1e-20;
          for (int v = 0; v < 3; v++)
            for (int c = 0; c < 3; c++) wn[v][c] = g[c] / len;
        }
        for (int v = 0; v < 3; v++) {
          for (int c = 0; c < 3; c++) s->tri_v.push_back((float)wp[v][c]);
        }
        for (int v = 0; v < 3; v++)
          for (int c = 0; c < 3; c++) s->tri_n.push_back((float)wn[v][c]);
        for (int v = 0; v < 3; v++) {
          s->tri_uv.push_back(wuv[v][0]);
          s->tri_uv.push_back(wuv[v][1]);
        }
        s->tri_mat.push_back(mat);
      }
    }
  }

  if (node.has("children")) {
    const Json& ch = node["children"];
    for (size_t i = 0; i < ch.size(); i++)
      load_node(gltf, bin, bin_len, ch.at(i).inum(0), chain, scale_m, s,
                default_mat, camera_node, camera_world, depth + 1);
  }
}

Scene* load_glb_impl(const uint8_t* data, size_t len, const float gscale[3]) {
  auto s = std::make_unique<Scene>();
  if (len < 12 || memcmp(data, "glTF", 4) != 0) {
    s->error = "not a GLB file";
    return s.release();
  }
  uint32_t total;
  memcpy(&total, data + 8, 4);
  if (total > len) total = (uint32_t)len;

  const char* json_ptr = nullptr;
  size_t json_len = 0;
  const uint8_t* bin = nullptr;
  size_t bin_len = 0;
  size_t off = 12;
  while (off + 8 <= total) {
    uint32_t clen, ctype;
    memcpy(&clen, data + off, 4);
    memcpy(&ctype, data + off + 4, 4);
    off += 8;
    if (off + clen > len) break;
    if (ctype == 0x4E4F534A && !json_ptr) {
      json_ptr = (const char*)(data + off);
      json_len = clen;
    } else if (ctype == 0x004E4942 && !bin) {
      bin = data + off;
      bin_len = clen;
    }
    off += clen;
  }
  if (!json_ptr) {
    s->error = "GLB missing JSON chunk";
    return s.release();
  }
  JsonParser jp(json_ptr, json_len);
  Json gltf = jp.parse();
  if (!jp.ok) {
    s->error = "JSON parse error";
    return s.release();
  }

  classify_materials(gltf, s.get());
  int default_mat = (int)gltf["materials"].size();  // default slot

  int scene_idx = gltf.has("scene") ? gltf["scene"].inum(0) : 0;
  const Json& scenes = gltf["scenes"];
  const Json& scene =
      scenes.at(scene_idx < (int)scenes.size() ? scene_idx : 0);

  // sky extras (scene.cpp:80-94)
  const Json& extras = scene["extras"];
  // >= 3: gltf.py takes the first three of a longer list ([:3] parity)
  if (extras.has("sky_color") && extras["sky_color"].size() >= 3)
    for (int c = 0; c < 3; c++)
      s->sky[c] = (float)extras["sky_color"].at(c).dnum(0.5);
  if (extras.has("sky_strength")) {
    float st = (float)extras["sky_strength"].dnum(1.0);
    for (int c = 0; c < 3; c++) s->sky[c] *= st;
  }

  Mat4 scale_m = Mat4::identity();
  for (int i = 0; i < 3; i++) scale_m.m[i * 4 + i] = gscale[i];

  int camera_node = -1;
  Mat4 camera_world = Mat4::identity();
  const Json& roots = scene["nodes"];
  for (size_t i = 0; i < roots.size(); i++)
    load_node(gltf, bin, bin_len, roots.at(i).inum(0), Mat4::identity(),
              scale_m, s.get(), default_mat, &camera_node, &camera_world);

  // camera (scene.cpp:109-128); bbox default otherwise
  if (camera_node >= 0) {
    s->has_camera = true;
    for (int c = 0; c < 3; c++)
      s->cam_pos[c] = (float)camera_world.m[c * 4 + 3];
    // rotation = world columns normalized; dir = R @ (0,0,-1)
    double col[3][3];
    for (int j = 0; j < 3; j++) {
      double n = 0;
      for (int i = 0; i < 3; i++) n += camera_world.m[i * 4 + j] *
                                       camera_world.m[i * 4 + j];
      n = n > 0 ? std::sqrt(n) : 1.0;
      for (int i = 0; i < 3; i++) col[i][j] = camera_world.m[i * 4 + j] / n;
    }
    double dir[3] = {-col[0][2], -col[1][2], -col[2][2]};
    double dn = std::sqrt(dir[0] * dir[0] + dir[1] * dir[1] + dir[2] * dir[2]);
    if (dn < 1e-20) dn = 1.0;
    for (int c = 0; c < 3; c++) s->cam_dir[c] = (float)(dir[c] / dn);
    int cam_ref = gltf["nodes"].at(camera_node)["camera"].inum(0);
    double yfov =
        gltf["cameras"].at(cam_ref)["perspective"]["yfov"].dnum(M_PI / 4);
    s->focal = (float)(1.0 / std::tan(yfov / 2.0));
  } else if (!s->tri_v.empty()) {
    double lo[3] = {1e30, 1e30, 1e30}, hi[3] = {-1e30, -1e30, -1e30};
    for (size_t i = 0; i < s->tri_v.size(); i += 3)
      for (int c = 0; c < 3; c++) {
        lo[c] = std::min(lo[c], (double)s->tri_v[i + c]);
        hi[c] = std::max(hi[c], (double)s->tri_v[i + c]);
      }
    double ext = std::max(std::max(hi[0] - lo[0], hi[1] - lo[1]),
                          hi[2] - lo[2]);
    for (int c = 0; c < 3; c++)
      s->cam_pos[c] = (float)(0.5 * (lo[c] + hi[c]));
    s->cam_pos[2] += (float)(2.0 * std::max(ext, 1e-6));
    s->cam_dir[0] = 0; s->cam_dir[1] = 0; s->cam_dir[2] = -1;
    s->focal = (float)(1.0 / std::tan(M_PI / 8));
  } else {
    // no camera, no triangles: gltf.py frames a unit bbox at origin
    // from +Z (center 0, extent 1 -> pos (0,0,2)); match it exactly
    s->cam_pos[0] = 0; s->cam_pos[1] = 0; s->cam_pos[2] = 2.0f;
    s->cam_dir[0] = 0; s->cam_dir[1] = 0; s->cam_dir[2] = -1;
    s->focal = (float)(1.0 / std::tan(M_PI / 8));
  }

  // raw embedded image bytes (decoded Python-side)
  const Json& images = gltf["images"];
  for (size_t i = 0; i < images.size() && i < 128; i++) {
    const Json& im = images.at(i);
    Image img;
    if (im.has("bufferView")) {
      const Json& view = gltf["bufferViews"].at(im["bufferView"].inum(0));
      size_t o = (size_t)view["byteOffset"].dnum(0);
      size_t l = (size_t)view["byteLength"].dnum(0);
      if (bin && o + l <= bin_len)
        img.bytes.assign(bin + o, bin + o + l);
    }
    s->images.push_back(std::move(img));
  }
  return s.release();
}

}  // namespace

extern "C" {

void* srt_load_glb(const uint8_t* data, int64_t len, const float* scale3) {
  float sc[3] = {scale3 ? scale3[0] : 1.0f, scale3 ? scale3[1] : 1.0f,
                 scale3 ? scale3[2] : 1.0f};
  // No C++ exception may cross the C ABI into ctypes (that would
  // std::terminate the whole Python process); malformed inputs become
  // an error string, which the Python side turns into a clean fallback.
  try {
    return load_glb_impl(data, (size_t)len, sc);
  } catch (const std::exception& e) {
    auto* s = new Scene();
    s->error = std::string("native loader exception: ") + e.what();
    return s;
  } catch (...) {
    auto* s = new Scene();
    s->error = "native loader exception";
    return s;
  }
}

const char* srt_error(void* sp) {
  auto* s = (Scene*)sp;
  return s->error.c_str();
}

int64_t srt_num_triangles(void* sp) {
  return (int64_t)((Scene*)sp)->tri_mat.size();
}

int64_t srt_num_materials(void* sp) {
  return (int64_t)((Scene*)sp)->mtype.size();
}

int64_t srt_num_images(void* sp) {
  return (int64_t)((Scene*)sp)->images.size();
}

void srt_copy_geometry(void* sp, float* tri_v, float* tri_n, float* tri_uv,
                       int32_t* tri_mat) {
  auto* s = (Scene*)sp;
  memcpy(tri_v, s->tri_v.data(), s->tri_v.size() * 4);
  memcpy(tri_n, s->tri_n.data(), s->tri_n.size() * 4);
  memcpy(tri_uv, s->tri_uv.data(), s->tri_uv.size() * 4);
  memcpy(tri_mat, s->tri_mat.data(), s->tri_mat.size() * 4);
}

void srt_copy_materials(void* sp, int32_t* mtype, float* albedo, int32_t* tex,
                        float* rough, float* ior, float* emissive) {
  auto* s = (Scene*)sp;
  memcpy(mtype, s->mtype.data(), s->mtype.size() * 4);
  memcpy(albedo, s->albedo.data(), s->albedo.size() * 4);
  memcpy(tex, s->tex.data(), s->tex.size() * 4);
  memcpy(rough, s->rough.data(), s->rough.size() * 4);
  memcpy(ior, s->ior.data(), s->ior.size() * 4);
  memcpy(emissive, s->emissive.data(), s->emissive.size() * 4);
}

void srt_scene_info(void* sp, float* sky3, float* campos3, float* camdir3,
                    float* focal, int32_t* has_camera) {
  auto* s = (Scene*)sp;
  memcpy(sky3, s->sky, 12);
  memcpy(campos3, s->cam_pos, 12);
  memcpy(camdir3, s->cam_dir, 12);
  *focal = s->focal;
  *has_camera = s->has_camera ? 1 : 0;
}

int64_t srt_image_size(void* sp, int32_t idx) {
  auto* s = (Scene*)sp;
  if (idx < 0 || idx >= (int32_t)s->images.size()) return 0;
  return (int64_t)s->images[idx].bytes.size();
}

void srt_copy_image(void* sp, int32_t idx, uint8_t* out) {
  auto* s = (Scene*)sp;
  if (idx < 0 || idx >= (int32_t)s->images.size()) return;
  memcpy(out, s->images[idx].bytes.data(), s->images[idx].bytes.size());
}

void srt_free(void* sp) { delete (Scene*)sp; }

}  // extern "C"
