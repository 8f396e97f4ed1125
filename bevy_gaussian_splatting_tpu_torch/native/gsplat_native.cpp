// Native host runtime: fast PLY decode, the .gcloud FlexBuffers codec and a
// host LSD radix sort.
//
// The reference's IO and CPU-sort layers are native (Rust ply-rs parser,
// rayon parallel sort: src/io/ply.rs, src/sort/rayon.rs); these are their
// C++ equivalents for the host side, exposed through a C ABI consumed via
// ctypes (native/__init__.py beside this file builds and binds it).
//
//  - ply3d_parse: single-pass binary-little-endian PLY vertex decode with the
//    reference's activation pipeline (sigmoid opacity ply.rs:40-42, mean+-4
//    clamped exp scale ply.rs:105-116, quaternion normalize ply.rs:118-124,
//    f_rest channel remap ply.rs:56-66 incl. the /16 reference quirk,
//    pad-to-32 ply.rs:127-129). Multi-threaded over row ranges.
//  - radix_sort_pairs_u32: 8-bit LSD radix sort of (key, value) pairs:
//    the host analogue of the GPU sort (src/sort/radix.wgsl), for the
//    SortMode::STD/RAYON host paths on million-key clouds where a
//    comparison argsort is the bottleneck.
//
// The arithmetic is the JAX package's native/gsplat_native.cpp, built with
// the same command line, so both decode a file to the same bits.  The
// FlexBuffers reader here also checks every offset, width and length it
// follows against the buffer's size: a malformed or truncated buffer makes
// gcloud_probe return -1 and the decoders -1 or -2, where an unchecked read
// would run outside the buffer.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

struct Ply3dHeaderInfo {
  int64_t vertex_count;
  int64_t row_stride;      // bytes per vertex row
  int64_t header_bytes;    // offset of binary payload
  int32_t ok;              // 1 on success
};

// property offsets within a row, -1 when absent
struct Ply3dOffsets {
  int32_t x, y, z, visibility;
  int32_t f_dc[3];
  int32_t f_rest[72];  // up to SH degree 4 (24 rest coeffs x 3 channels)
  int32_t n_rest;
  int32_t scale[3];
  int32_t opacity;
  int32_t rot[4];
};

}  // extern "C"

namespace {

constexpr float kMaxSizeVariance = 4.0f;  // src/io/ply.rs:21
constexpr int kShMaxRest = 72;  // degree-4 layout: 24 rest coeffs x 3 channels

int type_size(const std::string& t) {
  if (t == "float" || t == "float32" || t == "int" || t == "int32" ||
      t == "uint" || t == "uint32")
    return 4;
  if (t == "double" || t == "float64") return 8;
  if (t == "short" || t == "ushort" || t == "int16" || t == "uint16") return 2;
  if (t == "char" || t == "uchar" || t == "int8" || t == "uint8") return 1;
  return -1;
}

struct Prop {
  std::string name;
  int size;
  int offset;
};

bool parse_header(const uint8_t* data, size_t len, Ply3dHeaderInfo* info,
                  std::vector<Prop>* props) {
  const char* p = reinterpret_cast<const char*>(data);
  const char* end = p + len;
  auto read_line = [&]() -> std::string {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl) return std::string();
    std::string line(p, nl - p);
    p = nl + 1;
    if (!line.empty() && line.back() == '\r') line.pop_back();
    return line;
  };

  if (read_line() != "ply") return false;
  bool in_vertex = false;
  int64_t count = 0;
  int offset = 0;
  bool little = false;
  while (p < end) {
    std::string line = read_line();
    if (line.rfind("format ", 0) == 0) {
      little = line.find("binary_little_endian") != std::string::npos;
    } else if (line.rfind("element ", 0) == 0) {
      in_vertex = line.rfind("element vertex ", 0) == 0;
      if (in_vertex) count = atoll(line.c_str() + 15);
    } else if (line.rfind("property ", 0) == 0 && in_vertex) {
      // property <type> <name>
      size_t sp1 = line.find(' ', 9);
      if (sp1 == std::string::npos) return false;
      std::string type = line.substr(9, sp1 - 9);
      std::string name = line.substr(sp1 + 1);
      int sz = type_size(type);
      if (sz < 0) return false;  // list property etc.
      props->push_back({name, sz, offset});
      offset += sz;
    } else if (line == "end_header") {
      info->vertex_count = count;
      info->row_stride = offset;
      info->header_bytes = p - reinterpret_cast<const char*>(data);
      info->ok = little && count > 0 ? 1 : 0;
      return info->ok == 1;
    }
  }
  return false;
}

inline float load_f32(const uint8_t* row, int off) {
  float v;
  memcpy(&v, row + off, sizeof(float));
  return v;
}

}  // namespace

extern "C" {

// Returns vertex count (padded to the reference's 32 rule) or -1 on error.
// Caller allocates: pv [padded, 4], sh [padded, sh_width], rot [padded, 4],
// so [padded, 4] float32, zero-initialized.  sh_width is the padded storage
// width for the target SH degree (4/12/28/48/76); sh_per_channel the
// per-channel coefficient count (d+1)^2 driving the reference's f_rest remap
// quirk (ply.rs:56-66 divides the channel by the COMPILE-TIME count).
int64_t ply3d_parse(const uint8_t* data, int64_t len, float* pv, float* sh,
                    float* rot, float* so, int32_t strict_reference,
                    int32_t n_threads, int32_t sh_width,
                    int32_t sh_per_channel) {
  Ply3dHeaderInfo info{};
  std::vector<Prop> props;
  if (!parse_header(data, static_cast<size_t>(len), &info, &props)) return -1;

  Ply3dOffsets off;
  memset(&off, -1, sizeof(off));
  off.n_rest = 0;
  for (const auto& pr : props) {
    if (pr.size != 4) continue;  // gaussian PLYs are all-float rows
    const std::string& n = pr.name;
    if (n == "x") off.x = pr.offset;
    else if (n == "y") off.y = pr.offset;
    else if (n == "z") off.z = pr.offset;
    else if (n == "visibility") off.visibility = pr.offset;
    else if (n == "opacity") off.opacity = pr.offset;
    else if (n.rfind("f_dc_", 0) == 0) {
      int i = atoi(n.c_str() + 5);
      if (i >= 0 && i < 3) off.f_dc[i] = pr.offset;
    } else if (n.rfind("f_rest_", 0) == 0) {
      int i = atoi(n.c_str() + 7);
      if (i >= 0 && i < kShMaxRest) {
        off.f_rest[i] = pr.offset;
        if (i + 1 > off.n_rest) off.n_rest = i + 1;
      }
    } else if (n.rfind("scale_", 0) == 0) {
      int i = atoi(n.c_str() + 6);
      if (i >= 0 && i < 3) off.scale[i] = pr.offset;
    } else if (n.rfind("rot_", 0) == 0) {
      int i = atoi(n.c_str() + 4);
      if (i >= 0 && i < 4) off.rot[i] = pr.offset;
    }
  }
  // required set (ply.rs:81-85)
  if (off.x < 0 || off.y < 0 || off.z < 0 || off.f_dc[0] < 0 ||
      off.f_dc[1] < 0 || off.f_dc[2] < 0 || off.scale[0] < 0 ||
      off.scale[1] < 0 || off.opacity < 0 || off.rot[0] < 0 ||
      off.rot[1] < 0 || off.rot[2] < 0 || off.rot[3] < 0)
    return -2;

  const int64_t n = info.vertex_count;
  const int64_t stride = info.row_stride;
  // truncated (n * stride > len - header_bytes, without the overflow)
  if (stride <= 0 || n > (len - info.header_bytes) / stride) return -3;
  const uint8_t* base = data + info.header_bytes;

  // precompute f_rest -> interleaved slot map (ply.rs:56-66); a degree-0
  // build has no rest coefficients (per_channel - 1 would divide by zero)
  int rest_slot[kShMaxRest];
  for (int i = 0; i < kShMaxRest; ++i) {
    if (sh_per_channel <= 1) {
      rest_slot[i] = -1;
      continue;
    }
    int channel =
        strict_reference ? i / sh_per_channel : i / (sh_per_channel - 1);
    int coefficient = (i % (sh_per_channel - 1)) + 1;
    int idx = coefficient * 3 + channel;
    rest_slot[i] = idx < sh_width ? idx : -1;
  }

  int nt = n_threads > 0 ? n_threads : 1;
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const uint8_t* row = base + r * stride;
      float* pvr = pv + r * 4;
      float* shr = sh + r * sh_width;
      float* rotr = rot + r * 4;
      float* sor = so + r * 4;

      pvr[0] = load_f32(row, off.x);
      pvr[1] = load_f32(row, off.y);
      pvr[2] = load_f32(row, off.z);
      pvr[3] = off.visibility >= 0 ? load_f32(row, off.visibility) : 1.0f;

      shr[0] = load_f32(row, off.f_dc[0]);
      shr[1] = load_f32(row, off.f_dc[1]);
      shr[2] = load_f32(row, off.f_dc[2]);
      for (int i = 0; i < off.n_rest; ++i) {
        if (off.f_rest[i] >= 0 && rest_slot[i] >= 0)
          shr[rest_slot[i]] = load_f32(row, off.f_rest[i]);
      }

      float q0 = load_f32(row, off.rot[0]), q1 = load_f32(row, off.rot[1]);
      float q2 = load_f32(row, off.rot[2]), q3 = load_f32(row, off.rot[3]);
      float norm = std::sqrt(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3);
      rotr[0] = q0 / norm;
      rotr[1] = q1 / norm;
      rotr[2] = q2 / norm;
      rotr[3] = q3 / norm;

      float s0 = load_f32(row, off.scale[0]);
      float s1 = load_f32(row, off.scale[1]);
      float s2 = off.scale[2] >= 0 ? load_f32(row, off.scale[2]) : s1;
      float mean = (s0 + s1 + s2) / 3.0f;
      auto act = [&](float v) {
        v = std::min(std::max(v, mean - kMaxSizeVariance), mean + kMaxSizeVariance);
        return std::exp(v);
      };
      sor[0] = act(s0);
      sor[1] = act(s1);
      sor[2] = act(s2);
      sor[3] = 1.0f / (1.0f + std::exp(-load_f32(row, off.opacity)));
    }
  };

  if (nt <= 1 || n < 4096) {
    worker(0, n);
  } else {
    std::vector<std::thread> threads;
    int64_t step = (n + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      int64_t lo = t * step, hi = std::min(n, lo + step);
      if (lo < hi) threads.emplace_back(worker, lo, hi);
    }
    for (auto& th : threads) th.join();
  }

  int64_t pad = 32 - (n % 32);  // reference always appends (ply.rs:127-128)
  return n + pad;
}

// Peek at vertex count + padded count without decoding.
int64_t ply3d_count(const uint8_t* data, int64_t len) {
  Ply3dHeaderInfo info{};
  std::vector<Prop> props;
  if (!parse_header(data, static_cast<size_t>(len), &info, &props)) return -1;
  return info.vertex_count + (32 - info.vertex_count % 32);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Flexbuffers .gcloud codec (serde layout of src/io/gcloud/flexbuffers.rs).
//
// Encoder: schema-specialized writer producing a standard flexbuffers buffer
// readable by any conforming reader (the Python flatbuffers.flexbuffers module
// round-trips it in tests).  Design choices for speed: all offsets/sizes use
// fixed 4-byte widths, each column shares ONE key vector across its N row maps
// (the format explicitly allows key-vector sharing), and every row has a fixed
// byte stride so encoding is a tight memcpy loop.
//
// Decoder: a general reader for the subset used by gcloud buffers (maps,
// untyped vectors, typed float/key vectors, inline floats at any byte width),
// so it also decodes buffers written by minimal-width encoders.
// ---------------------------------------------------------------------------

namespace gcloudfb {

constexpr uint8_t kPackedFloatW32 = (3 << 2) | 2;    // inline FLOAT, W32 parent
constexpr uint8_t kPackedVecFloat = (13 << 2) | 2;   // VECTOR_FLOAT, W32
constexpr uint8_t kPackedMap = (9 << 2) | 2;         // MAP, W32
constexpr uint8_t kPackedVec = (10 << 2) | 2;        // VECTOR (untyped), W32

struct Writer {
  uint8_t* buf;
  size_t pos = 0;
  void u8(uint8_t v) { buf[pos++] = v; }
  void u32(uint32_t v) {
    memcpy(buf + pos, &v, 4);
    pos += 4;
  }
  void f32(float v) {
    memcpy(buf + pos, &v, 4);
    pos += 4;
  }
  void f32s(const float* v, int n) {
    memcpy(buf + pos, v, 4 * size_t(n));
    pos += 4 * size_t(n);
  }
  void bytes(const char* s, size_t n) {
    memcpy(buf + pos, s, n);
    pos += n;
  }
  void align4() {
    while (pos & 3) buf[pos++] = 0;
  }
  // offset slot: stores (slot position - target)
  void off(size_t target) { u32(static_cast<uint32_t>(pos - target)); }
};

// Writes a null-terminated key and returns its offset.
inline size_t put_key(Writer& w, const char* s) {
  size_t loc = w.pos;
  w.bytes(s, strlen(s) + 1);
  return loc;
}

// Typed key vector from sorted key offsets; returns vector loc (element 0).
inline size_t put_keys_vector(Writer& w, const size_t* keys, int n) {
  w.align4();
  w.u32(static_cast<uint32_t>(n));
  size_t loc = w.pos;
  for (int i = 0; i < n; ++i) w.off(keys[i]);
  return loc;
}

// Typed f32 vector; returns loc.
inline size_t put_f32_vector(Writer& w, const float* v, int n) {
  w.align4();
  w.u32(static_cast<uint32_t>(n));
  size_t loc = w.pos;
  w.f32s(v, n);
  return loc;
}

// Map with a shared keys vector; values are (loc, packed_type) pairs where a
// packed type of kPackedFloatW32 means `inline_val` is written inline.
struct MapVal {
  size_t loc;      // target for offset slots; ignored for inline
  uint8_t type;
  float inline_val;  // used when type == kPackedFloatW32
};

inline size_t put_map(Writer& w, size_t keys_loc, const MapVal* vals, int n) {
  w.align4();
  w.off(keys_loc);
  w.u32(4);  // keys vector byte width
  w.u32(static_cast<uint32_t>(n));
  size_t loc = w.pos;
  for (int i = 0; i < n; ++i) {
    if (vals[i].type == kPackedFloatW32) {
      w.f32(vals[i].inline_val);
    } else {
      w.off(vals[i].loc);
    }
  }
  for (int i = 0; i < n; ++i) w.u8(vals[i].type);
  return loc;
}

// Untyped vector of N offset elements with one shared packed type.
inline size_t put_offset_vector(Writer& w, const size_t* locs, int64_t n,
                                uint8_t packed_type) {
  w.align4();
  w.u32(static_cast<uint32_t>(n));
  size_t loc = w.pos;
  for (int64_t i = 0; i < n; ++i) w.off(locs[i]);
  for (int64_t i = 0; i < n; ++i) w.u8(packed_type);
  return loc;
}

// ---- columns ----------------------------------------------------------------

// vec-field + scalar-field rows, e.g. {position: [f32;3], visibility: f} —
// keys must be passed sorted; `vec_first` says whether the vector field sorts
// before the scalar field.
inline size_t put_vec_scalar_column(Writer& w, size_t key_vec, size_t key_scalar,
                                    bool vec_first, const float* data, int64_t n,
                                    int vec_dim, std::vector<size_t>& scratch) {
  size_t keys[2] = {vec_first ? key_vec : key_scalar,
                    vec_first ? key_scalar : key_vec};
  size_t kv = put_keys_vector(w, keys, 2);
  scratch.resize(n);
  for (int64_t r = 0; r < n; ++r) {
    const float* row = data + r * (vec_dim + 1);
    size_t vloc = put_f32_vector(w, row, vec_dim);
    MapVal vals[2];
    MapVal vecv{vloc, kPackedVecFloat, 0.0f};
    MapVal scal{0, kPackedFloatW32, row[vec_dim]};
    vals[0] = vec_first ? vecv : scal;
    vals[1] = vec_first ? scal : vecv;
    scratch[r] = put_map(w, kv, vals, 2);
  }
  return put_offset_vector(w, scratch.data(), n, kPackedMap);
}

// single-vector rows, e.g. {rotation: [f32;4]} or {coefficients: [f32;48]}
inline size_t put_vec_column(Writer& w, size_t key, const float* data,
                             int64_t n, int dim, std::vector<size_t>& scratch) {
  size_t kv = put_keys_vector(w, &key, 1);
  scratch.resize(n);
  for (int64_t r = 0; r < n; ++r) {
    size_t vloc = put_f32_vector(w, data + r * dim, dim);
    MapVal v{vloc, kPackedVecFloat, 0.0f};
    scratch[r] = put_map(w, kv, &v, 1);
  }
  return put_offset_vector(w, scratch.data(), n, kPackedMap);
}

// two-vector rows: {rotation: [f32;4], rotation_r: [f32;4]} (keys pre-sorted)
inline size_t put_vec2_column(Writer& w, size_t key_a, size_t key_b,
                              const float* data, int64_t n, int dim_a, int dim_b,
                              std::vector<size_t>& scratch) {
  size_t keys[2] = {key_a, key_b};
  size_t kv = put_keys_vector(w, keys, 2);
  scratch.resize(n);
  for (int64_t r = 0; r < n; ++r) {
    const float* row = data + r * (dim_a + dim_b);
    size_t va = put_f32_vector(w, row, dim_a);
    size_t vb = put_f32_vector(w, row + dim_a, dim_b);
    MapVal vals[2] = {{va, kPackedVecFloat, 0.0f}, {vb, kPackedVecFloat, 0.0f}};
    scratch[r] = put_map(w, kv, vals, 2);
  }
  return put_offset_vector(w, scratch.data(), n, kPackedMap);
}

// two-scalar rows: {timestamp: f, timescale: f} (keys pre-sorted)
inline size_t put_scalar2_column(Writer& w, size_t key_a, size_t key_b,
                                 const float* data, int64_t n,
                                 std::vector<size_t>& scratch) {
  size_t keys[2] = {key_a, key_b};
  size_t kv = put_keys_vector(w, keys, 2);
  scratch.resize(n);
  for (int64_t r = 0; r < n; ++r) {
    MapVal vals[2] = {{0, kPackedFloatW32, data[r * 2]},
                      {0, kPackedFloatW32, data[r * 2 + 1]}};
    scratch[r] = put_map(w, kv, vals, 2);
  }
  return put_offset_vector(w, scratch.data(), n, kPackedMap);
}

inline void finish_root(Writer& w, const size_t* root_keys, const size_t* cols,
                        int ncols) {
  size_t kv = put_keys_vector(w, root_keys, ncols);
  std::vector<MapVal> vals(ncols);
  for (int i = 0; i < ncols; ++i) vals[i] = {cols[i], kPackedVec, 0.0f};
  size_t root = put_map(w, kv, vals.data(), ncols);
  w.align4();
  w.off(root);
  w.u8(kPackedMap);
  w.u8(4);
}

// ---- generic reader (subset) -------------------------------------------------
//
// Every offset, width and length is checked against the buffer's size: a
// failed check gives a node of type -1 or a reference with ok == false,
// which the callers treat as a missing field.

// [pos, pos + n) lies inside a buffer of `size` bytes
inline bool inside(size_t size, size_t pos, size_t n) {
  return pos <= size && n <= size - pos;
}

inline bool valid_width(uint64_t bw) {
  return bw == 1 || bw == 2 || bw == 4 || bw == 8;
}

inline uint64_t rd_uint(const uint8_t* p, int bw) {
  uint64_t v = 0;
  memcpy(&v, p, bw);
  return v;
}

inline double rd_float(const uint8_t* p, int bw) {
  if (bw == 4) {
    float f;
    memcpy(&f, p, 4);
    return f;
  }
  double d;
  memcpy(&d, p, 8);
  return d;
}

struct Node {
  const uint8_t* base;  // buffer start
  size_t size;          // buffer size
  size_t pos;           // element position
  int type;             // flexbuffers type, -1 when missing or malformed
  int bw;               // byte width of the pointed-to data
};

inline Node bad_node() {
  Node n{};
  n.type = -1;
  return n;
}

// The target of the offset slot at `slot`; false when the slot or the
// target lies outside the buffer.
inline bool indirect(const uint8_t* base, size_t size, size_t slot,
                     int parent_bw, size_t* target) {
  if (!inside(size, slot, parent_bw)) return false;
  uint64_t off = rd_uint(base + slot, parent_bw);
  if (off > slot) return false;
  *target = slot - off;
  return true;
}

// Follow an element at `slot` (inside a vector/map with `parent_bw`).
inline Node elem(const uint8_t* base, size_t size, size_t slot, int parent_bw,
                 uint8_t packed) {
  Node n;
  n.base = base;
  n.size = size;
  n.type = packed >> 2;
  n.bw = 1 << (packed & 3);
  if (n.type <= 3 || n.type == 26) {  // inline
    if (!inside(size, slot, parent_bw)) return bad_node();
    n.pos = slot;
    n.bw = parent_bw;
  } else if (!indirect(base, size, slot, parent_bw, &n.pos)) {
    return bad_node();
  }
  return n;
}

// A float or double scalar node's value; false for another width or a
// value outside the buffer.
inline bool node_float(const Node& n, float* out) {
  if (n.type < 0 || (n.bw != 4 && n.bw != 8) || !inside(n.size, n.pos, n.bw))
    return false;
  *out = static_cast<float>(rd_float(n.base + n.pos, n.bw));
  return true;
}

struct MapRef {
  const uint8_t* base;
  size_t size;  // buffer size
  size_t loc;  // values start
  int bw;
  int64_t len;
  size_t keys_loc;
  int keys_bw;
  bool ok;  // the map's header, values, type bytes and keys lie in the buffer
};

inline MapRef as_map(const Node& n) {
  MapRef m{};
  if (n.type < 0) return m;
  const size_t bw = size_t(n.bw);
  if (n.pos < 3 * bw || !inside(n.size, n.pos - 3 * bw, 3 * bw)) return m;
  m.base = n.base;
  m.size = n.size;
  m.loc = n.pos;
  m.bw = n.bw;
  uint64_t count = rd_uint(n.base + n.pos - bw, n.bw);
  uint64_t keys_bw = rd_uint(n.base + n.pos - 2 * bw, n.bw);
  if (count > n.size || !valid_width(keys_bw)) return m;
  m.len = static_cast<int64_t>(count);
  m.keys_bw = static_cast<int>(keys_bw);
  if (!indirect(n.base, n.size, n.pos - 3 * bw, n.bw, &m.keys_loc)) return m;
  m.ok = inside(n.size, m.loc, count * (bw + 1)) &&
         inside(n.size, m.keys_loc, count * keys_bw);
  return m;
}

inline Node map_get(const MapRef& m, const char* key) {
  if (!m.ok) return bad_node();
  const size_t key_bytes = strlen(key) + 1;
  for (int64_t i = 0; i < m.len; ++i) {
    size_t kslot = m.keys_loc + size_t(i) * m.keys_bw;
    size_t kpos;
    if (!indirect(m.base, m.size, kslot, m.keys_bw, &kpos)) return bad_node();
    if (inside(m.size, kpos, key_bytes) &&
        memcmp(m.base + kpos, key, key_bytes) == 0) {
      uint8_t packed = m.base[m.loc + size_t(m.len) * m.bw + i];
      return elem(m.base, m.size, m.loc + size_t(i) * m.bw, m.bw, packed);
    }
  }
  return bad_node();
}

struct VecRef {
  const uint8_t* base;
  size_t size;  // buffer size
  size_t loc;
  int bw;
  int64_t len;
  bool typed;  // typed vectors store no per-element type bytes
  int elem_type;
  bool ok;  // the length, elements and type bytes lie in the buffer
};

inline VecRef as_vec(const Node& n) {
  VecRef v{};
  if (n.type < 0) return v;
  const size_t bw = size_t(n.bw);
  if (n.pos < bw || !inside(n.size, n.pos - bw, bw)) return v;
  v.base = n.base;
  v.size = n.size;
  v.loc = n.pos;
  v.bw = n.bw;
  uint64_t count = rd_uint(n.base + n.pos - bw, n.bw);
  v.typed = n.type >= 11 && n.type <= 15;
  v.elem_type = v.typed ? n.type - 11 + 1 : 0;
  if (count > n.size) return v;
  v.len = static_cast<int64_t>(count);
  v.ok = inside(n.size, v.loc, count * (bw + (v.typed ? 0 : 1)));
  return v;
}

inline Node vec_get(const VecRef& v, int64_t i) {
  if (!v.ok || i < 0 || i >= v.len) return bad_node();
  uint8_t packed;
  if (v.typed) {
    packed = static_cast<uint8_t>((v.elem_type << 2) | (31 - __builtin_clz(v.bw)));
  } else {
    packed = v.base[v.loc + size_t(v.len) * v.bw + i];
  }
  return elem(v.base, v.size, v.loc + size_t(i) * v.bw, v.bw, packed);
}

// read a float vector field into out[0..dim)
inline bool read_f32s(const Node& n, float* out, int dim) {
  if (n.type < 0) return false;
  VecRef v = as_vec(n);
  if (!v.ok || v.len < dim) return false;
  if (v.typed && v.elem_type == 3 && v.bw == 4) {  // fast path: raw f32
    memcpy(out, v.base + v.loc, 4 * size_t(dim));
    return true;
  }
  for (int i = 0; i < dim; ++i) {
    if (!node_float(vec_get(v, i), out + i)) return false;
  }
  return true;
}

inline Node root_node(const uint8_t* data, int64_t len) {
  if (len < 3) return bad_node();
  int root_bw = data[len - 1];
  if (!valid_width(root_bw) || size_t(len) < 2 + size_t(root_bw)) return bad_node();
  uint8_t packed = data[len - 2];
  size_t slot = size_t(len) - 2 - root_bw;
  return elem(data, size_t(len), slot, root_bw, packed);
}

}  // namespace gcloudfb

extern "C" {

// Exact encoded size for the fixed-width layout above.  sh_width is the
// cloud's SH storage width (4/12/28/48/76 per the sh0..sh4 degree axis).
int64_t gcloud3d_size(int64_t n, int32_t sh_width) {
  // keys 109 (+3 align) ; per column: keys vec + rows + column vec
  int64_t pv = 12 + 40 * n + (4 + 5 * n + 3) / 4 * 4;
  int64_t rot = 8 + 40 * n + (4 + 5 * n + 3) / 4 * 4;
  int64_t so = 12 + 40 * n + (4 + 5 * n + 3) / 4 * 4;
  // per row: f32 vec (4 + 4*w, 4-aligned) + map (12 + 4 + 1 -> pad)
  int64_t sh = 8 + (24 + 4 * int64_t(sh_width)) * n + (4 + 5 * n + 3) / 4 * 4;
  return pv + rot + so + sh + 512;  // + keys/root blocks + alignment slack
}

int64_t gcloud4d_size(int64_t n) {
  int64_t colvec = (4 + 5 * n + 3) / 4 * 4;
  int64_t pv = 12 + 40 * n + colvec;
  int64_t iso = 12 + 64 * n + colvec;  // two [4]-vecs (20+20) + map 24
  int64_t so = 12 + 40 * n + colvec;
  int64_t sh = 8 + 600 * n + colvec;  // vec 4+576, map 17 pad to 20
  int64_t ts = 12 + 24 * n + colvec;  // map only: 12+8+2 pad to 24
  return pv + iso + so + sh + ts + 1024;  // + keys/root blocks + slack
}

// Encode Gaussian3d planar cloud -> flexbuffers; returns bytes written.
// pv [n,4], sh [n,sh_width], rot [n,4], so [n,4].  out must hold
// gcloud3d_size(n, sh_width).
int64_t gcloud3d_encode(const float* pv, const float* sh, const float* rot,
                        const float* so, int64_t n, uint8_t* out,
                        int32_t sh_width) {
  using namespace gcloudfb;
  Writer w{out};
  size_t k_coeff = put_key(w, "coefficients");
  size_t k_opacity = put_key(w, "opacity");
  size_t k_position = put_key(w, "position");
  size_t k_pv = put_key(w, "position_visibility");
  size_t k_rotation = put_key(w, "rotation");
  size_t k_scale = put_key(w, "scale");
  size_t k_so = put_key(w, "scale_opacity");
  size_t k_sh = put_key(w, "spherical_harmonic");
  size_t k_vis = put_key(w, "visibility");

  std::vector<size_t> scratch;
  // row-map keys sorted: {position < visibility}, {opacity < scale}
  size_t col_pv = put_vec_scalar_column(w, k_position, k_vis, true, pv, n, 3, scratch);
  size_t col_rot = put_vec_column(w, k_rotation, rot, n, 4, scratch);
  size_t col_so = put_vec_scalar_column(w, k_scale, k_opacity, false, so, n, 3, scratch);
  size_t col_sh = put_vec_column(w, k_coeff, sh, n, sh_width, scratch);

  // root keys sorted alphabetically
  size_t root_keys[4] = {k_pv, k_rotation, k_so, k_sh};
  size_t cols[4] = {col_pv, col_rot, col_so, col_sh};
  finish_root(w, root_keys, cols, 4);
  return static_cast<int64_t>(w.pos);
}

// Encode Gaussian4d planar cloud.  pv [n,4], sh [n,144], iso [n,8], so [n,4],
// ts [n,2].
int64_t gcloud4d_encode(const float* pv, const float* sh, const float* iso,
                        const float* so, const float* ts, int64_t n,
                        uint8_t* out) {
  using namespace gcloudfb;
  Writer w{out};
  size_t k_coeff = put_key(w, "coefficients");
  size_t k_iso = put_key(w, "isotropic_rotations");
  size_t k_opacity = put_key(w, "opacity");
  size_t k_position = put_key(w, "position");
  size_t k_pv = put_key(w, "position_visibility");
  size_t k_rotation = put_key(w, "rotation");
  size_t k_rot_r = put_key(w, "rotation_r");
  size_t k_scale = put_key(w, "scale");
  size_t k_so = put_key(w, "scale_opacity");
  size_t k_sh = put_key(w, "spherindrical_harmonic");
  size_t k_tt = put_key(w, "timestamp_timescale");
  size_t k_timescale = put_key(w, "timescale");
  size_t k_timestamp = put_key(w, "timestamp");
  size_t k_vis = put_key(w, "visibility");

  std::vector<size_t> scratch;
  size_t col_pv = put_vec_scalar_column(w, k_position, k_vis, true, pv, n, 3, scratch);
  // {rotation < rotation_r}
  size_t col_iso = put_vec2_column(w, k_rotation, k_rot_r, iso, n, 4, 4, scratch);
  size_t col_so = put_vec_scalar_column(w, k_scale, k_opacity, false, so, n, 3, scratch);
  size_t col_sh = put_vec_column(w, k_coeff, sh, n, 144, scratch);
  // {timestamp < timescale}? lexicographic: "timesc" < "timest", so
  // timescale sorts FIRST; field order in rows is (timestamp, timescale) in
  // the data, swap into sorted (timescale, timestamp) layout
  std::vector<float> ts_sorted(size_t(n) * 2);
  for (int64_t r = 0; r < n; ++r) {
    ts_sorted[r * 2] = ts[r * 2 + 1];   // timescale
    ts_sorted[r * 2 + 1] = ts[r * 2];   // timestamp
  }
  size_t col_ts = put_scalar2_column(w, k_timescale, k_timestamp,
                                     ts_sorted.data(), n, scratch);

  // root keys sorted alphabetically
  size_t root_keys[5] = {k_iso, k_pv, k_so, k_sh, k_tt};
  size_t cols[5] = {col_iso, col_pv, col_so, col_sh, col_ts};
  finish_root(w, root_keys, cols, 5);
  return static_cast<int64_t>(w.pos);
}

// Probe a gcloud buffer: returns row count, sets *is4d and *sh_width (the
// per-row coefficient count of the harmonic column — the SH degree axis).
int64_t gcloud_probe(const uint8_t* data, int64_t len, int32_t* is4d,
                     int32_t* sh_width) {
  using namespace gcloudfb;
  if (len < 3) return -1;
  Node root = root_node(data, len);
  if (root.type != 9) return -1;
  MapRef m = as_map(root);
  if (!m.ok) return -1;
  Node sh4 = map_get(m, "spherindrical_harmonic");
  *is4d = sh4.type >= 0 ? 1 : 0;
  VecRef pv = as_vec(map_get(m, "position_visibility"));
  if (!pv.ok) return -1;
  int64_t n = pv.len;
  *sh_width = 0;
  Node shcol = *is4d ? sh4 : map_get(m, "spherical_harmonic");
  VecRef v = as_vec(shcol);
  if (v.ok && v.len > 0) {
    Node row = vec_get(v, 0);
    if (row.type == 9) {
      VecRef coeffs = as_vec(map_get(as_map(row), "coefficients"));
      if (coeffs.ok) *sh_width = static_cast<int32_t>(coeffs.len);
    }
  }
  return n;
}

}  // extern "C"

namespace gcloudfb {

// decode a column of maps; `fill` extracts one row into out + r*row_stride
template <typename F>
bool decode_column(const MapRef& root, const char* name, int64_t n, F fill) {
  VecRef v = as_vec(map_get(root, name));
  if (!v.ok || v.len < n) return false;
  for (int64_t r = 0; r < n; ++r) {
    Node e = vec_get(v, r);
    if (e.type != 9) return false;
    MapRef m = as_map(e);
    if (!m.ok || !fill(m, r)) return false;
  }
  return true;
}

inline bool read_scalar(const MapRef& m, const char* key, float* out) {
  return node_float(map_get(m, key), out);
}

}  // namespace gcloudfb

extern "C" {

// Decode 3D gcloud into caller-allocated arrays (sh is [n, sh_width] as
// reported by gcloud_probe); returns n or negative error.
int64_t gcloud3d_decode(const uint8_t* data, int64_t len, float* pv, float* sh,
                        float* rot, float* so, int64_t n, int32_t sh_width) {
  using namespace gcloudfb;
  Node root = root_node(data, len);
  if (root.type != 9) return -1;
  MapRef rm = as_map(root);
  if (!rm.ok) return -1;
  bool ok =
      decode_column(rm, "position_visibility", n, [&](const MapRef& m, int64_t r) {
        return read_f32s(map_get(m, "position"), pv + r * 4, 3) &&
               read_scalar(m, "visibility", pv + r * 4 + 3);
      }) &&
      decode_column(rm, "spherical_harmonic", n, [&](const MapRef& m, int64_t r) {
        return read_f32s(map_get(m, "coefficients"), sh + r * sh_width,
                         sh_width);
      }) &&
      decode_column(rm, "rotation", n, [&](const MapRef& m, int64_t r) {
        return read_f32s(map_get(m, "rotation"), rot + r * 4, 4);
      }) &&
      decode_column(rm, "scale_opacity", n, [&](const MapRef& m, int64_t r) {
        return read_f32s(map_get(m, "scale"), so + r * 4, 3) &&
               read_scalar(m, "opacity", so + r * 4 + 3);
      });
  return ok ? n : -2;
}

// Decode 4D gcloud; arrays: pv [n,4], sh [n,144], iso [n,8], so [n,4], ts [n,2].
int64_t gcloud4d_decode(const uint8_t* data, int64_t len, float* pv, float* sh,
                        float* iso, float* so, float* ts, int64_t n) {
  using namespace gcloudfb;
  Node root = root_node(data, len);
  if (root.type != 9) return -1;
  MapRef rm = as_map(root);
  if (!rm.ok) return -1;
  bool ok =
      decode_column(rm, "position_visibility", n, [&](const MapRef& m, int64_t r) {
        return read_f32s(map_get(m, "position"), pv + r * 4, 3) &&
               read_scalar(m, "visibility", pv + r * 4 + 3);
      }) &&
      decode_column(rm, "spherindrical_harmonic", n, [&](const MapRef& m, int64_t r) {
        return read_f32s(map_get(m, "coefficients"), sh + r * 144, 144);
      }) &&
      decode_column(rm, "isotropic_rotations", n, [&](const MapRef& m, int64_t r) {
        return read_f32s(map_get(m, "rotation"), iso + r * 8, 4) &&
               read_f32s(map_get(m, "rotation_r"), iso + r * 8 + 4, 4);
      }) &&
      decode_column(rm, "scale_opacity", n, [&](const MapRef& m, int64_t r) {
        return read_f32s(map_get(m, "scale"), so + r * 4, 3) &&
               read_scalar(m, "opacity", so + r * 4 + 3);
      }) &&
      decode_column(rm, "timestamp_timescale", n, [&](const MapRef& m, int64_t r) {
        return read_scalar(m, "timestamp", ts + r * 2) &&
               read_scalar(m, "timescale", ts + r * 2 + 1);
      });
  return ok ? n : -2;
}

// 8-bit LSD radix sort of u32 keys with u32 payload, ascending, stable.
void radix_sort_pairs_u32(uint32_t* keys, uint32_t* vals, int64_t n) {
  std::vector<uint32_t> kbuf(n), vbuf(n);
  uint32_t* ks[2] = {keys, kbuf.data()};
  uint32_t* vs[2] = {vals, vbuf.data()};
  for (int pass = 0; pass < 4; ++pass) {
    int src = pass & 1, dst = src ^ 1;
    size_t hist[257] = {0};
    int shift = pass * 8;
    for (int64_t i = 0; i < n; ++i) ++hist[((ks[src][i] >> shift) & 0xFF) + 1];
    for (int d = 0; d < 256; ++d) hist[d + 1] += hist[d];
    for (int64_t i = 0; i < n; ++i) {
      size_t pos = hist[(ks[src][i] >> shift) & 0xFF]++;
      ks[dst][pos] = ks[src][i];
      vs[dst][pos] = vs[src][i];
    }
  }
  // 4 passes => result lands back in the caller's buffers (parity invariant,
  // tests/radix.rs:65-79)
}

}  // extern "C"
