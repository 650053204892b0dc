// sdfgenfast native I/O library.
//
// Clean-room, high-throughput implementations of the framework's file formats
// (the reference implements these in C++ too: common/mesh_io_obj.cpp,
// common/mesh_io_stl.cpp, common/sdf_io.cpp — semantics matched, code new):
//   - Wavefront OBJ:   v / f lines, v|v/vt|v/vt/vn|v//vn, fan triangulation,
//                      1-based (and negative-relative) indices
//   - STL:             binary/ASCII auto-detect via the "solid" prefix +
//                      exact-size rule 80+4+50n; 3 duplicated verts per tri
//   - .sdf:            36-byte header (3x i32 dims, 3x f32 min, 3x f32 max)
//                      + f32 payload, k-fastest
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment). All
// returned buffers are malloc'd; free with sdfgenio_free.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cctype>
#include <string>
#include <vector>

namespace {

struct Buf {
  char* data = nullptr;
  size_t len = 0;
  ~Buf() { free(data); }
};

bool read_file(const char* path, Buf& b) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n < 0) { fclose(f); return false; }
  b.data = static_cast<char*>(malloc(static_cast<size_t>(n) + 1));
  b.len = static_cast<size_t>(n);
  size_t rd = fread(b.data, 1, b.len, f);
  fclose(f);
  if (rd != b.len) return false;
  b.data[b.len] = '\0';
  return true;
}

void set_err(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    snprintf(err, static_cast<size_t>(errlen), "%s", msg);
  }
}

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

}  // namespace

extern "C" {

void sdfgenio_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// OBJ
// ---------------------------------------------------------------------------

int sdfgenio_load_obj(const char* path, float** out_verts, uint32_t** out_tris,
                      int64_t* out_nv, int64_t* out_nt, char* err, int errlen) {
  Buf buf;
  if (!read_file(path, buf)) {
    set_err(err, errlen, "failed to open OBJ file");
    return 1;
  }
  std::vector<float> verts;
  std::vector<uint32_t> tris;
  std::vector<int64_t> face;  // scratch per face line
  verts.reserve(1 << 16);
  tris.reserve(1 << 16);

  const char* p = buf.data;
  const char* end = buf.data + buf.len;
  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (p[0] == 'v' && (p + 1 < end) && (p[1] == ' ' || p[1] == '\t')) {
      char* q = nullptr;
      const char* s = p + 1;
      float x = strtof(s, &q);
      float y = strtof(q, &q);
      float z = strtof(q, &q);
      if (q != s) {
        verts.push_back(x);
        verts.push_back(y);
        verts.push_back(z);
      }
    } else if (p[0] == 'f' && (p + 1 < end) && (p[1] == ' ' || p[1] == '\t')) {
      face.clear();
      const char* s = p + 1;
      const char* line_end = s;
      while (line_end < end && *line_end != '\n') ++line_end;
      while (s < line_end) {
        s = skip_ws(s, line_end);
        if (s >= line_end || *s == '\n') break;
        char* q = nullptr;
        long idx = strtol(s, &q, 10);
        if (q == s) break;  // not a number
        face.push_back(idx);
        // skip /vt/vn suffix up to whitespace
        s = q;
        while (s < line_end && *s != ' ' && *s != '\t' && *s != '\r') ++s;
      }
      if (face.size() >= 3) {
        int64_t nv_now = static_cast<int64_t>(verts.size() / 3);
        auto resolve = [&](int64_t i) -> int64_t {
          return i < 0 ? i + 1 + nv_now : i;  // negative = relative
        };
        int64_t v0 = resolve(face[0]) - 1;
        for (size_t t = 1; t + 1 < face.size(); ++t) {
          tris.push_back(static_cast<uint32_t>(v0));
          tris.push_back(static_cast<uint32_t>(resolve(face[t]) - 1));
          tris.push_back(static_cast<uint32_t>(resolve(face[t + 1]) - 1));
        }
      }
    }
    p = next_line(p, end);
  }
  if (verts.empty()) {
    set_err(err, errlen, "No vertices found in OBJ file");
    return 2;
  }
  if (tris.empty()) {
    set_err(err, errlen, "No faces found in OBJ file");
    return 3;
  }
  *out_nv = static_cast<int64_t>(verts.size() / 3);
  *out_nt = static_cast<int64_t>(tris.size() / 3);
  *out_verts = static_cast<float*>(malloc(verts.size() * sizeof(float)));
  *out_tris = static_cast<uint32_t*>(malloc(tris.size() * sizeof(uint32_t)));
  memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
  memcpy(*out_tris, tris.data(), tris.size() * sizeof(uint32_t));
  return 0;
}

// ---------------------------------------------------------------------------
// STL
// ---------------------------------------------------------------------------

static int load_binary_stl(const Buf& buf, float** out_verts, uint32_t** out_tris,
                           int64_t* out_nv, int64_t* out_nt, char* err, int errlen) {
  if (buf.len < 84) {
    set_err(err, errlen, "binary STL truncated");
    return 4;
  }
  uint32_t n;
  memcpy(&n, buf.data + 80, 4);
  size_t need = 84 + static_cast<size_t>(n) * 50;
  if (buf.len < need) {
    set_err(err, errlen, "binary STL truncated");
    return 4;
  }
  if (n == 0) {
    set_err(err, errlen, "No faces found in STL file");
    return 3;
  }
  float* verts = static_cast<float*>(malloc(static_cast<size_t>(n) * 9 * sizeof(float)));
  uint32_t* tris = static_cast<uint32_t*>(malloc(static_cast<size_t>(n) * 3 * sizeof(uint32_t)));
  const char* rec = buf.data + 84;
  for (uint32_t i = 0; i < n; ++i, rec += 50) {
    memcpy(verts + static_cast<size_t>(i) * 9, rec + 12, 36);  // skip normal
    tris[i * 3 + 0] = i * 3 + 0;
    tris[i * 3 + 1] = i * 3 + 1;
    tris[i * 3 + 2] = i * 3 + 2;
  }
  *out_verts = verts;
  *out_tris = tris;
  *out_nv = static_cast<int64_t>(n) * 3;
  *out_nt = static_cast<int64_t>(n);
  return 0;
}

static int load_ascii_stl(const Buf& buf, float** out_verts, uint32_t** out_tris,
                          int64_t* out_nv, int64_t* out_nt, char* err, int errlen) {
  std::vector<float> verts;
  verts.reserve(1 << 16);
  const char* p = buf.data;
  const char* end = buf.data + buf.len;
  while (p < end) {
    p = skip_ws(p, end);
    if (end - p >= 6 && strncasecmp(p, "vertex", 6) == 0) {
      char* q = nullptr;
      const char* s = p + 6;
      float x = strtof(s, &q);
      float y = strtof(q, &q);
      float z = strtof(q, &q);
      if (q != s) {
        verts.push_back(x);
        verts.push_back(y);
        verts.push_back(z);
      }
    }
    p = next_line(p, end);
  }
  if (verts.empty()) {
    set_err(err, errlen, "No vertices found in ASCII STL file");
    return 2;
  }
  if (verts.size() % 9 != 0) {
    set_err(err, errlen, "ASCII STL vertex count not a multiple of 3");
    return 5;
  }
  int64_t nt = static_cast<int64_t>(verts.size() / 9);
  *out_verts = static_cast<float*>(malloc(verts.size() * sizeof(float)));
  memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
  uint32_t* tris = static_cast<uint32_t*>(malloc(static_cast<size_t>(nt) * 3 * sizeof(uint32_t)));
  for (int64_t i = 0; i < nt * 3; ++i) tris[i] = static_cast<uint32_t>(i);
  *out_tris = tris;
  *out_nv = nt * 3;
  *out_nt = nt;
  return 0;
}

int sdfgenio_load_stl(const char* path, float** out_verts, uint32_t** out_tris,
                      int64_t* out_nv, int64_t* out_nt, char* err, int errlen) {
  Buf buf;
  if (!read_file(path, buf)) {
    set_err(err, errlen, "failed to open STL file");
    return 1;
  }
  if (buf.len < 5) {
    set_err(err, errlen, "STL file too short");
    return 4;
  }
  // format sniff: "solid" prefix is ASCII only if the binary size rule fails
  bool solid = strncasecmp(buf.data, "solid", 5) == 0;
  bool binary = !solid;
  if (solid && buf.len >= 84) {
    uint32_t n;
    memcpy(&n, buf.data + 80, 4);
    if (buf.len == 84 + static_cast<size_t>(n) * 50) binary = true;
  }
  return binary ? load_binary_stl(buf, out_verts, out_tris, out_nv, out_nt, err, errlen)
                : load_ascii_stl(buf, out_verts, out_tris, out_nv, out_nt, err, errlen);
}

// ---------------------------------------------------------------------------
// .sdf
// ---------------------------------------------------------------------------

int sdfgenio_write_sdf(const char* path, const float* data, int32_t ni, int32_t nj,
                       int32_t nk, const float* origin, float dx,
                       int64_t* inside_count, char* err, int errlen) {
  FILE* f = fopen(path, "wb");
  if (!f) {
    set_err(err, errlen, "failed to open file for writing");
    return 1;
  }
  int32_t dims[3] = {ni, nj, nk};
  float bmin[3] = {origin[0], origin[1], origin[2]};
  float bmax[3] = {origin[0] + ni * dx, origin[1] + nj * dx, origin[2] + nk * dx};
  int64_t count = static_cast<int64_t>(ni) * nj * nk;
  int64_t inside = 0;
  for (int64_t i = 0; i < count; ++i)
    if (data[i] < 0.0f) ++inside;
  bool ok = fwrite(dims, 4, 3, f) == 3 && fwrite(bmin, 4, 3, f) == 3 &&
            fwrite(bmax, 4, 3, f) == 3 &&
            fwrite(data, 4, static_cast<size_t>(count), f) == static_cast<size_t>(count);
  fclose(f);
  if (!ok) {
    set_err(err, errlen, "failed to write SDF data");
    return 2;
  }
  if (inside_count) *inside_count = inside;
  return 0;
}

int sdfgenio_read_sdf(const char* path, float** out_data, int32_t* dims,
                      float* bounds, char* err, int errlen) {
  Buf buf;
  if (!read_file(path, buf)) {
    set_err(err, errlen, "failed to open SDF file");
    return 1;
  }
  if (buf.len < 36) {
    set_err(err, errlen, "SDF file too short for header");
    return 2;
  }
  memcpy(dims, buf.data, 12);
  memcpy(bounds, buf.data + 12, 24);
  if (dims[0] <= 0 || dims[1] <= 0 || dims[2] <= 0) {
    set_err(err, errlen, "invalid dimensions in SDF file");
    return 3;
  }
  size_t count = static_cast<size_t>(dims[0]) * dims[1] * dims[2];
  if (buf.len < 36 + count * 4) {
    set_err(err, errlen, "SDF file truncated");
    return 4;
  }
  *out_data = static_cast<float*>(malloc(count * 4));
  memcpy(*out_data, buf.data + 36, count * 4);
  return 0;
}

}  // extern "C"
