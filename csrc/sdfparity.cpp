// Native x-ray parity kernel.
//
// Computes the inside/outside parity field the pipeline consumes: for every
// grid column (j, k), count x-ray crossings of each triangle with the ray
// along +i using exact double-precision SOS point-in-triangle predicates,
// prefix the counts along i, and emit the parity bit-packed along i
// (little bit order), i.e. the exact output of
// sdfgenfast.ops.sign_host.pack_parity(parity_field_host(...)).
//
// Semantics follow the reference's double-precision sign pass
// (cpu_lib/makelevelset3.cpp:155-187, 222-235, 295-303): grid coordinates in
// double, SOS-tie-broken orientation, intersection coordinate by barycentric
// interpolation, crossings binned at ceil(fi) with <0 clamped to cell 0 and
// >= ni dropped. Implementation is new: triangle-parallel with relaxed
// atomic XOR into a byte grid (crossing events are sparse), then a
// column-parallel prefix-XOR + bit-pack pass.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// f64 SOS orientation (matches ops/sign_host.py:_orientation and the
// reference's orientation, makelevelset3.cpp:155-165).
inline int orientation(double x1, double y1, double x2, double y2,
                       double* twice_area) {
  double area = y1 * x2 - x1 * y2;
  *twice_area = area;
  if (area > 0.0) return 1;
  if (area < 0.0) return -1;
  if (y2 > y1) return 1;
  if (y2 < y1) return -1;
  if (x1 > x2) return 1;
  if (x1 < x2) return -1;
  return 0;
}

struct ParityArgs {
  const float* verts;
  const uint32_t* tris;
  int64_t nt;
  double ox, oy, oz, dx;
  int32_t ni, nj, nk;
  uint8_t* events;     // crossing-parity grid, layout per bit_packed
  bool bit_packed;     // false: ni*nj*nk bytes (crossings transport);
                       // true: ((ni+7)/8)*nj*nk bytes, bit (i%8) of byte
                       // ((i/8)*nj + j)*nk + k — the PACKED OUTPUT buffer
                       // doubles as the events grid (zero extra allocation,
                       // and the prefix pass touches 1/8 the memory)
};

void triangle_range(const ParityArgs& A, int64_t t0, int64_t t1) {
  const int32_t ni = A.ni, nj = A.nj, nk = A.nk;
  for (int64_t t = t0; t < t1; ++t) {
    const uint32_t* tri = A.tris + 3 * t;
    double fi[3], fj[3], fk[3];
    for (int v = 0; v < 3; ++v) {
      const float* p = A.verts + 3 * static_cast<int64_t>(tri[v]);
      fi[v] = (static_cast<double>(p[0]) - A.ox) / A.dx;
      fj[v] = (static_cast<double>(p[1]) - A.oy) / A.dx;
      fk[v] = (static_cast<double>(p[2]) - A.oz) / A.dx;
    }
    double fjmin = std::min(fj[0], std::min(fj[1], fj[2]));
    double fjmax = std::max(fj[0], std::max(fj[1], fj[2]));
    double fkmin = std::min(fk[0], std::min(fk[1], fk[2]));
    double fkmax = std::max(fk[0], std::max(fk[1], fk[2]));
    int64_t j0 = static_cast<int64_t>(std::ceil(fjmin));
    int64_t j1 = static_cast<int64_t>(std::floor(fjmax));
    int64_t k0 = static_cast<int64_t>(std::ceil(fkmin));
    int64_t k1 = static_cast<int64_t>(std::floor(fkmax));
    j0 = std::max<int64_t>(0, std::min<int64_t>(j0, nj - 1));
    j1 = std::max<int64_t>(0, std::min<int64_t>(j1, nj - 1));
    k0 = std::max<int64_t>(0, std::min<int64_t>(k0, nk - 1));
    k1 = std::max<int64_t>(0, std::min<int64_t>(k1, nk - 1));
    if (fjmax < fjmin || fkmax < fkmin) continue;
    for (int64_t j = j0; j <= j1; ++j) {
      double x1 = fj[0] - static_cast<double>(j);
      double x2 = fj[1] - static_cast<double>(j);
      double x3 = fj[2] - static_cast<double>(j);
      for (int64_t k = k0; k <= k1; ++k) {
        double y1 = fk[0] - static_cast<double>(k);
        double y2 = fk[1] - static_cast<double>(k);
        double y3 = fk[2] - static_cast<double>(k);
        double a, b, c;
        int sa = orientation(x2, y2, x3, y3, &a);
        int sb = orientation(x3, y3, x1, y1, &b);
        int sc = orientation(x1, y1, x2, y2, &c);
        if (sa == 0 || sb != sa || sc != sa) continue;
        double total = a + b + c;
        if (total == 0.0) total = 1.0;
        double fint = (a * fi[0] + b * fi[1] + c * fi[2]) / total;
        int64_t bin = static_cast<int64_t>(std::ceil(fint));
        if (bin >= ni) continue;  // dropped (makelevelset3.cpp:233)
        if (bin < 0) bin = 0;     // counted at interval 0 (:231)
        if (A.bit_packed) {
          uint8_t* cell = A.events + ((bin >> 3) * nj + j) * nk + k;
          __atomic_xor_fetch(cell, static_cast<uint8_t>(1u << (bin & 7)),
                             __ATOMIC_RELAXED);
        } else {
          uint8_t* cell = A.events + (bin * nj + j) * nk + k;
          __atomic_xor_fetch(cell, 1, __ATOMIC_RELAXED);
        }
      }
    }
  }
}

// In-place prefix-XOR along i of the BIT-PACKED events grid: within each
// byte a parallel-prefix (b ^= b<<1; b ^= b<<2; b ^= b<<4), then the
// carry bit (the previous byte's top bit after prefixing) flips the whole
// byte. Touches ((ni+7)/8)*nj*nk bytes once — 8x less traffic than the
// old byte-per-cell pass, which dominated host parity time (36 ms at the
// 37M-cell benchmark box; the raster work itself is sparse).
void prefix_pack_bits_range(const ParityArgs& A, int64_t nb,
                            int64_t j0, int64_t j1) {
  const int64_t nj = A.nj, nk = A.nk;
  std::vector<uint8_t> run(static_cast<size_t>((j1 - j0) * nk), 0);
  const int64_t n = (j1 - j0) * nk;
  for (int64_t ib = 0; ib < nb; ++ib) {
    uint8_t* row = A.events + (ib * nj + j0) * nk;
    uint8_t* r = run.data();
    for (int64_t x = 0; x < n; ++x) {
      uint8_t b = row[x];
      b ^= static_cast<uint8_t>(b << 1);
      b ^= static_cast<uint8_t>(b << 2);
      b ^= static_cast<uint8_t>(b << 4);
      b ^= static_cast<uint8_t>(0u - r[x]);  // carry 1 -> flip all bits
      row[x] = b;
      r[x] = b >> 7;
    }
  }
}

}  // namespace

namespace {

// Extract per-column crossing positions from the events grid: for column
// (j, k), the i indices whose crossing-event parity is odd, ascending. The
// device reconstructs the parity field as XOR_c (i >= cross_c) — the
// prefix-XOR of sdfgenio_parity_packed expressed as a handful of compares,
// so only (cap, nj, nk) int16 (sentinel-padded) ever crosses the host->
// device link instead of a bit-packed (ni/8, nj, nk) field.
void crossings_range(const ParityArgs& A, int16_t* out, int32_t cap,
                     int32_t* counts, int64_t nb, int64_t j0, int64_t j1) {
  // BIT-PACKED events (same layout as the parity_packed path): the scan
  // touches (ni/8)*nj*nk bytes instead of byte-per-cell — at 512^3 that is
  // 16.8 MB instead of 134 MB, and the alloc+memset shrinks 8x too. Bits
  // scan LSB-first within ascending byte-planes, so per-column crossing
  // positions stay ascending in i.
  const int64_t nj = A.nj, nk = A.nk;
  const int64_t span = (j1 - j0) * nk;
  int32_t* cnt = counts + j0 * nk;
  for (int64_t ib = 0; ib < nb; ++ib) {
    const uint8_t* src = A.events + (ib * nj + j0) * nk;
    for (int64_t x = 0; x < span; ++x) {
      uint8_t b = src[x];
      while (b) {
        const int bit = __builtin_ctz(b);
        b = static_cast<uint8_t>(b & (b - 1));
        const int32_t c = cnt[x]++;
        if (c < cap) {
          const int64_t col = j0 * nk + x;  // j * nk + k
          out[static_cast<int64_t>(c) * nj * nk + col] =
              static_cast<int16_t>(ib * 8 + bit);
        }
      }
    }
  }
}

}  // namespace

// Per-column x-ray crossing positions, (cap, nj, nk) int16 C-order, padded
// with sentinel 32767. *max_crossings returns the true per-column maximum;
// when it exceeds `cap` the output is truncated and the caller must retry
// with a larger cap. Same exact-f64 SOS semantics as sdfgenio_parity_packed.
extern "C" int sdfgenio_crossings(
    const float* verts, int64_t nv, const uint32_t* tris, int64_t nt,
    const double* origin, double dx,
    int32_t ni, int32_t nj, int32_t nk,
    int16_t* crossings_out,  // cap * nj * nk int16, caller-allocated
    int32_t cap, int32_t* max_crossings,
    int num_threads, char* err, int errlen) {
  (void)nv;
  (void)err;
  (void)errlen;
  if (ni <= 0 || nj <= 0 || nk <= 0 || ni > 32766 || cap <= 0) return 1;
  const int64_t nb = (ni + 7) / 8;
  const int64_t cols = static_cast<int64_t>(nj) * nk;
  std::vector<uint8_t> events(static_cast<size_t>(nb) * cols, 0);
  std::vector<int32_t> counts(static_cast<size_t>(cols), 0);
  for (int64_t x = 0; x < static_cast<int64_t>(cap) * cols; ++x)
    crossings_out[x] = 32767;

  ParityArgs A;
  A.verts = verts;
  A.tris = tris;
  A.nt = nt;
  A.ox = origin[0];
  A.oy = origin[1];
  A.oz = origin[2];
  A.dx = dx;
  A.ni = ni;
  A.nj = nj;
  A.nk = nk;
  A.events = events.data();
  A.bit_packed = true;

  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 4;
  int nth = num_threads > 0 ? num_threads : hw;

  {
    int use = static_cast<int>(
        std::min<int64_t>(nth, std::max<int64_t>(1, nt / 16)));
    if (use <= 1) {
      triangle_range(A, 0, nt);
    } else {
      std::vector<std::thread> pool;
      int64_t chunk = (nt + use - 1) / use;
      for (int w = 0; w < use; ++w) {
        int64_t t0 = w * chunk;
        int64_t t1 = std::min<int64_t>(nt, t0 + chunk);
        if (t0 >= t1) break;
        pool.emplace_back(triangle_range, std::cref(A), t0, t1);
      }
      for (auto& th : pool) th.join();
    }
  }

  {
    int use = static_cast<int>(
        std::min<int64_t>(nth, std::max<int64_t>(1, nj / 8)));
    if (use <= 1) {
      crossings_range(A, crossings_out, cap, counts.data(), nb, 0, nj);
    } else {
      std::vector<std::thread> pool;
      int64_t chunk = (nj + use - 1) / use;
      for (int w = 0; w < use; ++w) {
        int64_t j0 = w * chunk;
        int64_t j1 = std::min<int64_t>(nj, j0 + chunk);
        if (j0 >= j1) break;
        pool.emplace_back(crossings_range, std::cref(A), crossings_out, cap,
                          counts.data(), nb, j0, j1);
      }
      for (auto& th : pool) th.join();
    }
  }

  int32_t mx = 0;
  for (int64_t x = 0; x < cols; ++x) mx = std::max(mx, counts[x]);
  *max_crossings = mx;
  return 0;
}

extern "C" int sdfgenio_parity_packed(
    const float* verts, int64_t nv, const uint32_t* tris, int64_t nt,
    const double* origin,  // full f64 origin (GridSpec keeps f64 tuples)
    double dx,             // pre-rounded through f32 by the caller
    int32_t ni, int32_t nj, int32_t nk,
    uint8_t* packed_out,  // ((ni+7)/8) * nj * nk bytes, caller-allocated
    int num_threads, char* err, int errlen) {
  (void)nv;
  (void)err;
  (void)errlen;
  if (ni <= 0 || nj <= 0 || nk <= 0) return 1;
  const int64_t nb = (ni + 7) / 8;
  std::memset(packed_out, 0, static_cast<size_t>(nb) * nj * nk);

  ParityArgs A;
  A.verts = verts;
  A.tris = tris;
  A.nt = nt;
  // Grid-coordinate conversion identical to triangle_grid_coords
  // (ops/band.py:72): f = (double(v) - origin_f64) / double(float32(dx)).
  A.ox = origin[0];
  A.oy = origin[1];
  A.oz = origin[2];
  A.dx = dx;
  A.ni = ni;
  A.nj = nj;
  A.nk = nk;
  A.events = packed_out;  // events accumulate bit-packed, prefixed in place
  A.bit_packed = true;

  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 4;
  int nth = num_threads > 0 ? num_threads : hw;

  {
    int use = static_cast<int>(
        std::min<int64_t>(nth, std::max<int64_t>(1, nt / 16)));
    if (use <= 1) {
      triangle_range(A, 0, nt);
    } else {
      std::vector<std::thread> pool;
      int64_t chunk = (nt + use - 1) / use;
      for (int w = 0; w < use; ++w) {
        int64_t t0 = w * chunk;
        int64_t t1 = std::min<int64_t>(nt, t0 + chunk);
        if (t0 >= t1) break;
        pool.emplace_back(triangle_range, std::cref(A), t0, t1);
      }
      for (auto& th : pool) th.join();
    }
  }

  {
    int use = static_cast<int>(
        std::min<int64_t>(nth, std::max<int64_t>(1, nj / 8)));
    if (use <= 1) {
      prefix_pack_bits_range(A, nb, 0, nj);
    } else {
      std::vector<std::thread> pool;
      int64_t chunk = (nj + use - 1) / use;
      for (int w = 0; w < use; ++w) {
        int64_t j0 = w * chunk;
        int64_t j1 = std::min<int64_t>(nj, j0 + chunk);
        if (j0 >= j1) break;
        pool.emplace_back(prefix_pack_bits_range, std::cref(A), nb, j0, j1);
      }
      for (auto& th : pool) th.join();
    }
  }
  return 0;
}
