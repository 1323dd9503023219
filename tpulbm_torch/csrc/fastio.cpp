// fastio.cpp — native ASCII formatters for the large artifacts: legacy
// VTK frames and the per-cell velocity_field.csv and temperature_field.csv.
// The port's copy of tpulbm's native/fastio.cpp, with its own exact "%.8f"
// formatter and the CSVs' rows formatted by blocks in threads: a 1M-cell
// field costs seconds in Python f-strings and over a second through
// snprintf on one thread. Output bytes equal
// std::fixed << setprecision(8) streams and the NumPy fallback of
// tpulbm_torch/utils/io.py.
//
// Plain C ABI, built with g++ at first use and loaded with ctypes by
// tpulbm_torch/utils/native.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <system_error>
#include <thread>
#include <vector>

namespace {

// Format v as "%.8f" into buf (at least kMaxFmt bytes), returning the chars
// written. Finite values below 1e10 take an exact integer path: v * 1e8 as
// mant * 5^8 * 2^(e + 8) in 128 bits, rounded half to even on the exact
// value as glibc's printf rounds, then written as digits, about ten times
// faster than snprintf. The sign is written for every negative value, as
// printf writes "-0.00000000". NaN is "nan" whatever its sign bit, as
// Python formats it; the rest go to snprintf.
constexpr int kMaxFmt = 330;  // "%.8f" of -DBL_MAX: 309 digits, sign, 9

inline int fmt8(char* buf, double v) {
  if (v != v) {
    std::memcpy(buf, "nan", 3);
    return 3;
  }
  if (!(std::fabs(v) < 1e10)) return std::snprintf(buf, kMaxFmt, "%.8f", v);
  uint64_t bits;
  std::memcpy(&bits, &v, sizeof bits);
  const int biased = static_cast<int>((bits >> 52) & 0x7ff);
  const uint64_t frac = bits & ((uint64_t{1} << 52) - 1);
  const uint64_t mant = biased ? frac | (uint64_t{1} << 52) : frac;
  const int shift = (biased ? biased - 1075 : -1074) + 8;
  const unsigned __int128 p = static_cast<unsigned __int128>(mant) * 390625u;
  uint64_t q;
  if (shift >= 0) {
    q = static_cast<uint64_t>(p << shift);
  } else if (-shift >= 80) {
    q = 0;  // below 2^-8 of a unit in the last place: rounds to zero
  } else {
    const int sh = -shift;
    const unsigned __int128 one = 1;
    const unsigned __int128 rem = p & ((one << sh) - 1);
    const unsigned __int128 half = one << (sh - 1);
    q = static_cast<uint64_t>(p >> sh);
    if (rem > half || (rem == half && (q & 1))) ++q;
  }
  int k = 0;
  if (bits >> 63) buf[k++] = '-';
  uint64_t whole = q / 100000000u;
  uint32_t part = static_cast<uint32_t>(q % 100000000u);
  char digits[20];
  int n = 0;
  do {
    digits[n++] = static_cast<char>('0' + whole % 10);
    whole /= 10;
  } while (whole);
  while (n) buf[k++] = digits[--n];
  buf[k++] = '.';
  for (int i = 7; i >= 0; --i) {
    buf[k + i] = static_cast<char>('0' + part % 10);
    part /= 10;
  }
  return k + 8;
}

// Write a non-negative integer in decimal, returning the chars written.
inline int fmt_int(char* buf, int64_t v) {
  char digits[20];
  int n = 0;
  do {
    digits[n++] = static_cast<char>('0' + v % 10);
    v /= 10;
  } while (v);
  for (int i = 0; i < n; ++i) buf[i] = digits[n - 1 - i];
  return n;
}

constexpr size_t kBuf = 1 << 22;  // 4 MiB stdio buffer

// A per-cell CSV: `header`, then row(line, x, y) (a line of at most
// `max_line` chars, its length returned) for every cell, y-major. Blocks
// of rows are formatted into buffers by up to 8 threads, then written in
// order: the same bytes as one thread's, a fraction of its time (a
// 1M-cell field formats 5M values). Returns 0 on success.
template <class Row>
int write_rows(const char* path, const char* header, int64_t ny, int64_t nx,
               int max_line, Row row) {
  FILE* f = std::fopen(path, "w");
  if (!f) return 1;
  std::fputs(header, f);
  auto format = [&](int64_t y0, int64_t y1, std::vector<char>& out) {
    std::vector<char> line(max_line);
    out.reserve(static_cast<size_t>((y1 - y0) * nx) * 48);
    for (int64_t y = y0; y < y1; ++y)
      for (int64_t x = 0; x < nx; ++x) {
        int k = row(line.data(), x, y);
        out.insert(out.end(), line.data(), line.data() + k);
      }
  };
  const int64_t cells = ny * nx;
  int threads = static_cast<int>(std::min<int64_t>(
      {8, std::max(1u, std::thread::hardware_concurrency()),
       std::max<int64_t>(1, cells / 65536), std::max<int64_t>(1, ny)}));
  std::vector<std::vector<char>> parts(threads);
  std::vector<std::thread> pool;
  int64_t next = 0;
  for (int t = 0; t < threads; ++t) {
    const int64_t y0 = next, y1 = ny * (t + 1) / threads;
    next = y1;
    if (t + 1 == threads) {
      format(y0, y1, parts[t]);  // the calling thread takes the last block
      break;
    }
    try {
      pool.emplace_back(format, y0, y1, std::ref(parts[t]));
    } catch (const std::system_error&) {
      format(y0, y1, parts[t]);  // no thread to be had: format it here
    }
  }
  for (auto& th : pool) th.join();
  for (const auto& part : parts)
    if (!part.empty()) std::fwrite(part.data(), 1, part.size(), f);
  return std::fclose(f) ? 1 : 0;
}

}  // namespace

extern "C" {

// Writes: header, then "ux uy 0.0" vector lines, then the magnitude scalar
// block, then the density scalar block — byte-for-byte the reference VTK
// layout (LBMIO.h:69-107). Returns 0 on success.
int fastio_write_vtk(const char* path, const char* header,
                     const double* ux, const double* uy, const double* rho,
                     int64_t n) {
  FILE* f = std::fopen(path, "w");
  if (!f) return 1;
  setvbuf(f, nullptr, _IOFBF, kBuf);
  std::fputs(header, f);
  std::fputs("VECTORS velocity double\n", f);
  char line[2 * kMaxFmt + 8];
  for (int64_t i = 0; i < n; ++i) {
    int k = fmt8(line, ux[i]);
    line[k++] = ' ';
    k += fmt8(line + k, uy[i]);
    std::memcpy(line + k, " 0.0\n", 5);
    std::fwrite(line, 1, k + 5, f);
  }
  std::fputs("\nSCALARS velocity_magnitude double\nLOOKUP_TABLE default\n", f);
  for (int64_t i = 0; i < n; ++i) {
    int k = fmt8(line, std::sqrt(ux[i] * ux[i] + uy[i] * uy[i]));
    line[k++] = '\n';
    std::fwrite(line, 1, k, f);
  }
  std::fputs("\nSCALARS density double\nLOOKUP_TABLE default\n", f);
  for (int64_t i = 0; i < n; ++i) {
    int k = fmt8(line, rho[i]);
    line[k++] = '\n';
    std::fwrite(line, 1, k, f);
  }
  return std::fclose(f) ? 1 : 0;
}

// 3-D variant: real uz in the vector lines and the magnitude
// (STRUCTURED_POINTS with DIMENSIONS nx ny nz in the header; same blocks).
int fastio_write_vtk3(const char* path, const char* header, const double* ux,
                      const double* uy, const double* uz, const double* rho,
                      int64_t n) {
  FILE* f = std::fopen(path, "w");
  if (!f) return 1;
  setvbuf(f, nullptr, _IOFBF, kBuf);
  std::fputs(header, f);
  std::fputs("VECTORS velocity double\n", f);
  char line[3 * kMaxFmt + 8];
  for (int64_t i = 0; i < n; ++i) {
    int k = fmt8(line, ux[i]);
    line[k++] = ' ';
    k += fmt8(line + k, uy[i]);
    line[k++] = ' ';
    k += fmt8(line + k, uz[i]);
    line[k++] = '\n';
    std::fwrite(line, 1, k, f);
  }
  std::fputs("\nSCALARS velocity_magnitude double\nLOOKUP_TABLE default\n", f);
  for (int64_t i = 0; i < n; ++i) {
    int k = fmt8(line,
                 std::sqrt(ux[i] * ux[i] + uy[i] * uy[i] + uz[i] * uz[i]));
    line[k++] = '\n';
    std::fwrite(line, 1, k, f);
  }
  std::fputs("\nSCALARS density double\nLOOKUP_TABLE default\n", f);
  for (int64_t i = 0; i < n; ++i) {
    int k = fmt8(line, rho[i]);
    line[k++] = '\n';
    std::fwrite(line, 1, k, f);
  }
  return std::fclose(f) ? 1 : 0;
}

// Per-cell CSV "x,y,ux,uy,rho,velocity_magnitude" (LBMIO.h:312-320).
int fastio_write_velocity_field(const char* path, const double* ux,
                                const double* uy, const double* rho,
                                int64_t ny, int64_t nx) {
  return write_rows(path, "x,y,ux,uy,rho,velocity_magnitude\n", ny, nx,
                    4 * kMaxFmt + 48, [=](char* line, int64_t x, int64_t y) {
                      int64_t i = y * nx + x;
                      double mag = std::sqrt(ux[i] * ux[i] + uy[i] * uy[i]);
                      int k = fmt_int(line, x);
                      line[k++] = ',';
                      k += fmt_int(line + k, y);
                      line[k++] = ',';
                      k += fmt8(line + k, ux[i]);
                      line[k++] = ',';
                      k += fmt8(line + k, uy[i]);
                      line[k++] = ',';
                      k += fmt8(line + k, rho[i]);
                      line[k++] = ',';
                      k += fmt8(line + k, mag);
                      line[k++] = '\n';
                      return k;
                    });
}

// Per-cell CSV "x,y,temperature" in velocity_field.csv's cell order.
int fastio_write_temperature_field(const char* path, const double* t,
                                   int64_t ny, int64_t nx) {
  return write_rows(path, "x,y,temperature\n", ny, nx, kMaxFmt + 48,
                    [=](char* line, int64_t x, int64_t y) {
                      int k = fmt_int(line, x);
                      line[k++] = ',';
                      k += fmt_int(line + k, y);
                      line[k++] = ',';
                      k += fmt8(line + k, t[y * nx + x]);
                      line[k++] = '\n';
                      return k;
                    });
}

}  // extern "C"
