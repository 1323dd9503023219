// The per-cell parts of a D3Q19 timestep that the port's 3-D kernels share,
// float32: BGK collision, the pull with the reference's ghost rule, and the
// boundary sequence of the sphere in a duct. step_d3q19.cu (one step per
// launch) and step_d3q19_blocked.cu (N steps per launch) both build on these
// functions, so that N launches of the first and one launch of the second
// run the same operations in the same order and give the same bits.
//
// Rounding follows the plain version (tpulbm_torch/ops/step_torch.py):
// directions are summed in order, u = m * (1/rho) as tpulbm's
// _collide_planes_core does, and the libraries are built with -fmad=false so
// no multiply and add share one rounding.

#pragma once

#include <stdint.h>

// The D3Q19 velocity set in tpulbm.lattice.D3Q19's order:
// X(index, cx, cy, cz, opposite). tests/test_torch_3d.py parses this table
// and compares it with the lattice.
#define TPULBM_D3Q19(X) \
  X(0, 0, 0, 0, 0)      \
  X(1, 1, 0, 0, 2)      \
  X(2, -1, 0, 0, 1)     \
  X(3, 0, 1, 0, 4)      \
  X(4, 0, -1, 0, 3)     \
  X(5, 0, 0, 1, 6)      \
  X(6, 0, 0, -1, 5)     \
  X(7, 1, 1, 0, 8)      \
  X(8, -1, -1, 0, 7)    \
  X(9, 1, -1, 0, 10)    \
  X(10, -1, 1, 0, 9)    \
  X(11, 1, 0, 1, 12)    \
  X(12, -1, 0, -1, 11)  \
  X(13, 1, 0, -1, 14)   \
  X(14, -1, 0, 1, 13)   \
  X(15, 0, 1, 1, 16)    \
  X(16, 0, -1, -1, 15)  \
  X(17, 0, 1, -1, 18)   \
  X(18, 0, -1, 1, 17)

// +v, -v or nothing, by the sign of a velocity component (a literal)
#define TPULBM_SIGNED_ADD(acc, c, v) \
  if ((c) > 0) {                     \
    acc = acc + (v);                 \
  } else if ((c) < 0) {              \
    acc = acc - (v);                 \
  }

namespace tpulbm3d {

constexpr int kQ = 19;

// Population index I as a type, so that a pull's callee sees it as a
// constant expression: Pop<I>::value.
template <int I>
struct Pop {
  static constexpr int value = I;
};

struct Consts {
  float inv_tau;    // 1 / tau
  float eq_in[kQ];  // frozen ghost and inlet equilibrium(rho=1, u=(U,0,0))
  float w[kQ];      // lattice weights: the rest equilibrium of solids
};

inline Consts make_consts(float inv_tau, const float* eq_in, const float* w) {
  Consts k;
  k.inv_tau = inv_tau;
  for (int i = 0; i < kQ; ++i) {
    k.eq_in[i] = eq_in[i];
    k.w[i] = w[i];
  }
  return k;
}

// BGK relaxation of one cell's 19 populations, in place.
__device__ __forceinline__ void collide_bgk(float* f, const Consts& k) {
  float rho = f[0];
#pragma unroll
  for (int i = 1; i < kQ; ++i) rho = rho + f[i];
  float mx = 0.0f, my = 0.0f, mz = 0.0f;
#define TPULBM_MOMENT(i, cx, cy, cz, o) \
  TPULBM_SIGNED_ADD(mx, cx, f[i])       \
  TPULBM_SIGNED_ADD(my, cy, f[i])       \
  TPULBM_SIGNED_ADD(mz, cz, f[i])
  TPULBM_D3Q19(TPULBM_MOMENT)
#undef TPULBM_MOMENT
  const float inv_rho = 1.0f / rho;
  const float ux = mx * inv_rho;
  const float uy = my * inv_rho;
  const float uz = mz * inv_rho;
  const float base = 1.0f - 1.5f * (ux * ux + uy * uy + uz * uz);
  f[0] = f[0] - k.inv_tau * (f[0] - k.w[0] * rho * base);
#define TPULBM_RELAX(i, cx, cy, cz, o)                               \
  if ((i) > 0) {                                                     \
    float cu = 0.0f;                                                 \
    TPULBM_SIGNED_ADD(cu, cx, ux)                                    \
    TPULBM_SIGNED_ADD(cu, cy, uy)                                    \
    TPULBM_SIGNED_ADD(cu, cz, uz)                                    \
    const float feq =                                                \
        k.w[i] * rho * (base + 3.0f * cu + 4.5f * cu * cu);          \
    f[i] = f[i] - k.inv_tau * (f[i] - feq);                          \
  }
  TPULBM_D3Q19(TPULBM_RELAX)
#undef TPULBM_RELAX
}

// Pull g_i(x, y, z) = f_post_i((x, y, z) - c_i) with the reference's ghost
// rule: a source across a y or z edge gives the frozen equilibrium, one
// across only an x edge gives zero, and an in-domain source gives
// post(Pop<i>(), ox, oy, oz), the collided value the caller keeps at offset
// (ox, oy, oz) = -c_i from (x, y, z).
template <class Post>
__device__ __forceinline__ void pull_d3q19(float* g, int x, int y, int z,
                                           int nx, int ny, int nz,
                                           const Consts& k, const Post& post) {
  if (x > 0 && x < nx - 1 && y > 0 && y < ny - 1 && z > 0 && z < nz - 1) {
    // every source lies in the domain: the same values, no edge tests
#define TPULBM_PULL_IN(i, cx, cy, cz, o) \
  g[i] = post(Pop<i>(), -(cx), -(cy), -(cz));
    TPULBM_D3Q19(TPULBM_PULL_IN)
#undef TPULBM_PULL_IN
    return;
  }
#define TPULBM_PULL(i, cx, cy, cz, o)                                      \
  {                                                                        \
    const int sx = x - (cx), sy = y - (cy), sz = z - (cz);                 \
    if (sy < 0 || sy >= ny || sz < 0 || sz >= nz) {                        \
      g[i] = k.eq_in[i];                                                   \
    } else if (sx < 0 || sx >= nx) {                                       \
      g[i] = 0.0f;                                                         \
    } else {                                                               \
      g[i] = post(Pop<i>(), -(cx), -(cy), -(cz));                          \
    }                                                                      \
  }
  TPULBM_D3Q19(TPULBM_PULL)
#undef TPULBM_PULL
}

// The part of the boundary sequence that precedes the outlet, on the
// post-stream populations of a fluid cell at (x, y, z), in place:
// bounce-back y walls (bottom, then top), z walls (bottom, then top), each
// reading what the one before wrote, then the equilibrium inlet at x = 0.
__device__ __forceinline__ void walls_and_inlet(float* g, int x, int y, int z,
                                                int ny, int nz,
                                                const Consts& k) {
#define TPULBM_WALL(i, cx, cy, cz, o, comp, sign) \
  if ((comp) == (sign)) g[i] = g[o];
#define TPULBM_WALL_Y0(i, cx, cy, cz, o) TPULBM_WALL(i, cx, cy, cz, o, cy, 1)
#define TPULBM_WALL_Y1(i, cx, cy, cz, o) TPULBM_WALL(i, cx, cy, cz, o, cy, -1)
#define TPULBM_WALL_Z0(i, cx, cy, cz, o) TPULBM_WALL(i, cx, cy, cz, o, cz, 1)
#define TPULBM_WALL_Z1(i, cx, cy, cz, o) TPULBM_WALL(i, cx, cy, cz, o, cz, -1)
  if (y == 0) { TPULBM_D3Q19(TPULBM_WALL_Y0) }
  if (y == ny - 1) { TPULBM_D3Q19(TPULBM_WALL_Y1) }
  if (z == 0) { TPULBM_D3Q19(TPULBM_WALL_Z0) }
  if (z == nz - 1) { TPULBM_D3Q19(TPULBM_WALL_Z1) }
#undef TPULBM_WALL_Y0
#undef TPULBM_WALL_Y1
#undef TPULBM_WALL_Z0
#undef TPULBM_WALL_Z1
#undef TPULBM_WALL
  if (x == 0) {
#pragma unroll
    for (int i = 0; i < kQ; ++i) g[i] = k.eq_in[i];
  }
}

// One cell's populations after a whole step (tpulbm's stored state:
// post-BC, pre-collision) at (x, y, z); solid_at(ox) tells whether the cell
// at offset ox along x is solid. A solid cell is pinned to rest equilibrium
// (the equilibrium obstacle); a fluid cell pulls, then the walls and the
// inlet apply. The zero-gradient outlet is not cell-local: a fluid cell at
// x = nx-1 takes every population of x = nx-2 as it stands after the stream
// and the walls, before the obstacle pin, even when nx-2 is solid (the
// walls skip solids), so its pull is that of nx-2 (of x itself when
// nx == 1, as a roll does). post(Pop<i>(), ox, oy, oz) reads the collided
// value at offset (ox, oy, oz) from (x, y, z).
template <class Solid, class Post>
__device__ __forceinline__ void step_cell(float* g, const Solid& solid_at,
                                          int x, int y, int z, int nx, int ny,
                                          int nz, const Consts& k,
                                          const Post& post) {
  if (solid_at(0)) {
#pragma unroll
    for (int i = 0; i < kQ; ++i) g[i] = k.w[i];
    return;
  }
  const int dx = (x == nx - 1 && nx > 1) ? 1 : 0;
  const int xs = x - dx;
  pull_d3q19(g, xs, y, z, nx, ny, nz, k,
             [&](auto i, int ox, int oy, int oz) {
               return post(i, ox - dx, oy, oz);
             });
  if (dx == 0 || !solid_at(-dx)) walls_and_inlet(g, xs, y, z, ny, nz, k);
}

}  // namespace tpulbm3d
