"""Plain PyTorch lattice Boltzmann: the benchmark's reference for flow past
a cylinder in a 2-D channel (D2Q9) and past a sphere in a 3-D duct (D3Q19),
under BGK or MRT collision.

Written from the method, not from the program under test, and importing
nothing of it. The state is (Q, [nz,] ny, nx), x minor, its populations in
the order the program lays them out, so that the reference can step a
state the program hands over:

    D2Q9:  0 rest, 1 +x, 2 +y, 3 -x, 4 -y, 5 (+x+y), 6 (-x+y), 7 (-x-y),
           8 (+x-y)
    D3Q19: 0 rest, the axes +x -x +y -y +z -z, then the face diagonals
           (+x+y) (-x-y) (+x-y) (-x+y) (+x+z) (-x-z) (+x-z) (-x+z)
           (+y+z) (-y-z) (+y-z) (-y+z)

A step is collide, then pull-stream (a source beyond the x range reads 0,
one beyond the y or z range the frozen inlet equilibrium), then the
boundary rules in this order: bounce-back walls at y = 0 and y = ny-1 (and
z = 0, nz-1 in 3-D), the inlet at x = 0 (Zou-He velocity in 2-D, the
inlet equilibrium in 3-D), the outlet at x = nx-1 (Zou-He pressure rho = 1
in 2-D, zero gradient in 3-D), and last the obstacle's cells pinned to the
rest equilibrium w_i. The obstacle is the voxel disc or ball of integer
centre (int(cx nx), int(cy ny)[, nz // 2]) and radius int(r ny), dist^2 <=
r^2. The start is the equilibrium at rho = 1, u = (U, 0[, 0]) with the
obstacle at rest.

The force on the obstacle is the momentum exchange on the post-collision
populations, F = sum_i 2 c_i sum_x f*_i(x) [x fluid, x + c_i solid, inside
the domain], summed in float64. Fields are rho and u = sum_i c_i f_i / rho,
with rho = 1 and u = 0 on the obstacle.

Every operation runs in the dtype the Case is built with: float64 for the
reference, bfloat16 for the control (the nearest precision below the
float32 the configurations state).
"""
from __future__ import annotations

import numpy as np
import torch

D2Q9_C = ((0, 0), (1, 0), (0, 1), (-1, 0), (0, -1),
          (1, 1), (-1, 1), (-1, -1), (1, -1))
D2Q9_W = (4 / 9,) + (1 / 9,) * 4 + (1 / 36,) * 4
D3Q19_C = ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
           (0, 0, 1), (0, 0, -1), (1, 1, 0), (-1, -1, 0), (1, -1, 0),
           (-1, 1, 0), (1, 0, 1), (-1, 0, -1), (1, 0, -1), (-1, 0, 1),
           (0, 1, 1), (0, -1, -1), (0, 1, -1), (0, -1, 1))
D3Q19_W = (1 / 3,) + (1 / 18,) * 6 + (1 / 36,) * 12


def mrt_basis(c: np.ndarray) -> tuple[np.ndarray, tuple[str, ...]]:
    """Orthogonal moment basis: Lallemand & Luo (2000) for D2Q9,
    d'Humieres et al. (2002) for D3Q19. Returns (M (Q, Q), row names)."""
    c = c.astype(np.float64)
    cx, cy = c[:, 0], c[:, 1]
    ones = np.ones(len(c))
    if c.shape[1] == 2:
        c2 = cx * cx + cy * cy
        rows = {"rho": ones, "e": 3 * c2 - 4, "eps": 4.5 * c2 * c2 - 10.5 * c2 + 4,
                "jx": cx, "qx": (3 * c2 - 5) * cx, "jy": cy,
                "qy": (3 * c2 - 5) * cy, "pxx": cx * cx - cy * cy,
                "pxy": cx * cy}
    else:
        cz = c[:, 2]
        c2 = cx * cx + cy * cy + cz * cz
        rows = {"rho": ones, "e": 19 * c2 - 30,
                "eps": (21 * c2 * c2 - 53 * c2 + 24) / 2,
                "jx": cx, "qx": (5 * c2 - 9) * cx, "jy": cy,
                "qy": (5 * c2 - 9) * cy, "jz": cz, "qz": (5 * c2 - 9) * cz,
                "pxx": 3 * cx * cx - c2,
                "pixx": (3 * c2 - 5) * (3 * cx * cx - c2),
                "pww": cy * cy - cz * cz,
                "piww": (3 * c2 - 5) * (cy * cy - cz * cz),
                "pxy": cx * cy, "pyz": cy * cz, "pxz": cx * cz,
                "mx": (cy * cy - cz * cz) * cx, "my": (cz * cz - cx * cx) * cy,
                "mz": (cx * cx - cy * cy) * cz}
    M = np.stack(list(rows.values()))
    gram = M @ M.T
    if not np.allclose(gram, np.diag(np.diag(gram))):
        raise ValueError("the MRT basis rows are not orthogonal")
    return M, tuple(rows)


def mrt_matrix(c: np.ndarray, tau: float, ghost_rates: dict) -> np.ndarray:
    """R = M^-1 S M (float64): the conserved moments (rho, j) relax at 0,
    the shear stresses (pxx, pww, pxy, pyz, pxz) at 1/tau, every other
    moment at its rate in `ghost_rates`."""
    M, names = mrt_basis(c)
    rates = []
    for name in names:
        if name == "rho" or name.startswith("j"):
            rates.append(0.0)
        elif name in ("pxx", "pww", "pxy", "pyz", "pxz"):
            rates.append(1.0 / tau)
        else:
            rates.append(float(ghost_rates[name]))
    return np.linalg.inv(M) @ np.diag(rates) @ M


class Case:
    """One cylinder (2-D, nz = 0) or sphere (3-D) problem on `device` in
    `dtype`: its mask, start, step, force and fields.

    params: nx, ny, nz, tau, inlet_velocity, cylinder_x, cylinder_y,
    cylinder_radius, collision ("bgk" or "mrt") and, for MRT, mrt_rates
    (the ghost moments' rates by name)."""

    def __init__(self, params: dict, device="cpu", dtype=torch.float64):
        self.p = dict(params)
        self.device = torch.device(device)
        self.dtype = dtype
        nx, ny, nz = int(params["nx"]), int(params["ny"]), int(params["nz"])
        self.three_d = nz > 0
        self.shape = (nz, ny, nx) if self.three_d else (ny, nx)
        c = np.array(D3Q19_C if self.three_d else D2Q9_C, np.int64)
        w = np.array(D3Q19_W if self.three_d else D2Q9_W, np.float64)
        self.c, self.w = c, w
        self.Q, self.D = c.shape
        self.opp = [int(np.flatnonzero((c == -c[i]).all(1))[0])
                    for i in range(self.Q)]
        self.tau = float(params["tau"])
        self.u_in = float(params["inlet_velocity"])
        self.collision = params.get("collision", "bgk")
        if self.collision == "mrt":
            self.R = torch.as_tensor(
                mrt_matrix(c, self.tau, params["mrt_rates"]),
                dtype=dtype, device=self.device)
        elif self.collision != "bgk":
            raise ValueError(f"collision {self.collision!r}: the reference "
                             "runs bgk and mrt")
        self.solid = torch.as_tensor(self._mask(), device=self.device)
        self._solid_idx = self.solid.reshape(-1).nonzero().squeeze(1)
        self._c = torch.as_tensor(c, dtype=dtype, device=self.device)
        self._w = torch.as_tensor(w, dtype=dtype, device=self.device).reshape(
            (self.Q,) + (1,) * len(self.shape))
        edge = [self.solid.select(a, k).any()
                for a in range(len(self.shape)) for k in (0, -1)]
        if any(bool(e) for e in edge):
            raise ValueError("the obstacle touches the domain's edge")
        r = int(float(params["cylinder_radius"]) * ny)
        # 1/2 rho U^2 A: A the cylinder's diameter per unit span, the
        # sphere's frontal area
        area = np.pi * r * r if self.three_d else 2.0 * r
        self.force_scale = 0.5 * self.u_in ** 2 * area
        u0 = np.zeros(self.D)
        u0[0] = self.u_in
        self.eq_in = self._feq_host(1.0, u0)
        # the momentum exchange's links: fluid x with a solid x + c_i
        # inside the domain
        self.links = []
        for i in range(1, self.Q):
            shifted = self._shift(self.solid, [-int(v) for v in c[i]], False)
            self.links.append((i, ~self.solid & shifted))

    # -- set-up -------------------------------------------------------------
    def _mask(self) -> np.ndarray:
        p = self.p
        nx, ny = int(p["nx"]), int(p["ny"])
        cx = int(float(p["cylinder_x"]) * nx)
        cy = int(float(p["cylinder_y"]) * ny)
        r = float(int(float(p["cylinder_radius"]) * ny))
        x = np.arange(nx, dtype=np.float64) - cx
        y = np.arange(ny, dtype=np.float64) - cy
        if not self.three_d:
            return y[:, None] ** 2 + x[None, :] ** 2 <= r * r
        nz = int(p["nz"])
        z = np.arange(nz, dtype=np.float64) - nz // 2
        return (z[:, None, None] ** 2 + y[None, :, None] ** 2
                + x[None, None, :] ** 2) <= r * r

    def _feq_host(self, rho: float, u: np.ndarray) -> np.ndarray:
        cu = self.c @ u
        return self.w * rho * (1 + 3 * cu + 4.5 * cu * cu - 1.5 * (u @ u))

    def _tensor(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=self.dtype,
                               device=self.device)

    def initial(self) -> torch.Tensor:
        """The start: the inlet equilibrium everywhere, the obstacle at
        rest."""
        f = self._tensor(self.eq_in).reshape(self._w.shape).expand(
            (self.Q,) + self.shape).clone()
        self._pin(f)
        return f

    # -- the step -----------------------------------------------------------
    def _shift(self, plane: torch.Tensor, vec, fill) -> torch.Tensor:
        """plane moved by the lattice vector `vec` (x, y[, z]): out[x] =
        plane[x - vec], `fill` where x - vec leaves the domain."""
        axes = tuple(plane.dim() - 1 - d for d in range(len(vec)))
        out = torch.roll(plane, tuple(int(v) for v in vec), axes)
        for axis, v in zip(axes, vec):
            self._fill_edge(out, axis, int(v), fill)
        return out

    @staticmethod
    def _fill_edge(plane: torch.Tensor, axis: int, v: int, fill) -> None:
        """Fill the cells of `plane` whose pull source, v cells back along
        `axis`, lies beyond the domain."""
        if v > 0:
            plane.narrow(axis, 0, v).fill_(fill)
        elif v < 0:
            plane.narrow(axis, plane.shape[axis] + v, -v).fill_(fill)

    def moments(self, f: torch.Tensor):
        rho = f.sum(0)
        u = torch.einsum("qd,q...->d...", self._c, f) / rho
        return rho, u

    def collide(self, f: torch.Tensor) -> torch.Tensor:
        rho, u = self.moments(f)
        usq = (u * u).sum(0).mul_(-1.5).add_(1.0)
        # feq_i = w_i rho (1 - 1.5 u.u + 3 c_i.u + 4.5 (c_i.u)^2), in place
        feq = torch.einsum("qd,d...->q...", self._c, u)
        feq.mul_(feq * 4.5 + 3.0).add_(usq).mul_(rho).mul_(self._w)
        if self.collision == "bgk":
            # f - (f - feq) / tau
            return feq.sub_(f).mul_(1.0 / self.tau).add_(f)
        # f - R (f - feq)
        return torch.einsum("ij,j...->i...", self.R,
                            feq.sub_(f)).add_(f)

    def _pin(self, f: torch.Tensor) -> None:
        """The obstacle's cells at the rest equilibrium w_i."""
        f.view(self.Q, -1)[:, self._solid_idx] = self._w.reshape(self.Q, 1)

    def step(self, f: torch.Tensor) -> torch.Tensor:
        post = self.collide(f)
        # pull: f_i(x) = post_i(x - c_i); the x ghosts read 0, then the y
        # and z ghosts (corners too) the inlet equilibrium
        out = torch.empty_like(post)
        nd = len(self.shape)
        for i in range(self.Q):
            ci = [int(v) for v in self.c[i]]
            dst, src = [slice(None)] * nd, [slice(None)] * nd
            for d, v in enumerate(ci):
                axis, n = nd - 1 - d, self.shape[nd - 1 - d]
                dst[axis] = slice(max(v, 0), n + min(v, 0))
                src[axis] = slice(max(-v, 0), n - max(v, 0))
            plane = out[i]
            plane[tuple(dst)] = post[i][tuple(src)]
            self._fill_edge(plane, nd - 1, ci[0], 0.0)
            for d in range(1, self.D):
                self._fill_edge(plane, nd - 1 - d, ci[d],
                                float(self.eq_in[i]))
        self._walls(out)
        if self.three_d:
            out[..., 0] = self._tensor(self.eq_in).reshape(
                (self.Q,) + (1,) * (nd - 1))
            out[..., -1] = out[..., -2]
        else:
            self._zou_he(out)
        self._pin(out)
        return out

    def _walls(self, f: torch.Tensor) -> None:
        """Bounce-back at y = 0, ny-1 (then z = 0, nz-1): a population
        entering the domain there takes its opposite's value."""
        for comp in range(1, self.D):
            axis = len(self.shape) - 1 - comp
            for k, sign in ((0, 1), (self.shape[axis] - 1, -1)):
                for i in range(self.Q):
                    if self.c[i, comp] == sign:
                        f[i].select(axis, k).copy_(
                            f[self.opp[i]].select(axis, k))

    def _zou_he(self, f: torch.Tensor) -> None:
        """Zou & He (1997): velocity U at x = 0, pressure rho = 1 at
        x = nx-1, on every row."""
        g = f[..., 0]
        rho = (g[0] + g[2] + g[4] + 2 * (g[3] + g[6] + g[7])) / (1 - self.u_in)
        ru = rho * self.u_in
        half = 0.5 * (g[2] - g[4])
        g[1] = g[3] + (2 / 3) * ru
        g[5] = g[7] - half + ru / 6
        g[8] = g[6] + half + ru / 6
        h = f[..., -1]
        u = -1 + (h[0] + h[2] + h[4] + 2 * (h[1] + h[5] + h[8]))
        half = 0.5 * (h[2] - h[4])
        h[3] = h[1] - (2 / 3) * u
        h[6] = h[8] - half - u / 6
        h[7] = h[5] + half - u / 6

    def run(self, f: torch.Tensor, steps: int) -> torch.Tensor:
        for _ in range(steps):
            f = self.step(f)
        return f

    # -- what is compared ---------------------------------------------------
    def force(self, f: torch.Tensor) -> np.ndarray:
        """The obstacle's force (D,) float64 from the state f, by momentum
        exchange on its post-collision populations."""
        post = self.collide(f)
        total = np.zeros(self.D)
        for i, link in self.links:
            s = float(torch.sum(post[i][link], dtype=torch.float64))
            total += 2.0 * self.c[i] * s
        return total

    def fields(self, f: torch.Tensor):
        """(rho, u (D, ...)) as float64 host arrays, rho = 1 and u = 0 on
        the obstacle."""
        rho, u = self.moments(f)
        rho = torch.where(self.solid, 1.0, rho.double())
        u = torch.where(self.solid, 0.0, u.double())
        return rho.cpu().numpy(), u.cpu().numpy()

    def final_fields(self, f: torch.Tensor):
        """The fields written at the end of a run from the state f one step
        before its end: the interior from f, the inlet and outlet columns
        from the state one step later. Returns (rho, u, the last state)."""
        rho, u = self.fields(f)
        last = self.step(f)
        rho_t, u_t = self.fields(last)
        for col in (0, -1):
            rho[..., col] = rho_t[..., col]
            u[..., col] = u_t[..., col]
        return rho, u, last

