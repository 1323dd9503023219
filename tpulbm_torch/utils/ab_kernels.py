"""Time the cylinder's and the sphere's kernels of one checkout, for
comparing two commits on the same card.

    python3 tpulbm_torch/utils/ab_kernels.py CHECKOUT LABEL [GROUP]

Run it as a file, not with -m: it imports tpulbm_torch from CHECKOUT (the
root of an unpacked commit), builds that checkout's D2Q9 and D3Q19
sources there (each library the timings launch, all at once), and prints
one JSON line: LABEL and the ms per step of re200 at 2048x512 (the 1-step
and the N = 2, 3, 4 kernels; N=4 under every other collision, the
Bouzidi cylinder and the Bouzidi slab), of one shard of scale-8m
(4096x2048) on a 2x2 mesh (the N=4 ring build with x rings, shard (0, 0),
its rings exchanged once), of the sphere at 256^3 (BGK: the 1-step and
N=3 kernels; MRT: the 1-step and N=3; D3Q27: the 1-step, N=2 and N=3) and
of one shard of the sphere at 256^3 on a 2x2 mesh (the N=3 ring build,
shard (0, 0), its rings exchanged once), CUDA events, the lower of three
turns after a warm-up; and the scale-8m shard and re200's N=4 again on
the card's clock (`_device`: the launches enqueued behind a sleep of the
card, which the host cannot hold back); then the 1-step D3Q19 kernel's
cells (ONE_STEP: every build of PERF.md's row 6 and row 7's depth-1
entries, the 64^3 and 128^3 boxes among them, and one shard of the
sphere, of the Bouzidi sphere at 256^3 and of the D3Q27 Bouzidi sphere at
128^3 on a 2x2 mesh, with x rings, beside the four shards summed and the
one-device kernel in the same turns). GROUP one_step times those cells
only. GROUP march times the D2Q9 1-step and Shan-Chen cells (MARCH: every
build of PERF.md's row 1, row 4's ranged launches, row 5's depth-1 shards
and row 9, with re200's N = 2-4 beside them) on the card's clock
(`device_ms`), a shard's launches also as the host issues them
(`_issued`), the four multiphase shards summed (`_summed`) beside one
device; and for every cell a hash of the state after MARCH_LAUNCHES
launches from a seeded +-10% perturbed state (`hash`), which is equal
across two commits whose kernels give the same bits.
Alternate the commits (parent, change, change, parent), one process each,
in one call.
"""
import hashlib
import json
import sys
from concurrent.futures import ThreadPoolExecutor


def ms_per_step(step, f, steps: int, per: int) -> float:
    """The lower of three turns of `steps` steps (one launch is `per`)."""
    import torch

    def run(g, n):
        spare = torch.empty_like(g)
        for _ in range(n // per):
            g, spare = step(g, spare), g
        return g

    run(f.clone(), 20 * per)
    best = None
    for _ in range(3):
        g = f.clone()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        run(g, steps)
        t1.record()
        torch.cuda.synchronize()
        t = t0.elapsed_time(t1) / steps
        best = t if best is None else min(best, t)
    return best


def device_ms(step, f, launches: int, per: int) -> float:
    """ms per step on the card's clock: `launches` launches of `step` (each
    `per` steps) enqueued behind a sleep of the card, so that they run back
    to back however slowly the host issues them; raises if the host took
    longer to enqueue them than the card slept."""
    import time

    import torch
    spare = torch.empty_like(f)
    for _ in range(3):
        step(f, spare)
    torch.cuda.synchronize()
    s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    s.record()
    torch.cuda._sleep(200_000_000)
    a.record()
    t0 = time.perf_counter()
    for _ in range(launches):
        step(f, spare)
    host_ms = 1e3 * (time.perf_counter() - t0)
    b.record()
    torch.cuda.synchronize()
    if host_ms >= s.elapsed_time(a):
        raise RuntimeError(f"the host took {host_ms:.3f} ms to enqueue "
                           f"{launches} launches, the card slept "
                           f"{s.elapsed_time(a):.3f} ms")
    return a.elapsed_time(b) / (launches * per)


# the 1-step D3Q19 kernel's cells: name -> (SimulationParams keywords, a
# mesh shape for one shard's depth-1 ring build or None); "spin" the
# Bouzidi sphere spinning about z, "kolmogorov3d" the preset's box
_SPHERE = dict(problem="cylinder3d", nx=256, ny=256, nz=256,
               inlet_velocity=0.05)
_BZ = dict(_SPHERE, cylinder_radius=0.23, obstacle_bc="bouzidi")
_OPS = {"bgk": {}, "trt": dict(collision="trt"),
        "mrt": dict(collision="mrt"),
        "regularized": dict(collision="regularized"),
        "les": dict(smagorinsky=0.17), "power_law": dict(power_law_n=0.7)}


def _cube(kw: dict, n: int) -> dict:
    return dict(kw, nx=n, ny=n, nz=n)


_DUCT = dict(problem="poiseuille", nx=256, ny=256, nz=256, tau=0.8,
             periodic_x=True, inlet_velocity=0.0,
             body_force=(1e-6, 0.0, 0.0))
_TG = dict(problem="taylor-green", nx=256, ny=256, nz=256, tau=0.8,
           inlet_velocity=0.04, periodic_x=True, cylinder_radius=0.0)
_KOL = dict(problem="kolmogorov3d")
ONE_STEP = {
    **{f"sphere_{op}": (dict(_SPHERE, **kw), None) for op, kw in _OPS.items()},
    "sphere_source": (dict(_SPHERE, body_force=(1e-6, 0.0, 0.0)), None),
    "sphere_bounce_back": (dict(_SPHERE, obstacle_bc="bounce_back"), None),
    **{f"duct_{op}": (dict(_DUCT, **kw), None) for op, kw in _OPS.items()},
    "box_256": (_TG, None),
    "kolmogorov3d_128": (_KOL, None),
    "sphere_d3q27": (dict(_SPHERE, lattice3d="d3q27"), None),
    **{f"box_force_64_{op}": (dict(_cube(_KOL, 64), **kw), None)
       for op, kw in _OPS.items() if op != "bgk"},
    **{f"box_force_64_d3q27_{op}": (dict(_cube(_KOL, 64), lattice3d="d3q27",
                                         **kw), None)
       for op, kw in _OPS.items() if op != "mrt"},
    **{f"sphere_64_d3q27_{op}": (dict(_cube(_SPHERE, 64), lattice3d="d3q27",
                                      **kw), None)
       for op, kw in _OPS.items() if op not in ("bgk", "mrt")},
    "box_64_d3q27": (dict(_cube(_TG, 64), lattice3d="d3q27"), None),
    "sphere_64_d3q27_bounce_back": (dict(
        _cube(_SPHERE, 64), lattice3d="d3q27", obstacle_bc="bounce_back"),
        None),
    "duct_64_d3q27": (dict(_cube(_DUCT, 64), lattice3d="d3q27"), None),
    **{f"bouzidi_{op}": (dict(_BZ, **kw), None) for op, kw in _OPS.items()},
    "bouzidi_d3q27": (dict(_BZ, lattice3d="d3q27"), None),
    **{f"bouzidi_64_d3q27_{op}": (dict(_cube(_BZ, 64), lattice3d="d3q27",
                                       **kw), None)
       for op, kw in _OPS.items() if op not in ("bgk", "mrt")},
    "bouzidi_64_d3q27_spin": (dict(_cube(_BZ, 64), lattice3d="d3q27"),
                              None),
    "sphere_2x2_shard": (_SPHERE, (2, 2)),
    "bouzidi_2x2_shard": (_BZ, (2, 2)),
    "bouzidi_d3q27_128_2x2_shard": (dict(_cube(_BZ, 128), lattice3d="d3q27"),
                                    (2, 2)),
}


def _one_step_problem(name: str, n=None):
    """The problem of ONE_STEP's cell `name` (at n^3 where given: the
    libraries' defines do not depend on the size)."""
    import dataclasses

    import numpy as np
    from tpulbm_torch.config import PRESETS, SimulationParams
    from tpulbm_torch.models import make_problem
    kw = dict(ONE_STEP[name][0])
    if n is not None:
        kw.update(nx=n, ny=n, nz=n)
    if kw.get("problem") == "kolmogorov3d":
        kw.pop("problem")
        params = PRESETS["kolmogorov3d"].replace(**kw)
    else:
        params = SimulationParams(**kw)
    problem = make_problem(params.replace(precision="f32", enable_vtk=False))
    if name.endswith("_spin"):   # the sphere spinning about z
        p = problem.params
        c = np.array([p.get_cylinder_x(), p.get_cylinder_y(), p.nz // 2])
        omega = p.inlet_velocity / float(p.get_cylinder_radius_cells())

        def uw(pts):
            d = pts - c
            return np.stack([-omega * d[..., 1], omega * d[..., 0],
                             np.zeros_like(d[..., 0])], axis=-1)
        problem = dataclasses.replace(problem, obstacle_velocity=uw)
    return problem


def one_step_builds() -> list:
    """(source, defines) of every library ONE_STEP's cells launch."""
    from tpulbm_torch.ops import step_cuda
    builds = []
    for name, (_, shape) in ONE_STEP.items():
        c = step_cuda.StepConstants.of(_one_step_problem(name, 16))
        builds.append(("step_d3q19.cu", step_cuda.build_defines(
            c.mode, c.variant)))
        if shape is not None:
            builds.append(("step_d3q19.cu", step_cuda.build_defines(
                c.mode, c.variant | step_cuda.RINGS)))
    return list(dict.fromkeys(builds))


def time_one_step(dev, out: dict) -> None:
    """ms per step of every ONE_STEP cell into `out`: the one-device
    kernel, or one shard's depth-1 ring build with the four shards summed
    (`_summed`) and the one-device kernel (`_one`) in the same turns."""
    import torch
    from tpulbm_torch.convert import state_from_numpy
    from tpulbm_torch.ops import step_cuda
    from tpulbm_torch.ops import bouzidi
    from tpulbm_torch.parallel import halo, mesh, sharded_step
    tables = {}   # a geometry's Bouzidi link table, shared by its operators
    for name, (kw, shape) in ONE_STEP.items():
        p = _one_step_problem(name)
        if p.obstacle_bc == "bouzidi":
            key = (repr(sorted((k, v) for k, v in kw.items()
                               if k not in ("collision", "smagorinsky",
                                            "power_law_n"))),
                   name.endswith("_spin"))
            if key not in tables:
                tables[key] = bouzidi.link_tables(p)
            object.__setattr__(p, "_bouzidi_tables", tables[key])
        f = state_from_numpy(p.initial_state(), p, dev)
        cells = f[0].numel()
        steps = min(1200, max(150, 150 * 256 ** 3 // cells))
        one = step_cuda.make_local_step_cuda_3d(p, dev)
        if shape is None:
            out[name] = ms_per_step(one, f, steps, 1)
        else:
            m = mesh.make_mesh(shape, devices=[dev] * 4)
            masks = halo.pad_mask(sharded_step._solid_grid(p, m),
                                  periodic_x=p.periodic_x,
                                  periodic_y=p.periodic_y, depth=1)
            geo = sharded_step.kernel_shards(p, m, 1, True, masks)
            blocks = sharded_step.split(m, f)
            rings = halo.exchange(blocks, eq_ring=p.ghost_ring_values(),
                                  depth=1, periodic_x=p.periodic_x,
                                  periodic_y=p.periodic_y, x_rings=True)
            consts = step_cuda.kernel_constants(p, q=19)
            outs = [[torch.empty_like(b) for b in row] for row in blocks]

            def shard(f, o):
                return step_cuda.collide_stream_rings_3d(
                    blocks[0][0], outs[0][0], rings[0][0], geo[0][0],
                    consts, 1)

            def summed(f, o):
                for iy, ix in m.shards():
                    step_cuda.collide_stream_rings_3d(
                        blocks[iy][ix], outs[iy][ix], rings[iy][ix],
                        geo[iy][ix], consts, 1)
                return o

            out[name] = ms_per_step(shard, f, 4 * steps, 1)
            out[f"{name}_summed"] = ms_per_step(summed, f, steps, 1)
            out[f"{name}_one"] = ms_per_step(one, f, steps, 1)
            del blocks, rings, outs, geo
        del f, one
        torch.cuda.empty_cache()


# the march group's cells: name -> (problem keywords, which _march_problem
# turns into a problem; mesh shape or None; layout: "one" one device,
# "rows" ring rows, "tiled" x rings, "overlap" the overlap mode's three
# ranged launches, "n2".."n4" the N-step kernel on one device)
_RE200 = dict(preset="re200")
_OPS2 = {"bgk": {}, "trt": dict(collision="trt", zou_he_corners="clean"),
         "mrt": dict(collision="mrt", mrt_rates=(("e", 1.857),)),
         "regularized": dict(collision="regularized"),
         "kbc": dict(collision="kbc"), "les": dict(smagorinsky=0.17),
         "power_law": dict(power_law_n=0.7)}
_CHANNEL = dict(problem="poiseuille", nx=2048, ny=512, tau=0.8,
                inlet_velocity=0.0, body_force=(1.53e-7, 0.0))
_BOX = dict(nx=2048, ny=512, tau=0.8, kolmogorov_n=4, periodic_x=True,
            cylinder_radius=0.0)
_MP = dict(problem="multiphase", nx=2048, ny=512, tau=1.0, shan_chen_g=-5.0,
           inlet_velocity=0.0, cylinder_radius=0.15, cylinder_x=0.5,
           cylinder_y=0.5)
MARCH = {
    **{f"re200_{op}": (dict(_RE200, **kw), None, "one")
       for op, kw in _OPS2.items()},
    **{f"re200_n{n}": (_RE200, None, f"n{n}") for n in (2, 3, 4)},
    **{f"channel_{op}": (dict(_CHANNEL, **kw), None, "one")
       for op, kw in _OPS2.items() if op != "trt"},
    "channel_trt": (dict(_CHANNEL, collision="trt"), None, "one"),
    "cavity_1024": (dict(problem="cavity", nx=1024, ny=1024,
                         inlet_velocity=0.1, cylinder_radius=0.0,
                         cavity_re=1000.0), None, "one"),
    "cylinder_bounce_back": (dict(_RE200, obstacle_bc="bounce_back"), None,
                             "one"),
    "cylinder_source": (dict(_RE200, body_force=(1.53e-7, 0.0)), None,
                        "one"),
    **{f"bouzidi_{op}": (dict(_RE200, obstacle_bc="bouzidi", **kw), None,
                         "one") for op, kw in _OPS2.items()},
    "bouzidi_spin": (dict(_RE200, obstacle_bc="bouzidi", spin=True), None,
                     "one"),
    "slab_2048": (dict(slab="bouzidi"), None, "one"),
    **{f"slab_256_{op}": (dict(slab="bouzidi", nx=256, ny=64, **kw), None,
                          "one") for op, kw in _OPS2.items()
       if op not in ("bgk", "trt")},
    "slab_256_trt": (dict(slab="bouzidi", nx=256, ny=64, collision="trt"),
                     None, "one"),
    "slab_256_bounce_back": (dict(slab="bounce_back", nx=256, ny=64), None,
                             "one"),
    "slab_256_pin": (dict(slab="equilibrium", nx=256, ny=64), None, "one"),
    "slab_256_couette": (dict(slab="bouzidi", nx=256, ny=64, force=0.0,
                              moving=0.05), None, "one"),
    "scale8m_4x1_rows": (dict(preset="scale-8m"), (4, 1), "rows"),
    "scale8m_4x1_overlap": (dict(preset="scale-8m"), (4, 1), "overlap"),
    "tg_4x1_overlap": (dict(_BOX, problem="taylor-green",
                            inlet_velocity=0.04), (4, 1), "overlap"),
    "scale8m_2x2_tiled": (dict(preset="scale-8m"), (2, 2), "tiled"),
    "tg_2x2_tiled": (dict(_BOX, problem="taylor-green", inlet_velocity=0.04),
                     (2, 2), "tiled"),
    "kolmogorov_2x2_tiled": (dict(_BOX, problem="kolmogorov",
                                  inlet_velocity=0.05), (2, 2), "tiled"),
    "bouzidi_1x2_tiled": (dict(_RE200, obstacle_bc="bouzidi"), (1, 2),
                          "tiled"),
    "slab_1x2_tiled": (dict(slab="bouzidi"), (1, 2), "tiled"),
    "mp_droplet": (_MP, None, "one"),
    "mp_droplet_4x1": (_MP, (4, 1), "rows"),
    "mp_droplet_2x2": (_MP, (2, 2), "tiled"),
}
MARCH_LAUNCHES = 10   # launches before a cell's hash
MARCH_REPS = 200      # calls a card's-clock turn enqueues


def _march_problem(kw: dict):
    """The problem of a MARCH cell's keywords, f32, no VTK: a preset, the
    cavity at its Reynolds number, the slab (tpulbm's solid-slab channel as
    chip_smoke.slab_problem builds it, obstacle rule `slab`), the spinning
    Bouzidi cylinder (`spin`), or plain SimulationParams."""
    import dataclasses

    import numpy as np
    from tpulbm_torch.config import PRESETS, SimulationParams
    from tpulbm_torch.models import make_problem
    kw = dict(kw)
    preset, spin = kw.pop("preset", None), kw.pop("spin", False)
    bc = kw.pop("slab", None)
    if bc is not None:
        nx, ny = kw.pop("nx", 2048), kw.pop("ny", 512)
        tau, moving = 0.8, kw.pop("moving", 0.0)
        y0, y1 = 1.75, ny - 2.25
        force = kw.pop("force", 8.0 * (tau - 0.5) / 3.0 * 0.05
                       / (y1 - y0) ** 2)
        params = SimulationParams(
            problem="poiseuille", nx=nx, ny=ny, tau=tau, periodic_x=True,
            inlet_velocity=0.0, precision="f32", enable_vtk=False,
            obstacle_bc=bc, body_force=(force, 0.0), **kw)
        solid = np.zeros((ny, nx), bool)
        solid[:2] = solid[-2:] = True

        def uw(p):
            return np.stack([np.where(p[..., 1] > 0.5 * ny, moving, 0.0),
                             np.zeros_like(p[..., 0])], axis=-1)
        return dataclasses.replace(
            make_problem(params), solid=solid, init_u=(0.0, 0.0),
            walls_y=False, periodic_x=True, obstacle_bc=bc,
            obstacle_sdf=lambda p: np.minimum(p[..., 1] - y0,
                                              y1 - p[..., 1]),
            obstacle_velocity=uw if moving else None,
            body_force=(force, 0.0) if force else ())
    if kw.pop("cavity_re", None):
        from tpulbm_torch.models.cavity import tau_for_cavity_reynolds
        kw["tau"] = tau_for_cavity_reynolds(1000.0, kw["inlet_velocity"],
                                            kw["nx"])
    params = (PRESETS[preset].replace(**kw) if preset
              else SimulationParams(**kw))
    params = params.replace(precision="f32", enable_vtk=False)
    if spin:
        params = params.replace(cylinder_omega=params.inlet_velocity / float(
            params.get_cylinder_radius_cells()))
    return make_problem(params)


def march_builds(problems: dict) -> list:
    """(source, defines) of every library the march cells launch."""
    from tpulbm_torch.ops import step_cuda
    builds = [("step_multiphase.cu", ()),
              ("step_multiphase.cu", step_cuda.build_defines(
                  "bgk", step_cuda.RINGS))]
    for name, (_, shape, layout) in MARCH.items():
        p = problems[name]
        if p.shan_chen:
            continue
        c = step_cuda.StepConstants.of(p)
        if layout.startswith("n"):
            builds.append(("step_d2q9_blocked.cu", step_cuda.build_defines(
                c.mode, c.variant)))
            continue
        builds.append(("step_d2q9.cu", step_cuda.build_defines(
            c.mode, c.variant | (step_cuda.RINGS if shape else 0))))
    return list(dict.fromkeys(builds))


def _hash(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _perturbed(problem, f):
    """f times seeded noise in [0.9, 1.1), the solid cells at rest
    (chip_smoke.perturbed's state)."""
    import torch
    gen = torch.Generator(device=f.device).manual_seed(7)
    out = f * (0.9 + 0.2 * torch.rand(f.shape, generator=gen,
                                      device=f.device, dtype=f.dtype))
    if problem.solid is not None:
        solid = torch.as_tensor(problem.solid, device=f.device)
        w = torch.as_tensor(problem.lattice.w, dtype=f.dtype,
                            device=f.device)
        out = torch.where(solid, w.view(-1, 1, 1), out)
    return out


def _march_shards(problem, shape, dev, depth, x_rings):
    """(launch(block, out, rings, (iy, ix), rows=None), split, rings) of a
    D2Q9 or Shan-Chen problem's shards on `shape`, every shard on `dev`."""
    import numpy as np
    import torch  # noqa: F401
    from tpulbm_torch.ops import step_cuda
    from tpulbm_torch.parallel import halo, mesh, sharded_step
    m = mesh.make_mesh(shape, devices=[dev] * (shape[0] * shape[1]))
    local = sharded_step.block_shape(problem, m)
    if problem.shan_chen:
        from tpulbm_torch.ops import step_multiphase_cuda as mp
        consts = mp.MultiphaseConstants.of(problem)
        geo = {c: step_cuda.Shard(
            index=c, origin=sharded_step.origin(m, local, *c),
            local_shape=local, grid=tuple(problem.spatial_shape),
            depth=mp.DEPTH, x_rings=x_rings) for c in m.shards()}

        def launch(b, o, r, c, rows=None):
            return mp.collide_stream_multiphase_rings(b, o, r, geo[c], consts)
    else:
        consts = step_cuda.kernel_constants(problem)
        solid = (np.zeros(problem.spatial_shape, bool)
                 if problem.solid is None else problem.solid)
        masks = halo.pad_mask(sharded_step.shard_mask(m, solid),
                              periodic_x=problem.periodic_x,
                              periodic_y=problem.periodic_y, depth=depth)
        grid = sharded_step.kernel_shards(problem, m, depth, x_rings, masks)

        def launch(b, o, r, c, rows=None):
            return step_cuda.collide_stream_rings(
                b, o, r, grid[c[0]][c[1]], consts, depth, rows=rows)

    def rings(blocks):
        return halo.exchange(blocks, eq_ring=problem.ghost_ring_values(),
                             depth=depth, periodic_x=problem.periodic_x,
                             periodic_y=problem.periodic_y, x_rings=x_rings)
    return launch, (lambda f: sharded_step.split(m, f)), rings, m, local


def time_march(dev, out: dict) -> None:
    """Every MARCH cell into `out`: ms per step on the card's clock, a
    shard's launches as the host issues them (`_issued`), the multiphase
    shards summed (`_summed`), and each cell's state hash (`_hash`)."""
    import torch
    from tpulbm_torch.ops import step_cuda, step_multiphase_cuda
    from tpulbm_torch.parallel import sharded_step  # noqa: F401
    problems = {name: _march_problem(kw) for name, (kw, _, _) in
                MARCH.items()}
    with ThreadPoolExecutor(16) as pool:
        list(pool.map(lambda b: cuda_build_load(*b), march_builds(problems)))
    for name, (kw, shape, layout) in MARCH.items():
        p = problems[name]
        f0 = _initial(p, dev)
        fp = _perturbed(p, f0)
        if p.shan_chen:
            one = step_multiphase_cuda.make_local_step_multiphase_cuda(p,
                                                                       dev)
        elif layout.startswith("n"):
            one = step_cuda.make_local_step_cuda_blocked(p, dev,
                                                         int(layout[1:]))
        else:
            one = step_cuda.make_local_step_cuda(p, dev)
        per = int(layout[1:]) if layout.startswith("n") else 1
        if shape is None:
            g, spare = fp.clone(), torch.empty_like(fp)
            for _ in range(MARCH_LAUNCHES):
                g, spare = one(g, spare), g
            out[f"{name}_hash"] = _hash(g)
            out[name] = min(device_ms(one, f0, MARCH_REPS, per)
                            for _ in range(3))
            del g, spare
        else:
            depth = 2 if p.shan_chen else 1
            launch, split, rings, m, local = _march_shards(
                p, shape, dev, depth, layout == "tiled" or shape[1] != 1)
            nyl = local[-2]

            def step_of(blocks, rs, c):
                def step(b, o):
                    if layout == "overlap":
                        launch(b, o, (None,) * 4, c, rows=(2, nyl - 2))
                        launch(b, o, rs[c[0]][c[1]], c, rows=(0, 2))
                        return launch(b, o, rs[c[0]][c[1]], c,
                                      rows=(nyl - 2, nyl))
                    return launch(b, o, rs[c[0]][c[1]], c)
                return step
            pblocks = split(fp)
            prings = rings(pblocks)
            outs = []
            for c in m.shards():
                step = step_of(pblocks, prings, c)
                g = pblocks[c[0]][c[1]].clone()
                spare = torch.empty_like(g)
                for _ in range(MARCH_LAUNCHES):
                    g, spare = step(g, spare), g
                outs.append(_hash(g))
            out[f"{name}_hash"] = hashlib.sha256(
                "".join(outs).encode()).hexdigest()[:16]
            blocks = split(f0)
            rs = rings(blocks)
            shard = step_of(blocks, rs, (0, 0))
            b = blocks[0][0]
            out[name] = min(device_ms(shard, b, MARCH_REPS, 1)
                            for _ in range(3))
            out[f"{name}_issued"] = ms_per_step(shard, b, MARCH_REPS, 1)
            if p.shan_chen:
                outs_ = [[torch.empty_like(x) for x in row]
                         for row in blocks]

                def summed(f, o):
                    for iy, ix in m.shards():
                        launch(blocks[iy][ix], outs_[iy][ix], rs[iy][ix],
                               (iy, ix))
                    return o
                out[f"{name}_summed"] = min(
                    device_ms(summed, f0, MARCH_REPS, 1) for _ in range(3))
                out[f"{name}_one"] = min(
                    device_ms(one, f0, MARCH_REPS, 1) for _ in range(3))
                del outs_
            del pblocks, prings, blocks, rs
        del f0, fp, one
        torch.cuda.empty_cache()


def _initial(problem, dev):
    """The problem's initial state on `dev`, built there
    (sharded_step.shard_initial_state on one shard, as the Runner builds
    it)."""
    from tpulbm_torch.parallel import mesh, sharded_step
    m = mesh.make_mesh((1, 1), devices=[dev])
    return sharded_step.shard_initial_state(problem, m)[0][0][0]


def cuda_build_load(source, defines):
    from tpulbm_torch.utils import cuda_build
    return cuda_build.load(source, defines)


def main(checkout: str, label: str, group: str = "all") -> None:
    sys.path.insert(0, checkout)
    import torch
    from tpulbm_torch.config import PRESETS, SimulationParams
    from tpulbm_torch.convert import state_from_numpy
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import step_cuda
    from tpulbm_torch.parallel import halo, mesh, sharded_step
    from tpulbm_torch.utils import cuda_build

    if not step_cuda.__file__.startswith(checkout):
        raise RuntimeError(f"imported {step_cuda.__file__}, not {checkout}")
    dev = torch.device("cuda", 0)
    if group == "march":
        out = {"label": label}
        time_march(dev, out)
        print(json.dumps(out))
        return
    if group == "one_step":
        with ThreadPoolExecutor(16) as pool:
            list(pool.map(lambda b: cuda_build.load(*b), one_step_builds()))
        out = {"label": label}
        time_one_step(dev, out)
        print(json.dumps(out))
        return

    def sphere(**kw):
        return make_problem(SimulationParams(
            problem="cylinder3d", nx=256, ny=256, nz=256,
            inlet_velocity=0.05, precision="f32", **kw))

    base = PRESETS["re200"].replace(precision="f32")
    re200 = make_problem(base)
    operators = {op: make_problem(base.replace(**kw)) for op, kw in (
        ("trt", dict(collision="trt")), ("mrt", dict(collision="mrt")),
        ("regularized", dict(collision="regularized")),
        ("kbc", dict(collision="kbc")), ("les", dict(smagorinsky=0.17)),
        ("power_law", dict(power_law_n=0.7)),
        ("bouzidi", dict(obstacle_bc="bouzidi")))}
    operators["slab"] = _march_problem(MARCH["slab_2048"][0])
    scale = make_problem(PRESETS["scale-8m"].replace(precision="f32"))
    bgk, mrt = sphere(), sphere(collision="mrt")
    d3q27 = sphere(lattice3d="d3q27")
    builds = [("step_d2q9.cu", ()), ("step_d2q9_blocked.cu", ()),
              ("step_d2q9_blocked.cu",
               step_cuda.build_defines("bgk", step_cuda.RINGS))]
    for p in operators.values():
        c = step_cuda.StepConstants.of(p)
        builds.append(("step_d2q9_blocked.cu",
                       step_cuda.build_defines(c.mode, c.variant)))
    for p in (bgk, mrt, d3q27):
        c = step_cuda.StepConstants.of(p)
        for src in ("step_d3q19.cu", "step_d3q19_blocked.cu"):
            builds.append((src, step_cuda.build_defines(c.mode, c.variant)))
    builds.append(("step_d3q19_blocked.cu",
                   step_cuda.build_defines("bgk", step_cuda.RINGS)))
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda b: cuda_build.load(*b), builds))
    out = {"label": label}
    f = state_from_numpy(re200.initial_state(), re200, dev)
    out["re200_1step"] = ms_per_step(
        step_cuda.make_local_step_cuda(re200, dev), f, 2400, 1)
    for n in (2, 3, 4):
        out[f"re200_n{n}"] = ms_per_step(
            step_cuda.make_local_step_cuda_blocked(re200, dev, n), f, 2400,
            n)
    for op, p in operators.items():
        out[f"re200_{op}_n4"] = ms_per_step(
            step_cuda.make_local_step_cuda_blocked(p, dev, 4),
            state_from_numpy(p.initial_state(), p, dev), 2400, 4)
    # one shard of scale-8m on the 2x2 mesh (x rings), every shard on the
    # one card
    m = mesh.make_mesh((2, 2), devices=[dev] * 4)
    blocks = sharded_step.split(
        m, state_from_numpy(scale.initial_state(), scale, dev))
    geo = sharded_step.kernel_shards(scale, m, 4, True)
    rings = halo.exchange(blocks, eq_ring=scale.ghost_ring_values(),
                          depth=4, periodic_x=scale.periodic_x,
                          periodic_y=scale.periodic_y, x_rings=True)
    consts = step_cuda.kernel_constants(scale)
    b, r, g = blocks[0][0], rings[0][0], geo[0][0]
    spare = torch.empty_like(b)
    out["scale8m_2x2_shard_n4"] = ms_per_step(
        lambda f, o: step_cuda.collide_stream_rings(b, spare, r, g, consts,
                                                    4),
        b, 2400, 4)
    # the same on the card's clock (the host issues a shard's launch more
    # slowly than the card runs it) and re200's N=4 beside it
    out["scale8m_2x2_shard_n4_device"] = device_ms(
        lambda f, o: step_cuda.collide_stream_rings(b, spare, r, g, consts,
                                                    4),
        b, 200, 4)
    out["re200_n4_device"] = device_ms(
        step_cuda.make_local_step_cuda_blocked(re200, dev, 4),
        state_from_numpy(re200.initial_state(), re200, dev), 200, 4)
    for name, p, depths in (("sphere", bgk, (3,)), ("sphere_mrt", mrt, (3,)),
                            ("sphere_d3q27", d3q27, (2, 3))):
        f = state_from_numpy(p.initial_state(), p, dev)
        out[f"{name}_1step"] = ms_per_step(
            step_cuda.make_local_step_cuda_3d(p, dev), f, 150, 1)
        for n in depths:
            out[f"{name}_n{n}"] = ms_per_step(
                step_cuda.make_local_step_cuda_3d_blocked(p, dev, n), f, 150,
                n)
    # one shard of the 2x2 mesh, every shard on the one card
    m = mesh.make_mesh((2, 2), devices=[dev] * 4)
    blocks = sharded_step.split(
        m, state_from_numpy(bgk.initial_state(), bgk, dev))
    masks = halo.pad_mask(sharded_step._solid_grid(bgk, m),
                          periodic_x=bgk.periodic_x,
                          periodic_y=bgk.periodic_y, depth=3)
    geo = sharded_step.kernel_shards(bgk, m, 3, True, masks)
    rings = halo.exchange(blocks, eq_ring=bgk.ghost_ring_values(), depth=3,
                          periodic_x=bgk.periodic_x,
                          periodic_y=bgk.periodic_y, x_rings=True)
    consts = step_cuda.kernel_constants(bgk, q=19)
    b, r, g = blocks[0][0], rings[0][0], geo[0][0]
    spare = torch.empty_like(b)
    out["sphere_2x2_shard_n3"] = ms_per_step(
        lambda f, o: step_cuda.collide_stream_rings_3d(b, spare, r, g,
                                                       consts, 3),
        b, 150, 3)
    with ThreadPoolExecutor(16) as pool:
        list(pool.map(lambda b: cuda_build.load(*b), one_step_builds()))
    time_one_step(dev, out)
    print(json.dumps(out))


if __name__ == "__main__":
    main(*sys.argv[1:4])
