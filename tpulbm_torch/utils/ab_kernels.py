"""Time the cylinder's BGK kernels of one checkout, for comparing two
commits on the same card.

    python3 tpulbm_torch/utils/ab_kernels.py CHECKOUT LABEL

Run it as a file, not with -m: it imports tpulbm_torch from CHECKOUT (the
root of an unpacked commit), builds that checkout's four D2Q9 and D3Q19
sources there, and prints one JSON line: LABEL and the ms per step of
re200 at 2048x512 (the 1-step and N=4 kernels) and of the sphere at 256^3
(the 1-step and N=3 kernels), CUDA events, the lower of three turns after
a warm-up. Alternate the commits (parent, change, change, parent), one
process each, in one call.
"""
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


def main(checkout: str, label: str) -> None:
    sys.path.insert(0, checkout)
    import torch
    from tpulbm_torch.config import PRESETS, SimulationParams
    from tpulbm_torch.convert import state_from_numpy
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import step_cuda
    from tpulbm_torch.utils import cuda_build

    if not step_cuda.__file__.startswith(checkout):
        raise RuntimeError(f"imported {step_cuda.__file__}, not {checkout}")
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(cuda_build.load, ["step_d2q9.cu", "step_d2q9_blocked.cu",
                                        "step_d3q19.cu",
                                        "step_d3q19_blocked.cu"]))
    dev = torch.device("cuda", 0)
    out = {"label": label}
    p = make_problem(PRESETS["re200"].replace(precision="f32"))
    f = state_from_numpy(p.initial_state(), p, dev)
    out["re200_1step"] = ms_per_step(step_cuda.make_local_step_cuda(p, dev),
                                     f, 2400, 1)
    out["re200_n4"] = ms_per_step(
        step_cuda.make_local_step_cuda_blocked(p, dev, 4), f, 2400, 4)
    p = make_problem(SimulationParams(problem="cylinder3d", nx=256, ny=256,
                                      nz=256, inlet_velocity=0.05,
                                      precision="f32"))
    f = state_from_numpy(p.initial_state(), p, dev)
    out["sphere_1step"] = ms_per_step(
        step_cuda.make_local_step_cuda_3d(p, dev), f, 150, 1)
    out["sphere_n3"] = ms_per_step(
        step_cuda.make_local_step_cuda_3d_blocked(p, dev, 3), f, 150, 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main(*sys.argv[1:3])
