"""The benchmark's yardstick: the card's published peaks, the bytes and
operations a lattice-Boltzmann step must move and compute, and the
reduction of a torch.profiler chrome trace to device time by group, the
idle share of the stepping loop, the longest idle gaps, and the port's
kernel launches with their depth and bound.

Frozen copies, kept here so that a change to the program cannot move them:
the tables and `bound_of` of chip_smoke.py (its STEP_BYTES, STEP_FLOPS,
MODE_FLOPS, MODE_FLOPS_3D), and the grouping and idle arithmetic of
tpulbm_torch/utils/profile_run.py (PORT_KERNELS, _group, _busy,
device_breakdown).
"""
from __future__ import annotations

import heapq
import re

# NVIDIA H100 SXM, the data sheet's dense rates at the 700 W limit: HBM3
# bandwidth and the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# Per cell and step: the bytes a step must move (float32 populations read
# and written once, plus the 1-byte solid mask where the kernel reads one)
# and the floating-point operations, counted from the plain step's
# expressions (moments, equilibria, relaxation, source; boundary rows
# neglected).
STEP_BYTES = {"d2q9": 9 * 4 * 2 + 1, "d3q19": 19 * 4 * 2 + 1,
              "thermal": 14 * 4 * 2, "multiphase": 9 * 4 * 2}
STEP_FLOPS = {"d2q9": 115, "d3q19": 256, "thermal": 165, "multiphase": 150}
# D2Q9 under the other collisions: TRT's closed form; MRT at rank 2;
# regularized; KBC; Smagorinsky; the power law's 8 Newton steps
MODE_FLOPS = {"trt": 163, "mrt": 185, "regularized": 182, "kbc": 313,
              "smagorinsky": 143, "power_law": 272}
# D3Q19: TRT; MRT's rank-10 U/V (dense); regularized; Smagorinsky; the
# power law's 8 Newton steps
MODE_FLOPS_3D = {"trt": 382, "mrt": 1006, "regularized": 526,
                 "smagorinsky": 320, "power_law": 449}
for _mode, _flops in MODE_FLOPS.items():
    STEP_BYTES[f"d2q9_{_mode}"] = STEP_BYTES["d2q9"]
    STEP_FLOPS[f"d2q9_{_mode}"] = _flops
for _mode, _flops in MODE_FLOPS_3D.items():
    STEP_BYTES[f"d3q19_{_mode}"] = STEP_BYTES["d3q19"]
    STEP_FLOPS[f"d3q19_{_mode}"] = _flops
# D3Q27: 27 populations read and written, D3Q19's operations x 27/19
STEP_BYTES["d3q27"] = 27 * 4 * 2 + 1
STEP_FLOPS["d3q27"] = round(STEP_FLOPS["d3q19"] * 27 / 19)
for _mode, _flops in MODE_FLOPS_3D.items():
    STEP_BYTES[f"d3q27_{_mode}"] = STEP_BYTES["d3q27"]
    STEP_FLOPS[f"d3q27_{_mode}"] = round(_flops * 27 / 19)
STEP_BYTES["thermal_smagorinsky"] = STEP_BYTES["thermal"]
STEP_FLOPS["thermal_smagorinsky"] = STEP_FLOPS["thermal"] + 27


def bound_of(step_bytes: int, step_flops: int, cells: int,
             steps_per_launch: int = 1) -> dict:
    """The least time (ms) one step of `cells` cells could take: the
    larger of its bytes over the bandwidth and its operations over the
    float32 rate; an N-step launch moves the state once for N steps."""
    t_bytes = cells * step_bytes / steps_per_launch / HBM_BYTES_PER_S
    t_ops = cells * step_flops / F32_FLOPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def launch_bound_s(kind: str, cells: int, depth: int) -> float:
    """Seconds one launch of depth N needs at least: the state's bytes once
    over the bandwidth, or N steps' operations over the float32 rate."""
    return max(cells * STEP_BYTES[kind] / HBM_BYTES_PER_S,
               cells * depth * STEP_FLOPS[kind] / F32_FLOPS_PER_S)


# the port's kernels, by a part of their mangled or demangled names
PORT_KERNELS = {"thermal_step_kernel": "thermal",
                r"d2q9_march_kernel(ILi1E|<1,)": "d2q9 1-step",
                "d2q9_march_kernel": "d2q9 N-step",
                "d3q19_step_kernel": "d3q19",
                r"d3q19_blocked_kernel(ILi2E|<2>)": "d3q19 N=2",
                r"d3q19_blocked_kernel(ILi3E|<3>)": "d3q19 N=3",
                "multiphase_step_kernel": "multiphase"}
# the steps one launch advances: the first template argument of the
# N-step kernels, mangled (ILi4E) or demangled (<4, or <4>)
_DEPTH = re.compile(r"(?:d2q9_march_kernel|d3q19_blocked_kernel)"
                    r"(?:ILi(\d+)E|<(\d+)[,>])")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def group(event: dict) -> str:
    cat = event.get("cat", "")
    if cat == "gpu_memcpy":
        return "copies"
    if cat == "gpu_memset":
        return "sets"
    for part, name in PORT_KERNELS.items():
        if re.search(part, event.get("name", "")):
            return name
    return "other kernels"


def is_port(event: dict) -> bool:
    return group(event) in PORT_KERNELS.values()


def depth_of(name: str) -> int:
    """Steps one launch of the kernel `name` advances: its template depth
    for the N-step kernels, 1 for every other kernel of the port."""
    m = _DEPTH.search(name)
    return int(m.group(1) or m.group(2)) if m else 1


def busy(spans: list, lo: float, hi: float) -> float:
    """Length of the union of (start, end) spans, clipped to [lo, hi]."""
    total, cur = 0.0, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in spans):
        if a >= b:
            continue
        if cur is None or a > cur[1]:
            total += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return total + (0.0 if cur is None else cur[1] - cur[0])


def gaps(spans: list, lo: float, hi: float) -> list:
    """The (start, end) intervals of [lo, hi] that no span covers."""
    out, edge = [], lo
    for a, b in sorted(spans):
        if a > edge:
            out.append((edge, min(a, hi)))
        edge = max(edge, b)
        if edge >= hi:
            break
    if edge < hi:
        out.append((edge, hi))
    return [(a, b) for a, b in out if b > a]


class Trace:
    """A chrome trace's events (microseconds), split into the device's and
    the host's."""

    def __init__(self, events: list):
        events = [e for e in events if e.get("ph") == "X"]
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.host = sorted((e for e in events
                            if e.get("cat") not in DEVICE_CATS),
                           key=lambda e: float(e["ts"]))

    @staticmethod
    def span(e: dict) -> tuple:
        return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))

    def port_launches(self) -> list:
        """[(kernel name, device us)] of the port's kernel launches."""
        return [(e["name"], float(e.get("dur", 0.0))) for e in self.device
                if is_port(e)]

    def groups(self) -> dict:
        """Device ms and count by group (the port's kernels by name, other
        kernels, copies, sets)."""
        out: dict = {}
        for e in self.device:
            g = out.setdefault(group(e), {"ms": 0.0, "count": 0})
            g["ms"] += float(e.get("dur", 0.0)) / 1e3
            g["count"] += 1
        return out

    def loop_window(self):
        """(lo, hi) from the first port launch's start to the last one's
        end, or None without one."""
        spans = [self.span(e) for e in self.device if is_port(e)]
        if not spans:
            return None
        return min(a for a, _ in spans), max(b for _, b in spans)

    def busy_us(self, lo: float, hi: float) -> float:
        return busy([self.span(e) for e in self.device], lo, hi)

    def device_span(self):
        spans = [self.span(e) for e in self.device]
        if not spans:
            return None
        return min(a for a, _ in spans), max(b for _, b in spans)

    def idle_gaps(self, lo: float, hi: float, top: int = 10) -> list:
        """[[host activity, seconds]]: the device's idle gaps in [lo, hi]
        summed by what the host was doing at each gap's start (the
        innermost CUDA runtime call covering it, else the innermost host
        operation, else 'idle'), the longest totals first. One sweep over
        the gaps in time order: the host events started by a gap's start
        wait in a heap by their start, latest first, and those ended by
        then leave it for good."""
        by: dict = {}
        heaps: dict = {"runtime": [], "op": []}
        host = iter(self.host)
        nxt = next(host, None)
        for a, b in gaps([self.span(e) for e in self.device], lo, hi):
            while nxt is not None and float(nxt["ts"]) <= a:
                start, end = self.span(nxt)
                kind = ("runtime" if nxt.get("cat") in ("cuda_runtime",
                                                        "cuda_driver")
                        else "op")
                heapq.heappush(heaps[kind], (-start, end,
                                             nxt.get("name", "?")))
                nxt = next(host, None)
            name = "idle"
            for kind in ("op", "runtime"):
                heap = heaps[kind]
                while heap and heap[0][1] <= a:
                    heapq.heappop(heap)
                if heap:
                    name = heap[0][2]
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def top_ops(self, top: int = 10) -> list:
        """[[device operation, seconds]], the most device time first; the
        port's kernels by group and depth, others by name."""
        by: dict = {}
        for e in self.device:
            g = group(e)
            name = (f"d2q9 N={depth_of(e['name'])}" if g == "d2q9 N-step"
                    else g if is_port(e) else e.get("name", "?")[:120])
            by[name] = by.get(name, 0.0) + float(e.get("dur", 0.0)) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]
