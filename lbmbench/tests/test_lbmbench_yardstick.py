"""The yardstick's trace arithmetic on a synthetic chrome trace, against
numbers worked out by hand: the grouping, the union of device time, the
loop's idle share, the idle gaps by the host's activity, the depth read
from kernel names, and the metric readers' roofline share and diagnostics
time."""
from __future__ import annotations

import pytest

from lbmbench import harness, spec, yardstick
from lbmbench.yardstick import Trace, depth_of

N4 = ("void (anonymous namespace)::d2q9_march_kernel<4, false>(float const*,"
      " float*, unsigned char const*, int, int)")
N1 = "void (anonymous namespace)::d2q9_march_kernel<1, false>(float const*)"


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def host(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    kernel(N4, 100, 50),
    kernel("void at::native::reduce_kernel<512, 1>", 110, 20),
    kernel("void at::native::vectorized_elementwise_kernel<4>", 160, 10),
    kernel(N1, 200, 20),
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 230,
     "dur": 5},
    host("cpu_op", "aten::sum", 150, 15),
    host("cuda_runtime", "cudaStreamSynchronize", 168, 32),
    host("cpu_op", "aten::copy_", 160, 60),
    {"ph": "i", "cat": "kernel", "name": N4, "ts": 0},
]


def cell(**traffic) -> spec.Cell:
    base = dict(nx=100, ny=10, nz=0, output_frequency=5, job_steps=100,
                collision="bgk")
    base.update(traffic)
    return spec.Cell("synthetic", 1, {"lattice": "D2Q9"}, base, {}, [], [],
                     harness.spec.HERE)


def test_groups_and_loop_idle():
    tr = Trace(EVENTS)
    groups = tr.groups()
    assert groups["d2q9 N-step"] == {"ms": 0.05, "count": 1}
    assert groups["d2q9 1-step"] == {"ms": 0.02, "count": 1}
    assert groups["other kernels"]["count"] == 2
    assert groups["other kernels"]["ms"] == pytest.approx(0.03)
    assert groups["copies"]["count"] == 1
    # the loop: 100 to 220 us; busy [100, 150] + [160, 170] + [200, 220]
    assert tr.loop_window() == (100.0, 220.0)
    assert tr.busy_us(100, 220) == 80.0
    assert tr.device_span() == (100.0, 235.0)
    assert tr.busy_us(100, 235) == 85.0


def test_idle_gaps_by_host_activity():
    tr = Trace(EVENTS)
    # gaps [150, 160] under aten::sum, [170, 200] under the synchronize
    # (the runtime call wins over aten::copy_, which also covers it)
    assert tr.idle_gaps(100, 220) == [["cudaStreamSynchronize", 30e-6],
                                      ["aten::sum", 10e-6]]
    assert yardstick.gaps([(0, 1), (2, 3)], 0, 5) == [(1, 2), (3, 5)]


@pytest.mark.parametrize("name,depth", [
    (N4, 4), (N1, 1),
    ("_ZN12_GLOBAL__N_117d2q9_march_kernelILi3ELb0EEEvPKfPf", 3),
    ("(anonymous namespace)::d3q19_blocked_kernel<2>(float const*)", 2),
    ("_ZN46_GLOBAL__N__1aaa_d3q19_blocked_kernelILi3EEEvPKfPfPKh", 3),
    ("_ZN46_GLOBAL__N__1aaa_d3q19_step_kernelEPKfPfPKhiii", 1),
    ("void at::native::reduce_kernel<512, 1>", 1)])
def test_depth_from_kernel_names(name, depth):
    assert depth_of(name) == depth


def test_roofline_and_diagnostics_readers():
    run = harness.Run(cell(), [], 1, Trace(EVENTS))
    cells = 1000
    # each launch moves 1000 x 73 B once; N=4 computes 4 x 115 operations a
    # cell, N=1 115: both bound by bytes
    bound = 2 * cells * 73 / 3.35e12
    assert max(cells * 4 * 115 / 67e12, cells * 115 / 67e12) < bound / 2
    share = 100 * bound / 70e-6
    assert harness.read_metric("kernel_roofline", run) == pytest.approx(share)
    # 30 us of other kernels over (4 + 1) steps / 5 = one interval
    assert harness.read_metric("diag_ms_per_interval", run) == \
        pytest.approx(0.03)
    assert harness.read_metric("device_idle", run) == \
        pytest.approx(100 * 40 / 120)


@pytest.mark.parametrize("depth,by", [(3, "bytes"), (4, "operations")])
def test_launch_bound_of_mrt_in_3d(depth, by):
    # D3Q19 MRT at 256^3: 153 B a cell once, 1006 operations a cell a step
    cells = 256 ** 3
    t_bytes, t_ops = cells * 153 / 3.35e12, cells * depth * 1006 / 67e12
    assert yardstick.launch_bound_s("d3q19_mrt", cells, depth) == \
        pytest.approx(max(t_bytes, t_ops))
    assert yardstick.bound_of(153, 1006, cells, depth)["bound_by"] == by


def test_readers_without_a_trace_return_nothing():
    run = harness.Run(cell(), [], 0, None)
    for name in ("kernel_roofline", "diag_ms_per_interval", "device_idle"):
        assert harness.read_metric(name, run) is None
    empty = harness.Run(cell(), [], 1, Trace([]))
    for name in ("kernel_roofline", "diag_ms_per_interval", "device_idle"):
        assert harness.read_metric(name, empty) is None
