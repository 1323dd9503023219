"""The port's step kernels' share of their bound over the traced launches:
the sum of each launch's least time (the state's bytes once over 3.35 TB/s,
or its depth's operations over 67 TFLOP/s float32, whichever is larger)
over the sum of their device time, in percent."""

from lbmbench.yardstick import depth_of, launch_bound_s


def read(run):
    if run.trace is None:
        return None
    launches = run.trace.port_launches()
    device_s = sum(us for _, us in launches) / 1e6
    if not device_s:
        return None
    bound_s = sum(launch_bound_s(run.cell.step_kind, run.cell.cells,
                                 depth_of(name)) for name, _ in launches)
    return 100.0 * bound_s / device_s
