"""Device time of the kernels that are not the port's step kernels (the
diagnostics' plain PyTorch kernels: forces, max |u|, stability, fields) per
output interval, in the traced part; the intervals are the steps the traced
port launches advance (each launch's depth) over the output frequency."""

from lbmbench.yardstick import depth_of


def read(run):
    if run.trace is None:
        return None
    launches = run.trace.port_launches()
    steps = sum(depth_of(name) for name, _ in launches)
    if not steps:
        return None
    other = run.trace.groups().get("other kernels", {"ms": 0.0})["ms"]
    return other / (steps / run.cell.freq)
