"""One run of one cell: set-up, the measured window of whole Runner.run()
jobs, the check against the reference, and the metrics.

Set-up (from process start to the first job's start): the cell's files,
one warm-up job on a Runner of its own (one super-chunk and the job's tail
chunk lengths, spec.warmup_steps), then the window's Runner. The window
runs jobs (run(resume=False): the initial state, the loop with its
diagnostics and host fetches, forces.csv and the final fields) back to
back; a job starts only while fewer than `seconds` have passed since the
first one started, and the window ends when the last one returns.

The harness reaches into the Runner at one point, by a subclass: the
states that the tail's diagnostics samples read (Runner._diag, one an
output interval up to the job's last force row), the last few kept on the
device, so that the reference can follow the job's end from the oldest.
A `--trace 1` run profiles the first TRACE_SECONDS of the first job on the
host's clock: a timer signal ends the profile wherever the job then is.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import signal
import tempfile
import threading
import time

import torch

from . import check, spec
from .yardstick import Trace

# host seconds from the first job's start that a --trace 1 run profiles
TRACE_SECONDS = 2.0


@dataclasses.dataclass
class Job:
    seconds: float          # host clock around run()
    wall_seconds: float     # RunResult.wall_seconds
    loop_seconds: float     # the Runner's metered loop: cells x steps / mlups
    host_fetches: int
    launches: int
    success: bool


@dataclasses.dataclass
class Run:
    """What a metric reader sees."""
    cell: spec.Cell
    jobs: list
    traced_jobs: int            # the first jobs, profiled in part
    trace: Trace | None


def launch_total() -> int:
    """Kernel launches so far, summed over the port's counting wrappers."""
    from tpulbm_torch.ops import (step_cuda, step_multiphase_cuda,
                                  step_thermal_cuda)
    total = 0
    for mod in (step_cuda, step_thermal_cuda, step_multiphase_cuda):
        for wrapper in vars(mod).values():
            if hasattr(wrapper, "launches_by_library"):
                n = step_cuda.launches(wrapper)
                total += sum(n.values()) if isinstance(n, dict) else n
            elif isinstance(getattr(wrapper, "launches", None), int):
                total += wrapper.launches
    return total


def observed(runner_cls, keep: int):
    class Observed(runner_cls):
        """The Runner, with the states of the last `keep` diagnostics
        samples of each job kept on the device (the tail samples one an
        output interval up to the job's last force row)."""
        _kept = None
        _samples = 0

        def run(self, *args, **kwargs):
            self._samples = 0
            return super().run(*args, **kwargs)

        def _diag(self, f):
            block = f[0][0] if isinstance(f, list) else f
            if self._kept is None:
                self._kept = [None] * keep
            slot = self._samples % keep
            buf = self._kept[slot]
            if buf is None or buf.shape != block.shape:
                self._kept[slot] = block.detach().clone()
            else:
                buf.copy_(block)
            self._samples += 1
            return super()._diag(f)

        def kept_state(self):
            """(state, step) of the oldest kept sample of the last job, or
            (None, None) where it took none."""
            n = min(self._samples, keep)
            if not n:
                return None, None
            freq = self.params.output_frequency
            t_last = (self.params.num_timesteps - 1) // freq * freq
            return (self._kept[(self._samples - n) % keep],
                    t_last - (n - 1) * freq)

    return Observed


class Tracer:
    """torch.profiler from start() for `seconds` on the host's clock (or
    until stop()): a timer signal stops it at the main thread's next
    Python instruction, wherever the program then is."""

    def __init__(self, seconds: float, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.device = device
        self.prof = torch.profiler.profile(activities=acts)
        self.seconds = seconds
        self.running = False
        self._handler = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self.prof.start()
        self.running = True
        if threading.current_thread() is threading.main_thread():
            self._handler = signal.signal(signal.SIGALRM,
                                          lambda *_: self.stop())
            # system calls that the signal interrupts restart
            signal.siginterrupt(signal.SIGALRM, False)
            signal.setitimer(signal.ITIMER_REAL, self.seconds)

    def stop(self):
        if self._handler is not None:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, self._handler)
            self._handler = None
        if self.running:
            self._sync()
            self.prof.stop()
            self.running = False

    def trace(self, path: str) -> Trace:
        self.prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        os.remove(path)
        return Trace(events)


def read_metric(name: str, run: Run):
    """The per-layer metric `name`, read by metrics/<name>.py's read(run),
    or where there is no such file by the reader of the name's part before
    its first dot (`device_idle.2d` by metrics/device_idle.py);
    None where it finds nothing to read."""
    path = run.cell.bench_dir / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(f"{name.split('.')[0]}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"lbmbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(run)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             t_process: float, device="cuda", log=print) -> dict:
    """One run: the result's keys (correct, attempted, failed, metrics,
    device[, breakdown], checks)."""
    from tpulbm_torch import runner as runner_mod
    from tpulbm_torch.config import SimulationParams

    device = torch.device(device)
    Observed = observed(runner_mod.Runner, check.END_INTERVALS + 1)
    warm_steps = spec.warmup_steps(cell,
                                   getattr(runner_mod, "_SUPER_K", None))
    with tempfile.TemporaryDirectory(prefix="lbmbench-") as out_dir:
        warm = Observed(SimulationParams.from_dict(spec.program_params(
            cell, seed, out_dir, warm_steps)),
            device=device, verbose=False)
        if not warm.run(resume=False).success:
            raise RuntimeError("the warm-up job was unstable")
        del warm
        runner = Observed(SimulationParams.from_dict(
            spec.program_params(cell, seed, out_dir)),
            device=device, verbose=False)
        tracer = Tracer(TRACE_SECONDS, device) if trace else None
        jobs = []
        t_first = time.perf_counter()
        while not jobs or time.perf_counter() - t_first < seconds:
            if tracer is not None and not jobs:
                tracer.start()
            n0 = launch_total()
            t0 = time.perf_counter()
            result = runner.run(resume=False)
            t1 = time.perf_counter()
            if tracer is not None:
                tracer.stop()
            loop = (cell.cells * result.final_step / (result.mlups * 1e6)
                    if result.mlups else float("nan"))
            jobs.append(Job(t1 - t0, result.wall_seconds, loop,
                            result.host_fetches, launch_total() - n0,
                            result.success))
            if not result.success:
                break
        t_last = time.perf_counter()
        for k, job in enumerate(jobs):
            log(f"job {k}: {job.seconds:.4f} s on the host clock, "
                f"{job.wall_seconds - job.loop_seconds:.4f} s outside the "
                f"loop, {job.launches} launches, {job.host_fetches} fetches")
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        state, t_state = runner.kept_state()
        del runner
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref_params = spec.reference_params(cell, seed)
        t_check = time.perf_counter()
        values = check.compare(ref_params, cell.traffic, out_dir, state,
                               t_state, device)
        log(f"check: {time.perf_counter() - t_check:.4f} s")
        del state
        tr = tracer.trace(os.path.join(out_dir, "trace.json")) \
            if tracer is not None else None
    ok, rows = check.verdict(values, cell.limits)
    failed = sum(not j.success for j in jobs)
    run = Run(cell, jobs, 1 if trace else 0, tr)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        steps = sum(cell.steps for j in jobs if j.success)
        window = t_last - t_first
        values_e2e = {"mlups": cell.cells * steps / window / 1e6,
                      "setup_s": t_first - t_process}
        # a metric split by cells (mlups.2d) reports its base
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values_e2e[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(ok and not failed), "attempted": len(jobs),
           "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        # the traced window: the traced part's first device operation to
        # its last
        span = tr.device_span() or (0.0, 0.0)
        dev["busy_s"] = tr.busy_us(*span) / 1e6
        dev["window_s"] = (span[1] - span[0]) / 1e6
        loop = tr.loop_window()
        if span[1] > span[0]:
            out["breakdown"] = {
                "device_ops": tr.top_ops(),
                "idle_gaps": tr.idle_gaps(*(loop or span))}
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in rows}
    return out
