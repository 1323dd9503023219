"""Seconds a job spends outside the Runner's metered stepping loop: its
RunResult.wall_seconds less the loop's time (cells x steps / mlups), the
initial state and the final artifacts; the mean over the window's jobs
that ran without the profiler (all of them where none did)."""


def read(run):
    jobs = run.jobs[run.traced_jobs:] or run.jobs
    gaps = [j.wall_seconds - j.loop_seconds for j in jobs if j.success]
    return sum(gaps) / len(gaps) if gaps else None
