"""Device-to-host fetches in the Runner's loop (RunResult.host_fetches) per
1,000 steps, over the window's jobs."""


def read(run):
    jobs = [j for j in run.jobs if j.success]
    if not jobs:
        return None
    return 1000.0 * sum(j.host_fetches for j in jobs) / (
        run.cell.steps * len(jobs))
