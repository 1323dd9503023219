"""The port's kernel launches (step_cuda.launches(), summed over its
counting wrappers) per 1,000 steps, over the window's jobs."""


def read(run):
    jobs = [j for j in run.jobs if j.success]
    if not jobs:
        return None
    return 1000.0 * sum(j.launches for j in jobs) / (
        run.cell.steps * len(jobs))
