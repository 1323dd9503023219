"""The device's idle share of the stepping loop in the traced part, in
percent: the window from the first port launch's start to the last one's
end, less the union of every device operation in it, over the window."""


def read(run):
    if run.trace is None:
        return None
    window = run.trace.loop_window()
    if window is None or window[1] <= window[0]:
        return None
    lo, hi = window
    return 100.0 * (1.0 - run.trace.busy_us(lo, hi) / (hi - lo))
