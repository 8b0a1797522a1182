"""The share of the traced window in which no kernel and no copy ran on
the device (the union of their intervals), in %."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
