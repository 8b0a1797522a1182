"""d2h_share.synth: device-to-host copy time as a share of the traced
window, in %."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    copies = run.trace.copies("DtoH")
    if not copies:
        return None
    return 100.0 * sum(e - s for _, s, e in copies) / run.trace.window_s
