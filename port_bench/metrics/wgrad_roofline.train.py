"""wgrad_roofline.train: the least time of the train step's weight
gradients (``work.py``: each convolution's input and output gradient read,
its weight gradient written, at the TF32 peak or the HBM rate) over the
device time of the weight-gradient kernels, in %."""

WGRAD = ("wgrad",)


def read(run):
    if run.trace is None or not run.facts.get("units_done"):
        return None
    busy = sum(e - s for name, s, e in run.trace.kernels() if any(p in name for p in WGRAD))
    if busy <= 0:
        return None
    return 100.0 * run.facts["wgrad_least_s"] * run.facts["units_done"] / busy
