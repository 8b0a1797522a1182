"""conv_roofline.train: the least time of the train step's convolutions
in every role but the weight gradient (``work.py``: forward, input
gradient, the penalty's transposed convolution and its input gradient, one
unit a convolution and role, at the TF32 peak or the HBM rate) over the
device time of every kernel of the window but the weight gradient's, in %.

A kernel that matches no pattern counts here, so a renamed or fused
kernel can only lower this share."""

WGRAD = ("wgrad",)


def read(run):
    if run.trace is None or not run.facts.get("units_done"):
        return None
    busy = sum(e - s for name, s, e in run.trace.kernels() if not any(p in name for p in WGRAD))
    if busy <= 0:
        return None
    return 100.0 * run.facts["conv_least_s"] * run.facts["units_done"] / busy
