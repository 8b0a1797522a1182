"""conv_roofline.synth: the generator's least time (``work.py``: each
block's operations at the bf16 peak or its bytes at the HBM rate, and the
head) over the device time of the generator's layer, in %.

The layer's device time is every kernel of the window but the vocoder's,
which these patterns name; a kernel that matches none counts here, so a
renamed or fused kernel can only lower this share."""

VOCODER = ("istft", "scan", "cos_kernel", "sin_kernel", "remainder", "MaxNanFunctor", "MinNanFunctor")


def read(run):
    if run.trace is None or not run.facts.get("units_done"):
        return None
    busy = sum(e - s for name, s, e in run.trace.kernels() if not any(p in name for p in VOCODER))
    if busy <= 0:
        return None
    return 100.0 * run.facts["generator_least_s"] * run.facts["units_done"] / busy
