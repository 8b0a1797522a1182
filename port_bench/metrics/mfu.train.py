"""mfu.train: the operations of the whole n_critic cycles completed in the
window (every convolution in every role, weight gradients included, counted
by ``work.py``) over the window's length times the TF32 dense peak, in %."""


def read(run):
    if run.trace is None or not run.facts.get("units_done"):
        return None
    return 100.0 * run.facts["flops"] * run.facts["units_done"] / (run.trace.window_s * run.facts["peak_flops"])
