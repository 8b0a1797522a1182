"""mfu.synth: the operations of the synthesis calls completed in the
window (generator, head and vocoder, counted by ``work.py``) over the
window's length times the bf16 dense peak, in %."""


def read(run):
    if run.trace is None or not run.facts.get("units_done"):
        return None
    return 100.0 * run.facts["flops"] * run.facts["units_done"] / (run.trace.window_s * run.facts["peak_flops"])
