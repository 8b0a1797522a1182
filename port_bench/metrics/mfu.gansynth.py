"""mfu.gansynth: the least operations of the GANSynth calls completed in the
window (the dense input, blocks, tail and head, the mel products, the iSTFT:
``work_gansynth.py``) over the window's length times the bf16 dense peak,
in %."""


def read(run):
    if run.trace is None or not run.facts.get("units_done") or "mel_least_s" not in run.facts:
        return None
    return 100.0 * run.facts["flops"] * run.facts["units_done"] / (run.trace.window_s * run.facts["peak_flops"])
