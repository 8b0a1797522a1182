"""istft_roofline.synth: the vocoder's least time (``work.py``: the image
read and the waveform written at the HBM rate, or an inverse FFT a frame at
the peak) over the device time of the kernels these patterns name (the
fused iSTFT and the spectrum's own kernels: the phase's prefix sum, its
remainder, cos and sin, the magnitude's span), in %."""

VOCODER = ("istft", "scan", "cos_kernel", "sin_kernel", "remainder", "MaxNanFunctor", "MinNanFunctor")


def read(run):
    if run.trace is None or not run.facts.get("units_done"):
        return None
    busy = sum(e - s for name, s, e in run.trace.kernels() if any(p in name for p in VOCODER))
    if busy <= 0:
        return None
    return 100.0 * run.facts["vocoder_least_s"] * run.facts["units_done"] / busy
