"""istft_roofline.gansynth: K5's least time at GANSynth's ``n_fft`` 2048 and
hop 512 (``work_gansynth.py``: the spectra read and the waveform written at
the HBM rate, or an inverse FFT a frame at the peak) over the device time of
the kernels named ``istft``, in %.  The calls are the program's count of
K5's launches in the window; None where the vocoder is not K5."""


def read(run):
    launches = run.facts.get("launches") or {}
    if run.trace is None or not launches.get("istft") or "istft_least_s" not in run.facts:
        return None
    busy = sum(e - s for name, s, e in run.trace.kernels() if "istft" in name)
    if busy <= 0:
        return None
    return 100.0 * run.facts["istft_least_s"] * launches["istft"] / busy
