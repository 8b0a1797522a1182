"""mel_roofline.gansynth: the mel products' least time (``work_gansynth.py``:
their operations at the 3xTF32 peak, 495 TFLOP/s, or their bytes at the
HBM rate, whichever is longer, so any float32-accurate route stays at or
below 100%) over the device time of the float32 GEMM kernels these
patterns name, in %.  The calls are the program's count of its products,
two a call.  The dense input's small GEMM shares the patterns and counts
here too, which can only lower the share."""

GEMM = ("gemm", "gemv")


def read(run):
    launches = run.facts.get("launches") or {}
    if run.trace is None or not launches.get("mel") or "mel_least_s" not in run.facts:
        return None
    busy = sum(e - s for name, s, e in run.trace.kernels() if any(p in name for p in GEMM))
    if busy <= 0:
        return None
    return 100.0 * run.facts["mel_least_s"] * (launches["mel"] / 2) / busy
