"""conv_roofline.gansynth: GANSynth's generator's least time (``work_gansynth.py``:
the dense input, each block's operations at the bf16 peak or its bytes at
the HBM rate, the tail, the head) over the device time of the generator's
layer, in %.

The calls are the program's own count: its mel products in the window, two
a call (``facts["launches"]["mel"]``).  The layer's device time is every
kernel of the window but the vocoder's, which these patterns name (the
mel products' and the dense input's float32 GEMMs alike, K5, the
spectrum's prefix sum and elementwise functions); a kernel that matches none
counts here, so a renamed or fused kernel can only lower this share."""

VOCODER = ("istft", "gemm", "gemv", "scan", "exp_kernel", "cos_kernel", "sin_kernel", "sqrt_kernel")


def read(run):
    launches = run.facts.get("launches") or {}
    if run.trace is None or not launches.get("mel") or "generator_least_s" not in run.facts:
        return None
    busy = sum(e - s for name, s, e in run.trace.kernels() if not any(p in name for p in VOCODER))
    if busy <= 0:
        return None
    return 100.0 * run.facts["generator_least_s"] * (launches["mel"] / 2) / busy
