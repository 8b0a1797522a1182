"""host_per_device.train: the host's time in the window's train iterations
(the program's ``mg.train.iteration`` spans,
``musicgan_tpu_torch/utils/profiling.py``, summed) over the device's busy
time in the traced window (the union of its kernels and copies).  Above 1
the host sets the pace.  An iteration is the window's where its
``mg.train.iteration`` lies inside one of the benchmark's
``port_bench.train_step`` spans; None where the program keeps no such span."""


def read(run):
    try:
        from musicgan_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    marks = [(t0, t1) for name, t0, t1 in run.spans if name == "port_bench.train_step"]
    recorded = spans()
    steps = {s.index for s in recorded if s.name == "mg.train.iteration" and s.parent is None
             and any(a <= s.t0_ns * 1e-9 and s.t1_ns * 1e-9 <= b for a, b in marks)}
    if not steps or run.trace is None or run.trace.busy_s() <= 0:
        return None
    host_s = sum((s.t1_ns - s.t0_ns) * 1e-9 for s in recorded if s.index in steps)
    return host_s / run.trace.busy_s()
