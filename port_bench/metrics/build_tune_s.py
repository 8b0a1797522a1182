"""build_tune_s: the seconds of set-up the process spent building kernels
and timing candidates, the union of the program's ``mg.build.compile`` (one
a source ``nvcc`` compiles, all at once) and ``mg.autotune.measure`` spans
(``musicgan_tpu_torch/utils/profiling.py``).  0 on a warm checkout:
anything else is a kernel built again or a shape timed again.  The union,
not the sum: the sources compile side by side.  None where the program
keeps no spans."""


def read(run):
    try:
        from musicgan_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    total, end = 0, None
    for t0, t1 in sorted((s.t0_ns, s.t1_ns) for s in spans()
                         if s.name in ("mg.build.compile", "mg.autotune.measure")):
        if end is None or t0 > end:
            total, end = total + t1 - t0, t1
        elif t1 > end:
            total, end = total + t1 - end, t1
    return total * 1e-9
