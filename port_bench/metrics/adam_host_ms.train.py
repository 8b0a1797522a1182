"""adam_host_ms.train: the host's time in Adam a train iteration, the
program's ``mg.train.critic_adam`` and ``mg.train.gen_adam`` spans (the
generator's with its EMA; ``musicgan_tpu_torch/utils/profiling.py``) summed
by iteration, the median over the window's iterations, in ms.  An iteration
is the window's where its ``mg.train.iteration`` lies inside one of the
benchmark's ``port_bench.train_step`` spans; None where the program keeps
no such span."""

import statistics


def read(run):
    try:
        from musicgan_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    marks = [(t0, t1) for name, t0, t1 in run.spans if name == "port_bench.train_step"]
    recorded = spans()
    steps = {s.index for s in recorded if s.name == "mg.train.iteration" and s.parent is None
             and any(a <= s.t0_ns * 1e-9 and s.t1_ns * 1e-9 <= b for a, b in marks)}
    ms = dict.fromkeys(steps, 0.0)
    for s in recorded:
        if s.name in ("mg.train.critic_adam", "mg.train.gen_adam") and s.parent in ms:
            ms[s.parent] += (s.t1_ns - s.t0_ns) * 1e-6
    return statistics.median(ms.values()) if ms else None
