"""critic_host_ms.train: the host's time in the critic's phase of a train
iteration (noise, both critic forwards, the penalty, the gradients), the
program's ``mg.train.critic`` span
(``musicgan_tpu_torch/utils/profiling.py``), the median over the window's
iterations, in ms.  An iteration is the window's where its
``mg.train.iteration`` lies inside one of the benchmark's
``port_bench.train_step`` spans; None where the program keeps no such span."""

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
    ms = [(s.t1_ns - s.t0_ns) * 1e-6 for s in recorded if s.name == "mg.train.critic" and s.parent in steps]
    return statistics.median(ms) if ms else None
