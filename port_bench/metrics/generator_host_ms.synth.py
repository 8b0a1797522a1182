"""generator_host_ms.synth: the host's time in the generator of a synthesis
call, the program's ``mg.synth.generator`` span
(``musicgan_tpu_torch/utils/profiling.py``), the median over the window's
calls, in ms.  A call is the window's where its ``mg.synth.call`` lies
inside one of the benchmark's ``port_bench.synthesize_fn`` spans; None
where the program keeps no such span."""

import statistics


def read(run):
    try:
        from musicgan_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    marks = [(t0, t1) for name, t0, t1 in run.spans if name == "port_bench.synthesize_fn"]
    recorded = spans()
    calls = {s.index for s in recorded if s.name == "mg.synth.call" and s.parent is None
             and any(a <= s.t0_ns * 1e-9 and s.t1_ns * 1e-9 <= b for a, b in marks)}
    ms = [(s.t1_ns - s.t0_ns) * 1e-6 for s in recorded if s.name == "mg.synth.generator" and s.parent in calls]
    return statistics.median(ms) if ms else None
