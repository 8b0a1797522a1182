"""mel_host_ms.gansynth: the host's time in the two mel-to-linear products
of a GANSynth synthesis call, the program's
``mg.synth.mel`` span (inside ``mg.synth.spectrum``,
``musicgan_tpu_torch/utils/profiling.py``), the median over the window's
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
    inside = {s.index for s in recorded if s.name == "mg.synth.call" and s.parent is None
              and any(a <= s.t0_ns * 1e-9 and s.t1_ns * 1e-9 <= b for a, b in marks)}
    by_index = {s.index: s for s in recorded}

    def in_call(s):  # an ancestor of s is one of the window's calls
        while s is not None and s.parent is not None:
            if s.parent in inside:
                return True
            s = by_index.get(s.parent)
        return False

    ms = [(s.t1_ns - s.t0_ns) * 1e-6 for s in recorded if s.name == "mg.synth.mel" and in_call(s)]
    return statistics.median(ms) if ms else None
