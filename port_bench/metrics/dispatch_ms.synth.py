"""dispatch_ms.synth: the host's time to issue one ``synthesize_fn`` call
(the benchmark's span around the call, which returns once the call's work
is queued), the median over the window's calls, in ms."""

import statistics


def read(run):
    spans = [t1 - t0 for name, t0, t1 in run.spans if name == "port_bench.synthesize_fn"]
    return statistics.median(spans) * 1e3 if spans else None
