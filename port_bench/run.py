"""Run one cell of the port's benchmark once.

    python3 -m port_bench --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  Set-up (build, load, the autotune, warm-up,
the cell's first steps) runs from the seed; then the window measures for
``--seconds``; then, with the program's state freed, the plain reference
judges what the window produced.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, also printed as the last lines of standard
error.

The run exits non-zero and prints no result without enough CUDA devices,
and if ``jax``, ``jaxlib``, ``flax`` or ``musicgan_tpu`` is in
``sys.modules`` once the window has closed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from . import spec

__all__ = ["Run", "main", "run_cell", "verdict", "forbidden_modules"]

FORBIDDEN = ("jax", "jaxlib", "flax", "musicgan_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``'s start,
    in clock ticks since boot, against ``CLOCK_BOOTTIME``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def prepare_environment(root: Path) -> None:
    """Every cache of the program at a fixed path inside the checkout: the
    autotune table, and the compile caches a library could use.  The
    kernels build into the package's own ``_build/`` (the program's
    default), so the variables that would move them are removed."""
    cache = Path(root) / ".port_bench_cache"
    os.environ["MUSICGAN_AUTOTUNE_DIR"] = str(cache / "autotune")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ.pop("MUSICGAN_COMPILE_CACHE", None)
    os.environ.pop("MUSICGAN_NO_COMPILE_CACHE", None)


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the run must not hold,
    compared whole (``musicgan_tpu_torch`` is not ``musicgan_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def verdict(checks: dict) -> bool:
    """``correct``: some number was compared, and each is within its limit."""
    return bool(checks) and all(v <= lim for v, lim in checks.values())


def card_reading() -> str:
    """``nvidia-smi``'s SM clock, power draw, power limit and temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"


@dataclasses.dataclass
class Run:
    """What a driver reads and fills.  The driver sets ``end_to_end``
    (metric name -> value), ``attempted``, ``failed``, ``checks`` (name ->
    ``(value, limit)``) and ``facts`` (what the per-layer readers read:
    counts and work of the window); ``trace`` is the reduced trace of a
    ``--trace 1`` run."""

    cell: spec.Cell
    seed: int
    seconds: float
    traced: bool
    device: object
    end_to_end: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checks: dict = dataclasses.field(default_factory=dict)
    facts: dict = dataclasses.field(default_factory=dict)
    trace: object = None
    spans: list = dataclasses.field(default_factory=list)

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def root(self) -> Path:
        return self.cell.root

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span around a call into the program: kept with its
        perf_counter times, and in the trace while one is recorded."""
        import torch

        with torch.profiler.record_function(name) if self.traced else contextlib.nullcontext():
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.spans.append((name, t0, time.perf_counter()))

    @contextlib.contextmanager
    def measure(self, trace: bool = True):
        """The measured window, which a driver wraps around its loop.  In a
        traced run (and with ``trace``) the profiler records it, and its
        ends (``time.time_ns()``, the profiler's time base) bound the
        reduced trace."""
        import torch

        from . import trace as tracing

        on = self.traced and trace and self.device.type == "cuda"
        with tracing.profiled(on, self.traffic.get("trace_host_ops", True)) as holder:
            with torch.profiler.record_function(tracing.WINDOW_SPAN):
                t0 = time.time_ns()
                try:
                    yield
                finally:
                    t1 = time.time_ns()
        if holder.events is not None:
            self.trace = tracing.reduce_events(holder.events, (t0, t1))

    def log(self, msg: str) -> None:
        print(f"[port_bench] {msg}", flush=True)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device) -> tuple[dict, Run]:
    """Set-up, window, check and per-layer readings of one run; returns
    the result object (not yet printed) and the run record."""
    import torch

    driver = spec.load_driver(cell.traffic["driver"])
    run = Run(cell, seed, seconds, traced, device)
    state = driver.setup(run)
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age_s()
    before = card_reading() if cuda else "cpu"
    driver.window(run, state)
    after = card_reading() if cuda else "cpu"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run.log(f"card before the window: {before}")
    run.log(f"card after the window: {after}")
    run.log(f"attempted {run.attempted}, failed {run.failed}; " + ", ".join(
        f"{k} {v}" for k, v in run.facts.items() if isinstance(v, (int, float, str))))
    found = forbidden_modules()
    if found:
        raise SystemExit(f"port_bench: the process holds {', '.join(found)} after the window")
    driver.check(run, state)
    del state
    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = spec.load_metric(m["name"], cell.root).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        run.end_to_end["setup_s"] = setup_s
        metrics = {m["name"]: {"value": run.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in run.end_to_end}
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    result = {
        "correct": verdict(run.checks),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": dev,
    }
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        ops = sorted(run.trace.seconds_by_name().items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(run.trace.idle_gaps().items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return result, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    prepare_environment(root)
    cell = spec.load_cell(args.workload, root)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
