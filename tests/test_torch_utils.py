"""The port's metric logger and stall watchdog against the JAX package's:
the same rows in the same columns, the same retryable-failure markers, and
the detector's own contract (fires once the beats stop, never when disabled)."""

import csv
import importlib.util
import io
import threading
import time

import pytest
import torch

from musicgan_tpu.utils import metrics as jax_metrics
from musicgan_tpu.utils import watchdog as jax_watchdog
from musicgan_tpu_torch.utils import metrics, watchdog


def _drive(logger_cls, out):
    log = logger_cls(str(out), window=2)
    log.push({"disc_loss": 1.0, "grad_pen": 4.0, "e_tp": 0.5, "e_tn": 0.25})  # a critic-only first row
    log.log_row(0, 0, extra={"alpha": 1.0})
    log.push({"disc_loss": 3.0, "grad_pen": 2.0, "e_tp": 0.5, "e_tn": 0.25, "gen_loss": -1.0, "e_gen": 1.0})
    log.log_row(5, 1, extra={"alpha": 1 / 3})
    log.push({"disc_loss": 5.0, "grad_pen": 0.0, "e_tp": 0.5, "e_tn": 0.25})
    row = log.log_row(10, 1, extra={"alpha": 0.75})
    log.close()
    with open(log.csv_path) as f:
        return row, list(csv.DictReader(f))


def test_metric_logger_writes_the_jax_loggers_rows(tmp_path):
    row_t, rows_t = _drive(metrics.MetricLogger, tmp_path / "t")
    row_j, rows_j = _drive(jax_metrics.MetricLogger, tmp_path / "j")
    assert list(rows_t[0]) == list(rows_j[0]) == [
        "step", "stage", "wall_s", "disc_loss", "grad_pen", "e_tp", "e_tn", "gen_loss", "e_gen", "alpha"]
    drop = lambda r: {k: v for k, v in r.items() if k != "wall_s"}  # noqa: E731
    assert [drop(r) for r in rows_t] == [drop(r) for r in rows_j]
    assert drop(row_t) == drop(row_j)
    assert rows_t[0]["gen_loss"] == "" and rows_t[2]["disc_loss"] == "4.0"  # the window holds two values
    assert rows_t[1]["alpha"] == "0.333333"


def test_metric_logger_appends_across_a_resume(tmp_path):
    _drive(metrics.MetricLogger, tmp_path)
    _, rows = _drive(metrics.MetricLogger, tmp_path)
    assert [r["step"] for r in rows] == ["0", "5", "10"] * 2  # one header, six rows


@pytest.mark.parametrize("kwarg,package", [("mlflow_uri", "mlflow"), ("tb_dir", "tensorboard")])
def test_optional_sinks_fail_clearly_without_their_package(tmp_path, kwarg, package):
    if importlib.util.find_spec(package) is not None:
        pytest.skip(f"{package} is installed")
    with pytest.raises(ImportError, match=package):
        metrics.MetricLogger(str(tmp_path), **{kwarg: str(tmp_path / "sink")})


def test_watchdog_fires_once_the_beats_stop():
    fired, stream = [], io.StringIO()
    wd = watchdog.StallWatchdog(0.2, poll_s=0.02, _exit=fired.append, _stream=stream)
    try:
        time.sleep(0.4)
        assert fired == []  # disarmed until the first beat
        wd.beat()
        for _ in range(5):
            time.sleep(0.05)
            wd.beat()
        assert fired == []
        wd.disarm()
        time.sleep(0.4)
        assert fired == []
        wd.beat()
        deadline = time.time() + 5
        while not fired and time.time() < deadline:
            time.sleep(0.02)
    finally:
        wd.close()
    assert fired == [watchdog.EXIT_STALLED] and watchdog.EXIT_STALLED == jax_watchdog.EXIT_STALLED == 75
    assert "no device progress" in stream.getvalue() and "Thread" in stream.getvalue()


def test_watchdog_disabled_starts_no_thread():
    before = threading.active_count()
    with watchdog.StallWatchdog(0.0) as wd:
        wd.beat()
        assert threading.active_count() == before and wd._thread is None


def test_failure_markers_are_the_jax_packages():
    """The JAX package's markers, whole and first; then torch.distributed's
    own (tests/test_torch_parallel.py holds each)."""
    n = len(jax_watchdog._DIST_FAILURE_MARKERS)
    assert watchdog._DIST_FAILURE_MARKERS[:n] == jax_watchdog._DIST_FAILURE_MARKERS
    assert watchdog._DIST_FAILURE_MARKERS[n:] == (
        "distbackenderror", "distnetworkerror", "diststoreerror", "connection closed by peer",
        "collective operation timeout", "waiting for clients",
    )
    for msg in ("UNAVAILABLE: device lost", "Connection reset by peer", "all good"):
        e = RuntimeError(msg)
        assert watchdog.is_distributed_failure(e) == jax_watchdog.is_distributed_failure(e)


@pytest.mark.parametrize("exc,want", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (RuntimeError("cuDNN error: CUDNN_STATUS_EXECUTION_FAILED"), True),
    (RuntimeError("mg_conv3x3: CUDA error 700 at launch: unavailable"), True),
    (RuntimeError("shape mismatch"), False),
    (BrokenPipeError("CUDA error"), False),
    (ValueError("unavailable"), False),
])
def test_is_runtime_error_names_cudas_errors(exc, want):
    assert watchdog.is_runtime_error(exc) is want


def test_is_runtime_error_knows_torchs_accelerator_error():
    accel = getattr(torch, "AcceleratorError", None)
    if accel is None:
        pytest.skip("this torch has no AcceleratorError")
    assert issubclass(accel, RuntimeError)
    fake = type("AcceleratorError", (Exception,), {})("device-side assert")
    assert watchdog.is_runtime_error(fake)
