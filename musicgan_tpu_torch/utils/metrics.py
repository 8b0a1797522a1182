"""Host-side metric sink: sliding-window console stats + CSV log, with
optional TensorBoard / MLflow sinks.

Counterpart of ``musicgan_tpu/utils/metrics.py``.  Replaces the
reference's MLflow + tqdm observability (reference
``train.py:118-127,224-244``) with a dependency-free writer.  Device
metrics stay device scalars in the train loop; they are only read back on
the logging cadence, so the loop never blocks on a device sync per step
(the reference syncs ~6 scalars every iteration, ``train.py:180-186``).

The optional sinks close the reference's queryable-store feature
(reference ``train.py:24-30,238-244``) without changing the sync
discipline: they receive the SAME cadence-batched rows as the CSV (lead
process only — the train loop only constructs a MetricLogger there).
TensorBoard uses torch's bundled ``SummaryWriter``; each sink is imported
only when asked for and fails with an error naming the missing package.
"""

from __future__ import annotations

import collections
import csv
import os
import time
from typing import Mapping

__all__ = ["MetricLogger"]


_DEFAULT_FIELDS = (
    "disc_loss", "grad_pen", "e_tp", "e_tn", "gen_loss", "e_gen", "alpha",
)


class MetricLogger:
    def __init__(
        self, output_dir: str, window: int = 20,
        fields: tuple = _DEFAULT_FIELDS,
        tb_dir: str | None = None,
        mlflow_uri: str | None = None,
        run_name: str | None = None,
        params: Mapping | None = None,
    ):
        self.fields = fields
        os.makedirs(output_dir, exist_ok=True)
        self.csv_path = os.path.join(output_dir, "metrics.csv")
        self.window = window
        self._windows: dict[str, collections.deque] = {}
        self._csv_file = None
        self._csv_writer = None
        self._t0 = time.perf_counter()

        self._tb = None
        if tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                # torch ships the writer but it needs the separate
                # `tensorboard` package at import time; surface that as
                # actionably as the mlflow branch below does.
                raise ImportError(
                    "--tb-dir requires the 'tensorboard' package (torch's "
                    "SummaryWriter imports it); install tensorboard or "
                    "drop --tb-dir for the CSV/console logger"
                ) from e

            self._tb = SummaryWriter(tb_dir)
        self._mlflow = None
        if mlflow_uri:
            try:
                import mlflow
            except ImportError as e:
                raise ImportError(
                    "--mlflow-uri requires the 'mlflow' package, which is "
                    "not installed; use --tb-dir for the bundled "
                    "TensorBoard sink instead"
                ) from e
            mlflow.set_tracking_uri(mlflow_uri)
            # reference parity: experiment 'music_gan', run per train
            # invocation (reference train.py:24-30)
            mlflow.set_experiment("music_gan")
            mlflow.start_run(run_name=run_name)
            if params:
                mlflow.log_params(dict(params))
            self._mlflow = mlflow

    def push(self, metrics: Mapping[str, float]) -> None:
        """Accumulate one step's (host) metric values into the windows."""
        for k, v in metrics.items():
            self._windows.setdefault(
                k, collections.deque(maxlen=self.window)
            ).append(float(v))

    def window_means(self) -> dict[str, float]:
        return {
            k: sum(w) / len(w) for k, w in self._windows.items() if w
        }

    def log_row(self, step: int, stage: int, extra: Mapping[str, float] | None = None):
        row = {
            "step": step,
            "stage": stage,
            "wall_s": round(time.perf_counter() - self._t0, 3),
            **{k: round(v, 6) for k, v in self.window_means().items()},
            **({k: round(float(v), 6) for k, v in (extra or {}).items()}),
        }
        if self._csv_writer is None:
            # Fixed column set: a critic-only first row must not freeze the
            # header without the generator columns.
            names = ["step", "stage", "wall_s"] + [
                k for k in self.fields if k not in ("step", "stage", "wall_s")
            ] + [k for k in row if k not in ("step", "stage", "wall_s")
                 and k not in self.fields]
            self._csv_file = open(self.csv_path, "a", newline="")
            self._csv_writer = csv.DictWriter(
                self._csv_file, fieldnames=names, extrasaction="ignore"
            )
            if self._csv_file.tell() == 0:
                self._csv_writer.writeheader()
        self._csv_writer.writerow(row)
        self._csv_file.flush()
        if self._tb is not None:
            for k, v in row.items():
                if k not in ("step", "stage", "wall_s"):
                    self._tb.add_scalar(f"train/{k}", v, step)
            self._tb.add_scalar("train/stage", stage, step)
        if self._mlflow is not None:
            self._mlflow.log_metrics(
                {k: v for k, v in row.items() if k != "step"}, step=step
            )
        return row

    def close(self):
        if self._csv_file:
            self._csv_file.close()
        if self._tb is not None:
            self._tb.close()
        if self._mlflow is not None:
            self._mlflow.end_run()
