"""The writer half of dataset ingest: packed spectrogram shards
(counterpart of ``ShardWriter`` and ``INDEX_NAME`` in
``musicgan_tpu/audio/ingest.py``; the files and ``index.json`` it writes are
byte-identical to that writer's, and ``audio/dataset.py`` reads either).
WAV -> spectrogram ingest (``create_dataset``) is not ported yet
(ROADMAP.md section A item 13).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..config import AudioConfig

_CFG = AudioConfig()

__all__ = ["ShardWriter", "INDEX_NAME"]

INDEX_NAME = "index.json"


class ShardWriter:
    """Accumulates ``(2, H, W)`` samples and writes packed ``.npy`` shards.

    The index is (re)written ATOMICALLY after every shard flush with
    ``"complete": false``, so a concurrently-running trainer can pick up
    new shards mid-ingest (``SpectrogramDataset.refresh``): streaming
    ingest overlaps dataset building with training.  ``close()`` marks the
    index complete.
    """

    def __init__(self, out_dir: str, samples_per_shard: int = 128):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.samples_per_shard = samples_per_shard
        self._buf: list[np.ndarray] = []
        self._shards: list[dict] = []
        self._total = 0

    def add(self, chunks: np.ndarray) -> None:
        for c in chunks:
            self._buf.append(c)
            self._total += 1
            if len(self._buf) >= self.samples_per_shard:
                self._flush()

    def _index_dict(self, complete: bool) -> dict:
        flushed = sum(s["num_samples"] for s in self._shards)
        return {
            # the format's name is the JAX package's: one format, two writers
            "format": "musicgan_tpu.shards.v1",
            "dtype": "float32",
            "sample_shape": [2, _CFG.n_bins, _CFG.n_vec],
            "total_samples": flushed,
            "shards": list(self._shards),
            "complete": complete,
        }

    def _write_index(self, index: dict) -> None:
        # atomic: a concurrent reader sees either the old or the new index,
        # never a torn file
        path = os.path.join(self.out_dir, INDEX_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(index, f, indent=1)
        os.replace(tmp, path)

    def _flush(self) -> None:
        if not self._buf:
            return
        k = len(self._shards)
        name = f"shard_{k:05d}.npy"
        arr = np.stack(self._buf, axis=0)
        np.save(os.path.join(self.out_dir, name), arr)
        self._shards.append({"file": name, "num_samples": int(arr.shape[0])})
        self._buf = []
        self._write_index(self._index_dict(complete=False))

    def close(self) -> dict:
        self._flush()
        index = self._index_dict(complete=True)
        assert index["total_samples"] == self._total
        self._write_index(index)
        return index
