"""Training dataset: memmapped packed shards with a sharded, prefetching
batch iterator (counterpart of ``musicgan_tpu/audio/dataset.py``; it reads
the same files, and the same seed gives the same batches: the permutation
is numpy's ``default_rng``).

The replacement for the reference's ``AudioDataset`` +
``DataLoader(num_workers=6)`` (reference ``audio/dataset.py:14-44``,
``train.py:77-84``):

* packed ``.npy`` shards are memory-mapped, so random access costs one page
  fault instead of one ``torch.load`` of a small file;
* per-host index sharding (``host_id::num_hosts``) gives multi-host data
  parallelism without coordination;
* a background thread keeps one batch ahead so host gather overlaps device
  compute.

Also reads a directory of reference-format ``magn_phase_{i}.pt`` files (via
torch, CPU) for drop-in compatibility with datasets built by the reference.
"""

from __future__ import annotations

import json
import os
import queue
import re
import threading
from typing import Iterator

import numpy as np

from .ingest import INDEX_NAME

__all__ = ["SpectrogramDataset", "batch_indices", "batch_iterator"]


class SpectrogramDataset:
    """Random-access view over a packed-shard dir or a reference ``.pt`` dir."""

    def __init__(self, dataset_path: str):
        assert os.path.isdir(dataset_path), dataset_path
        self.path = dataset_path
        index_path = os.path.join(dataset_path, INDEX_NAME)
        if os.path.isfile(index_path):
            with open(index_path) as f:
                self.index = json.load(f)
            self._shards = [
                np.load(os.path.join(dataset_path, s["file"]), mmap_mode="r")
                for s in self.index["shards"]
            ]
            counts = [s["num_samples"] for s in self.index["shards"]]
            self._offsets = np.concatenate([[0], np.cumsum(counts)])
            self._pt_files = None
        else:
            # Reference-format directory of per-sample .pt tensors
            # (reference audio/dataset.py:22-31).
            pat = re.compile(r"^magn_phase_\d+\.pt$")
            files = sorted(
                f for f in os.listdir(dataset_path) if pat.match(f)
            )
            if not files:
                raise FileNotFoundError(
                    f"no {INDEX_NAME} and no magn_phase_*.pt in {dataset_path}"
                )
            self._pt_files = np.array(files)
            self._shards = None
            self.index = {"total_samples": len(files)}

    def __len__(self) -> int:
        return int(self.index["total_samples"])

    @property
    def complete(self) -> bool:
        """False while a streaming ingest is still appending shards."""
        return bool(self.index.get("complete", True))

    def peek_total(self) -> int:
        """Total samples the on-disk index offers right now, WITHOUT
        mutating the open view.  A multi-host run would gather this so
        that every host refreshes to the same agreed snapshot."""
        if self._shards is None or self.complete:
            return len(self)
        try:
            with open(os.path.join(self.path, INDEX_NAME)) as f:
                new_index = json.load(f)
        except (OSError, ValueError):  # mid-replace race or gone
            return len(self)
        return max(len(self), int(new_index["total_samples"]))

    def refresh(self, limit: int | None = None) -> bool:
        """Pick up shards appended since the dataset was opened (streaming
        ingest: ``ShardWriter`` rewrites the index atomically per flush).
        Returns True if the dataset grew.  No-op for reference ``.pt`` dirs
        and for already-complete shard sets.

        ``limit`` caps the visible sample count: on multi-host runs every
        process passes the allgathered min of ``peek_total()`` so batch
        composition (which derives from ``len(dataset)``) stays identical
        across hosts even when their index files grow at different rates.
        Rows past the cap become visible on a later refresh.

        A view larger than ``limit`` SHRINKS to it (in-memory, never
        fails): hosts that opened their dataset mid-ingest at different
        snapshot sizes must still converge on the agreed count, else
        they would dispatch different numbers of per-step collectives
        and deadlock the pod.  The hidden rows (and the on-disk
        ``complete`` flip) come back through a later, larger agreement."""
        if limit is not None and int(limit) < len(self):
            # Shrink before anything that can early-return or fail —
            # this must hold even for complete/pt-dir views and when the
            # on-disk index is transiently unreadable.
            self.index["total_samples"] = int(limit)
            self.index["complete"] = False
            return False
        if self._shards is None or self.complete:
            return False
        index_path = os.path.join(self.path, INDEX_NAME)
        try:
            with open(index_path) as f:
                new_index = json.load(f)
        except (OSError, ValueError):  # mid-replace race or gone: keep old
            return False
        new_total = int(new_index["total_samples"])
        if limit is not None:
            new_total = min(new_total, int(limit))
        if new_total <= len(self):
            # Only adopt the on-disk completeness when nothing is held
            # back: a capped view may still have rows (and the final
            # "complete" flip) to pick up on a later refresh.
            if limit is None or new_index["total_samples"] <= new_total:
                self.index["complete"] = new_index.get("complete", True)
            return False
        for s in new_index["shards"][len(self._shards):]:
            self._shards.append(
                np.load(os.path.join(self.path, s["file"]), mmap_mode="r")
            )
        counts = [s["num_samples"] for s in new_index["shards"]]
        self._offsets = np.concatenate([[0], np.cumsum(counts)])
        capped = new_total < int(new_index["total_samples"])
        self.index = new_index
        self.index["total_samples"] = new_total
        if capped:
            # Withheld rows (and possibly the final flip to complete) must
            # stay reachable through future refreshes.
            self.index["complete"] = False
        return True

    def __getitem__(self, i: int) -> np.ndarray:
        """-> float32 ``(2, 512, 512)``."""
        if self._shards is not None:
            k = int(np.searchsorted(self._offsets, i, side="right") - 1)
            return np.asarray(self._shards[k][i - self._offsets[k]])
        import torch  # lazy: only needed for reference-format datasets

        t = torch.load(
            os.path.join(self.path, self._pt_files[i]), weights_only=True
        )
        return t.numpy().astype(np.float32)

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """-> float32 ``(B, 2, 512, 512)`` batch."""
        return np.stack([self[int(i)] for i in indices], axis=0)

    def nbytes(self) -> int:
        s = self.index.get("sample_shape", [2, 512, 512])
        return len(self) * int(np.prod(s)) * 4

    def as_array(self, dtype=np.float32, pad_rows: int = 0) -> np.ndarray:
        """Materialize the whole corpus as one array of ``dtype`` (the
        device-resident dataset mode ships this to device memory once).
        ``dtype`` is a numpy dtype, or ``"bfloat16"``, which numpy lacks:
        the result then holds the bfloat16 bit patterns as ``uint16``
        (round to nearest even, as a cast does), for
        ``torch.from_numpy(a).view(torch.bfloat16)``.

        The cast happens here, shard by shard, so a bfloat16-resident
        corpus never materializes a full float32 copy: host peak is the
        target buffer plus one shard, and the caller can copy exactly the
        resident bytes to the device.

        ``pad_rows`` appends that many extra rows (copies of row 0, so
        they are always finite data) — the mesh-sharded resident corpus
        must be divisible by the device count, and padding HERE avoids a
        corpus-sized ``np.concatenate`` copy on the host.  Padded rows are
        never sampled: the epoch index stream draws from the LOGICAL
        length only (train/loop.py tracks it separately)."""
        bf16 = str(dtype) in ("bfloat16", "torch.bfloat16")
        dtype = np.dtype(np.uint16 if bf16 else dtype)
        cast = _bfloat16_bits if bf16 else np.asarray
        n_total = len(self) + pad_rows
        if self._shards is not None:
            shape = tuple(self._shards[0].shape[1:])
            out = np.empty((n_total, *shape), dtype)
            ofs = 0
            for s in self._shards:
                k = min(s.shape[0], len(self) - ofs)  # a capped view ends inside a shard
                if k <= 0:
                    break
                out[ofs:ofs + k] = cast(s[:k])  # casts if dtype differs
                ofs += k
        else:
            out = np.empty((n_total, *self[0].shape), dtype)
            out[: len(self)] = cast(self.gather(np.arange(len(self))))
        if pad_rows:
            out[len(self):] = out[0]
        return out


def _bfloat16_bits(a) -> np.ndarray:
    """float32 -> the bit patterns of its bfloat16 roundings (to nearest
    even; NaN stays NaN), as ``uint16``."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    rounded = (bits + (0x7FFF + ((bits >> 16) & 1))) >> 16
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    return np.where(nan, (bits >> 16) | 0x40, rounded).astype(np.uint16)


def batch_indices(
    dataset_len: int,
    batch_size: int,
    seed: int,
    drop_last: bool = True,
    skip: int = 0,
) -> Iterator[np.ndarray]:
    """One epoch of shuffled index batches (the device-resident dataset
    mode ships these instead of sample data; single-host).

    ``skip`` drops the first N batches of the epoch's deterministic order
    without yielding them (bit-exact resume fast-forward)."""
    perm = np.random.default_rng(seed).permutation(dataset_len)
    n = (
        len(perm) // batch_size
        if drop_last
        else -(-len(perm) // batch_size)
    )
    for b in range(skip, n):
        yield perm[b * batch_size : (b + 1) * batch_size].astype(np.int32)


def batch_iterator(
    dataset: SpectrogramDataset,
    batch_size: int,
    seed: int,
    host_id: int = 0,
    num_hosts: int = 1,
    drop_last: bool = True,
    prefetch: int = 2,
    skip: int = 0,
) -> Iterator[np.ndarray]:
    """One epoch of shuffled, host-sharded, prefetched batches.

    ``skip`` drops the first N batches at the *index* level — the skipped
    batches' sample data is never read from disk (a resume fast-forward
    deep into a long epoch costs no IO).

    The global permutation is seeded identically on every host.  Each host
    takes a contiguous ``batch_size`` block of every global batch, so the
    global batch assembled in process order carries rows
    ``perm[b*G:(b+1)*G]`` in order: bit-identical batch composition to a
    single-process run of global batch ``G = batch_size * num_hosts``.
    """
    perm = np.random.default_rng(seed).permutation(len(dataset))
    if num_hosts > 1:
        g = batch_size * num_hosts
        n_full = len(perm) // g
        local = (
            perm[: n_full * g]
            .reshape(n_full, num_hosts, batch_size)[:, host_id, :]
            .reshape(-1)
        )
    else:
        local = perm
    n_batches = len(local) // batch_size if drop_last else -(-len(local) // batch_size)

    stop = threading.Event()

    def put(q: queue.Queue, item) -> bool:
        # Bounded put so the producer notices an abandoned consumer (e.g. a
        # mid-epoch ``max_iters`` break) instead of blocking on a full queue
        # forever and leaking one thread per epoch.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def produce(q: queue.Queue):
        try:
            for b in range(skip, n_batches):
                idx = local[b * batch_size : (b + 1) * batch_size]
                if not put(q, dataset.gather(idx)):
                    return
            put(q, None)
        except BaseException as e:  # surface IO errors in the consumer
            put(q, e)

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    t = threading.Thread(target=produce, args=(q,), daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
