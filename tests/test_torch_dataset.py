"""The port's dataset, shard writer and host input pipeline against the JAX
package's, on files and seeds shared between the two."""

import filecmp
import os

import numpy as np
import pytest
import torch

from musicgan_tpu.audio import dataset as jax_ds
from musicgan_tpu.audio import host_pipeline as jax_hp
from musicgan_tpu.audio import ingest as jax_ingest
from musicgan_tpu_torch.audio import dataset as ds
from musicgan_tpu_torch.audio import host_pipeline as hp
from musicgan_tpu_torch.audio import ingest


def _samples(n, seed=0, size=16):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 2, size, size)).astype(np.float32)


def _write(writer_cls, path, samples, per_shard=3, close=True):
    w = writer_cls(str(path), samples_per_shard=per_shard)
    w.add(samples)
    if close:
        w.close()
    return w


def test_shard_writer_is_byte_identical_to_jax(tmp_path):
    x = _samples(8)
    _write(ingest.ShardWriter, tmp_path / "a", x)
    _write(jax_ingest.ShardWriter, tmp_path / "b", x)
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == sorted(os.listdir(tmp_path / "b"))
    assert names == ["index.json", "shard_00000.npy", "shard_00001.npy", "shard_00002.npy"]
    assert ingest.INDEX_NAME == jax_ingest.INDEX_NAME
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "a", tmp_path / "b", names, shallow=False)
    assert (sorted(match), mismatch, errors) == (names, [], [])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dataset_reads_either_writers_shards(tmp_path, writer):
    x = _samples(7, seed=1)
    _write(jax_ingest.ShardWriter if writer == "jax" else ingest.ShardWriter, tmp_path / "d", x)
    a, b = ds.SpectrogramDataset(str(tmp_path / "d")), jax_ds.SpectrogramDataset(str(tmp_path / "d"))
    assert len(a) == len(b) == 7 and a.complete and a.nbytes() == b.nbytes()
    for i in range(7):
        assert np.array_equal(a[i], x[i]) and np.array_equal(b[i], x[i])
    idx = np.array([6, 0, 3])
    assert np.array_equal(a.gather(idx), b.gather(idx))
    assert np.array_equal(a.as_array(), b.as_array())
    assert np.array_equal(a.as_array(np.float16, pad_rows=2), b.as_array(np.float16, pad_rows=2))


def test_as_array_bfloat16_is_torchs_cast(tmp_path):
    x = _samples(5, seed=2)
    x[0, 0, 0, :4] = [np.inf, -np.inf, np.nan, 0.0]
    x[1, 0, 0, :3] = [1.00390625, 1.01171875, 3.3895e38]  # two ties (down, up), and a round up to inf
    _write(ingest.ShardWriter, tmp_path / "d", x, per_shard=2)
    bits = ds.SpectrogramDataset(str(tmp_path / "d")).as_array("bfloat16")
    assert bits.dtype == np.uint16 and bits.shape == x.shape
    got = torch.from_numpy(bits).view(torch.bfloat16)
    ref = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16)) or (
        torch.equal(torch.isnan(got), torch.isnan(ref))
        and torch.equal(torch.nan_to_num(got.float()), torch.nan_to_num(ref.float()))
    )


def test_dataset_reads_a_reference_pt_directory(tmp_path):
    x = _samples(3, seed=3)
    for i, s in enumerate(x):
        torch.save(torch.from_numpy(s).double(), tmp_path / f"magn_phase_{i}.pt")
    a, b = ds.SpectrogramDataset(str(tmp_path)), jax_ds.SpectrogramDataset(str(tmp_path))
    assert len(a) == len(b) == 3 and a.refresh() is False
    assert np.array_equal(a.gather(np.arange(3)), b.gather(np.arange(3)))
    assert a[1].dtype == np.float32 and np.array_equal(a.as_array(), x)
    with pytest.raises(FileNotFoundError):
        ds.SpectrogramDataset(str(tmp_path / ".."))  # neither an index nor .pt samples


@pytest.mark.parametrize("n,batch,seed,skip,drop_last", [
    (16, 4, 0, 0, True), (17, 4, 3, 2, True), (10, 3, 7, 1, False), (8, 8, 1, 0, True), (9, 2, 5, 3, True),
])
def test_batch_indices_and_iterator_match_jax(tmp_path, n, batch, seed, skip, drop_last):
    got = list(ds.batch_indices(n, batch, seed, drop_last=drop_last, skip=skip))
    ref = list(jax_ds.batch_indices(n, batch, seed, drop_last=drop_last, skip=skip))
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)

    x = _samples(n, seed=seed, size=4)
    _write(ingest.ShardWriter, tmp_path / "d", x, per_shard=5)
    a, b = ds.SpectrogramDataset(str(tmp_path / "d")), jax_ds.SpectrogramDataset(str(tmp_path / "d"))
    it_a = list(ds.batch_iterator(a, batch, seed, drop_last=drop_last, skip=skip))
    it_b = list(jax_ds.batch_iterator(b, batch, seed, drop_last=drop_last, skip=skip))
    assert len(it_a) == len(it_b) == len(got)
    for u, v, idx in zip(it_a, it_b, got):
        assert np.array_equal(u, v) and np.array_equal(u, x[idx])
    # Two hosts: each takes its block of every global batch.
    if n >= 2 * batch:
        for host in (0, 1):
            u = list(ds.batch_iterator(a, batch, seed, host_id=host, num_hosts=2))
            v = list(jax_ds.batch_iterator(b, batch, seed, host_id=host, num_hosts=2))
            assert len(u) == len(v) and all(np.array_equal(p, q) for p, q in zip(u, v))


def test_batch_iterator_surfaces_read_errors_and_stops_its_thread():
    class Broken:
        def __len__(self):
            return 8

        def gather(self, idx):
            raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(ds.batch_iterator(Broken(), 2, 0))


@pytest.mark.parametrize("size", [4, 32, 16])
def test_prepare_batch_equals_jax_exactly(size):
    x = _samples(3, seed=size, size=16) * 5 + 2
    got, ref = hp.prepare_batch(x, size), jax_hp.prepare_batch(x, size)
    assert got.dtype == ref.dtype == np.float32 and got.shape == (3, 2, size, size)
    assert np.array_equal(got, ref)
    assert np.array_equal(hp.resize_operator(16, size), jax_hp.resize_operator(16, size))


def test_prepare_batch_matches_the_device_pipeline():
    """Host pipeline (numpy) against the train step's on-device one
    (``grower_transform``): the same function, float32 sums in another order."""
    from musicgan_tpu_torch.audio.transforms import grower_transform

    x = _samples(2, seed=9, size=64)
    dev = grower_transform(torch.from_numpy(x), 8).numpy()
    np.testing.assert_allclose(hp.prepare_batch(x, 8), dev, atol=2e-6)


def test_refresh_grows_and_shrinks_as_jax(tmp_path):
    x = _samples(9, seed=4, size=4)
    w = ingest.ShardWriter(str(tmp_path / "d"), samples_per_shard=2)
    w.add(x[:4])  # two shards flushed, the index still open
    a, b = ds.SpectrogramDataset(str(tmp_path / "d")), jax_ds.SpectrogramDataset(str(tmp_path / "d"))

    def same(ra, rb):
        assert ra == rb
        assert (len(a), a.complete, a.peek_total()) == (len(b), b.complete, b.peek_total())

    same(a.refresh(), b.refresh())
    assert len(a) == 4 and not a.complete
    w.add(x[4:8])
    assert a.peek_total() == 8 and len(a) == 4
    same(a.refresh(limit=6), b.refresh(limit=6))  # grows, capped
    assert len(a) == 6 and not a.complete and np.array_equal(a[5], x[5])
    same(a.refresh(limit=3), b.refresh(limit=3))  # shrinks in memory
    assert len(a) == 3
    assert np.array_equal(a.as_array(), x[:3])    # a capped view ends inside a shard
    same(a.refresh(), b.refresh())                # the hidden rows come back
    assert len(a) == 8
    w.add(x[8:])
    w.close()
    same(a.refresh(), b.refresh())
    assert len(a) == 9 and a.complete
    same(a.refresh(), b.refresh())                # complete: nothing more to pick up
    assert np.array_equal(a.gather(np.arange(9)), x)
