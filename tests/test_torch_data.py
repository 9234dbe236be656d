"""The port's data feed (tmdiff_tpu_torch/data, runtime/prefetch.py) against
the JAX package's on the CPU: synthetic scenes, the PanCollection h5 layer,
batch and sensor sequences bit for bit, and the feeders' order and
exhaustion."""
import numpy as np
import pytest
import torch

from tmdiff_tpu.data import h5 as jax_h5
from tmdiff_tpu.data import pipeline as jax_pipeline
from tmdiff_tpu.data import synthetic as jax_synthetic
from tmdiff_tpu.runtime import counts_to_float as jax_counts_to_float
from tmdiff_tpu_torch.data import h5, pipeline, synthetic
from tmdiff_tpu_torch.runtime.prefetch import DeviceFeeder, Prefetcher

torch.set_num_threads(2)


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("bands,size,seed", [(4, 32, 0), (8, 16, 3)])
def test_make_arrays_bit_equal(bands, size, seed):
    _assert_same(synthetic.make_arrays(n=3, bands=bands, size=size, seed=seed),
                 jax_synthetic.make_arrays(n=3, bands=bands, size=size, seed=seed))


def test_dataset_batches_and_sensor_mix_equal_jax():
    """PanDataset.batch, BatchIterator (reshuffling every epoch, with a batch
    size that does not divide the set) and the 4:4:8 SensorMixer give the
    JAX package's sequences bit for bit."""
    sets = {"QB": (4, 10, 0), "GF2": (4, 7, 1), "WV3": (8, 13, 2)}
    mine, theirs = {}, {}
    for sensor, (bands, n, seed) in sets.items():
        data = synthetic.make_arrays(n=n, bands=bands, size=16, seed=seed)
        mine[sensor] = pipeline.BatchIterator(h5.PanDataset(data), 3, seed=seed)
        theirs[sensor] = jax_pipeline.BatchIterator(jax_h5.PanDataset(data), 3, seed=seed)
        idx = np.array([2, 0, 2, 5])
        _assert_same(mine[sensor].dataset.batch(idx), theirs[sensor].dataset.batch(idx))
        _assert_same(mine[sensor].dataset[1], theirs[sensor].dataset[1])
        assert len(mine[sensor]) == len(theirs[sensor])
    mixer, jax_mixer = pipeline.SensorMixer(mine, seed=5), jax_pipeline.SensorMixer(theirs, seed=5)
    np.testing.assert_array_equal(mixer.probs, jax_mixer.probs)
    for _ in range(25):
        (b, s), (jb, js) = next(mixer), next(jax_mixer)
        assert s == js
        _assert_same(b, jb)


@pytest.mark.parametrize("full_resolution", [False, True])
def test_h5_round_trip_through_jax_writer(tmp_path, full_resolution):
    """A file written by the JAX package's write_h5 (raw counts) loads into
    the same arrays through the port's load_pancollection, PanDataset and
    LazyPanDataset as through the JAX package's."""
    path = str(tmp_path / "train_gf2_data.h5")
    jax_synthetic.write_h5(path, n=5, bands=4, size=16, seed=2, img_scale=1023.0,
                           full_resolution=full_resolution)
    mine, theirs = h5.load_pancollection(path), jax_h5.load_pancollection(path)
    assert mine["has_reference"] == theirs["has_reference"] == (not full_resolution)
    assert mine["img_scale"] == theirs["img_scale"] == 1023.0
    _assert_same({k: mine[k] for k in h5.KEYS}, {k: theirs[k] for k in h5.KEYS})
    idx = np.array([4, 1, 1, 0])
    _assert_same(h5.PanDataset(path).batch(idx), jax_h5.PanDataset(path).batch(idx))
    lazy, jax_lazy = h5.LazyPanDataset(path, data_len=4), jax_h5.LazyPanDataset(path, data_len=4)
    try:
        assert len(lazy) == len(jax_lazy) == 4 and lazy.bands == jax_lazy.bands == 4
        _assert_same(lazy.batch(idx), jax_lazy.batch(idx))
        _assert_same(lazy[2], jax_lazy[2])
    finally:
        lazy.close()
        jax_lazy.close()


def test_counts_to_float_equals_jax():
    counts = np.random.default_rng(0).integers(0, 2048, (3, 4, 5), dtype=np.uint16)
    for scale in (2047.0, 1023.0):
        np.testing.assert_array_equal(h5.counts_to_float(counts, scale),
                                      jax_counts_to_float(counts, scale))
        floats = counts.astype(np.float64)
        np.testing.assert_array_equal(h5.counts_to_float(floats, scale),
                                      jax_counts_to_float(floats, scale))


@pytest.mark.parametrize("depth", [0, 2])
def test_device_feeder_keeps_order_and_yields_every_item(depth):
    """A finite source of N items comes out whole and in order (the JAX
    package's feeder drops the last item, ADVICE.md), arrays as tensors on
    the device and other values as they were; the iteration stays ended."""
    items = [({"Res": np.full((2, 3), i, np.float32)}, f"s{i}") for i in range(5)]
    feeder = DeviceFeeder(iter(items), device="cpu", depth=depth)
    out = list(feeder)
    assert [s for _, s in out] == [s for _, s in items]
    for i, (batch, _) in enumerate(out):
        assert isinstance(batch["Res"], torch.Tensor) and batch["Res"].device.type == "cpu"
        assert torch.equal(batch["Res"], torch.full((2, 3), float(i)))
    with pytest.raises(StopIteration):
        next(feeder)
    feeder.close()
    assert list(DeviceFeeder(iter([]), device="cpu", depth=depth)) == []


def test_prefetcher_raises_worker_errors_and_closes():
    def source():
        yield 1
        raise KeyError("bad row")

    pf = Prefetcher(source(), depth=1)
    assert next(pf) == 1
    with pytest.raises(KeyError, match="bad row"):
        next(pf)
    endless = Prefetcher(iter(int, 1), depth=2)  # never ends
    assert next(endless) == 0
    endless.close(timeout=5.0)
    assert not endless._thread.is_alive()
