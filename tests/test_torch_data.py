"""The port's dataset path against the JAX package on the same files: the
bbox helpers and ``transform_keypoints_np`` (exact), ``HeatmapCoder``
(exact), ``FlameDataset`` items (exact) over several configs, and the
``DataLoader``'s batches over two epochs in both worker modes (the same
sample indices in the same order as the JAX loader's). The dataset, 8
images at 64x64, is rendered once per module by the port's
``cli/make_dataset.py`` on the CPU; the JAX package reads the same files.

Also the fault of ``train/loop.py::_to_device``: a ``collate`` batch, with
its lists of sample indices and file names, goes through one ``Trainer``
train step on the CPU.
"""

import logging
import os

import numpy as np
import pytest
import torch

from dad3dheads_tpu_torch.cli.make_dataset import make_dataset
from dad3dheads_tpu_torch.constants import IMAGE_FILENAME_KEY, INPUT_IMAGE_KEY, SAMPLE_INDEX_KEY
from dad3dheads_tpu_torch.data import bbox as tbbox
from dad3dheads_tpu_torch.data.dataset import DataLoader, FlameDataset, HeatmapCoder, collate
from dad3dheads_tpu_torch.ops.preprocess import transform_keypoints_np

S, N = 64, 8


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tests run beside other test processes: two torch threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("data"))
    make_dataset(out, "train", N, S, seed=0, device="cpu")
    return os.path.join(out, "DAD-3DHeadsDataset", "train")


def dataset_config(base, **extra):
    return {"ann_path": os.path.join(base, "train.json"), "dataset_root": base, "img_size": S, "seed": 3, **extra}


def test_bbox_helpers_equal_the_jax_packages():
    from dad3dheads_tpu.data import bbox as jbbox

    rng = np.random.default_rng(0)
    offsets = [0.1, 0.25, (0.1, 0.3), (0.05, 0.1, 0.15, 0.2)]
    for _ in range(50):
        box = rng.integers(-20, 120, size=4)
        box[2:] = np.abs(box[2:]) + 1
        shape = tuple(int(v) for v in rng.integers(30, 150, size=2))
        for off in offsets:
            np.testing.assert_array_equal(tbbox.extend_bbox(box, off), jbbox.extend_bbox(box, off))
        np.testing.assert_array_equal(tbbox.ensure_bbox_boundaries(box, shape),
                                      jbbox.ensure_bbox_boundaries(box, shape))
        seed = int(rng.integers(1 << 30))
        a = tbbox.random_extended_bbox(box, shape, np.random.default_rng(seed))
        b = jbbox.random_extended_bbox(box, shape, np.random.default_rng(seed))
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tbbox.extend_bbox(np.array([0, 0, 10, 10]), (0.1, 0.1, 0.1))


def test_transform_keypoints_equals_the_jax_packages():
    from dad3dheads_tpu.ops.preprocess import transform_keypoints_np as jax_transform

    rng = np.random.default_rng(1)
    kp = (rng.normal(size=(68, 2)) * 40).astype(np.float32)
    for scale, pads in ((0.73, [3, 4, 0, 1]), (np.asarray([0.5, 1.25], np.float32), [0, 0, 0, 0]), (2.0, [0, 0, 7, 7])):
        a, b = transform_keypoints_np(kp, scale, pads), jax_transform(kp, scale, pads)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("radius", [5, 2, "pointwise"])
def test_heatmap_coder_equals_the_jax_packages(radius):
    from dad3dheads_tpu.data.dataset import HeatmapCoder as JaxCoder

    rng = np.random.default_rng(2)
    kp = rng.uniform(-8, S + 8, size=(68, 2)).astype(np.float32)
    presence = rng.uniform(size=68) > 0.2
    a = HeatmapCoder(S, 4, radius=radius)(kp, presence)
    b = JaxCoder(S, 4, radius=radius)(kp, presence)
    assert a.dtype == b.dtype == np.uint8 and a.max() == 255
    np.testing.assert_array_equal(a, b)


CONFIGS = {
    "float_host_heatmap": {},
    "uint8_device_heatmap": {"output_uint8": True, "device_heatmap": True},
    "keypoints_191": {"keypoints": {"2d_subset_name": "keypoints_191"}, "num_classes": 191},
    "resize_mode_mean": {"transform": {"resize_mode": "resize", "normalize": "mean"}},
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_flame_dataset_items_equal_the_jax_packages(base, name):
    """Every item of the same files, exact: images, bbox, presence,
    landmarks, vertices and heatmaps; the second read comes from the
    ``.cache.npy`` sidecar that the first wrote."""
    from dad3dheads_tpu.data.dataset import FlameDataset as JaxDataset

    cfg = dataset_config(base, **CONFIGS[name])
    port, ref = FlameDataset.from_config(cfg), JaxDataset.from_config(cfg)
    assert len(port) == len(ref) == N
    for _ in range(2):
        for i in range(N):
            a, b = port[i], ref[i]
            assert a is not None and set(a) == set(b)
            for k in b:
                if isinstance(b[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                else:
                    assert a[k] == b[k], k
    assert all(os.path.isfile(os.path.join(base, e["annotation_path"]) + ".cache.npy") for e in port.data)
    assert port[0][INPUT_IMAGE_KEY].dtype == (np.uint8 if name == "uint8_device_heatmap" else np.float32)


def test_flame_dataset_skips_unreadable_items(base, tmp_path):
    cfg = dataset_config(base)
    ds = FlameDataset.from_config(cfg)
    ds.data = [dict(ds.data[0], img_path="missing.png"), dict(ds.data[1], annotation_path="missing.json"), ds.data[2]]
    assert ds[0] is None and ds[1] is None and ds[2] is not None
    batch = collate([ds[i] for i in range(3)])
    assert batch[INPUT_IMAGE_KEY].shape == (3, S, S, 3)
    assert batch[SAMPLE_INDEX_KEY] == [2, 2, 2]
    with pytest.raises(RuntimeError, match="all samples"):
        collate([None, None])


def _indices(loader):
    return [[int(i) for i in b[SAMPLE_INDEX_KEY]] for b in loader]


@pytest.mark.parametrize("worker_mode", ["thread", "process"])
def test_loader_yields_the_jax_loaders_batches(base, worker_mode):
    """Two epochs, shuffled, for process 0 of 1 (batch 3, drop_last) and
    process 1 of 2 (global batch 4); and one unshuffled epoch without
    drop_last: the batches of the JAX loader with the same seed, in order,
    each the collated items."""
    from dad3dheads_tpu.data.dataset import DataLoader as JaxLoader
    from dad3dheads_tpu.data.dataset import FlameDataset as JaxDataset

    cfg = dataset_config(base, output_uint8=True, device_heatmap=True)
    port_ds, ref_ds = FlameDataset.from_config(cfg), JaxDataset.from_config(cfg)
    cases = [
        dict(batch_size=3, shuffle=True, seed=11, process_index=0, process_count=1),
        dict(batch_size=4, shuffle=True, seed=12, process_index=1, process_count=2),
        dict(batch_size=3, shuffle=False, drop_last=False, process_index=0, process_count=1),
    ]
    for kw in cases:
        port = DataLoader(port_ds, num_workers=2, worker_mode=worker_mode, **kw)
        ref = JaxLoader(ref_ds, num_workers=2, **kw)
        assert len(port) == len(ref)
        for _ in range(2 if kw["shuffle"] else 1):
            got, want = list(port), list(ref)
            assert [b[SAMPLE_INDEX_KEY] for b in got] == [b[SAMPLE_INDEX_KEY] for b in want], kw
            assert len(got) == len(port)
            for a, b in zip(got, want):
                assert a[IMAGE_FILENAME_KEY] == b[IMAGE_FILENAME_KEY]
                for k, v in b.items():
                    if isinstance(v, np.ndarray):
                        np.testing.assert_array_equal(a[k], v, err_msg=k)
        port.close()


def test_loader_rank_from_torch_distributed(base, monkeypatch):
    """Without explicit ranks the loader asks torch.distributed; uninitialised
    it is process 0 of 1."""
    ds = FlameDataset.from_config(dataset_config(base))
    loader = DataLoader(ds, 4, num_workers=1)
    assert (loader.process_index, loader.process_count) == (0, 1)
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    loader = DataLoader(ds, 4, num_workers=1)
    assert (loader.process_index, loader.process_count, loader.local_batch_size) == (1, 2, 2)
    with pytest.raises(ValueError, match="divisible"):
        DataLoader(ds, 3, num_workers=1)


def test_loader_thread_clamp_warns(base, caplog):
    ds = FlameDataset.from_config(dataset_config(base))
    cpus = os.cpu_count() or 1
    with caplog.at_level(logging.WARNING, logger="dad3dheads_tpu_torch.data.dataset"):
        t = DataLoader(ds, 2, num_workers=cpus + 3, worker_mode="thread")
    assert t.num_workers == cpus and any("clamped" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="dad3dheads_tpu_torch.data.dataset"):
        p = DataLoader(ds, 2, num_workers=cpus + 3, worker_mode="process")
    assert p.num_workers == cpus + 3 and not caplog.records
    with pytest.raises(ValueError, match="worker_mode"):
        DataLoader(ds, 2, worker_mode="fork")


def test_loader_relays_worker_exceptions(base):
    class Exploding(FlameDataset):
        def __getitem__(self, idx):
            if idx == 5:
                raise RuntimeError("boom at sample 5")
            return super().__getitem__(idx)

    ds = Exploding.from_config(dataset_config(base))
    with pytest.raises(RuntimeError, match="boom at sample 5"):
        list(DataLoader(ds, 2, shuffle=False, num_workers=2))


def test_collate_batch_through_one_trainer_step(base, tmp_path):
    """A loader batch carries lists (sample indices, file names) beside its
    arrays: the Trainer moves the arrays to the device, leaves the lists on
    the host, and its train step runs on the batch."""
    from dad3dheads_tpu_torch.train.loop import Trainer

    ds = FlameDataset.from_config(dataset_config(base, output_uint8=True, device_heatmap=True))
    batch = collate([ds[0], ds[1]])
    assert isinstance(batch[SAMPLE_INDEX_KEY], list) and isinstance(batch[IMAGE_FILENAME_KEY], list)
    config = {"img_size": S, "experiment_dir": str(tmp_path / "exp"), "model": {"dropout": 0.0},
              "optimizer": {"name": "adam", "lr": 1e-4}}
    trainer = Trainer(config, train_loader=[batch], device="cpu")
    state = trainer.init_state()
    (moved,) = list(trainer._batches(trainer.train_loader))
    assert moved[SAMPLE_INDEX_KEY] == [0, 1] and moved[IMAGE_FILENAME_KEY] == batch[IMAGE_FILENAME_KEY]
    assert moved[INPUT_IMAGE_KEY].dtype == torch.uint8 and moved[INPUT_IMAGE_KEY].shape == (2, S, S, 3)
    logs = trainer.train_step(state, trainer.flame, moved, 1.0)
    assert state.step == 1 and np.isfinite(float(logs["loss"]))
