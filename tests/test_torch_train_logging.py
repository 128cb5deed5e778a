"""The port's asynchronous checkpoints and its TensorBoard image panels on the
CPU. Async: a save, then an optimizer step that updates every tensor of the
state in place, then ``flush``: the file equals a synchronous save of the
state before the step, byte for byte (Adam and lamb, whose ``step`` counters
are tensors too); and the JAX package's async round trip. Panels: the panel
forward against the JAX ``Trainer``'s on the same weights (bridged) and the
same uint8 batch; the drawn grids against the JAX package's
``visualization`` on the same host arrays; the model back in train mode."""

import os
import shutil

import numpy as np
import pytest
import torch

from dad3dheads_tpu_torch import weights
from dad3dheads_tpu_torch.constants import INPUT_IMAGE_KEY, TARGET_2D_LANDMARKS
from dad3dheads_tpu_torch.core import FlameModel
from dad3dheads_tpu_torch.train import TrainState, get_optimizer, init_train_state
from dad3dheads_tpu_torch.train import checkpoint
from dad3dheads_tpu_torch.train.checkpoint import CheckpointManager
from dad3dheads_tpu_torch.train.loop import Trainer

IMG = 64
MONITOR = "valid/metrics/reproject_nme_2d"


def _small_state(name: str) -> TrainState:
    """A conv, a BatchNorm (running statistics) and a linear layer, one
    optimizer step taken, so that every state tensor exists."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4), torch.nn.Flatten(),
                                torch.nn.Linear(4 * 6 * 6, 5))
    state = TrainState(model, get_optimizer({"name": name, "lr": 1e-2, "weight_decay": 1e-3}, model.parameters(),
                                            gradient_clip_val=1.0), step=3, epoch=1)
    _train_step(state)
    return state


def _train_step(state: TrainState) -> None:
    state.optimizer.zero_grad()
    state.model.train()
    state.model(torch.randn(2, 3, 8, 8)).square().mean().backward()
    state.optimizer.step(0.5)
    state.step += 1


@pytest.mark.parametrize("name", ["adam", "lamb"])
def test_async_save_is_the_state_at_save(tmp_path, name):
    """The write queued before the step holds the state before it, byte for
    byte like a synchronous save made then, in last and in the top-k."""
    state = _small_state(name)
    sync = CheckpointManager(str(tmp_path / "sync"), monitor=MONITOR)
    sync.save(state, 1, {MONITOR: 2.0})
    ck = CheckpointManager(str(tmp_path / "async"), monitor=MONITOR, async_save=True)
    assert ck.save(state, 1, {MONITOR: 2.0}) is None
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    _train_step(state)
    assert any(not torch.equal(before[k], v) for k, v in state.model.state_dict().items())
    ck.flush()
    for a, b in ((sync.last_path, ck.last_path), (sync.best["path"], ck.best["path"])):
        assert os.path.basename(a) == os.path.basename(b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), b
    restored = _small_state(name)
    ck.restore_last(restored)
    assert all(torch.equal(before[k], v) for k, v in restored.model.state_dict().items())
    assert restored.step == 4
    # the weights in last and in the top-k payload are copied once
    full = state.state_dict()
    snap = checkpoint._device_snapshot({"state": full, "model": full["model"]})
    assert all(snap["model"][k] is snap["state"]["model"][k] for k in full["model"])


def test_async_checkpoint_roundtrip(tmp_path):
    """The JAX package's round trip (tests/test_train_loop.py): writes land
    by flush; best and restore drain the queue; the best is epoch 1, last is
    epoch 2."""
    state = _small_state("adam")
    weight = state.model[3].bias
    ck = CheckpointManager(str(tmp_path), monitor="m", mode="min", save_top_k=2, async_save=True)
    for epoch, m in enumerate([5.0, 3.0, 4.0]):
        with torch.no_grad():
            weight.copy_(torch.arange(5.0) + epoch)
        ck.save(state, epoch, {"m": m})
    assert ck.best["value"] == 3.0  # the property flushes
    ck.restore(state)
    np.testing.assert_array_equal(weight.detach().numpy(), np.arange(5.0) + 1)
    ck.restore_last(state)
    np.testing.assert_array_equal(weight.detach().numpy(), np.arange(5.0) + 2)
    assert len(ck._registry) == 2 and all(os.path.isfile(e["path"]) for e in ck._registry)


def test_async_writer_error_reaches_flush(tmp_path):
    state = _small_state("adam")
    ck = CheckpointManager(str(tmp_path / "ck"), monitor=MONITOR, async_save=True)
    shutil.rmtree(tmp_path / "ck")  # the writer cannot create last.pt
    ck.save(state, 0, {})
    with pytest.raises(RuntimeError, match="does not exist"):
        ck.flush()


class _FakeTB:
    def __init__(self):
        self.images = []

    def add_scalar(self, tag, value, step):
        pass

    def add_image(self, tag, img, step, dataformats="HWC"):
        assert dataformats == "HWC" and img.dtype == np.uint8
        self.images.append((tag, img, step))


@pytest.fixture(scope="module")
def panels(tmp_path_factory):
    """The port's and the JAX Trainer's panel forward on one weight set
    (the port's init, bridged) and one uint8 batch of 9 (the panels take 8),
    and the port's drawn panels."""
    import jax  # noqa: F401 -- tests/conftest.py has put JAX on the CPU
    from dad3dheads_tpu.core.flame import FlameModel as JaxFlame
    from dad3dheads_tpu.models import create_model as jax_create_model
    from dad3dheads_tpu.train.loop import Trainer as JaxTrainer

    tmp = tmp_path_factory.mktemp("panels")
    rng = np.random.default_rng(5)
    batch = {INPUT_IMAGE_KEY: rng.integers(0, 256, (9, IMG, IMG, 3), dtype=np.uint8),
             TARGET_2D_LANDMARKS: rng.uniform(0.1, 0.9, (9, 68, 2)).astype(np.float32)}
    state = init_train_state({}, {"name": "adam"}, torch.Generator().manual_seed(0), "cpu")
    state.model.train()  # as the train step leaves it
    config = {"img_size": IMG, "experiment_dir": str(tmp / "port"), "images_log_freq": 1}
    trainer = Trainer(config, flame=FlameModel.load(), device="cpu")
    trainer._tb = _FakeTB()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))  # the tests run beside other test processes
    try:
        port = [t.numpy() for t in trainer.panel_forward(state, tbatch)]
        trainer.log_image_panels(state, tbatch, 7)
        trainer._drain_panels()
    finally:
        torch.set_num_threads(threads)
    train_mode = state.model.training

    variables = weights.flax_from_state_dict(state.model.state_dict())
    jt = JaxTrainer(jax_create_model({"backbone": "resnet50"}), {**config, "experiment_dir": str(tmp / "jax")},
                    flame=JaxFlame.load())
    jt._tb = _FakeTB()  # log_image_panels builds its panel forward only with a writer

    class _State:
        params, batch_stats = variables["params"], variables["batch_stats"]

    jt.log_image_panels(_State, batch, 7)
    jt._drain_panels()
    ref = [np.asarray(x) for x in jt._viz_forward(_State.params, _State.batch_stats, batch[INPUT_IMAGE_KEY],
                                                 batch[TARGET_2D_LANDMARKS])]
    yield port, ref, trainer._tb.images, train_mode
    shutil.rmtree(tmp, ignore_errors=True)


def test_panel_forward_matches_jax(panels):
    """uint8 images equal; the heatmap probability map within one level of
    255; the packed (8, 272) pred + GT landmarks at 1e-4."""
    (img, hm, lmks), (jimg, jhm, jlmks), _, _ = panels
    assert img.dtype == hm.dtype == np.uint8 and img.shape == jimg.shape == (8, IMG, IMG, 3)
    np.testing.assert_array_equal(img, jimg)
    assert hm.shape == jhm.shape == (8, IMG // 4, IMG // 4, 1)
    assert np.abs(hm.astype(int) - jhm.astype(int)).max() <= 1
    assert lmks.shape == jlmks.shape == (8, 272)
    np.testing.assert_allclose(lmks, jlmks, rtol=0, atol=1e-4)


def test_drawn_panels_match_jax_visualization(panels):
    """The port's grids, drawn on its worker thread from the one packed
    host copy, equal the JAX package's functions on the same host arrays;
    the model is back in train mode."""
    from dad3dheads_tpu.train import visualization as jvis
    from dad3dheads_tpu_torch.constants import OUTPUT_2D_LANDMARKS, OUTPUT_LANDMARKS_HEATMAP
    from dad3dheads_tpu_torch.train import visualization as tvis

    (img, hm, lmks), _, images, train_mode = panels
    assert train_mode
    k = lmks.shape[1] // 2
    host_batch = {INPUT_IMAGE_KEY: img, TARGET_2D_LANDMARKS: lmks[:, k:].reshape(8, -1, 2)}
    host_out = {OUTPUT_2D_LANDMARKS: lmks[:, :k].reshape(8, -1, 2), OUTPUT_LANDMARKS_HEATMAP: hm}
    drawn = {tag: (grid, step) for tag, grid, step in images}
    assert set(drawn) == {"train/landmarks", "train/heatmap"} and all(s == 7 for _, s in drawn.values())
    ref_lm = jvis.landmarks_panel_from_batch(host_batch, host_out, IMG)
    ref_hm = jvis.heatmap_panel_from_batch(host_batch, host_out)
    assert ref_lm.shape == (2 * IMG, 4 * IMG, 3)
    np.testing.assert_array_equal(drawn["train/landmarks"][0], ref_lm)
    np.testing.assert_array_equal(drawn["train/heatmap"][0], ref_hm)
    # the port's module on float images, and its helpers, equal the JAX package's
    x = np.random.default_rng(6).normal(size=(3, 16, 16, 3)).astype(np.float32)
    fb = {INPUT_IMAGE_KEY: x, TARGET_2D_LANDMARKS: np.full((3, 68, 2), 0.5, np.float32)}
    fo = {OUTPUT_2D_LANDMARKS: np.full((3, 68, 2), 0.25, np.float32),
          OUTPUT_LANDMARKS_HEATMAP: np.random.default_rng(7).normal(size=(3, 4, 4, 68)).astype(np.float32)}
    for mode in ("imagenet", "mean", "none"):
        np.testing.assert_array_equal(tvis.landmarks_panel_from_batch(fb, fo, 16, normalize=mode),
                                      jvis.landmarks_panel_from_batch(fb, fo, 16, normalize=mode))
        np.testing.assert_array_equal(tvis.heatmap_panel_from_batch(fb, fo, normalize=mode),
                                      jvis.heatmap_panel_from_batch(fb, fo, normalize=mode))
