"""The port's train loop and eval on the data pipeline, against JAX.

- ``resolve_epoch_schedule`` on ``schedule_ft1x.py`` and
  ``schedule_all_42e.py``: the JAX function's max_iters, steps and warmup,
  and the port's LR at every iteration within 1e-6 (relative) of JAX's
  ``build_lr_schedule`` on the resolved config; ``train_segmentor`` on an
  epoch schedule runs epochs x iters-per-epoch iterations at those LRs
  (the parent's loop ran 1000 an epoch, with the LR steps at iterations 9
  and 12).
- ``train_segmentor`` on a ``PackedDataset``: finite losses through the
  whole flagship-style pipeline; with an identity pipeline the batches it
  trains on are the JAX ``BatchLoader``'s (shuffled by epoch, across epoch
  boundaries) through JAX ``augment_batch``; a device-cached dataset gives
  the streaming batches bit for bit.
- ``evaluate_arch`` with a padded tail (5 images, batch 2): the confusion
  matrix of batch 1, and of JAX ``confusion_matrix`` on the same
  predictions.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.data import loader as jloader
from gaiaseg_tpu.data import metrics as jmetrics
from gaiaseg_tpu.data import transforms as J
from gaiaseg_tpu.engine import optim as joptim
from gaiaseg_tpu.engine import train as jtrain
from gaiaseg_tpu.utils.config import Config as JConfig
from gaiaseg_tpu_torch.data import (PackedDataset, SyntheticDataset,
                                    pack_dataset, parse_train_pipeline)
from gaiaseg_tpu_torch.data.device_cache import DeviceCachedDataset
from gaiaseg_tpu_torch.engine import evaluate_arch, optim
from gaiaseg_tpu_torch.engine import train as ptrain
from gaiaseg_tpu_torch.models import build_segmentor, encode_arch, \
    model_max_arch
from gaiaseg_tpu_torch.utils import Config

from test_torch_segmentor import model_cfg

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULES = ["configs/_dynamic_/schedules/schedule_ft1x.py",
             "configs/_dynamic_/schedules/schedule_all_42e.py"]
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])
FULL_PIPELINE = [
    dict(type="LoadImageFromFile"), dict(type="LoadAnnotations"),
    dict(type="Resize", img_scale=(64, 48), ratio_range=(0.5, 2.0)),
    dict(type="RandomCrop", crop_size=(32, 32), cat_max_ratio=0.75),
    dict(type="RandomFlip", prob=0.5), dict(type="PhotoMetricDistortion"),
    dict(type="Normalize", **NORM),
    dict(type="Pad", size=(32, 32), pad_val=0, seg_pad_val=255)]
TRAIN_STEP = ptrain.train_step
IDENTITY_PIPELINE = [dict(type="RandomCrop", crop_size=(48, 64)),
                     dict(type="Normalize", **NORM)]


@pytest.mark.parametrize("path", SCHEDULES)
@pytest.mark.parametrize("n_samples,batch", [(80, 8), (2975, 8), (5, 8)])
def test_resolve_epoch_schedule_matches_jax(path, n_samples, batch):
    cfg = Config.fromfile(os.path.join(REPO, path)).to_dict()
    want_iters, want_lrc = jtrain.resolve_epoch_schedule(
        JConfig.fromfile(os.path.join(REPO, path)).to_dict(), n_samples,
        batch)
    iters, lrc = ptrain.resolve_epoch_schedule(cfg, n_samples, batch)
    assert (iters, lrc) == (want_iters, want_lrc)
    ipe = max(n_samples // batch, 1)
    assert iters == cfg["total_epochs"] * ipe
    assert lrc["step"] == [s * ipe for s in cfg["lr_config"]["step"]]
    assert lrc["warmup_iters"] == ipe and "warmup_by_epoch" not in lrc
    if n_samples > 100:
        return
    base = optim.scale_lr(cfg["optimizer"]["lr"], batch, cfg["lr_scaler"])
    port = optim.build_lr_schedule(lrc, base, iters)
    ref = joptim.build_lr_schedule(want_lrc, base, want_iters)
    for it in range(iters + 2):
        assert port(it) == pytest.approx(float(ref(it)), rel=1e-6)


def test_iteration_based_configs_keep_their_length():
    cfg = {"runner": {"max_iters": 7}, "total_epochs": 3,
           "lr_config": {"policy": "poly"}}
    assert ptrain.resolve_epoch_schedule(cfg, 100, 2) == \
        jtrain.resolve_epoch_schedule(cfg, 100, 2) == \
        (None, {"policy": "poly"})


@pytest.fixture(scope="module")
def packed_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("packed") / "train.gsegpack")
    return pack_dataset(SyntheticDataset(length=6, size=(48, 64),
                                         num_classes=7, seed=0, cells=4),
                        path)


def _cfg(path, pipeline, **extra):
    return dict(model=model_cfg(False),
                data=dict(samples_per_gpu=2,
                          train=dict(type="PackedDataset", path=path,
                                     pipeline=pipeline)),
                optimizer=dict(type="SGD", lr=0.01, momentum=0.9,
                               weight_decay=5e-4),
                lr_config=dict(policy="poly", power=0.9, min_lr=1e-4,
                               by_epoch=False),
                runner=dict(max_iters=2), **extra)


def _model(cfg):
    torch.manual_seed(0)
    return build_segmentor(cfg["model"])


def test_train_segmentor_runs_the_full_pipeline(monkeypatch, packed_path):
    """Finite losses; each batch is the config's pipeline (a 32x32 crop of
    the 48x64 records) applied with the parameters drawn from the seed to
    the JAX ``BatchLoader``'s records."""
    from gaiaseg_tpu_torch.data import augment_batch, draw_augment_params
    cfg = _cfg(packed_path, FULL_PIPELINE)
    seen = _seen_batches(monkeypatch, cfg)
    assert [tuple(img.shape) for img, _ in seen] == [(2, 3, 32, 32)] * 2
    ref = jloader.BatchLoader(PackedDataset(packed_path), 2, shuffle=True,
                              seed=3, drop_last=True, infinite=True,
                              prefetch=0)
    gen = torch.Generator().manual_seed(3)
    for (img, gt), batch in zip(seen, ref):
        params = draw_augment_params(gen, 2, (0.5, 2.0), 0.5)
        want = augment_batch(torch.from_numpy(batch["img"]),
                             torch.from_numpy(batch["gt"]), params,
                             NORM["mean"], NORM["std"], crop_size=(32, 32),
                             cat_max_ratio=0.75, num_classes=7,
                             dtype=torch.float32)
        assert torch.equal(img, want["img"]) and torch.equal(gt, want["gt"])
    history = ptrain.train_segmentor(_model(cfg), cfg, device="cpu", seed=0)
    assert len(history) == 2
    assert all(np.isfinite(r["loss"]) and r["data_ms"] >= 0
               for r in history)


def _seen_batches(monkeypatch, cfg, train_dataset=None, iters=None):
    """The (img, gt) pairs ``train_segmentor`` trains on."""
    seen = []

    def spy(model, optimizer, img, gt, *args, **kw):
        seen.append((img.clone(), gt.clone()))
        return TRAIN_STEP(model, optimizer, img, gt, *args, **kw)

    monkeypatch.setattr(ptrain, "train_step", spy)
    ptrain.train_segmentor(_model(cfg), cfg, device="cpu", seed=3,
                           train_dataset=train_dataset, max_iters=iters)
    return seen


def test_train_batches_follow_jax_loader_and_augment(monkeypatch,
                                                     packed_path):
    """Identity pipeline (no resize, the whole image as the crop, no flip,
    no photometric): 5 iterations of batch 2 over 6 records cross an epoch
    boundary of the reshuffled index stream."""
    cfg = _cfg(packed_path, IDENTITY_PIPELINE)
    seen = _seen_batches(monkeypatch, cfg, iters=5)
    ds = PackedDataset(packed_path)
    ref = jloader.BatchLoader(ds, 2, shuffle=True, seed=3, drop_last=True,
                              infinite=True, prefetch=0)
    mean, std = jnp.asarray(NORM["mean"]), jnp.asarray(NORM["std"])
    for (img, gt), batch in zip(seen, ref):
        want = J.augment_batch(jax.random.PRNGKey(0), jnp.asarray(
            batch["img"]), jnp.asarray(batch["gt"]), mean, std,
            crop_size=(48, 64), ratio_range=(1.0, 1.0), cat_max_ratio=1.0,
            num_classes=7, photometric=False, flip_prob=0.0)
        np.testing.assert_array_equal(gt.numpy(), np.asarray(want["gt"]))
        f32 = J.normalize(jnp.asarray(batch["img"], jnp.float32), mean, std)
        np.testing.assert_allclose(img.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(f32), rtol=0, atol=2e-5)
        assert torch.equal(img.to(torch.bfloat16), torch.from_numpy(
            np.asarray(want["img"]).astype(np.float32)).to(torch.bfloat16)
            .permute(0, 3, 1, 2))
    assert len(seen) == 5


def test_device_cached_training_sees_the_streaming_batches(monkeypatch,
                                                           packed_path):
    cfg = _cfg(packed_path, FULL_PIPELINE)
    stream = _seen_batches(monkeypatch, cfg)
    cached = _seen_batches(monkeypatch, cfg, DeviceCachedDataset(
        PackedDataset(packed_path), "cpu"))
    assert len(stream) == len(cached) == 2
    for (a, b), (c, d) in zip(stream, cached):
        assert torch.equal(a, c) and torch.equal(b, d)


def test_epoch_schedule_sets_the_run_length(monkeypatch, packed_path):
    """6 records, batch 2: 3 iterations an epoch; 2 epochs with an LR step
    at epoch 1 and a one-epoch warmup."""
    lrc = dict(policy="step", warmup="linear", warmup_iters=1,
               warmup_ratio=0.1, warmup_by_epoch=True, gamma=0.5, step=[1])
    cfg = _cfg(packed_path, FULL_PIPELINE, total_epochs=2)
    cfg.pop("runner")
    cfg["lr_config"] = lrc
    history = ptrain.train_segmentor(_model(cfg), cfg, device="cpu", seed=0)
    iters, resolved = jtrain.resolve_epoch_schedule(cfg, 6, 2)
    assert len(history) == iters == 6
    ref = joptim.build_lr_schedule(resolved, 0.01, iters)
    assert [r["lr"] for r in history] == \
        pytest.approx([float(ref(i)) for i in range(6)], rel=1e-6)


def test_evaluate_arch_padded_tail_matches_batch_one(packed_path):
    cfg = _cfg(packed_path, FULL_PIPELINE)
    model = _model(cfg).eval()
    ds = SyntheticDataset(length=5, size=(32, 40), num_classes=7, seed=4)
    arch = encode_arch(model_max_arch(cfg["model"]))
    by2 = evaluate_arch(model, ds, arch, NORM, "cpu", batch_size=2)
    by1 = evaluate_arch(model, ds, arch, NORM, "cpu", batch_size=1)
    assert np.array_equal(by2["confusion"], by1["confusion"])
    assert by2["confusion"].sum() == 5 * 32 * 40
    want = np.zeros((7, 7), np.int64)
    with torch.no_grad():
        for i in range(5):
            img = torch.from_numpy(ds[i]["img"][None]).permute(0, 3, 1, 2)
            img = (img.float() - torch.tensor(NORM["mean"])[:, None, None]) \
                / torch.tensor(NORM["std"])[:, None, None]
            pred = model.simple_test(img, arch)
            want += np.asarray(jmetrics.confusion_matrix(
                jnp.asarray(pred.numpy()), jnp.asarray(ds[i]["gt"][None]),
                7))
    assert np.array_equal(by2["confusion"], want)
    assert by2["mIoU"] == pytest.approx(by1["mIoU"])


def test_pipeline_crop_sets_the_batch_shape():
    assert parse_train_pipeline(FULL_PIPELINE).crop_size == (32, 32)
