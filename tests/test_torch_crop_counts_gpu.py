"""RandomCrop's window-count kernel (``ops/cuda/crop_counts.py``) against its
plain torch version, on a card.

Marked ``gpu``; each test skips without CUDA (decided inside a fixture, never
at import). This file imports torch and the port only, so it runs where JAX
is not installed:

    python -m pytest tests/test_torch_crop_counts_gpu.py -q --noconftest

- the counts equal the plain version's bit for bit at the ADE20K cells'
  shapes (16 records of 512x683, 10 windows of 512x512, 150 classes) and the
  flagship's (8 of 1024x2048, 512x1024, 19 classes), at scales 0.5 and 0.4
  (windows past the image's edge), 1, 2 and drawn, flipped or not;
- with ``seg_pad_val`` below C, labels >= C, int32 and int64 labels;
- launched twice, the same bits; one launch counted a call;
- the augment captured as a CUDA graph on the feed's side stream and
  replayed with new records and parameters gives the eager plain route's
  image and label bits.
"""
import numpy as np
import pytest
import torch

from gaiaseg_tpu_torch.data import transforms as tf
from gaiaseg_tpu_torch.data.staging import DeviceFeed
from gaiaseg_tpu_torch.ops.cuda import LAUNCHES
from gaiaseg_tpu_torch.ops.cuda import crop_counts as cc

# (records, H, W, batch, crop, classes)
ADE = (16, 512, 683, 16, (512, 512), 150)
FLAGSHIP = (8, 1024, 2048, 8, (512, 1024), 19)
NORM_MEAN, NORM_STD = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _labels(n, h, w, classes, seed, cell=64, high=None):
    """Blocky labels: ``cell``-pixel squares of one class each (ids below
    ``high``, default ``classes``), a tenth of the squares 255."""
    rng = np.random.RandomState(seed)
    gh, gw = -(-h // cell), -(-w // cell)
    ids = rng.randint(0, high or classes, (n, gh, gw))
    ids[rng.rand(n, gh, gw) < 0.1] = 255
    lab = np.kron(ids, np.ones((1, cell, cell), np.int64))[:, :h, :w]
    return torch.from_numpy(np.ascontiguousarray(lab).astype(np.uint8))


def _windows(shape, scale, seed, device):
    """rows [B] and the windows' (near, valid) [B, K, ch + cw] at the drawn
    candidate origins of images scaled by ``scale`` (None: drawn in
    0.5..2), half of them flipped."""
    n, h, w, b, crop, _ = shape
    gen = torch.Generator().manual_seed(seed)
    params = tf.draw_augment_params(gen, b, (0.5, 2.0), 0.5)
    scales = params["scale"] if scale is None \
        else torch.full((b,), float(scale))
    rows = torch.randint(0, n, (b,), generator=gen)
    cy, cx = tf.crop_candidates((h, w), scales, params["trials"], crop)
    win = tf._windows((h, w), crop, cy, cx, scales, params["flip"])
    _, _, _, valid, near = win
    return rows.to(device), near.to(device), valid.to(device)


def _assert_kernel_matches_plain(label, rows, near, valid, ch, classes, pad):
    before = LAUNCHES["crop_counts"]
    got = cc.crop_counts(label, rows, near, valid, ch, classes, pad)
    want = cc.crop_counts_reference(label, rows, near, valid, ch, classes,
                                    pad)
    torch.cuda.synchronize()
    assert LAUNCHES["crop_counts"] == before + 1
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert torch.equal(got, want)
    assert int(got.sum()) > 0
    again = cc.crop_counts(label, rows, near, valid, ch, classes, pad)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [0.4, 0.5, 1.0, 2.0, None])
@pytest.mark.parametrize("shape", [ADE, FLAGSHIP], ids=["ade", "flagship"])
def test_counts_match_plain(cuda, shape, scale):
    """At 0.5 (0.4 for the flagship) the scaled image is smaller than the
    crop: the windows reach past its edge."""
    n, h, w, _, crop, classes = shape
    label = _labels(n, h, w, classes, seed=1).to(cuda)
    rows, near, valid = _windows(shape, scale, seed=2, device=cuda)
    if scale is not None:
        past = h * scale < crop[0] or w * scale < crop[1]
        assert bool(valid.all()) != past
    _assert_kernel_matches_plain(label, rows, near, valid, crop[0], classes,
                                 255)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.int64])
@pytest.mark.parametrize("shape", [ADE, FLAGSHIP], ids=["ade", "flagship"])
def test_pad_below_c_and_labels_past_c(cuda, shape, dtype):
    """Labels up to 200 (past both class counts) and ``seg_pad_val`` 5, a
    counted class unless excluded, in every label dtype the kernel reads."""
    n, h, w, _, crop, classes = shape
    label = _labels(n, h, w, classes, seed=3, cell=16, high=201)
    label = label.to(dtype).to(cuda)
    assert bool((label == 5).any()) and bool((label >= classes).any())
    rows, near, valid = _windows(shape, None, seed=4, device=cuda)
    _assert_kernel_matches_plain(label, rows, near, valid, crop[0], classes,
                                 5)


@pytest.mark.gpu
def test_cuda_route_raises_on_what_the_kernel_does_not_take(cuda):
    label = _labels(2, 64, 96, 19, seed=5)
    rows, near, valid = _windows((2, 64, 96, 2, (32, 48), 19), None, 6,
                                 cuda)
    with pytest.raises(ValueError, match="uint8, int32 or int64"):
        cc.crop_counts(label.to(torch.int16).to(cuda), rows, near, valid, 32,
                       19)
    with pytest.raises(ValueError, match="contiguous"):
        cc.crop_counts(label.to(cuda).transpose(1, 2).contiguous()
                       .transpose(1, 2), rows, near, valid, 32, 19)
    with pytest.raises(ValueError, match="shared memory"):
        cc.crop_counts(torch.zeros(1, 1, 60000, dtype=torch.uint8,
                                   device=cuda), rows, near, valid, 32, 19)
    with pytest.raises(ValueError, match="different devices"):
        cc.crop_counts(label, rows, near, valid, 32, 19)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graph_replay_matches_the_eager_plain_route(cuda, dtype,
                                                    monkeypatch):
    """ADE20K's pipeline over a cache of 24 records, batch 16: the augment
    captured once as a CUDA graph (as the train feed does) and replayed with
    three new draws of records and parameters gives, each time, the bits
    of the augment run eagerly with the plain counts."""
    n, h, w, b, crop, classes = 24, 512, 683, 16, (512, 512), 150
    rng = np.random.RandomState(7)
    imgs = torch.from_numpy(rng.randint(0, 256, (n, h, w, 3))
                            .astype(np.uint8)).to(cuda)
    gts = _labels(n, h, w, classes, seed=8).to(cuda)
    gen = torch.Generator().manual_seed(9)
    kw = dict(crop_size=crop, cat_max_ratio=0.75, num_classes=classes,
              dtype=dtype)
    feed = DeviceFeed(cuda)
    # on the card before the capture, as the feed keeps them: a host tuple
    # would be copied up from a temporary buffer inside the graph
    mean = torch.tensor(NORM_MEAN, device=cuda)
    std = torch.tensor(NORM_STD, device=cuda)

    def draw():
        params = tf.draw_augment_params(gen, b, (0.5, 2.0), 0.5)
        return {"idx": rng.randint(0, n, b).astype(np.int64), **params}

    def augment(dev):
        return tf.gather_augment_batch(imgs, gts, dev["idx"], dev, mean,
                                       std, **kw)

    with feed.side_stream():
        static = feed.upload(draw())
        augment(static)
        before = LAUNCHES["crop_counts"]
        graph, out = feed.capture(lambda: augment(static))
        assert LAUNCHES["crop_counts"] == before + 1
    for _ in range(3):
        arrays = draw()
        with feed.side_stream():
            feed.upload(arrays, out=static)
            graph.replay()
            got = {k: v.clone() for k, v in out.items()}
        feed.stream.synchronize()
        dev = {k: torch.as_tensor(v).to(cuda) for k, v in arrays.items()}
        with monkeypatch.context() as m:
            m.setattr(tf, "crop_counts", cc.crop_counts_reference)
            want = augment(dev)
        torch.cuda.synchronize()
        assert torch.equal(got["gt"], want["gt"])
        assert torch.equal(got["img"], want["img"])
