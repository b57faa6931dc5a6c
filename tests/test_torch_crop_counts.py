"""RandomCrop's window counts (``ops/cuda/crop_counts.py``) on the CPU.

- the wrapper's route for CPU tensors is the plain version, which counts
  what a loop over the windows' pixels counts (``seg_pad_val`` below C and
  labels >= C left out, windows past the image's edge, the ADE20K cells'
  24,160 bins), and launches nothing;
- every argument check runs before a launch: the shapes, dtypes and devices
  both routes take, then the kernel's label dtypes, layout and shared
  memory, which the card's tests reach through the wrapper.

The kernel's own counts against the plain version's are in
``test_torch_crop_counts_gpu.py`` (``gpu``).
"""
import numpy as np
import pytest
import torch

from gaiaseg_tpu_torch.data import transforms as tf
from gaiaseg_tpu_torch.ops.cuda import LAUNCHES
from gaiaseg_tpu_torch.ops.cuda import crop_counts as cc


def _case(scale, seed=0, n=3, h=20, w=28, b=4, crop=(12, 16), classes=7):
    rng = np.random.RandomState(seed)
    label = torch.from_numpy(rng.randint(0, 12, (n, h, w)).astype(np.uint8))
    label[:, :2] = 255
    gen = torch.Generator().manual_seed(seed)
    params = tf.draw_augment_params(gen, b, (0.5, 2.0), 0.5)
    scales = params["scale"] if scale is None \
        else torch.full((b,), float(scale))
    cy, cx = tf.crop_candidates((h, w), scales, params["trials"], crop)
    _, _, _, valid, near = tf._windows((h, w), crop, cy, cx, scales,
                                       params["flip"])
    rows = torch.from_numpy(rng.randint(0, n, b).astype(np.int64))
    return label, rows, near, valid, crop[0], classes


def _loop_counts(label, rows, near, valid, ch, classes, pad):
    lab, near, valid = label.numpy(), near.numpy(), valid.numpy()
    b, k = near.shape[:2]
    out = np.zeros((b, k, classes), np.int64)
    for i in range(b):
        for t in range(k):
            for y in range(ch):
                for x in range(ch, near.shape[2]):
                    if not (valid[i, t, y] and valid[i, t, x]):
                        continue
                    v = int(lab[int(rows[i]), near[i, t, y], near[i, t, x]])
                    if v < classes and v != pad:
                        out[i, t, v] += 1
    return out


@pytest.mark.parametrize("pad", [255, 3])
@pytest.mark.parametrize("scale", [0.5, 1.0, 2.0, None])
def test_cpu_route_counts_what_a_loop_counts(scale, pad):
    args = _case(scale)
    before = dict(LAUNCHES)
    got = cc.crop_counts(*args, seg_pad_val=pad)
    assert LAUNCHES == before             # the CPU launches no kernel
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), _loop_counts(*args, pad))
    if scale == 0.5:                      # the crop is past the image's edge
        assert not bool(args[3].all())


def test_plain_count_is_exact_at_the_ade_cells_bins():
    """16 images x 10 windows x 151 bins, the ADE20K cells' 24,160: the
    float keys of a histc put 349 of these counts one bin low; the integer
    count has none off."""
    args = _case(1.0, seed=3, n=4, h=12, w=16, b=16, crop=(8, 8),
                 classes=150)
    rng = np.random.RandomState(0)
    args[0][:] = torch.from_numpy(rng.randint(0, 150, (4, 12, 16))
                                  .astype(np.uint8))
    assert args[2].shape[:2] == (16, 10)
    np.testing.assert_array_equal(cc.crop_counts(*args).numpy(),
                                  _loop_counts(*args, 255))


def test_histograms_take_the_wrapper():
    label, rows, near, valid, ch, classes = _case(None, seed=1)
    win = (None, None, None, valid, near)
    assert torch.equal(tf._histograms(label, rows, win, ch, classes, 255),
                       cc.crop_counts_reference(label, rows, near, valid, ch,
                                                classes))


def _bad(**changes):
    label, rows, near, valid, ch, classes = _case(1.0)
    args = dict(label=label, rows=rows, near=near, valid=valid, ch=ch,
                num_classes=classes)
    args.update(changes)
    return args


@pytest.mark.parametrize("changes, match", [
    (dict(label=torch.zeros(20, 28, dtype=torch.uint8)), r"\[N, H, W\]"),
    (dict(near=torch.zeros(4, 10, 28, dtype=torch.int32)), "int64"),
    (dict(near=torch.zeros(4, 280, dtype=torch.int64)), "int64"),
    (dict(valid=torch.ones(4, 10, 28, dtype=torch.uint8)), "bool"),
    (dict(valid=torch.ones(4, 10, 27, dtype=torch.bool)), "bool"),
    (dict(rows=torch.zeros(4, dtype=torch.int32)), "rows"),
    (dict(rows=torch.zeros(3, dtype=torch.int64)), "rows"),
    (dict(ch=0), "ch = 0"),
    (dict(ch=28), "ch = 28"),
    (dict(num_classes=0), "positive"),
    (dict(label=torch.zeros(3, 20, 28, dtype=torch.uint8, device="meta")),
     "different devices"),
], ids=["label_2d", "near_int32", "near_2d", "valid_uint8", "valid_shape",
        "rows_int32", "rows_length", "ch_0", "ch_all", "no_classes",
        "devices"])
def test_wrapper_checks_before_any_launch(changes, match):
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match=match):
        cc.crop_counts(**_bad(**changes))
    assert LAUNCHES == before


def test_wrapper_refuses_other_devices():
    args = {k: v.to("meta") if isinstance(v, torch.Tensor) else v
            for k, v in _bad().items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        cc.crop_counts(**args)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.int64])
def test_kernel_takes_these_labels(dtype):
    cc._check_kernel(torch.zeros(2, 8, 8, dtype=dtype), 19, 1024, 232448)


@pytest.mark.parametrize("label, smem, match", [
    (torch.zeros(2, 8, 8, dtype=torch.int16), 1024, "uint8, int32 or int64"),
    (torch.zeros(2, 8, 8, dtype=torch.float32), 1024, "uint8, int32 or int64"),
    (torch.zeros(2, 8, 9, dtype=torch.uint8)[..., :8], 1024, "contiguous"),
    (torch.zeros(2, 8, 8, dtype=torch.uint8), 232449, "shared memory"),
], ids=["int16", "float32", "strided", "smem"])
def test_kernel_check_refuses(label, smem, match):
    with pytest.raises(ValueError, match=match):
        cc._check_kernel(label, 19, smem, 232448)
