"""The port's ``tools/mean_std.py`` and ``tools/image_demo.py`` on the CPU.

- ``mean_std`` on a tiny file dataset (PNG images of 10x14 and 12x9 under
  a config's ``data.train``) prints the numbers JAX's ``tools/mean_std.py``
  prints (its ``main``, run on the same config), within 1e-12, and honours
  ``--max-images`` and ``--split``.
- ``image_demo`` on the tiny synthetic config and a ``.pth`` written by
  the port, with a palette in the checkpoint: the overlay it writes equals
  JAX's ``show_result`` on the same image and the prediction
  ``inference_segmentor`` gives, bit for bit, at MAX and at an ``--arch``
  meta.
"""
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from gaiaseg_tpu_torch.engine import (inference_segmentor, init_segmentor,
                                      save_checkpoint)
from gaiaseg_tpu_torch.models import build_segmentor
from gaiaseg_tpu_torch.tools import image_demo, mean_std
from gaiaseg_tpu_torch.utils import Config

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tests", "tiny_synthetic.py")


def _file_dataset(tmp_path):
    """Images and labels under ``tmp_path/{train,val}`` and a config that
    reads them."""
    rng = np.random.RandomState(0)
    for split, shapes in (("train", [(10, 14), (12, 9), (10, 14)]),
                          ("val", [(8, 8)])):
        for i, (h, w) in enumerate(shapes):
            for d, arr in (("img", rng.randint(0, 256, (h, w, 3))),
                           ("ann", rng.randint(0, 5, (h, w)))):
                path = tmp_path / split / d / f"{i}.png"
                path.parent.mkdir(parents=True, exist_ok=True)
                Image.fromarray(arr.astype(np.uint8)).save(path)
    cfg = tmp_path / "files.py"
    body = "data = dict(samples_per_gpu=2, workers_per_gpu=0"
    for split in ("train", "val"):
        body += (f", {split}=dict(type='CustomDataset', data_root="
                 f"{str(tmp_path)!r}, img_dir='{split}/img', "
                 f"ann_dir='{split}/ann', img_suffix='.png')")
    cfg.write_text(body + ")\n")
    return str(cfg)


def _numbers(line):
    mean, std, n = re.fullmatch(
        r"mean=\[(.*)\] std=\[(.*)\] \((\d+) images\)", line.strip()).groups()
    return ([float(v) for v in mean.split(",")],
            [float(v) for v in std.split(",")], int(n))


@pytest.mark.parametrize("args", [[], ["--max-images", "2"],
                                  ["--split", "val"]],
                         ids=["all", "max_images", "val"])
def test_mean_std_prints_jax_numbers(tmp_path, capsys, monkeypatch, args):
    import importlib.util
    import sys
    cfg = _file_dataset(tmp_path)
    got = mean_std.main([cfg, "--device", "cpu", *args])
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    spec = importlib.util.spec_from_file_location(
        "jax_mean_std", os.path.join(REPO, "tools", "mean_std.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    monkeypatch.setattr(sys, "argv", ["mean_std.py", cfg, *args])
    jax_tool.main()
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    (pm, ps, pn), (jm, js, jn) = _numbers(port_line), _numbers(jax_line)
    assert pn == jn == {"all": 3, "max_images": 2, "val": 1}[
        "all" if not args else ("val" if "val" in args else "max_images")]
    np.testing.assert_allclose(pm, jm, rtol=1e-12)
    np.testing.assert_allclose(ps, js, rtol=1e-12)
    assert got == (pm, ps, pn)


PALETTE = [[10 * i, 255 - 20 * i, (37 * i) % 256] for i in range(5)]


@pytest.mark.parametrize("arch", [None, {
    "arch.backbone.body.width": [4, 8, 16, 16],
    "arch.backbone.body.depth": [1, 1, 2, 1]}], ids=["max", "meta"])
def test_image_demo_overlay_equals_jax_show_result(tmp_path, arch):
    import json

    from gaiaseg_tpu.engine.inference import show_result as j_show_result
    torch.manual_seed(0)
    model = build_segmentor(Config.fromfile(TINY)["model"])
    with torch.no_grad():            # a classifier that varies over the map
        model.decode_head.conv_seg.weight.normal_(0.0, 5.0)
    ckpt = str(tmp_path / "tiny.pth")
    save_checkpoint(ckpt, model, meta={"PALETTE": PALETTE,
                                       "CLASSES": list("abcde")})
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (40, 72, 3)).astype(np.uint8)
    image = str(tmp_path / "in.png")
    Image.fromarray(img).save(image)
    out = str(tmp_path / "out.png")
    args = [TINY, ckpt, image, "--out", out, "--opacity", "0.4",
            "--device", "cpu"]
    if arch:
        args += ["--arch", json.dumps(arch)]
    blend = image_demo.main(args)
    with Image.open(out) as im:
        written = np.asarray(im)
    assert np.array_equal(written, blend)
    seg = init_segmentor(TINY, ckpt, device="cpu")
    pred = inference_segmentor(seg, img, arch)
    assert pred.shape == (40, 72) and len(np.unique(pred)) > 1
    want = j_show_result(img, pred, PALETTE, 0.4)
    assert written.dtype == want.dtype and np.array_equal(written, want)
