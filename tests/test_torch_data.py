"""The port's data pipeline (host side) against the JAX package's.

- ``parse_train_pipeline`` / ``parse_test_pipeline`` on every config under
  ``configs/`` that has a pipeline: equal dataclasses.
- ``CustomDataset``, ``CityscapesDataset`` (``_labelIds`` mapped to trainIds
  and ``_labelTrainIds``, ``split`` files) and ``ADE20KDataset``
  (``reduce_zero_label``) on PNG/JPEG trees written here: bit-equal
  records, equal length and order; each builds through ``build_dataset``.
- ``PackedDataset`` / ``pack_dataset``: a file written by either package
  reads the same in both (same and resized shapes, byte-equal files); two
  processes that build the native reader at once both load it.
- ``BatchLoader``: equal batch streams and ``pad_count`` (shuffle,
  drop_last, padded tail, infinite with a dataset smaller than the batch,
  shards, ``index_only``); ``device_prefetch``/``_pump``: order,
  exceptions, early close.
- ``DeviceCachedDataset`` on the CPU: batches bit-equal to the streaming
  ones, the budget fallback, the ``build_dataset`` key.
- ``SegEvaluator``: the JAX evaluator's matrix and metrics.
"""
import glob
import os
import subprocess
import sys
import threading
import time
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gaiaseg_tpu.data import datasets as jds
from gaiaseg_tpu.data import loader as jloader
from gaiaseg_tpu.data import metrics as jmetrics
from gaiaseg_tpu.data import pipeline_cfg as jpipe
from gaiaseg_tpu.utils.config import Config as JConfig
from gaiaseg_tpu_torch.data import datasets as pds
from gaiaseg_tpu_torch.data import device_cache, loader, metrics, packed
from gaiaseg_tpu_torch.data import pipeline_cfg as ppipe

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------- #
# pipeline configs
# --------------------------------------------------------------------- #
def _pipelines():
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.py"),
                                 recursive=True)):
        try:
            cfg = JConfig.fromfile(path).to_dict()
        except Exception:
            continue
        for split, d in sorted((cfg.get("data") or {}).items()):
            if isinstance(d, dict) and d.get("pipeline"):
                out.append((os.path.relpath(path, REPO), split, d["pipeline"]))
    return out


PIPELINES = _pipelines()


def test_pipeline_configs_are_found():
    assert len(PIPELINES) >= 10


@pytest.mark.parametrize("path,split,pipeline", PIPELINES,
                         ids=[f"{p}:{s}" for p, s, _ in PIPELINES])
def test_parse_pipeline_matches_jax(path, split, pipeline):
    assert ppipe.parse_train_pipeline(pipeline).__dict__ == \
        jpipe.parse_train_pipeline(pipeline).__dict__
    assert ppipe.parse_test_pipeline(pipeline).__dict__ == \
        jpipe.parse_test_pipeline(pipeline).__dict__


# --------------------------------------------------------------------- #
# file datasets
# --------------------------------------------------------------------- #
def _write_tree(root, img_dir, ann_dir, stems, img_suffix, ann_suffix,
                values, seed):
    rng = np.random.RandomState(seed)
    for stem in stems:
        img = rng.randint(0, 256, (10, 14, 3)).astype(np.uint8)
        lab = rng.choice(values, (10, 14)).astype(np.uint8)
        for d, arr, suf in ((img_dir, img, img_suffix),
                            (ann_dir, lab, ann_suffix)):
            path = os.path.join(root, d, stem + suf)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(arr).save(path)


def _records_equal(port, ref):
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert a.keys() == b.keys() and a["idx"] == b["idx"] == i
        for k in ("img", "gt"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


CITY_STEMS = ["aachen/aachen_000000_000019", "aachen/aachen_000001_000019",
              "bonn/bonn_000000_000019"]


@pytest.mark.parametrize("suffix", ["_gtFine_labelIds.png",
                                    "_gtFine_labelTrainIds.png"])
def test_cityscapes_records_match_jax(tmp_path, suffix):
    root = str(tmp_path)
    values = [0, 7, 8, 11, 26, 33] if "labelIds" in suffix else \
        [0, 1, 5, 18, 255]
    _write_tree(root, "leftImg8bit/train", "gtFine/train", CITY_STEMS,
                "_leftImg8bit.png", suffix, values, seed=1)
    kw = dict(data_root=root, seg_map_suffix=suffix)
    port = pds.build_dataset(dict(type="CityscapesDataset19", **kw))
    ref = jds.build_dataset(dict(type="CityscapesDataset19", **kw))
    assert isinstance(port, pds.CityscapesDataset)
    _records_equal(port, ref)
    assert port.CLASSES == ref.CLASSES and port.num_classes == 19
    if "labelIds" in suffix:    # mapped to trainIds
        assert set(np.unique(port[0]["gt"])) <= {0, 1, 2, 13, 18, 255}
    with open(os.path.join(root, "split.txt"), "w") as f:
        f.write(f"{CITY_STEMS[2]}\n{CITY_STEMS[0]}\n")
    kw["split"] = "split.txt"
    _records_equal(pds.CityscapesDataset(**kw), jds.CityscapesDataset(**kw))
    assert len(pds.CityscapesDataset(**kw)) == 2


def test_ade20k_and_custom_records_match_jax(tmp_path):
    root = str(tmp_path)
    stems = ["ADE_train_00000001", "ADE_train_00000002"]
    _write_tree(root, "images/training", "annotations/training", stems,
                ".jpg", ".png", [0, 1, 7, 150], seed=2)
    for t in ("ADE20KDataset", "ADEDataset"):
        port = pds.build_dataset(dict(type=t, data_root=root))
        _records_equal(port, jds.build_dataset(dict(type=t, data_root=root)))
    assert (port[0]["gt"][np.asarray(Image.open(os.path.join(
        root, "annotations/training", stems[0] + ".png"))) == 0] == 255).all()
    kw = dict(type="CustomDataset", data_root=root, img_dir="images/training",
              ann_dir="annotations/training", img_suffix=".jpg",
              classes=("a", "b"))
    _records_equal(pds.build_dataset(kw), jds.build_dataset(kw))
    no_ann = dict(kw, ann_dir=None)
    _records_equal(pds.build_dataset(no_ann), jds.build_dataset(no_ann))


# --------------------------------------------------------------------- #
# packed files
# --------------------------------------------------------------------- #
def _jax_packed():
    """The JAX package's packed module, its reader built (a retry covers a
    build that another test process is writing at the same moment)."""
    from gaiaseg_tpu.data import packed as jpacked
    from gaiaseg_tpu.native import load_packio
    for attempt in range(5):
        try:
            load_packio()
            return jpacked
        except (OSError, RuntimeError):
            if attempt == 4:
                raise
            time.sleep(2.0)


@pytest.mark.parametrize("size", [None, (9, 13)])
def test_packed_files_read_the_same_in_both_packages(tmp_path, size):
    jpacked = _jax_packed()
    ds = pds.SyntheticDataset(length=5, size=(16, 24), num_classes=7)
    mine, theirs = str(tmp_path / "port.gsegpack"), str(tmp_path /
                                                        "jax.gsegpack")
    packed.pack_dataset(ds, mine, size=size)
    jpacked.pack_dataset(ds, theirs, size=size)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    idx = np.array([4, 0, 2, 2])
    for path in (mine, theirs):
        a = packed.PackedDataset(path, classes=ds.CLASSES)
        b = jpacked.PackedDataset(path, classes=ds.CLASSES)
        assert len(a) == len(b) == 5 and (a.h, a.w) == (b.h, b.w)
        ra, rb = a.read_batch(idx), b.read_batch(idx)
        for k in ("img", "gt", "idx"):
            assert ra[k].dtype == rb[k].dtype and np.array_equal(ra[k], rb[k])
        assert np.array_equal(a[3]["img"], b[3]["img"])
        if size is None:
            assert np.array_equal(a[3]["img"], ds[3]["img"])
            assert np.array_equal(a[3]["gt"], ds[3]["gt"])
    built = pds.build_dataset(dict(type="PackedDataset", path=mine,
                                   classes=ds.CLASSES))
    assert isinstance(built, packed.PackedDataset) and built.num_classes == 7
    with pytest.raises(IndexError):
        built.read_batch(np.array([5]))


_BUILD = r"""
import sys
from pathlib import Path
sys.path.insert(0, {repo!r})
from gaiaseg_tpu_torch.native import build
build.BUILD_DIR = Path({out!r})
lib = build.load_packio()
print(build.library_path().name, lib.packio_len(lib.packio_open(b{pack!r})))
"""


def test_concurrent_builds_all_load(tmp_path):
    """Two processes compile the reader into one empty build directory at
    once: each writes its own temporary file and renames it into place, so
    both load a whole library."""
    pack = str(tmp_path / "p.gsegpack")
    packed.pack_dataset(pds.SyntheticDataset(length=3, size=(4, 4)), pack)
    code = _BUILD.format(repo=REPO, out=str(tmp_path / "build"), pack=pack)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0] and outs[0][0].split()[1] == "3"
    assert sorted(os.listdir(tmp_path / "build")) == [outs[0][0].split()[0]]


# --------------------------------------------------------------------- #
# loader and prefetch
# --------------------------------------------------------------------- #
class _Records:
    """Records whose pixels name their index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"img": np.full((2, 3, 3), i, np.uint8),
                "gt": np.full((2, 3), i, np.int32), "idx": i}


LOADER_CASES = [
    dict(n=11, batch_size=4, shuffle=True, drop_last=True),
    dict(n=11, batch_size=4, shuffle=True, drop_last=False),
    dict(n=11, batch_size=4, shuffle=False, drop_last=False),
    dict(n=3, batch_size=4, shuffle=True, infinite=True),
    dict(n=13, batch_size=3, shuffle=True, infinite=True, shard_id=1,
         num_shards=2),
    dict(n=10, batch_size=4, shuffle=True, drop_last=False, index_only=True),
    dict(n=9, batch_size=2, shuffle=True, drop_last=False, shard_id=2,
         num_shards=3),
]


def _take(it, k):
    out = []
    for b in it:
        out.append(b)
        if len(out) == k:
            break
    return out


@pytest.mark.parametrize("case", LOADER_CASES,
                         ids=[str(i) for i in range(len(LOADER_CASES))])
def test_batch_loader_streams_match_jax(case):
    case = dict(case)
    n = case.pop("n")
    kw = dict(seed=5, prefetch=0, **case)
    port = loader.BatchLoader(_Records(n), **kw)
    ref = jloader.BatchLoader(_Records(n), **kw)
    assert len(port) == len(ref)
    epochs = 1 if case.get("infinite") else 3
    for _ in range(epochs):
        k = 12 if case.get("infinite") else 1000
        got, want = _take(port, k), _take(ref, k)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for key in a:
                assert np.array_equal(a[key], b[key]), key
    # the prefetching iterator yields the same first epoch
    again = loader.BatchLoader(_Records(n), **dict(kw, prefetch=2))
    first = loader.BatchLoader(_Records(n), **kw)
    for a, b in zip(_take(again, 3), _take(first, 3)):
        assert np.array_equal(a["idx"], b["idx"])


def test_batch_loader_read_batch_fast_path():
    class Fast(_Records):
        def read_batch(self, idx):
            return {"idx": np.asarray(idx), "img": np.asarray(idx) * 2}
    got = list(loader.BatchLoader(Fast(5), 2, drop_last=False, prefetch=0))
    assert [b["img"].tolist() for b in got] == [[0, 2], [4, 6], [8, 0]]
    assert got[-1]["pad_count"] == 1


def test_device_prefetch_orders_and_propagates():
    calls = []

    def prep(x):
        calls.append(x)
        return x * 10

    assert list(loader.device_prefetch(iter(range(7)), prep, depth=2)) == \
        [0, 10, 20, 30, 40, 50, 60]
    assert calls == list(range(7))

    def bad(x):
        if x == 3:
            raise ValueError("boom")
        return x

    got = []
    with pytest.raises(ValueError, match="boom"):
        for v in loader.device_prefetch(iter(range(10)), bad, depth=2):
            got.append(v)
    assert got == [0, 1, 2]


def test_early_close_stops_the_thread_and_releases_staged_items():
    class Item:
        pass

    made = []

    def source():
        while True:
            item = Item()
            made.append(weakref.ref(item))
            yield item

    before = threading.active_count()
    inner = loader._pump(source, 4)
    pf = loader.device_prefetch(inner, lambda x: x, depth=3)
    first = next(pf)
    time.sleep(0.3)                  # let both threads fill their queues
    assert threading.active_count() == before + 2
    pf.close()
    del inner, first
    assert threading.active_count() == before
    assert all(r() is None for r in made)   # nothing staged stays alive


# --------------------------------------------------------------------- #
# device cache and metrics
# --------------------------------------------------------------------- #
def test_device_cache_batches_match_streaming(caplog):
    ds = pds.SyntheticDataset(length=10, size=(16, 16), num_classes=19)
    c = device_cache.DeviceCachedDataset(ds, "cpu", slab_bytes=2000)
    idx = np.array([3, 7, 0, 9])
    b = c.read_batch(idx)
    assert b["gt"].dtype == torch.uint8 and b["img"].dtype == torch.uint8
    assert np.array_equal(b["img"].numpy(),
                          np.stack([ds[i]["img"] for i in idx]))
    assert np.array_equal(b["gt"].numpy(),
                          np.stack([ds[i]["gt"] for i in idx]))
    assert len(c) == 10 and c.num_classes == 19 and \
        np.array_equal(c[2]["img"], ds[2]["img"])
    tail = list(loader.BatchLoader(c, 4, drop_last=False, prefetch=0))[-1]
    assert tail["pad_count"] == 2
    assert np.array_equal(tail["img"][2].numpy(), ds[0]["img"])
    assert device_cache.cache_nbytes(ds) == 10 * 16 * 16 * 4
    with caplog.at_level("WARNING", logger="gaiaseg_tpu_torch"):
        assert device_cache.maybe_device_cache(ds, 1e-9, device="cpu") is ds
    assert "streaming from host" in caplog.text
    assert device_cache.maybe_device_cache(ds, "false", device="cpu") is ds
    assert isinstance(device_cache.maybe_device_cache(ds, "true",
                                                      device="cpu"),
                      device_cache.DeviceCachedDataset)
    with pytest.raises(ValueError):
        device_cache.maybe_device_cache(ds, "maybe", device="cpu")


def test_build_dataset_device_cache_key(monkeypatch):
    cfg = dict(type="SyntheticDataset", length=6, size=(16, 16))
    ds = pds.build_dataset(dict(cfg, device_cache=True), device="cpu")
    assert isinstance(ds, device_cache.DeviceCachedDataset)
    assert ds.imgs.device.type == "cpu" and len(ds) == 6
    assert not isinstance(pds.build_dataset(cfg, device="cpu"),
                          device_cache.DeviceCachedDataset)
    monkeypatch.setenv("GAIASEG_DEVICE_CACHE_GB", "1e-9")
    assert not isinstance(pds.build_dataset(dict(cfg, device_cache=True),
                                            device="cpu"),
                          device_cache.DeviceCachedDataset)


def test_seg_evaluator_matches_jax():
    rng = np.random.RandomState(0)
    names = [f"c{i}" for i in range(5)]
    port = metrics.SegEvaluator(5, names)
    ref = jmetrics.SegEvaluator(5, names)
    assert port.confusion().sum() == 0
    for _ in range(3):
        pred = rng.randint(0, 6, (2, 9, 11))
        label = rng.randint(0, 6, (2, 9, 11))
        label[label == 5] = 255
        port.update(torch.from_numpy(pred), torch.from_numpy(label))
        ref.update(jnp.asarray(pred), jnp.asarray(label))
    assert np.array_equal(port.confusion(), np.asarray(ref._cm))
    got, want = port.evaluate(), ref.evaluate()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], nan_ok=True)
    port.reset()
    assert port.confusion().sum() == 0


def test_pack_cli_writes_the_jax_packers_file(tmp_path):
    """``tools/pack_dataset.py`` of the port on a config's Cityscapes
    split: the same bytes as the JAX package's ``pack_dataset``."""
    from gaiaseg_tpu_torch.tools import pack_dataset as cli
    jpacked = _jax_packed()
    root = str(tmp_path / "cityscapes")
    _write_tree(root, "leftImg8bit/val", "gtFine/val", CITY_STEMS,
                "_leftImg8bit.png", "_gtFine_labelTrainIds.png",
                [0, 3, 255], seed=3)
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"data = dict(val=dict(type='CityscapesDataset19', "
                   f"data_root={root!r}, img_dir='leftImg8bit/val', "
                   f"ann_dir='gtFine/val', pipeline=[]))\n")
    out = str(tmp_path / "val.gsegpack")
    cli.main([str(cfg), out, "--split", "val", "--size", "6", "8"])
    ref = str(tmp_path / "ref.gsegpack")
    jpacked.pack_dataset(jds.build_dataset(dict(
        type="CityscapesDataset19", data_root=root, img_dir="leftImg8bit/val",
        ann_dir="gtFine/val")), ref, size=(6, 8))
    with open(out, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
