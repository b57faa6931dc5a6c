"""The port's tracer (``gaiaseg_tpu_torch/utils/tracing.py``) and the spans
and counters the train loop and its feed record:
- nesting and self time, on a stepped clock;
- no ``record_function`` range without a profiler; under a CPU
  ``torch.profiler`` the spans' and regions' ranges appear by name;
- the feed's spans come from its prefetch thread, under the index of the
  batch, and later batches stay queued for the next window;
- ``staging.take`` waits on the batch's event (``feed.wait``) before the
  stream (``device.drain``) and hands over the same tensors;
- ``LAUNCHES`` and ``TRAFFIC`` are the tracer's counter groups, counted
  where ``chip_smoke.py`` reads them (``TRAFFIC`` on 2 gloo ranks);
- a tiny ``train_segmentor`` run: rows with ``spans``, ``counts`` and
  ``profiled`` that survive a JSON round trip, spans that account for the
  loop's clocks, and rows readable after ``iter_hook`` stops the loop.
"""
import json
import os
import re
import threading

import pytest
import torch

from gaiaseg_tpu_torch.data import SyntheticDataset, parse_train_pipeline
from gaiaseg_tpu_torch.data import staging
from gaiaseg_tpu_torch.engine import train as ptrain
from gaiaseg_tpu_torch.models import build_segmentor
from gaiaseg_tpu_torch.utils import Config, tracing

from test_torch_parallel import run_ranks

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tests", "tiny_synthetic.py")


class _Clock:
    """A ``time`` stand-in whose ``perf_counter`` moves only by ``tick``."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def tick(self, s):
        self.now += s


@pytest.fixture
def recorder():
    rec = tracing.Recorder()
    try:
        yield rec
    finally:
        rec.stop()


def test_nesting_and_self_time(monkeypatch, recorder):
    clock = _Clock()
    monkeypatch.setattr(tracing, "time", clock)
    tracing.set_step(0)
    with tracing.span("outer") as outer:
        clock.tick(0.002)
        with tracing.span("inner"):
            clock.tick(0.003)
            with tracing.span("leaf"):
                clock.tick(0.004)
        with tracing.span("inner"):
            clock.tick(0.001)
        clock.tick(0.005)
    tracing.set_step(1)
    with tracing.span("outer"):
        clock.tick(0.010)
    assert outer.seconds == pytest.approx(0.015)
    spans, _ = recorder.window(2, 2)
    # a step's self ms: outer (7 + 10) / 2, inner (3 + 1) / 2, leaf 4 / 2
    assert spans == pytest.approx({"outer": 8.5, "inner": 2.0, "leaf": 2.0})
    spans, counts = recorder.window(3, 1)
    assert spans == {} and not any(counts.values())   # nothing held over


def test_spans_outside_a_recorder_keep_nothing():
    with tracing.span("kept.nowhere") as s:
        pass
    assert s.seconds >= 0.0
    rec = tracing.Recorder()
    try:
        assert rec.window(1 << 30, 1)[0] == {}
    finally:
        rec.stop()


def test_no_range_without_a_profiler(monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")
    monkeypatch.setattr(tracing, "record_function", entered)
    assert not tracing.profiling()
    with tracing.span("a.span"), tracing.region("a.region"):
        pass


def test_ranges_appear_under_a_cpu_profiler():
    from torch.profiler import ProfilerActivity, profile
    before = tracing.counters("probe").get("region", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.profiling()
        with tracing.span("probe.span"):
            with tracing.region("probe.region"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"probe.span", "probe.region"} <= names
    assert tracing.counters("probe")["region"] == before + 1
    assert not tracing.profiling()


def _feed(first_iter):
    pipe = parse_train_pipeline([
        dict(type="Resize", img_scale=(64, 32), ratio_range=(0.5, 2.0)),
        dict(type="RandomCrop", crop_size=(16, 32), cat_max_ratio=0.75),
        dict(type="RandomFlip", prob=0.5)])
    ds = SyntheticDataset(length=8, size=(32, 64), num_classes=5)
    return ptrain.make_train_feed(ds, pipe, 2, 5, torch.device("cpu"),
                                  seed=1, depth=2, first_iter=first_iter)


def test_feed_spans_come_from_the_prefetch_thread(recorder):
    main = threading.current_thread()
    feed = _feed(first_iter=7)
    try:
        for _ in range(3):
            next(feed)
        threads = {}
        for st in list(tracing._threads):
            for name, step, _ in list(st.records):
                threads.setdefault(name, set()).add((st.thread, step))
        for name in ptrain.FEED_SPANS:
            assert name in threads, name
            assert all(t is not main for t, _ in threads[name]), name
        assert {s for _, s in threads["feed.prep"]} >= {7, 8, 9}
        spans, counts = recorder.window(9, 2)      # batches 7 and 8
        assert set(ptrain.FEED_SPANS) <= set(spans)
        assert counts["feed.batches"] == 1.0
        # batch 9 (and those prefetched after it) wait for the next window
        left = {step for st in list(tracing._threads)
                for name, step, _ in list(st.records) if name == "feed.prep"}
        assert min(left) == 9
    finally:
        feed.close()


class _Event:
    def __init__(self, calls):
        self.calls = calls

    def synchronize(self):
        self.calls.append(("event.synchronize", _open_span()))


class _Stream:
    def __init__(self, calls):
        self.calls = calls

    def wait_event(self, event):
        self.calls.append(("stream.wait_event", _open_span()))

    def synchronize(self):
        self.calls.append(("stream.synchronize", _open_span()))


def _open_span():
    stack = tracing._state().stack
    return stack[-1].name if stack else None


def test_take_splits_the_wait_and_hands_over_the_same_tensors(monkeypatch,
                                                              recorder):
    calls = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream(calls))
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, s: calls.append(("record_stream", None)))
    img, gt = torch.randn(2, 3, 4, 4), torch.randint(0, 5, (2, 4, 4))
    want = (img.clone(), gt.clone())
    batch = (img, gt)
    tracing.set_step(0)
    staging.take(batch, _Event(calls))
    assert calls == [("stream.wait_event", None), ("record_stream", None),
                     ("record_stream", None),
                     ("event.synchronize", "feed.wait"),
                     ("stream.synchronize", "device.drain")]
    assert batch[0] is img and batch[1] is gt
    assert torch.equal(img, want[0]) and torch.equal(gt, want[1])
    assert set(recorder.window(1, 1)[0]) == {"feed.wait", "device.drain"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_take_on_the_card(cuda, recorder):
    """The card's feed through ``take``: the batches equal the CPU feed's
    and the wait is recorded as ``feed.wait`` and ``device.drain``."""
    pipe = parse_train_pipeline([
        dict(type="RandomCrop", crop_size=(64, 128), cat_max_ratio=0.75),
        dict(type="RandomFlip", prob=0.5)])
    ds = SyntheticDataset(length=10, size=(128, 256), num_classes=19)
    cpu = ptrain.make_train_feed(ds, pipe, 4, 19, torch.device("cpu"), seed=1)
    card = ptrain.make_train_feed(ds, pipe, 4, 19, cuda, seed=1, depth=3)
    try:
        for step in range(4):
            tracing.set_step(step)
            img, gt, ready = next(card)
            staging.take((img, gt), ready)
            want_img, want_gt, _ = next(cpu)
            assert torch.equal(gt.cpu(), want_gt)
            assert torch.allclose(img.float().cpu(), want_img,
                                  rtol=2 ** -8, atol=2e-5)
        spans, _ = recorder.window(4, 4)
        assert {"feed.wait", "device.drain", "feed.prep"} <= set(spans)
    finally:
        card.close()
        cpu.close()


def test_launches_and_traffic_are_tracer_counters():
    from gaiaseg_tpu_torch.ops import cuda as ops_cuda
    from gaiaseg_tpu_torch.ops.cuda import flash_attention, resize_ce
    from gaiaseg_tpu_torch.parallel import distributed
    launches = tracing.counters("launch")
    assert ops_cuda.LAUNCHES is launches is resize_ce.LAUNCHES \
        is flash_attention.LAUNCHES
    assert distributed.TRAFFIC is tracing.counters("collective.bytes")
    ops_cuda.reset_launches()
    tracing.count("launch.flash_fwd")
    tracing.count("launch.resize_ce_bwd", 2)
    assert dict(ops_cuda.LAUNCHES) == {
        "resize_ce_fwd": 0, "resize_ce_bwd": 2, "flash_fwd": 1,
        "flash_bwd_dkv": 0, "flash_bwd_dq": 0, "crop_counts": 0}
    ops_cuda.reset_launches()
    assert not any(ops_cuda.LAUNCHES.values())


def _traffic_rank(rank, world):
    from gaiaseg_tpu_torch.parallel import distributed
    distributed.reset_traffic()
    grads = [torch.ones(3, 5), torch.ones(7)]
    params = []
    for g in grads:
        p = torch.nn.Parameter(torch.zeros_like(g))
        p.grad = g.clone()
        params.append(p)
    distributed.all_reduce_grads(params)
    return dict(distributed.TRAFFIC), \
        dict(tracing.counters("collective.bytes"))


def test_traffic_counts_the_gradient_all_reduce(tmp_path):
    for traffic, group in run_ranks(_traffic_rank, tmp_path):
        assert traffic == group == {"data": 22 * 4, "model": 0}


def _tiny(**opts):
    cfg = Config.fromfile(TINY)
    cfg.merge_from_dict(opts)
    torch.manual_seed(0)
    return cfg, build_segmentor(cfg["model"])


class _Stop(Exception):
    pass


def test_rows_carry_spans_counts_and_profiled():
    """12 iterations at log interval 4: a CPU profiler records the third
    window, and ``iter_hook`` stops the loop at its end."""
    from torch.profiler import ProfilerActivity, profile
    cfg, model = _tiny()
    lines, st = [], {}

    def hook(it):
        if it == 8:
            st["prof"] = profile(activities=[ProfilerActivity.CPU])
            st["prof"].start()
        if it == 12:
            st["prof"].stop()
            raise _Stop
    with pytest.raises(_Stop):
        ptrain.train_segmentor(model, cfg, device="cpu", log=lines.append,
                               iter_hook=hook)
    rows = ptrain.last_history()["loss"]
    assert [r["iter"] for r in rows] == [4, 8, 12]
    assert [r["profiled"] for r in rows] == [False, False, True]
    assert json.loads(json.dumps(rows)) == rows
    for row in rows:
        spans, counts = row["spans"], row["counts"]
        assert {"feed.wait", "train.arch", "train.forward", "train.backward",
                "train.optimizer", "train.close"} <= set(spans)
        assert set(ptrain.FEED_SPANS) <= set(spans)
        assert all(v >= 0.0 for v in spans.values())
        assert counts["feed.batches"] == 1.0
        assert counts["loss.unfused"] == 2.0     # decode and auxiliary heads
        assert counts["launch.resize_ce_fwd"] == 0.0
        assert counts["launch.resize_ce_bwd.any"] == 0.0
        # inside the loop's clocks, and most of them
        steps = 4
        step = sum(v for k, v in spans.items() if k in (
            "train.step", "train.zero_grad", "train.forward",
            "train.backward", "train.grad_sync", "train.zero_fill",
            "train.clip", "train.optimizer", "train.close"))
        data = spans["feed.wait"] + spans["train.arch"]
        assert 0.75 * row["step_ms"] / steps <= step <= \
            1.01 * row["step_ms"] / steps
        assert data <= 1.01 * row["data_ms"] / steps
    names = {e.name for e in st["prof"].events()}
    assert {"train.forward", "train.backward", "feed.wait", "train.close",
            "loss.unfused"} <= names
    # the new fields follow ``data=``, which keeps its place and format
    row_lines = [ln for ln in lines if re.match(r"^iter \d+/\d+ ", ln)]
    assert len(row_lines) == 3
    for ln, row in zip(row_lines, rows):
        m = re.match(r"^iter (\d+)/\d+ .* data=([0-9.]+)ms", ln)
        assert int(m.group(1)) == row["iter"]
        assert m.group(2) == f"{row['data_ms']:.1f}"
        assert re.search(r" data=[0-9.]+ms wait=[0-9.]+ms drain=[0-9.]+ms "
                         r"fwd=[0-9.]+ms bwd=[0-9.]+ms upd=[0-9.]+ms "
                         r"feed=[0-9.]+ms$", ln), ln
    # a later call starts a fresh record
    cfg, model = _tiny()
    _, history = ptrain.train_segmentor(model, cfg, device="cpu",
                                        max_iters=4)
    assert ptrain.last_history() is history
    assert [r["profiled"] for r in history["loss"]] == [False]


def test_convnext_step_counts_its_depthwise_convs_and_drop_paths(
        monkeypatch):
    """A tiny ConvNeXt train step at a sub arch counts one
    ``conv.depthwise`` call a block it runs and one ``drop_path`` call a
    block it runs at a rate above 0 (the first block's rate is 0); neither
    region enters a range without a profiler, and in eval neither draws."""
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    cfg = Config.fromfile(os.path.join(REPO, "configs", "tests",
                                       "tiny_convnext_uper.py"))
    torch.manual_seed(0)
    model = build_segmentor(cfg["model"]).train()
    meta = {"arch.backbone.body.width": [8, 8, 24, 16],
            "arch.backbone.body.depth": [2, 1, 3, 1]}
    arch = encode_arch(model_max_arch(cfg["model"]), meta)
    img = torch.randn(2, 3, 32, 32)
    gt = torch.randint(0, 5, (2, 32, 32), dtype=torch.int32)
    conv, drop = tracing.counters("conv"), tracing.counters("")
    before = conv.get("depthwise", 0), drop.get("drop_path", 0)

    def entered(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")
    monkeypatch.setattr(tracing, "record_function", entered)
    total, _ = model.forward_train(img, gt, arch,
                                   torch.Generator().manual_seed(0))
    total.backward()
    active = sum(meta["arch.backbone.body.depth"])
    assert conv["depthwise"] - before[0] == active
    assert drop["drop_path"] - before[1] == active - 1
    model.eval()
    with torch.no_grad():
        model.extract_feat(img, arch)
    assert conv["depthwise"] - before[0] == 2 * active
    assert drop["drop_path"] - before[1] == active - 1
