"""The port's process functions on 2 gloo processes of this CPU.

The counterpart of ``tests/mp_worker.py`` (the JAX package's 2-process
test): ``broadcast_object`` of a sampler meta with strings,
``all_gather_objects`` in rank order, the tensor collectives, a global
batch split over the ranks (loader and train feed), and ``evaluate`` over 7
records at batch 2 on 2 ranks with the one-process confusion matrix.

``run_ranks`` starts the ranks with the ``spawn`` method on a free port,
joins them within a timeout (killing them past it, so a hang fails the
test) and leaves each rank's result in a file; every rank leaves its
process group in a ``finally``.
"""
import datetime
import os
import socket
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gaiaseg_tpu_torch import parallel
from gaiaseg_tpu_torch.data import SyntheticDataset
from gaiaseg_tpu_torch.data.loader import BatchLoader

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs", "local_examples", "train_supernet",
                        "pspnet_ar50to101v2_gsync.py")
TINY = os.path.join(REPO, "configs", "tests", "tiny_synthetic.py")
TIMEOUT_S = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(fn, rank, world, port, out_dir, args, join_group):
    torch.set_num_threads(1)
    out = os.path.join(out_dir, f"rank{rank}.pt")
    try:
        if join_group:
            parallel.initialize_distributed(f"127.0.0.1:{port}", world,
                                            rank, backend="gloo",
                                            timeout_s=TIMEOUT_S)
        torch.save({"result": fn(rank, world, *args)}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise
    finally:
        parallel.shutdown_distributed()


def run_ranks(fn, out_dir, *args, world=2, join_group=True,
              timeout=TIMEOUT_S):
    """``fn(rank, world, *args)`` on ``world`` spawned processes joined by
    a gloo group (``join_group=False``: ``fn`` joins one itself, with the
    port as its first argument); returns the ranks' results in order."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    if not join_group:
        args = (port,) + args
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, str(out_dir), args,
                               join_group)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    for p in procs:
        p.join(max((deadline - datetime.datetime.now()).total_seconds(), 1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"ranks {hung} did not finish in {timeout} s"
    results = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pt")
        assert os.path.exists(path), f"rank {r} left no result"
        got = torch.load(path, weights_only=False)
        assert "error" not in got, f"rank {r} failed:\n{got['error']}"
        results.append(got["result"])
    for r, p in enumerate(procs):
        assert p.exitcode == 0, f"rank {r} exit code {p.exitcode}"
    return results


# --------------------------------------------------------------------- #
def _objects(rank, world):
    from gaiaseg_tpu_torch.archspace import build_model_sampler
    from gaiaseg_tpu_torch.utils import Config
    meta = None
    if rank == 0:
        sampler = build_model_sampler(Config.fromfile(FLAGSHIP)
                                      ["train_sampler"])
        meta = [sampler.sample() for _ in range(5)][-1]   # the R50 anchor
    got = parallel.broadcast_object(meta)
    gathered = parallel.all_gather_objects({"rank": rank,
                                            "name": "r" * (rank * 40 + 1)})
    t = torch.full((3,), float(rank + 1))
    parallel.all_reduce_sum(t)
    b = [torch.full((2, 2), float(rank)), torch.arange(3.0) * (rank + 1)]
    parallel.broadcast_tensors(b, src=1)
    parallel.barrier()
    # under nccl, objects and barriers take a gloo group made beside it
    from gaiaseg_tpu_torch.parallel import distributed
    distributed.current_backend = lambda: "nccl"
    side = (parallel.broadcast_object(meta),
            parallel.all_gather_objects(rank * 10))
    parallel.barrier()
    return {"meta": got, "gathered": gathered, "sum": t, "bcast": b,
            "world": (parallel.process_index(), parallel.process_count()),
            "side": side, "side_group": distributed._objects_group
            is not None}


def test_objects_and_tensors_cross_two_ranks(tmp_path):
    res = run_ranks(_objects, tmp_path)
    want = res[0]["meta"]
    assert want["name"] == "R50" and "arch.backbone.body.depth" in want
    for r, got in enumerate(res):
        assert got["world"] == (r, 2)
        assert got["meta"] == want
        assert got["gathered"] == [{"rank": 0, "name": "r"},
                                   {"rank": 1, "name": "r" * 41}]
        torch.testing.assert_close(got["sum"], torch.full((3,), 3.0))
        torch.testing.assert_close(got["bcast"][0], torch.ones(2, 2))
        torch.testing.assert_close(got["bcast"][1], torch.arange(3.0) * 2)
        assert got["side_group"] and got["side"] == (want, [0, 10])


def test_single_process_returns_the_one_process_answers():
    assert parallel.data_parallel() == (0, 1)
    assert parallel.broadcast_object({"a": "b"}) == {"a": "b"}
    assert parallel.all_gather_objects(3) == [3]
    t = torch.ones(2)
    assert parallel.all_reduce_sum(t) is t and parallel.sum_over_ranks(t) \
        is t
    assert not parallel.initialize_distributed()
    with pytest.raises(ValueError, match="coordinator"):
        parallel.initialize_distributed(num_processes=2, process_id=0)


def _lonely(rank, world, port):
    if rank == 1:
        return None     # never joins: rank 0's rendezvous must fail
    try:
        parallel.initialize_distributed(f"127.0.0.1:{port}", world, 0,
                                        backend="gloo", timeout_s=3)
    except Exception as e:     # noqa: BLE001 - any rendezvous error
        return {"raised": type(e).__name__,
                "initialized": dist.is_initialized()}
    return {"raised": None}


def test_failed_rendezvous_raises_and_stays_single(tmp_path):
    res = run_ranks(_lonely, tmp_path, join_group=False, timeout=60)
    assert res[0]["raised"] is not None and not res[0]["initialized"]


def _torchrun_env(rank, world, port):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    made = parallel.initialize_distributed(backend="gloo", timeout_s=60)
    t = parallel.all_reduce_sum(torch.ones(2))
    return {"made": made, "rank": parallel.process_index(),
            "world": parallel.process_count(),
            "local": parallel.local_rank(), "sum": t}


def test_initialize_from_torchrun_environment(tmp_path):
    res = run_ranks(_torchrun_env, tmp_path, join_group=False)
    for r, got in enumerate(res):
        assert got["made"] and (got["rank"], got["world"], got["local"]) \
            == (r, 2, r)
        torch.testing.assert_close(got["sum"], torch.full((2,), 2.0))


# --------------------------------------------------------------------- #
@pytest.mark.parametrize("infinite", [True, False])
def test_batch_parts_make_the_global_batch(infinite):
    """Each step's parts over the ranks, in rank order, are the one-process
    batch of W·B, padding included."""
    ds = SyntheticDataset(length=13, size=(4, 4), num_classes=3, seed=2)
    kw = dict(shuffle=True, seed=3, drop_last=infinite, infinite=infinite,
              prefetch=0, index_only=True)
    one = BatchLoader(ds, 6, **kw)
    parts = [BatchLoader(ds, 6, batch_part=(r, 3), **kw) for r in range(3)]
    steps = 5 if infinite else len(one)
    for whole, *ranks in zip(*(iter(x) for x in [one] + parts)):
        np.testing.assert_array_equal(
            np.concatenate([b["idx"] for b in ranks]), whole["idx"])
        assert sum(b.get("pad_count", 0) for b in ranks) == \
            whole.get("pad_count", 0)
        steps -= 1
        if steps == 0:
            break
    assert steps == 0
    with pytest.raises(ValueError, match="batch_part"):
        BatchLoader(ds, 5, batch_part=(0, 2))


def _feed(rank, world, batch):
    from gaiaseg_tpu_torch.data.pipeline_cfg import parse_train_pipeline
    from gaiaseg_tpu_torch.engine.train import make_train_feed
    from gaiaseg_tpu_torch.utils import Config
    cfg = Config.fromfile(TINY)
    ds = SyntheticDataset(length=11, size=(40, 48), num_classes=5, seed=4,
                          cells=2)
    feed = make_train_feed(ds, parse_train_pipeline(
        cfg["data"]["train"]["pipeline"]), batch, 5, torch.device("cpu"),
        seed=7, depth=1)
    try:
        return [next(feed)[:2] for _ in range(4)]
    finally:
        feed.close()


def test_train_feed_parts_are_the_one_process_batches(tmp_path):
    """Same records and the same augmentation draws per sample: two ranks
    at 2 are the one process at 4, bit for bit."""
    ranks = run_ranks(_feed, tmp_path, 2)
    whole = _feed(0, 1, 4)
    for step, (img, gt) in enumerate(whole):
        torch.testing.assert_close(
            torch.cat([r[step][0] for r in ranks]), img, rtol=0, atol=0)
        torch.testing.assert_close(
            torch.cat([r[step][1] for r in ranks]), gt, rtol=0, atol=0)


# --------------------------------------------------------------------- #
def _tiny_model():
    from gaiaseg_tpu_torch.models import build_segmentor
    from gaiaseg_tpu_torch.utils import Config
    torch.manual_seed(0)
    return build_segmentor(Config.fromfile(TINY)["model"])


def _evaluate(rank, world):
    from gaiaseg_tpu_torch.engine import evaluate
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    from gaiaseg_tpu_torch.utils import Config
    model = _tiny_model()
    ds = SyntheticDataset(length=7, size=(32, 32), num_classes=5, seed=1,
                          cells=2)
    arch = encode_arch(model_max_arch(Config.fromfile(TINY)["model"]))
    return evaluate(model, ds, arch, batch_size=2, device="cpu")


def test_sharded_evaluate_sums_to_the_one_process_matrix(tmp_path):
    """7 records at batch 2 on 2 ranks: shards of 4 and 3 records, the
    second padded; the summed matrix is the one-process one exactly."""
    ranks = run_ranks(_evaluate, tmp_path)
    whole = _evaluate(0, 1)
    assert whole["confusion"].sum() == 7 * 32 * 32
    for got in ranks:
        np.testing.assert_array_equal(got["confusion"], whole["confusion"])
        assert got["mIoU"] == whole["mIoU"]
