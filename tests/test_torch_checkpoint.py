"""The port's checkpoints: reference-layout ``.pth`` files.

- A round trip of weights, BN statistics, the optimizer state (SGD momentum,
  AdamW moments and step) and ``meta``: bit-equal after ``load_checkpoint``
  into a fresh model and optimizer, and the optimizers take the same next
  step.
- ``latest.pth`` is a symlink swapped in place; ``latest_checkpoint`` finds
  it; no temporary file is left behind; a failed write raises and leaves
  the previous file.
- ``strict=False``: missing and unexpected keys are logged, not raised.
- The JAX package's own ``load_torch_segmentor`` reads a port checkpoint:
  its whole-inference logits within 1e-4 of max|logit| of the port's.
- ``subnet_ckpt_name`` is the JAX name with the port's suffix.
"""
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.engine.checkpoint import subnet_ckpt_name as j_subnet_name
from gaiaseg_tpu.engine.torch_convert import load_torch_segmentor
from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
from gaiaseg_tpu.models import encode_arch as j_encode_arch
from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
from gaiaseg_tpu_torch.engine import checkpoint as ck
from gaiaseg_tpu_torch.engine import optim
from gaiaseg_tpu_torch.engine.train import train_step
from gaiaseg_tpu_torch.models import build_segmentor, encode_arch, \
    model_max_arch

from test_torch_segmentor import METAS, model_cfg

torch.set_num_threads(1)
RTOL = 1e-4
OPTIMIZERS = {
    "sgd": dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=5e-4),
    "adamw": dict(type="AdamW", lr=1e-3, betas=(0.9, 0.999),
                  weight_decay=0.01),
}
META = {"iter": 2, "CLASSES": [f"c{i}" for i in range(7)],
        "PALETTE": [[i, 2 * i, 3 * i] for i in range(7)],
        "max_arch": model_max_arch(model_cfg(False))}


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(2, 3, 32, 32).astype(np.float32)),
            torch.from_numpy(rng.randint(0, 7, (2, 32, 32)).astype(np.int32)))


def _trained(opt_cfg, seed=0):
    torch.manual_seed(seed)
    model = build_segmentor(model_cfg(False)).train()
    opt = optim.build_optimizer(model.parameters(), opt_cfg)
    max_arch = model_max_arch(model_cfg(False))
    for i, name in enumerate(("max", "random")):
        train_step(model, opt, *_batch(i), encode_arch(max_arch, METAS[name]))
    return model, opt


def _equal_state(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        elif isinstance(a[k], dict):
            _equal_state(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
def test_round_trip_is_bit_equal(tmp_path, opt_name):
    model, opt = _trained(OPTIMIZERS[opt_name])
    path = str(tmp_path / "iter_2.pth")
    ck.save_checkpoint(path, model, opt, META)
    assert sorted(os.listdir(tmp_path)) == ["iter_2.pth"]
    raw = torch.load(path, map_location="cpu", weights_only=False)
    assert set(raw) == {"meta", "state_dict", "optimizer"}

    fresh, fresh_opt = _trained(OPTIMIZERS[opt_name], seed=1)
    assert not torch.equal(fresh.decode_head.conv_seg.weight,
                           model.decode_head.conv_seg.weight)
    meta = ck.load_checkpoint(path, fresh, fresh_opt)
    assert meta == META
    _equal_state(model.state_dict(), fresh.state_dict())
    _equal_state(opt.state_dict()["state"], fresh_opt.state_dict()["state"])
    # both take the same next step
    arch = encode_arch(model_max_arch(model_cfg(False)), METAS["min"])
    for m, o in ((model, opt), (fresh, fresh_opt)):
        train_step(m, o, *_batch(5), arch)
    _equal_state(model.state_dict(), fresh.state_dict())


def test_latest_symlink_is_swapped_in_place(tmp_path):
    model, opt = _trained(OPTIMIZERS["sgd"])
    wd = str(tmp_path)
    assert ck.latest_checkpoint(wd) is None
    for it in (4, 8):
        path = os.path.join(wd, f"iter_{it}.pth")
        ck.save_checkpoint(path, model, opt, dict(META, iter=it))
        ck.update_latest(wd, path)
        latest = ck.latest_checkpoint(wd)
        assert os.path.islink(latest)
        assert os.path.realpath(latest) == os.path.realpath(path)
    assert sorted(os.listdir(wd)) == ["iter_4.pth", "iter_8.pth",
                                      "latest.pth"]
    assert ck.load_checkpoint(ck.latest_checkpoint(wd), model)["iter"] == 8


def test_failed_write_raises_and_keeps_the_old_file(tmp_path, monkeypatch):
    model, opt = _trained(OPTIMIZERS["sgd"])
    path = str(tmp_path / "iter_2.pth")
    ck.save_checkpoint(path, model, opt, META)
    before = open(path, "rb").read()

    def full_disk(*args, **kw):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ck.torch, "save", full_disk)
    with pytest.raises(OSError, match="No space"):
        ck.save_checkpoint(path, model, opt, dict(META, iter=3))
    assert open(path, "rb").read() == before
    assert sorted(os.listdir(tmp_path)) == ["iter_2.pth"]


def test_non_strict_load_logs_missing_and_unexpected_keys(tmp_path, caplog):
    model, _ = _trained(OPTIMIZERS["sgd"])
    sd = dict(model.state_dict())
    dropped = sd.pop("decode_head.conv_seg.bias")
    sd["extra.weight"] = torch.zeros(1)
    path = str(tmp_path / "ref.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)
    fresh, _ = _trained(OPTIMIZERS["sgd"], seed=1)
    keep = fresh.decode_head.conv_seg.bias.clone()
    with caplog.at_level(logging.WARNING, logger="gaiaseg_tpu_torch"):
        assert ck.load_checkpoint(path, fresh) == {}
    assert "missing keys" in caplog.text and \
        "decode_head.conv_seg.bias" in caplog.text
    assert "unexpected keys" in caplog.text and "extra.weight" in caplog.text
    assert torch.equal(fresh.decode_head.conv_seg.bias, keep)
    assert not torch.equal(keep, dropped)
    assert torch.equal(fresh.decode_head.conv_seg.weight,
                       model.decode_head.conv_seg.weight)


@pytest.mark.parametrize("name", ["max", "min"])
def test_jax_reads_a_port_checkpoint(tmp_path, name):
    model, opt = _trained(OPTIMIZERS["sgd"])
    path = str(tmp_path / "port.pth")
    ck.save_checkpoint(path, model, opt, META)

    cfg = model_cfg(True)
    jmodel = j_build_segmentor(cfg)
    img = np.random.RandomState(7).randn(2, 32, 32, 3).astype(np.float32)
    k = jax.random.PRNGKey(0)
    tmpl = jax.jit(lambda a: jmodel.init(
        {"params": k, "dropout": k}, jnp.asarray(img),
        jnp.zeros((2, 32, 32), jnp.int32), a, compute_acc=False,
        method="forward_train"))(j_encode_arch(j_model_max_arch(cfg)))
    variables = load_torch_segmentor(path, dict(tmpl), cfg)
    meta = METAS[name]
    want = np.asarray(jmodel.apply(
        variables, jnp.asarray(img), j_encode_arch(j_model_max_arch(cfg),
                                                   meta),
        method=jmodel.whole_inference))
    model.eval()
    with torch.no_grad():
        got = model.whole_inference(
            torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
            encode_arch(model_max_arch(model_cfg(False)), meta))
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * float(np.abs(want).max()))


def test_subnet_ckpt_name_matches_jax():
    meta = {"arch": {"backbone": {"body": {"depth": [1, 2, 3, 1]}}},
            "name": "R50"}
    assert ck.subnet_ckpt_name(meta) == \
        j_subnet_name(meta)[:-len(".ckpt")] + ".pth"
