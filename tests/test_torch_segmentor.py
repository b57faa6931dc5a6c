"""Port's supernet segmentor vs the JAX DynamicEncoderDecoder.

The model config of tests/test_resize_ce.py:93-112: decode logits 4x4 and
aux logits 8x8 at a 32x32 label, so both losses pass the fused gate (the
JAX side runs its Pallas kernel in interpret mode via fused_loss=True; the
port's autograd Function takes its kernels' plain versions on the CPU).
At the MAX, MIN and one seeded random arch: the train-mode total loss,
every parameter's gradient and the BN running stats, then whole-mode
inference logits, within 1e-4 of each tensor's max magnitude (float32,
dropout 0). The converter round-trips through the JAX package's own
``segmentor_state_dict_to_variables``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.engine.torch_convert import segmentor_state_dict_to_variables
from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
from gaiaseg_tpu.models import encode_arch as j_encode_arch
from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
from gaiaseg_tpu_torch.engine.convert import variables_to_state_dict
from gaiaseg_tpu_torch.models import build_segmentor, encode_arch, \
    model_max_arch

torch.set_num_threads(1)
RTOL = 1e-4


def model_cfg(jax_side: bool):
    dt = {"dtype": jnp.float32} if jax_side else {}
    cfg = dict(
        type="DynamicEncoderDecoder",
        backbone=dict(type="DynamicResNet", stem_width=8,
                      body_width=[8, 16, 24, 32], body_depth=[2, 2, 3, 2],
                      strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
                      out_indices=(0, 1, 2, 3), **dt),
        decode_head=dict(type="DynamicPSPHead", in_index=1, channels=16,
                         pool_scales=(1, 2), dropout_ratio=0.0,
                         num_classes=7, align_corners=False, **dt,
                         loss_decode=dict(type="CrossEntropyLoss",
                                          loss_weight=1.0)),
        auxiliary_head=dict(type="DynamicFCNHead", in_index=0, channels=8,
                            num_convs=1, concat_input=False,
                            dropout_ratio=0.0, num_classes=7, **dt,
                            loss_decode=dict(type="CrossEntropyLoss",
                                             loss_weight=0.4)),
        test_cfg=dict(mode="whole"),
    )
    if jax_side:
        cfg["fused_loss"] = True
    return cfg


def _random_meta(seed):
    rng = np.random.RandomState(seed)
    return {"arch.backbone.stem.width": int(rng.choice([4, 8])),
            "arch.backbone.body.width": [int(rng.randint(w // 2, w + 1))
                                         for w in (8, 16, 24, 32)],
            "arch.backbone.body.depth": [int(rng.randint(1, d + 1))
                                         for d in (2, 2, 3, 2)]}


METAS = {
    "max": None,
    "min": {"arch.backbone.stem.width": 4,
            "arch.backbone.body.width": [4, 8, 12, 16],
            "arch.backbone.body.depth": [1, 1, 1, 1]},
    "random": _random_meta(11),
}


@pytest.fixture(scope="module")
def jax_side():
    cfg = model_cfg(True)
    model = j_build_segmentor(cfg)
    # batch 4, zero-mean images: on some inputs the JAX float32 side loses
    # digits in its BN statistics (E[x^2] - E[x]^2); a float64 run of the
    # port agreed with the float32 port to ~6e-6 where JAX was 5% off
    rng = np.random.RandomState(3)
    img = rng.randn(4, 32, 32, 3).astype(np.float32)
    gt = rng.randint(0, 7, (4, 32, 32)).astype(np.int32)
    gt[:, :4] = 255
    max_arch = j_model_max_arch(cfg)
    k = jax.random.PRNGKey(0)
    variables = jax.jit(lambda a: model.init(
        {"params": k, "dropout": k}, jnp.asarray(img), jnp.asarray(gt), a,
        compute_acc=False, method="forward_train"))(j_encode_arch(max_arch))
    variables = jax.tree_util.tree_map(np.asarray, variables)

    def loss_fn(params, arch):
        (total, _), mut = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(img), jnp.asarray(gt), arch, False,
            method=model.forward_train, mutable=["batch_stats"],
            rngs={"dropout": k})
        return total, mut

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    infer = jax.jit(lambda a: model.apply(variables, jnp.asarray(img), a,
                                          method=model.whole_inference))
    return dict(cfg=cfg, variables=variables, img=img, gt=gt,
                max_arch=max_arch, value_and_grad=value_and_grad,
                infer=infer)


def _port_model(variables):
    model = build_segmentor(model_cfg(False))
    model.load_state_dict(variables_to_state_dict(variables, model_cfg(False)),
                          strict=True)
    return model


def _close(got: np.ndarray, want: np.ndarray, what: str):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("name", list(METAS))
def test_forward_train_loss_grads_and_stats_match_jax(jax_side, name):
    meta = METAS[name]
    arch_j = j_encode_arch(jax_side["max_arch"], meta)
    (total_j, mut), grads_j = jax_side["value_and_grad"](
        jax_side["variables"]["params"], arch_j)
    model = _port_model(jax_side["variables"]).train()
    img = torch.from_numpy(jax_side["img"].transpose(0, 3, 1, 2).copy())
    gt = torch.from_numpy(jax_side["gt"])
    arch = encode_arch(model_max_arch(model_cfg(False)), meta)
    total, logs = model.forward_train(img, gt, arch)
    assert set(logs) == {"decode.loss_seg", "aux_0.loss_seg"}
    total.backward()
    assert abs(float(total.detach()) - float(total_j)) <= \
        RTOL * abs(float(total_j))

    stats_j = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
    want = variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, grads_j),
         "batch_stats": stats_j}, model_cfg(False))
    n_reached = 0
    for key, p in model.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape,
                                                                 np.float32)
        _close(g, want[key].numpy(), f"grad {key}")
        n_reached += p.grad is not None
    assert n_reached > 0
    for key, buf in model.named_buffers():
        _close(buf.numpy(), want[key].numpy(), f"stat {key}")


@pytest.mark.parametrize("name", list(METAS))
def test_whole_inference_matches_jax(jax_side, name):
    meta = METAS[name]
    logits_j = np.asarray(jax_side["infer"](
        j_encode_arch(jax_side["max_arch"], meta)))
    model = _port_model(jax_side["variables"]).eval()
    img = torch.from_numpy(jax_side["img"].transpose(0, 3, 1, 2).copy())
    arch = encode_arch(model_max_arch(model_cfg(False)), meta)
    with torch.no_grad():
        logits = model.whole_inference(img, arch)
        pred = model.simple_test(img, arch)
    _close(logits.permute(0, 2, 3, 1).numpy(), logits_j, "logits")
    assert tuple(pred.shape) == (4, 32, 32)


def test_convert_round_trips_through_jax_converter(jax_side):
    variables = jax_side["variables"]
    model = _port_model(variables)
    back = segmentor_state_dict_to_variables(model.state_dict(), variables,
                                             jax_side["cfg"])
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf), err_msg=str(path))


def test_inference_needs_eval_mode(jax_side):
    model = _port_model(jax_side["variables"]).train()
    img = torch.zeros(1, 3, 32, 32)
    with pytest.raises(RuntimeError):
        model.whole_inference(img, encode_arch(model_max_arch(
            model_cfg(False))))
